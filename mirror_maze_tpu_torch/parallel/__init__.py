"""Several devices and several processes (counterpart of the JAX package's
``parallel/__init__.py``).

``shard.py`` holds the single-process machinery over a list of devices (the
batched multi-camera renderer and the row-band engine). This package entry
adds the multi-process side: one ``initialize_multihost`` call per process
joins it to a ``torch.distributed`` process group, which the multiplayer
engine (``multiplayer.py``) exchanges camera positions over.
"""

from __future__ import annotations


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout_s: float = 60.0,
) -> int:
    """Join this process to a ``torch.distributed`` process group on the
    gloo backend; returns the number of processes (the world size).

    ``coordinator_address`` is ``host:port`` of process 0's machine
    (``init_method="tcp://host:port"``), ``num_processes`` the world size and
    ``process_id`` this process's rank. With no address the group comes up
    from the environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). Gloo runs any number of processes on one card (NCCL refuses
    two ranks on the same GPU) and exchanges host tensors. A collective that
    waits longer than ``timeout_s`` for a peer raises instead of hanging."""
    import datetime

    import torch.distributed as dist

    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group("gloo", init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_world_size()


from .shard import (  # noqa: E402
    batch_cameras,
    gather_frames,
    make_sharded_engine,
    make_sharded_renderer,
    make_sharded_scan_engine,
)

__all__ = [
    "batch_cameras",
    "gather_frames",
    "initialize_multihost",
    "make_sharded_engine",
    "make_sharded_renderer",
    "make_sharded_scan_engine",
]
