"""Failure detection and recovery for long engine runs (counterpart of the
JAX package's ``runtime/watchdog.py``).

The reference's only failure handling is a NaN check on the camera
quaternion that prints "Help!" and keeps running (`main.rs:828-844`). Here
the state is validated periodically and snapshotted while good, so a long
scripted render or session that goes non-finite rolls back to the last good
snapshot instead of drawing garbage.
"""

from __future__ import annotations

import torch

from .state import EngineState


def state_is_finite(state: EngineState) -> bool:
    """The simulation-critical fields (camera position, quaternion, yaw)
    are finite: one host fetch of a bool per band. The screen is not
    scanned: a non-finite screen comes only from a non-finite camera
    upstream. A band engine's state (parallel/shard.py ShardedEngineState,
    every field a tuple over the bands) is checked on every band."""
    fields = (state.cam_center, state.quat, state.half_theta)
    bands = zip(*(x if isinstance(x, tuple) else (x,) for x in fields))
    return all(bool(torch.isfinite(c).all() & torch.isfinite(q).all() & torch.isfinite(h).all())
               for c, q, h in bands)


def _copy(state):
    """A copy of every tensor of the state (of every band's)."""
    return type(state)(*(tuple(t.clone() for t in x) if isinstance(x, tuple) else x.clone()
                         for x in state))


class Watchdog:
    """Periodic state validation with rollback to the last good snapshot.

    >>> wd = Watchdog(interval=32)
    >>> state = wd.check(state)   # every frame; validates every `interval`
    """

    def __init__(self, interval: int = 32):
        self.interval = interval
        self._snapshot: EngineState | None = None
        self._since = 0
        self.rollbacks = 0

    def check(self, state, n: int = 1):
        """``state``, or a copy of the last good snapshot if ``state`` is not
        finite. Validates (and snapshots) every ``interval`` frames; ``n`` is
        the frames this call advances (a multi-frame step passes its count)."""
        self._since += n
        if self._since < self.interval and self._snapshot is not None:
            return state
        self._since = 0
        if state_is_finite(state):
            self._snapshot = _copy(state)
            return state
        self.rollbacks += 1
        if self._snapshot is None:
            raise FloatingPointError("engine state non-finite and no snapshot to roll back to")
        # A copy, so that the snapshot survives if the state goes bad again.
        return _copy(self._snapshot)
