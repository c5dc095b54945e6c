"""N-player multiplayer demo (``parallel/multiplayer.py``; counterpart of
the JAX package's ``examples/multiplayer_demo.py``).

Launches ``--players`` processes, joined into one ``torch.distributed``
process group over gloo, in the LITERAL seed-0 reference world. Players
1..N-1 stroll down the spawn corridor (each with its own gait and a slight
heading of its own); player 0 stands at the reference spawn and watches
their coloured sphere avatars, saving its view as a GIF. Every player
renders on the CUDA card (one card may hold them all) unless ``--device
cpu`` is given.

    python -m mirror_maze_tpu_torch.examples.multiplayer_demo [--players 3]
        [--out mp.gif] [--frames 96] [--device cpu]

Each player steps its own engine; the only traffic between them is one
[P, 3] position all_gather per frame. For a hands-on session use the CLI
instead: one terminal per player, e.g.

    python -m mirror_maze_tpu_torch play --players 2 --player-id 0 &
    python -m mirror_maze_tpu_torch play --players 2 --player-id 1

Each player prints its final position as ``player {pid} done at z=...``
followed by the exact position (float hex) for scripts that check it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

# Players 1..N-1 walk on frames where (i + pid) % 3 != 2 and turn by
# 12 * (pid - 1.5) on the first MOUSE_FRAMES frames; player 0 spectates.
MOUSE_FRAMES = 4
GIF_EVERY = 4
RENDEZVOUS_TIMEOUT_S = 120.0


def player_config(pid: int):
    """Player ``pid``'s configuration. Walkers start staggered down the
    corridor AND offset laterally so the nearer avatar does not occlude the
    farther one from the spectator."""
    from ..config import CameraConfig, EngineConfig, MazeConfig, ScreenConfig, TracerConfig

    spawn = ((-5.0, 0.0, -45.0) if pid == 0
             else (-5.0 + 1.8 * (pid - 1.5), 0.0, -45.0 + 5.0 * pid))
    return EngineConfig(
        maze=MazeConfig(rng="reference"),
        camera=CameraConfig(spawn=spawn, look_dir=(0.1, 0.0, 1.0)),
        tracer=TracerConfig(bounce_limit=4, mirror_limit=6),
        screen=ScreenConfig(width=192, height=144, samples_per_pixel=4,
                            chunks_per_frame=432),   # 1/4 screen per frame
        intersector="brute",
    )


def player_inputs(pid: int, n_frames: int) -> list:
    """Player ``pid``'s FrameInputs, frame by frame: each walker with its
    own gait (phase-shifted pauses) and a tiny heading of its own."""
    from ..runtime.state import FrameInputs

    return [FrameInputs.make(
        w=(pid > 0 and (i + pid) % 3 != 2),
        mouse_dx=(12.0 * (pid - 1.5) if pid > 0 and i < MOUSE_FRAMES else 0.0),
    ) for i in range(n_frames)]


def run_player(pid: int, port: int, out: str, n_frames: int, n_players: int,
               device=None) -> None:
    """One player process: join the group, step the engine, and (player 0)
    write every GIF_EVERY-th frame into the GIF at ``out``."""
    import numpy as np

    from ..device import resolve_device
    from ..parallel import initialize_multihost
    from ..parallel.multiplayer import make_multiplayer_engine

    dev = resolve_device(device)
    initialize_multihost(coordinator_address=f"localhost:{port}",
                         num_processes=n_players, process_id=pid,
                         timeout_s=RENDEZVOUS_TIMEOUT_S)
    cfg = player_config(pid)
    _, init_fn, step_fn = make_multiplayer_engine(cfg, me=pid, radius=1.2, device=dev)
    st = init_fn(seed=0)
    frames = []
    for i, inp in enumerate(player_inputs(pid, n_frames)):
        st, frame = step_fn(st, inp)
        if pid == 0 and i % GIF_EVERY == GIF_EVERY - 1:
            frames.append(frame.cpu().numpy())
    if pid == 0:
        from ..utils.imageio import write_gif

        write_gif(out, np.stack(frames), fps=8)
        print(f"wrote {out} ({len(frames)} frames)", flush=True)
    center = st.cam_center.cpu().tolist()
    print(f"player {pid} done at z={center[2]:.2f} "
          f"{json.dumps([float(c).hex() for c in center])}", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="multiplayer.gif")
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--players", type=int, default=2)
    p.add_argument("--port", type=int, default=None,
                   help="rendezvous port on localhost (default: a free one)")
    p.add_argument("--device", default=None,
                   help="device every player renders on (default: the CUDA card; fails "
                        "without one. 'cpu' runs the plain PyTorch versions)")
    p.add_argument("--player", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    port = args.port or _free_port()
    if args.player is not None:
        run_player(args.player, port, args.out, args.frames, args.players, args.device)
        return 0
    # The players resolve the device themselves; fail here first, once.
    from ..device import resolve_device

    resolve_device(args.device)
    common = ["--port", str(port), "--out", os.path.abspath(args.out),
              "--frames", str(args.frames), "--players", str(args.players)]
    if args.device is not None:
        common += ["--device", args.device]
    # The players import this package from where this process found it.
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--player", str(i),
                               *common], env=env)
             for i in range(args.players)]
    rc = 0
    for proc in procs:
        rc |= proc.wait()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
