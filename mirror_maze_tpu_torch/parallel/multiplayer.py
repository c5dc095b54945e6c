"""Multiplayer: one process per player, positions exchanged every frame
(counterpart of the JAX package's ``parallel/multiplayer.py``).

Each player is a process stepping its OWN engine in the shared deterministic
world (the same seed builds the same geometry in every process, so no scene
travels); the only traffic is an ``all_gather`` of every player's [3] camera
position per frame over a ``torch.distributed`` process group
(``parallel.initialize_multihost``). Remote players render as coloured
sphere avatars whose centres are tensors of the scene each step is given,
so moving them changes no step.

- The group's backend is gloo: the 12 bytes of a position go through the
  host, and any number of players may share one card (NCCL refuses two ranks
  on one GPU). Every player process renders on its own device (``cuda:0`` on
  a one-card machine).
- The jnp backends (``brute``, ``exact``, ``bvh``) read the avatars' centres
  and |c|^2 - r^2 from the scene-order view, which ``update_avatars``
  writes; for the fused kernel (``intersector="pallas"``) the step puts
  ``scenebuf.make_sphere_refresh`` in front, which derives the kernel's
  sphere records and tile boxes again from the moved centres on the device.
- A frame is the exchange on the host, then ONE replay of a captured CUDA
  graph on the card (runtime/graph.py ``StepRunner``): the gathered
  positions ride in the frame's input row after the keys and the mouse
  delta, and the graph's body (``multiplayer_body``) moves the avatars,
  refreshes the sphere records and steps the frame, as the JAX package's
  jitted ``shard_map`` does. The one host read a frame is the exchange's
  12 bytes of this player's position.
- Avatars do not collide (players pass through each other): collision uses
  the boxes captured at upload, which hold the avatars' park positions far
  outside the world.
- The exchange is a collective: every player runs the same sequence of
  them, and a player that leaves ends the session for the others, whose
  step raises ("a peer left the session") instead of hanging (the process
  group's timeout bounds the wait).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EngineConfig
from ..ops.prng import fma
from ..render.scenebuf import DeviceScene

# Park position of avatar spheres before the first exchange: far outside any
# closed world, so an avatar not yet placed never shadows real geometry (and
# its collision box never triggers).
PARK = 1.0e6

# Named per-player avatar albedos; players beyond these get distinct
# golden-angle hues (player_color).
PLAYER_COLORS = (
    (0.9, 0.25, 0.2),
    (0.2, 0.55, 0.9),
    (0.3, 0.85, 0.35),
    (0.95, 0.8, 0.25),
)


def player_color(i: int, colors=PLAYER_COLORS) -> tuple:
    """Player i's avatar albedo: the named palette first, then golden-angle
    hues, so every player count gets DISTINCT colours."""
    if i < len(colors):
        return tuple(colors[i])
    import colorsys

    h = (i * 0.6180339887498949) % 1.0
    return colorsys.hsv_to_rgb(h, 0.65, 0.9)


def avatar_scene(scene, n_players: int, me: int, radius: float = 1.0,
                 colors=PLAYER_COLORS, glow: float = 0.0):
    """Append n_players - 1 avatar spheres (every player but ``me``) to a
    host Scene, parked at PARK. Avatar i keeps player i's colour in every
    process, so "the red player" is red in everyone's view. ``glow`` > 0
    makes avatars emissive in their own colour (emission strength = glow),
    so players stay visible in dark corridors; 0 keeps them diffuse.
    Returns (scene, the avatars' sphere indices)."""
    others = [i for i in range(n_players) if i != me]
    a = len(others)
    if a == 0:
        return scene, []
    centers = np.full((a, 3), PARK, np.float32)
    col = np.array([player_color(i, colors) for i in others], np.float32)
    emission = np.concatenate([col, np.full((a, 1), float(glow), np.float32)], axis=1)
    s = scene.num_spheres

    def cat(old, new):
        return np.concatenate([np.asarray(old), new], axis=0)

    return dataclasses.replace(
        scene,
        sph_center=cat(scene.sph_center, centers),
        sph_radius=cat(scene.sph_radius, np.full(a, radius, np.float32)),
        sph_color=cat(scene.sph_color, col),
        sph_is_mirror=cat(scene.sph_is_mirror, np.zeros(a, bool)),
        sph_emission=cat(scene.sph_emission, emission),
        sph_ior=cat(scene.sph_ior, np.zeros(a, np.float32)),
        sph_tex_kind=cat(scene.sph_tex_kind, np.zeros(a, np.uint8)),
        sph_tex_scale=cat(scene.sph_tex_scale, np.ones(a, np.float32)),
        sph_tex_color2=cat(scene.sph_tex_color2, np.zeros((a, 3), np.float32)),
    ), list(range(s, s + a))


def update_avatars(dev: DeviceScene, slots, centers: torch.Tensor) -> DeviceScene:
    """Move the avatar spheres at ``slots`` (a list of sphere indices, or the
    same as a long tensor on the scene's device, made once by a body that a
    CUDA graph captures) to ``centers`` [A, 3]: the
    scene's ``sph_center`` and the two centre-derived fields of the
    scene-order view the jnp backends read, ``sph_center`` and
    ``sph_c2r2`` = |c|^2 - r^2 in float32 as the reference's jitted step
    computes it on the CPU, where XLA contracts it into
    fma(-r, r, fma(z, z, fma(y, y, x * x))) (each FMA emulated in float64
    and rounded once, ops/prng.py ``fma``). Radius, 1/r and colour stay.
    Returns a new DeviceScene; the given one is unchanged."""
    d = dev.sph_center.device
    if isinstance(slots, torch.Tensor):
        idx = slots
    else:
        idx = torch.tensor(list(slots), dtype=torch.long, device=d)
    if idx.numel() == 0:
        return dev
    centers = centers.to(device=d, dtype=torch.float32)
    new_center = dev.sph_center.index_copy(0, idx, centers)
    r = dev.sph_radius[idx]
    x, y, z = centers.unbind(-1)
    c2r2 = fma(-r, r, fma(z, z, fma(y, y, x * x)))
    prims = dev.prims._replace(sph_center=new_center,
                               sph_c2r2=dev.prims.sph_c2r2.index_copy(0, idx, c2r2))
    return dev._replace(sph_center=new_center, prims=prims)


def make_position_exchange():
    """``exchange(my_center [3]) -> [P, 3]`` float32 on ``my_center``'s
    device: an ``all_gather`` of every player's position over the process
    group (``initialize_multihost``), row i player i's. The group's backend
    is gloo, so the 12 bytes go through the host; this waits for the step
    that made ``my_center``. The per-frame traffic of the whole feature."""
    import torch.distributed as dist

    n = dist.get_world_size()

    def exchange(my_center: torch.Tensor) -> torch.Tensor:
        mine = my_center.detach().reshape(3).to(device="cpu", dtype=torch.float32)
        out = [torch.empty(3, dtype=torch.float32) for _ in range(n)]
        dist.all_gather(out, mine)
        return torch.stack(out).to(my_center.device)

    return exchange


def multiplayer_body(cfg: EngineConfig, dev: DeviceScene, slots, others,
                     max_depth: int, max_leaf: int):
    """One player's frame after the exchange, ``body(state, row, rotate) ->
    state``: ``row`` is the frame's input row (runtime/step.py
    ``INPUT_WIDTH`` values) followed by every player's position, [P * 3]
    float32, on the state's device. It moves the avatars at ``slots`` to
    the positions of the players ``others`` (``update_avatars``; none with
    no ``others``: a player alone keeps them parked), for the fused kernel
    re-derives the sphere records (``make_sphere_refresh``), and
    steps the single engine's frame on that scene. It reads nothing on the
    host, so a StepRunner captures it; its index tensors are made here,
    once. ``max_depth`` / ``max_leaf`` are the bvh traversal bounds."""
    from ..render.pipeline import scene_nearest_fn
    from ..render.scenebuf import make_sphere_refresh
    from ..runtime.step import INPUT_WIDTH, advance

    device = dev.planes.device
    refresh = make_sphere_refresh(dev) if cfg.intersector == "pallas" and slots else None
    slot_idx = torch.tensor(list(slots), dtype=torch.long, device=device)
    others_idx = torch.tensor(list(others), dtype=torch.long, device=device)

    def body(state, row: torch.Tensor, rotate: bool):
        scene = dev
        if others:
            positions = row[INPUT_WIDTH:].reshape(-1, 3)
            scene = update_avatars(scene, slot_idx, positions[others_idx])
        if refresh is not None:
            scene = refresh(scene)
        return advance(scene, cfg, state, row, rotate,
                       scene_nearest_fn(scene, cfg, max_depth, max_leaf))

    return body


def make_multiplayer_engine(cfg: EngineConfig, me: int | None = None, scene=None,
                            radius: float = 1.0, glow: float = 0.25, noise=None,
                            device=None):
    """Build (dev_scene, init_fn, step_fn) for one player process.

    The players are the processes of the process group
    (``initialize_multihost``; with ``torch.distributed`` not initialized,
    one player alone) and ``me`` is this one (None = its rank). The scene (``scene`` or the maze
    of ``cfg``) gets an avatar per other player (``avatar_scene``, with
    ``glow``) and is uploaded once to ``device`` (None = the card) with
    ``noise``.

    ``step_fn(state, inputs) -> (state, frame)`` exchanges the positions
    (``make_position_exchange``, on the host) and runs ``multiplayer_body``
    with them in the frame's input row: on the card one replay of a captured
    graph (``step_fn.runner`` is the StepRunner), on the CPU the body
    eagerly. ``init_fn(seed=0)`` makes the state. The state and frame are
    the single engine's, so ``InteractiveLoop.from_engine`` and
    ``EngineServer(engine=...)`` drive it unchanged; a failed exchange
    raises "a peer left the session"."""
    import torch.distributed as dist

    from ..render.scenebuf import upload_scene
    from ..runtime.graph import StepRunner
    from ..runtime.state import init_state
    from ..runtime.step import derive_traversal_bounds, display, input_stack, upload_rows
    from ..scene import build_scene

    joined = dist.is_available() and dist.is_initialized()
    n_players = dist.get_world_size() if joined else 1
    if me is None:
        me = dist.get_rank() if joined else 0
    host_scene = scene if scene is not None else build_scene(cfg.maze)
    host_scene, slots = avatar_scene(host_scene, n_players, me, radius, glow=glow)
    dev = upload_scene(host_scene, device=device, noise=noise)
    others = [i for i in range(n_players) if i != me] if n_players > 1 else []
    runner = StepRunner(multiplayer_body(cfg, dev, slots, others,
                                         *derive_traversal_bounds(dev, cfg, None, None)),
                        graphs=True)
    exchange = make_position_exchange() if n_players > 1 else None

    def init_fn(seed: int = 0):
        return init_state(cfg, seed, device=dev.planes.device)

    def step_fn(state, inputs):
        row = input_stack([inputs])
        if exchange is not None:
            try:
                positions = exchange(state.cam_center.cpu())
            except Exception as e:  # noqa: BLE001 — annotate the death
                raise RuntimeError(
                    "multiplayer step failed — most likely a peer left the session "
                    "(the per-frame exchange is a collective); the session is over "
                    "for everyone") from e
            row = np.concatenate([row, positions.numpy().reshape(1, -1)], axis=1)
        state = runner(state, upload_rows(row, state.screen.device), [bool(inputs.rot_updated)])
        return state, display(state, cfg)

    step_fn.runner = runner
    return dev, init_fn, step_fn
