"""Command-line entry points (counterpart of the JAX package's
``__main__.py``).

The reference ships one binary whose only mode is the interactive window
(`main.rs:590-939`). The port exposes the same capability on the card:

  python -m mirror_maze_tpu_torch render  --out frame.png   offline full frame
  python -m mirror_maze_tpu_torch demo    --out demo_dir/   scripted walkthrough
  python -m mirror_maze_tpu_torch minimap --out map.png     top-down map (host)
  python -m mirror_maze_tpu_torch play                      interactive terminal
                                                            (WASD + j/l yaw, q quits)
  python -m mirror_maze_tpu_torch serve   --port 8000       interactive session
                                                            streamed to a browser
  python -m mirror_maze_tpu_torch animate --out anim.gif    camera-path GIF
                                                            (spin/orbit/waypoints)
  python -m mirror_maze_tpu_torch multicam --out mc.png     batched cameras

All take --config {reference,v0,bvh,fuzzy,interactive,scale} and the
reference CLI's overrides, plus --device (default: the CUDA card; the command
fails where there is none unless --device cpu is given). The summary lines
name the CUDA kernel launches a command made.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time


def _device(args):
    """The command's device: ``--device``, or the CUDA card. A missing card
    ends the command with the device message (no fallback to the CPU)."""
    from .device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e} (on the command line: --device cpu)") from None


def _launches(before: collections.Counter) -> dict:
    """The kernel launches made since ``before`` (a copy of
    ``kernels.launches``), by kernel."""
    from . import kernels

    return {k: v - before.get(k, 0) for k, v in kernels.launches.items()
            if v - before.get(k, 0)}


def _launch_counter() -> collections.Counter:
    from . import kernels

    return collections.Counter(kernels.launches)


def _build(args):
    """World + device upload for single-engine commands."""
    from .render import upload_scene

    dev = _device(args)
    cfg, scene, noise = _build_world(args)
    return cfg, scene, upload_scene(scene, device=dev, noise=noise)


def _build_world(args):
    """Config + host scene (+ noise texture) WITHOUT the device upload:
    callers that hand the scene to an engine builder (multiplayer) use this
    directly, so the upload happens exactly once, with the right noise."""
    import dataclasses

    from .config import NAMED_CONFIGS
    from .scene import build_scene

    cfg = NAMED_CONFIGS[args.config]()
    # Overrides REPLACE individual fields, preserving everything else the
    # named config set (sort_chunk_window, fps, blur flags, ...).
    overrides = {}
    screen_overrides = {}
    if args.width:
        screen_overrides["width"] = args.width
    if args.height:
        screen_overrides["height"] = args.height
    if args.spp:
        screen_overrides["samples_per_pixel"] = args.spp
    if getattr(args, "adaptive_refresh", False):
        screen_overrides["adaptive_refresh"] = True
    if screen_overrides:
        overrides["screen"] = dataclasses.replace(cfg.screen, **screen_overrides)
    if args.intersector:
        overrides["intersector"] = args.intersector
        if args.intersector == "bvh":
            print(
                "note: the stack-traversal backend is a reference-parity path "
                "(the bvh_walk kernel on the card, one thread a ray; PERF.md); "
                "--intersector exact is the dense exact test, --intersector "
                "pallas the fused CUDA kernel.",
                file=sys.stderr,
            )
    maze_overrides = {}
    if args.seed is not None:
        maze_overrides["seed"] = args.seed
    if getattr(args, "rng", None):
        maze_overrides["rng"] = args.rng
    if getattr(args, "glass_prob", None) is not None:
        maze_overrides["glass_prob"] = float(args.glass_prob)
    if getattr(args, "glass_ior", None) is not None:
        maze_overrides["glass_ior"] = float(args.glass_ior)
    if maze_overrides:
        overrides["maze"] = dataclasses.replace(cfg.maze, **maze_overrides)
    camera_overrides = {}
    for flag, field in (("spawn", "spawn"), ("look", "look_dir")):
        val = getattr(args, flag, None)
        if val:
            parts = [float(x) for x in val.split(",")]
            if len(parts) != 3:
                raise SystemExit(f"--{flag} wants X,Y,Z (got {val!r})")
            camera_overrides[field] = tuple(parts)
    for flag, field in (("aperture", "aperture"), ("focus_dist", "focus_dist")):
        val = getattr(args, flag, None)
        if val is not None:
            camera_overrides[field] = float(val)
    if camera_overrides:
        overrides["camera"] = dataclasses.replace(cfg.camera, **camera_overrides)
    if overrides:
        cfg = cfg.replace(**overrides)
    if getattr(args, "scene", None):
        from .scene import load_scene

        scene = load_scene(args.scene)
        print(f"loaded scene {args.scene} ({scene.num_planes} planes)")
    else:
        scene = build_scene(cfg.maze)
    noise = None
    if getattr(args, "noise_png", None):
        from .utils.noise import load_noise_png

        noise = load_noise_png(args.noise_png)
    return cfg, scene, noise


def cmd_render(args) -> int:
    from .ops import prng
    from .render import make_camera, render_full_frame, to_display
    from .utils.imageio import write_png

    cfg, scene, dev = _build(args)
    d = dev.planes.device
    sc = cfg.screen
    cam = make_camera(cfg.camera, sc.width / sc.height, d)
    before = _launch_counter()
    t0 = time.perf_counter()
    img = render_full_frame(dev, cam, prng.PRNGKey(args.seed or 0, device=d), cfg)
    frame = to_display(img).cpu().numpy()
    dt = time.perf_counter() - t0
    rays = sc.width * sc.height * sc.samples_per_pixel
    print(f"rendered {frame.shape[1]}x{frame.shape[0]} ({scene.num_planes} planes) in "
          f"{dt:.3f}s ({rays / dt / 1e6:.4g} Mrays/s on {d}); kernel launches "
          f"{_launches(before)}")
    write_png(args.out, frame)
    print(f"wrote {args.out}")
    return 0


def demo_script(fi) -> list:
    """The demo's fixed 640-frame script of (phase, inputs): settle, walk,
    turn, settle, walk, settle; ``fi`` is the FrameInputs class."""
    return ([("settle", fi.idle())] * 128
            + [("walk", fi.make(w=True))] * 120
            + [("turn", fi.make(mouse_dx=-20.0))] * 16
            + [("settle2", fi.idle())] * 128
            + [("walk2", fi.make(w=True))] * 120
            + [("settle3", fi.idle())] * 128)


def cmd_demo(args) -> int:
    import os

    import numpy as np

    from .runtime.state import FrameInputs, init_state
    from .runtime.step import make_step
    from .utils.imageio import write_png

    cfg, scene, dev = _build(args)
    os.makedirs(args.out, exist_ok=True)
    step = make_step(dev, cfg)
    st = init_state(cfg, seed=args.seed or 0, device=dev.planes.device)
    script = demo_script(FrameInputs)
    before = _launch_counter()
    t0 = time.time()
    frame = None
    last_phase = None
    gif_frames = []
    gif_stride = max(1, args.gif_every) if args.gif else 0
    if gif_stride:
        # Each sampled frame is a host copy; cap the total so a small
        # --gif-every at 1080p cannot buffer gigabytes.
        max_gif_frames = 192
        min_stride = -(-len(script) // max_gif_frames)  # ceil div
        if gif_stride < min_stride:
            print(f"--gif-every {gif_stride} would sample {len(script) // gif_stride} frames; "
                  f"raising stride to {min_stride} (cap {max_gif_frames} frames)")
            gif_stride = min_stride
    for i, (phase, inp) in enumerate(script):
        # Snapshot the LAST frame of the finishing phase before stepping
        # into the new one.
        if phase != last_phase and last_phase is not None:
            write_png(f"{args.out}/{i:04d}_{last_phase}.png", frame.cpu().numpy())
        st, frame = step(st, inp)
        if gif_stride and i % gif_stride == 0:
            gif_frames.append(frame.cpu().numpy())
        last_phase = phase
    write_png(f"{args.out}/{len(script):04d}_final.png", frame.cpu().numpy())
    if gif_frames:
        from .utils.imageio import write_gif

        write_gif(args.gif, np.stack(gif_frames), fps=args.gif_fps)
        print(f"{len(gif_frames)} frames (every {gif_stride}) -> {args.gif}")
    dt = time.time() - t0
    print(f"{len(script)} frames in {dt:.1f}s ({len(script) / dt:.0f} fps) -> {args.out}/; "
          f"kernel launches {_launches(before)}")
    return 0


def cmd_minimap(args) -> int:
    """Top-down map of the world's actual geometry (utils/minimap.py):
    walls grey, mirrors cyan, glass pale blue, light panels warm, spheres as
    discs, the spawn camera marked. Host NumPy only: nothing runs on the
    device."""
    from .render import make_camera
    from .utils.imageio import write_png
    from .utils.minimap import render_minimap

    cfg, scene, _noise = _build_world(args)
    cam = make_camera(cfg.camera, cfg.screen.width / cfg.screen.height, "cpu")
    img = render_minimap(
        scene, size=args.map_size,
        camera_center=cam.center.numpy(),
        camera_quat=cam.rotation.numpy(),
    )
    write_png(args.out, img)
    print(f"wrote {args.out} ({scene.num_planes} planes, {img.shape[1]}x{img.shape[0]})")
    return 0


def _frame_of(state) -> int:
    from .runtime.loop import host_field

    return int(host_field(state, "frame").reshape(-1)[0])


def _build_multiplayer(args):
    """Join the process group and build this player's engine wrapped for
    the terminal and server drivers. Shared by `play --players N` and
    `serve --players N`."""
    from .parallel import initialize_multihost
    from .parallel.multiplayer import make_multiplayer_engine
    from .runtime.loop import InteractiveLoop

    dev_ = _device(args)
    n = initialize_multihost(
        coordinator_address=args.coordinator,
        num_processes=args.players,
        process_id=args.player_id,
    )
    if n != args.players:
        raise SystemExit(f"the process group came up with {n} processes, wanted {args.players}")
    cfg, scene, noise = _build_world(args)
    dev, init_fn, step_fn = make_multiplayer_engine(
        cfg, me=args.player_id, scene=scene, glow=args.avatar_glow, noise=noise,
        device=dev_,
    )
    loop = InteractiveLoop.from_engine(cfg, step_fn, init_fn(args.seed or 0))
    return cfg, scene, dev, loop


def _warn_multiplayer_flags(args) -> None:
    """Flags the multiplayer driver cannot honour SAY so: multiplayer is
    locked to per-frame stepping (the position exchange runs every frame)
    on the single engine."""
    if args.batch_frames > 1:
        print("warning: --batch-frames is ignored with --players > 1 "
              "(the per-frame position exchange cannot batch)", file=sys.stderr)
    if args.sharded_bands:
        print("warning: --sharded-bands is ignored with --players > 1 "
              "(each player is one single engine)", file=sys.stderr)


def _play_multiplayer(args) -> int:
    """N-player session: this process is ONE player (`--player-id`) in a
    process group of `--players` processes; remote players render as
    coloured sphere avatars (parallel/multiplayer.py). Launch one process
    per player with the same --players/--coordinator and a distinct
    --player-id. --load-state/--save-state checkpoint THIS player's engine
    state (each player keeps its own file)."""
    _warn_multiplayer_flags(args)
    cfg, scene, dev, loop = _build_multiplayer(args)
    if args.load_state:
        from .runtime.state import load_state

        loop.state = load_state(args.load_state, cfg, device=dev.planes.device)
        print(f"resumed from {args.load_state} (frame {_frame_of(loop.state)})")
    print(f"player {args.player_id}/{args.players} up ({dev.num_spheres} spheres incl. "
          f"avatars); WASD move, j/l turn, q quits. If any player exits, the session is "
          f"over for everyone (the per-frame exchange is a collective).")
    _run_session(loop, args, None if args.display == "none" else args.display)
    if args.save_state:
        from .runtime.state import save_state

        save_state(args.save_state, loop.state)
        print(f"state saved to {args.save_state} (resume with --load-state)")
    return 0


def _run_session(loop, args, display) -> None:
    """Run the loop, print the session line (frames stepped over the wall
    time until the device has finished them, input pacing included) and
    write the final view to ``--out``."""
    before = _launch_counter()
    frame0 = _frame_of(loop.state)
    t0 = time.perf_counter()
    loop.run(max_frames=args.frames, display=display)
    frames = _frame_of(loop.state) - frame0      # a host fetch: waits for the device
    dt = time.perf_counter() - t0
    if dt > 0 and frames:
        print(f"session: {frames} frames, wall {dt:.3f}s (~{frames / dt:.1f} fps incl. "
              f"input pacing); kernel launches {_launches(before)}")
    if args.out and loop.frame is not None:
        from .utils.imageio import write_png

        write_png(args.out, loop.frame.cpu().numpy())


def cmd_play(args) -> int:
    from .runtime.loop import InteractiveLoop

    if args.players > 1:
        return _play_multiplayer(args)
    cfg, scene, dev = _build(args)
    d = dev.planes.device
    before = _launch_counter()
    # Engine construction, and its warm-up frame, BEFORE the banner: the
    # start-up heartbeat stops at the first print, and the banner should mean
    # "ready to play".
    loop = InteractiveLoop(
        dev, cfg, seed=args.seed or 0, batch_frames=args.batch_frames,
        adaptive=not args.no_adaptive_batch, sharded_bands=args.sharded_bands,
    )
    print(f"WASD move, j/l turn, q quits. Frames render on {d}; final view saved on exit "
          f"(warm-up frame: kernel launches {_launches(before)}).")
    if args.load_state:
        # Checkpoints resume across engine layouts: band checkpoints restore
        # bit for bit at the same band count and convert otherwise
        # (parallel/shard.py load_sharded_state / sharded_to_single).
        if args.sharded_bands:
            from .parallel.shard import load_sharded_state

            loop.state = load_sharded_state(args.load_state, cfg, [d] * args.sharded_bands)
        else:
            from .runtime.state import load_state

            loop.state = load_state(args.load_state, cfg, device=d)
        print(f"resumed from {args.load_state} (frame {_frame_of(loop.state)})")
    _run_session(loop, args, None if args.display == "none" else args.display)
    if args.save_state:
        from .runtime.state import save_state

        save_state(args.save_state, loop.state)
        print(f"state saved to {args.save_state} (resume with --load-state)")
    return 0


def cmd_serve(args) -> int:
    """HTTP serving (runtime/server.py): stream the interactive engine to a
    browser and take WASD/pointer input back. With --players N this process
    is ONE multiplayer player (one serve process per player, distinct
    --player-id and --port)."""
    from .runtime.server import EngineServer

    engine = None
    if args.players > 1:
        _warn_multiplayer_flags(args)
        cfg, scene, dev, engine = _build_multiplayer(args)
    else:
        cfg, scene, dev = _build(args)
    d = dev.planes.device
    server = EngineServer(
        dev, cfg, seed=args.seed or 0,
        host=args.host, port=args.port,
        batch_frames=args.batch_frames,
        adaptive=not args.no_adaptive_batch,
        sharded_bands=args.sharded_bands,
        stream_every=args.stream_every,
        stream_scale=args.stream_scale,
        jpeg_quality=args.jpeg_quality,
        host_scene=scene,
        map_size=args.map_size,
        engine=engine,
        ckpt_path=args.save_state,
    )
    if args.load_state:
        # Resume the session (play --load-state's semantics): the engine has
        # not started stepping, so replacing its state here is race-free.
        if args.sharded_bands and args.players <= 1:
            from .parallel.shard import load_sharded_state

            server.engine.state = load_sharded_state(args.load_state, cfg,
                                                     [d] * args.sharded_bands)
        else:
            from .runtime.state import load_state

            server.engine.state = load_state(args.load_state, cfg, device=d)
        print(f"resumed from {args.load_state} (frame {_frame_of(server.engine.state)})")
    who = f" [player {args.player_id}/{args.players}]" if args.players > 1 else ""
    print(f"serving {cfg.screen.width}x{cfg.screen.height} ({scene.num_planes} planes){who} "
          f"on http://{args.host}:{server.port}/ from {d}  [ctrl-c stops]")
    server.serve_forever()
    return 0


def _factor_mesh(batch: int, height: int, device):
    """(devices, n_cam, n_tile, cards) shared by multicam and animate
    --sharded: the cards torch.cuda.device_count() reports (one device for
    --device cpu or a card named by index), as many as divide the batch on
    cameras, the rest on pixel-row tiles wherever the height allows."""
    import math

    import torch

    if device.type == "cuda" and device.index is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [device]
    n = len(devs)
    n_cam = math.gcd(batch, n)
    n_tile = 1
    for t in range(n // n_cam, 0, -1):
        # The batched renderer's only tiling precondition is height %
        # n_tile == 0 (raw pixel-row bands; the chunk grid is not involved).
        if height % t == 0:
            n_tile = t
            break
    return devs[:n_cam * n_tile], n_cam, n_tile, n


def cmd_animate(args) -> int:
    """Offline camera-path animation -> looping GIF (render/campath.py).

    Paths: spin (yaw in place at the spawn), orbit (circle a centre, aiming
    at it), waypoints (piecewise-linear flythrough)."""
    from .ops import prng
    from .render import make_camera
    from .render.campath import orbit_cameras, render_path, spin_cameras, waypoint_cameras
    from .utils.imageio import write_gif

    def vec3(s, flag):
        parts = [float(x) for x in s.split(",")]
        if len(parts) != 3:
            raise SystemExit(f"--{flag} wants X,Y,Z (got {s!r})")
        return tuple(parts)

    cfg, scene, dev = _build(args)
    d = dev.planes.device
    base = make_camera(cfg.camera, cfg.screen.width / cfg.screen.height, d)
    n = args.anim_frames
    if args.anim == "orbit":
        center = vec3(args.orbit_center, "orbit-center")
        cams = orbit_cameras(base, center, args.orbit_radius, args.orbit_height, n,
                             turns=args.turns)
    elif args.anim == "waypoints":
        if not args.waypoints:
            raise SystemExit("--anim waypoints needs --waypoints \"x,y,z;x,y,z;...\"")
        pts = [vec3(p, "waypoints") for p in args.waypoints.split(";")]
        target = vec3(args.target, "target") if args.target else None
        cams = waypoint_cameras(base, pts, n, target=target)
    else:
        cams = spin_cameras(base, cfg.camera.look_dir, n, turns=args.turns)
    key = prng.PRNGKey(args.seed or 0, device=d)
    before = _launch_counter()
    t0 = time.time()
    mesh_note = ""
    if args.sharded:
        # Frames ARE the camera batch: shard the path over the (cam, tile)
        # device layout through the multicam renderer.
        from .parallel import gather_frames, make_sharded_renderer

        devs, n_cam, n_tile, cards = _factor_mesh(n, cfg.screen.height, d)
        render = make_sharded_renderer(cfg, devs, n_cam, n_tile)
        fr, _ = render(dev, cams, key)
        frames = gather_frames(fr)
        mesh_note = f" on (cam={n_cam}, tile={n_tile})/{cards} device(s)"
    else:
        frames = render_path(dev, cams, key, cfg).cpu().numpy()
    dt = time.time() - t0
    write_gif(args.out, frames, fps=args.gif_fps)
    print(f"{n} frames {cfg.screen.width}x{cfg.screen.height} ({args.anim}){mesh_note} in "
          f"{dt:.1f}s -> {args.out} ({args.gif_fps} fps GIF); kernel launches "
          f"{_launches(before)}")
    return 0


def cmd_multicam(args) -> int:
    """Batched multi-camera render over a (cam, tile) device layout
    (parallel/shard.py make_sharded_renderer): on one card the layout is
    (1, 1) and the cameras render one after another; with more cards,
    cameras and image row bands spread over them."""
    import math

    import numpy as np

    from .ops import prng
    from .ops import quat as quat_ops
    from .parallel import batch_cameras, gather_frames, make_sharded_renderer
    from .render import make_camera
    from .utils.imageio import write_png

    cfg, scene, dev = _build(args)
    d = dev.planes.device
    b = args.cameras
    devs, n_cam, n_tile, cards = _factor_mesh(b, cfg.screen.height, d)

    base = make_camera(cfg.camera, cfg.screen.width / cfg.screen.height, d)
    cams = []
    for i in range(b):
        # Fan the batch around the spawn: one yaw step per camera.
        half = quat_ops.half_theta_of(base.rotation) + i * (math.pi / b)
        cams.append(base._replace(rotation=quat_ops.update_angle(base.rotation, half)))
    render = make_sharded_renderer(cfg, devs, n_cam, n_tile)
    before = _launch_counter()
    frames, mean_lum = render(dev, batch_cameras(cams), prng.PRNGKey(args.seed or 0, device=d))
    frames = gather_frames(frames)
    cols = int(math.ceil(math.sqrt(b)))
    rows = int(math.ceil(b / cols))
    h, w = frames.shape[1], frames.shape[2]
    grid = np.zeros((rows * h, cols * w, 3), np.float32)
    for i in range(b):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = frames[i]
    write_png(args.out, grid)
    print(f"{b} cameras on (cam={n_cam}, tile={n_tile}) over {cards} device(s); mean "
          f"luminance {float(mean_lum):.4f} -> {args.out}; kernel launches "
          f"{_launches(before)}")
    return 0


COMMANDS = (("render", cmd_render), ("demo", cmd_demo), ("play", cmd_play),
            ("multicam", cmd_multicam), ("animate", cmd_animate),
            ("minimap", cmd_minimap), ("serve", cmd_serve))


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the reference CLI's subcommands and flags, with the
    same names, defaults and choices, plus --device."""
    p = argparse.ArgumentParser(prog="mirror_maze_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in COMMANDS:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--device", default=None,
                        help="device to run on (default: the CUDA card; the command fails "
                             "without one. 'cpu' runs the plain PyTorch versions of the "
                             "kernels on the CPU)")
        sp.add_argument("--config", default="reference")
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--spp", type=int, default=0)
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--rng", default=None, choices=("numpy", "reference"),
                        help="world RNG stream: 'reference' rebuilds the reference app's "
                             "LITERAL world at this seed (rand-0.8 StdRng/ChaCha12 parity)")
        sp.add_argument("--intersector", default=None,
                        choices=("brute", "bvh", "exact", "pallas"),
                        help="nearest-hit backend: 'pallas' is the fused CUDA tracer "
                             "kernel, the others the jnp tracer's backends")
        sp.add_argument("--adaptive-refresh", action="store_true", dest="adaptive_refresh",
                        help="reorder each refresh epoch by per-chunk detail (variance) "
                             "instead of replaying the random shuffle; coverage unchanged")
        sp.add_argument("--frames", type=int, default=None)
        sp.add_argument("--display", default="ansi", choices=("ansi", "kitty", "none"),
                        help="play: terminal display mode (ansi half-blocks, kitty "
                             "graphics protocol, or none)")
        sp.add_argument("--cameras", type=int, default=4,
                        help="multicam: batch size (cameras fanned around the spawn yaw)")
        sp.add_argument("--save-state", default=None,
                        help="write the full engine state (.npz) on exit; bit-exact resume "
                             "via --load-state. serve: also enables POST /ckpt (live "
                             "checkpoint to this path) and saves on shutdown. multiplayer: "
                             "per-player file")
        sp.add_argument("--load-state", default=None,
                        help="resume play/serve from a saved state checkpoint (either "
                             "package's; multiplayer: each player loads its own)")
        sp.add_argument("--scene", default=None,
                        help="render a saved scene (.npz from scene.save_scene) instead of "
                             "generating the maze; custom worlds usually also want "
                             "--spawn/--look")
        sp.add_argument("--spawn", default=None, metavar="X,Y,Z",
                        help="camera spawn position override")
        sp.add_argument("--look", default=None, metavar="X,Y,Z",
                        help="camera look direction override")
        sp.add_argument("--glass-prob", type=float, default=None, dest="glass_prob",
                        help="probability a mirror wall becomes a GLASS pane (maze worlds; "
                             "0 = reference parity)")
        sp.add_argument("--glass-ior", type=float, default=None, dest="glass_ior",
                        help="index of refraction for --glass-prob walls")
        sp.add_argument("--aperture", type=float, default=None,
                        help="thin-lens radius for depth of field (0 = pinhole, the "
                             "reference camera)")
        sp.add_argument("--focus-dist", type=float, default=None, dest="focus_dist",
                        help="focal distance for --aperture > 0")
        sp.add_argument("--noise-png", default=None,
                        help="PNG to use as the RNG noise texture (e.g. the reference's "
                             "textures/noiseTexture-2.png); takes effect with noise_rng "
                             "configs (fuzzy). Default: procedural white noise")
        sp.add_argument("--batch-frames", type=int, default=1,
                        help="engine frames per step call in play mode (input is sampled "
                             "once per batch)")
        sp.add_argument("--no-adaptive-batch", action="store_true",
                        help="play: disable the adaptive input path (per-frame stepping "
                             "while keys/mouse are active, re-batching when idle)")
        sp.add_argument("--sharded-bands", type=int, default=None,
                        help="play: run the row-band engine with n bands (the screen split "
                             "into n bands whose present reads the neighbours' rows), every "
                             "band on the command's device")
        sp.add_argument("--players", type=int, default=1,
                        help="play/serve: total players in a multiplayer session (one OS "
                             "process per player; run each with the same "
                             "--players/--coordinator and a distinct --player-id, for serve "
                             "also a distinct --port; remote players appear as coloured "
                             "sphere avatars). The per-frame exchange is a collective: a "
                             "player exiting (q/crash) ends the session for every remaining "
                             "player")
        sp.add_argument("--player-id", type=int, default=0, dest="player_id",
                        help="play: this process's player index (0..players-1)")
        sp.add_argument("--coordinator", default="localhost:12321",
                        help="play/serve: torch.distributed rendezvous host:port (player "
                             "0's machine)")
        sp.add_argument("--avatar-glow", type=float, default=0.25, dest="avatar_glow",
                        help="play/serve multiplayer: avatar self-emission strength in the "
                             "player's colour (0 = passive spheres)")
        sp.add_argument("--anim", default="spin", choices=("spin", "orbit", "waypoints"),
                        help="animate: camera path type")
        sp.add_argument("--anim-frames", type=int, default=48, dest="anim_frames",
                        help="animate: frames on the path")
        sp.add_argument("--turns", type=float, default=1.0,
                        help="animate: revolutions for spin/orbit")
        sp.add_argument("--orbit-center", default="0,0,0", dest="orbit_center",
                        metavar="X,Y,Z", help="animate: orbit look-at center")
        sp.add_argument("--orbit-radius", type=float, default=10.0, dest="orbit_radius")
        sp.add_argument("--orbit-height", type=float, default=0.0, dest="orbit_height",
                        help="animate: camera height above orbit center")
        sp.add_argument("--waypoints", default=None, metavar="X,Y,Z;X,Y,Z;...",
                        help="animate: flythrough waypoints")
        sp.add_argument("--target", default=None, metavar="X,Y,Z",
                        help="animate: fixed look-at for waypoints (default: look along "
                             "travel)")
        sp.add_argument("--gif-fps", type=int, default=12, dest="gif_fps",
                        help="animate: GIF playback rate")
        sp.add_argument("--gif", default=None,
                        help="demo: also assemble sampled frames into a looping GIF at this "
                             "path (a host copy per sampled frame)")
        sp.add_argument("--map-size", type=int, default=512, dest="map_size",
                        help="minimap: output image side in pixels (serve: side of the live "
                             "/map overlay)")
        sp.add_argument("--host", default="127.0.0.1",
                        help="serve: bind address (0.0.0.0 exposes the session on the "
                             "network)")
        sp.add_argument("--port", type=int, default=8000,
                        help="serve: TCP port (0 = ephemeral)")
        sp.add_argument("--stream-every", type=int, default=2, dest="stream_every",
                        help="serve: encode every Nth engine frame into the HTTP stream (a "
                             "device-to-host copy per encode)")
        sp.add_argument("--stream-scale", type=int, default=1, dest="stream_scale",
                        help="serve: stride-sample frames ON THE DEVICE by this factor "
                             "before the copy to the host")
        sp.add_argument("--jpeg-quality", type=int, default=85, dest="jpeg_quality",
                        help="serve: JPEG quality when PIL is available (else builtin PNG)")
        sp.add_argument("--gif-every", type=int, default=8, dest="gif_every",
                        help="demo: sample every Nth frame into --gif")
        sp.add_argument("--sharded", action="store_true",
                        help="animate: spread the frame batch over the (cam, tile) device "
                             "layout (the multicam renderer; frames = camera batch)")
        sp.add_argument("--out", default={
            "render": "frame.png", "demo": "demo_out",
            "multicam": "multicam.png", "animate": "anim.gif",
            "minimap": "minimap.png"}.get(name))
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Long-wait heartbeat: the first frame of a fresh checkout builds the
    # CUDA kernels with nvcc (each library once; later runs load them from
    # mirror_maze_tpu_torch/_build/), which looks like a hang. Say so, a few
    # times, instead of letting the user kill a healthy build. It stops at the
    # command's FIRST OWN OUTPUT: once the command is talking, further notes
    # would be noise (e.g. printed into an interactive session's display).
    import threading

    done = threading.Event()

    class _FirstWriteTee:
        def __init__(self, raw):
            self._raw = raw

        def write(self, s):
            if s.strip():
                done.set()
            return self._raw.write(s)

        def __getattr__(self, name):
            return getattr(self._raw, name)

    def _heartbeat():
        waited = 0
        while not done.wait(120) and waited < 3:
            waited += 1
            print(
                f"note: {2 * waited} min in — the first run of a checkout builds the CUDA "
                "kernels with nvcc before its first frame (later runs load them from "
                "mirror_maze_tpu_torch/_build/). Avoid killing mid-build.",
                file=sys.stderr,
            )

    threading.Thread(target=_heartbeat, daemon=True).start()
    saved_stdout = sys.stdout
    sys.stdout = _FirstWriteTee(saved_stdout)
    try:
        return args.fn(args)
    finally:
        done.set()
        sys.stdout = saved_stdout


if __name__ == "__main__":
    sys.exit(main())
