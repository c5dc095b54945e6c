"""The port's multiplayer (parallel/multiplayer.py, parallel/__init__.py
initialize_multihost) against the JAX package's, on the CPU:

- ``avatar_scene`` and ``update_avatars`` bitwise against the reference's
  (``update_avatars`` against its jitted form, which is what the reference's
  step computes);
- an avatar moved into view through the fused tracer's plain version (with
  ``make_sphere_refresh`` in front) against the Pallas interpreter, frames
  by the golden rule, parking it restoring the avatar-free frame bitwise;
- the single-player engine bitwise ``make_step``;
- the frame body the card captures into a graph (``multiplayer_body``, the
  positions in its input row), run eagerly through a StepRunner, bitwise the
  step as it ran before (update_avatars, the sphere refresh, make_step_fn),
  and free of host reads after its first frame;
- two player processes over gloo (subprocesses with their own time limit):
  the positions each gathers are the players' camera centres, and player
  0's frame with player 1's avatar equals a single-process step given the
  same gathered positions, bitwise; a player that leaves makes the other's
  step raise instead of hanging."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tools import NoHostReads, assert_frames_match, eager_multiplayer_step, port_config
from mirror_maze_tpu.config import (
    CameraConfig as JCamera,
    EngineConfig as JEngine,
    MazeConfig as JMaze,
    ScreenConfig as JScreen,
    TracerConfig as JTracer,
)
from mirror_maze_tpu.parallel import multiplayer as jmp
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.runtime.state import init_state as j_init_state
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.parallel import multiplayer as mp
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.render.scenebuf import make_sphere_refresh
from mirror_maze_tpu_torch.runtime.state import EngineState, FrameInputs, init_state, load_state
from mirror_maze_tpu_torch.render import pipeline
from mirror_maze_tpu_torch.runtime.graph import StepRunner
from mirror_maze_tpu_torch.runtime.step import (
    derive_traversal_bounds,
    display,
    input_stack,
    make_step,
    make_step_fn,
    upload_rows,
)
from mirror_maze_tpu_torch.scene import build_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jcfg(intersector="brute", size=32, fps=60.0):
    return JEngine(
        maze=JMaze(width=4, height=4),
        camera=JCamera(spawn=(-5.0, 0.0, -15.0)),
        tracer=JTracer(bounce_limit=2, mirror_limit=2),
        screen=JScreen(width=size, height=size, samples_per_pixel=2,
                       chunks_per_frame=(size // 4) ** 2, fps=fps),   # a full repaint a frame
        intersector=intersector,
    )


@pytest.mark.parametrize("n_players,me,radius,glow", [
    (2, 0, 1.0, 0.0), (3, 1, 1.5, 0.25), (6, 5, 0.5, 1.0), (1, 0, 1.0, 0.25)])
def test_avatar_scene_is_bitwise_the_reference(n_players, me, radius, glow):
    cfg = _jcfg()
    js, jslots = jmp.avatar_scene(j_build(cfg.maze), n_players, me, radius, glow=glow)
    ps, pslots = mp.avatar_scene(build_scene(port_config(cfg).maze), n_players, me, radius,
                                 glow=glow)
    assert pslots == jslots == list(range(0, n_players - 1))
    for f in dataclasses.fields(js):
        a, b = getattr(ps, f.name), getattr(js, f.name)
        if b is None:
            assert a is None, f.name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f.name
    assert [mp.player_color(i) for i in range(9)] == [jmp.player_color(i) for i in range(9)]
    assert mp.PARK == jmp.PARK and mp.PLAYER_COLORS == jmp.PLAYER_COLORS


def test_update_avatars_is_bitwise_the_reference():
    cfg = _jcfg()
    js, jslots = jmp.avatar_scene(j_build(cfg.maze), 3, 1, radius=1.3)
    ps, pslots = mp.avatar_scene(build_scene(port_config(cfg).maze), 3, 1, radius=1.3)
    jd, pd = j_upload(js), upload_scene(ps, device="cpu")
    update = jax.jit(lambda d, c: jmp.update_avatars(d, jslots, c))
    rng = np.random.default_rng(5)
    for scale in (0.1, 3.0, 50.0, 1e3, 1e6):
        c = (rng.standard_normal((200, 2, 3)) * scale).astype(np.float32)
        for ci in c:
            jo, po = update(jd, jnp.asarray(ci)), mp.update_avatars(pd, pslots, torch.from_numpy(ci))
            for got in (po.sph_center, po.prims.sph_center):
                assert np.array_equal(got.numpy(), np.asarray(jo.sph_center))
            assert np.array_equal(po.prims.sph_c2r2.numpy().view(np.int32),
                                  np.asarray(jo.sph_c2r2).view(np.int32)), ci
    assert mp.update_avatars(pd, [], torch.zeros(0, 3)) is pd
    # The given scene is unchanged.
    assert np.array_equal(pd.sph_center.numpy(), np.asarray(js.sph_center))


def test_avatar_visible_through_the_fused_tracer_matches_the_pallas_kernel():
    """The avatar's centre flows through update_avatars and the sphere
    refresh into the fused tracer (its plain version on the CPU), as it
    flows through the reference's in-jit repack into the interpreted Pallas
    kernel: the same frames, parked, in view, and parked again."""
    jcfg = _jcfg("pallas", size=24)
    cfg = port_config(jcfg)
    js, slots = jmp.avatar_scene(j_build(jcfg.maze), 2, 0, glow=0.25)
    jd = j_upload(js)
    from mirror_maze_tpu.render.scenebuf import make_sphere_refresh as j_refresh
    from mirror_maze_tpu.runtime.step import make_step_fn as j_step_fn

    jr, jbase = j_refresh(jd), j_step_fn(jcfg, 32, 4)
    jstep = jax.jit(lambda d, st, inp: jbase(jr(d), st, inp))
    ps, _ = mp.avatar_scene(build_scene(cfg.maze), 2, 0, glow=0.25)
    pd = upload_scene(ps, device="cpu")
    pr, pstep = make_sphere_refresh(pd), make_step_fn(cfg)

    def frames(centers):
        c = np.asarray(centers, np.float32)
        _, jf = jstep(jmp.update_avatars(jd, slots, jnp.asarray(c)), j_init_state(jcfg, 0),
                      JInputs.idle())
        _, pf = pstep(pr(mp.update_avatars(pd, slots, torch.from_numpy(c))),
                      init_state(cfg, 0, device="cpu"), FrameInputs.idle())
        assert_frames_match(pf.numpy(), np.asarray(jf))
        return pf.numpy()

    parked = frames([[mp.PARK] * 3])
    visible = frames([[-5.0, 0.0, -10.0]])
    assert (visible != parked).any(axis=-1).mean() > 0.05
    assert np.array_equal(frames([[mp.PARK] * 3]), parked)


def test_single_player_engine_is_make_step():
    cfg = port_config(_jcfg())
    dev, init_fn, step_fn = mp.make_multiplayer_engine(cfg, device="cpu")
    assert dev.num_spheres == 0
    step = make_step(upload_scene(build_scene(cfg.maze), device="cpu"), cfg)
    a, b = init_fn(seed=3), init_state(cfg, 3, device="cpu")
    for inp in (FrameInputs.make(w=True), FrameInputs.make(mouse_dx=9.0), FrameInputs.idle()):
        (a, fa), (b, fb) = step_fn(a, inp), step(b, inp)
        assert np.array_equal(fa.numpy(), fb.numpy())
        for x, y in zip(a, b):
            assert np.array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("intersector", ["brute", "pallas", "bvh"])
def test_multiplayer_body_is_bitwise_the_eager_step(monkeypatch, intersector):
    """Player 1 of 3 with both avatars moving in view: the body with the
    gathered positions in its input row, through a StepRunner (eager on the
    CPU), against the eager step given the same positions; states and
    frames bitwise over walking, turning and idle frames. Then two more
    frames of the body under a mode that raises on host reads (the fused
    tracer and the plain walk stubbed: their card versions are kernels)."""
    cfg = port_config(_jcfg(intersector, size=24))
    scene, slots = mp.avatar_scene(build_scene(cfg.maze), 3, 1, glow=0.25)
    dev = upload_scene(scene, device="cpu")
    bounds = derive_traversal_bounds(dev, cfg, None, None)
    runner = StepRunner(mp.multiplayer_body(cfg, dev, slots, [0, 2], *bounds), graphs=True)
    eager = eager_multiplayer_step(cfg, dev, slots, [0, 2], bounds)
    script = ([FrameInputs.make(w=True)] * 2 + [FrameInputs.make(mouse_dx=9.0)]
              + [FrameInputs.idle()] * 2)

    def positions(i, st):
        pos = np.array([[-6.0 + 0.3 * i, 0.0, -10.0], [0.0, 0.0, 0.0],
                        [-4.0, 0.5, -9.0 + 0.4 * i]], np.float32)
        pos[1] = st.cam_center.numpy()
        return pos

    def row(inp, pos):
        return upload_rows(np.concatenate([input_stack([inp]), pos.reshape(1, -1)], axis=1),
                           "cpu")

    a = b = init_state(cfg, 0, device="cpu")
    frames = []
    for i, inp in enumerate(script):
        pos = positions(i, a)
        a = runner(a, row(inp, pos), [inp.rot_updated])
        b, fb = eager(b, inp, torch.from_numpy(pos))
        fa = display(a, cfg)
        assert np.array_equal(fa.numpy(), fb.numpy()), i
        for x, y in zip(a, b):
            assert np.array_equal(x.numpy(), y.numpy()), i
        frames.append(fa.numpy())
    _, parked = make_step_fn(cfg, *bounds)(dev, init_state(cfg, 0, device="cpu"), script[0])
    assert (frames[0] != parked.numpy()).any()            # the avatars show
    assert runner.graphs == {}
    if intersector == "pallas":
        monkeypatch.setattr(pipeline, "trace_paths_fused",
                            lambda scene, ori, dirs, seed, *x, **k: torch.full_like(ori, 0.25))
    if intersector == "bvh":
        monkeypatch.setattr(pipeline, "nearest_hit_bvh", lambda prims, o, *x, **k: (
            torch.full(o.shape[:1], 1e30), torch.zeros(o.shape[:1], dtype=torch.int32)))
    body = mp.multiplayer_body(cfg, dev, slots, [0, 2], *bounds)
    rows = [row(inp, positions(i, a)) for i, inp in enumerate(script[:2])]
    with NoHostReads():
        for r in rows:
            a = body(a, r[0], False)
    assert int(a.frame) == len(script) + 2


# The worker of one player: config as _jcfg(fps=10) (half a unit a walking
# frame), player 1 walks into player 0's view while player 0 stands still.
# Before its last step each player gathers the positions once more and saves
# its state; the last step's frame is saved beside the positions.
MP_WORKER = r"""
import sys
import numpy as np
pid, rendezvous, mode, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
import mirror_maze_tpu_torch as P
from mirror_maze_tpu_torch.parallel import initialize_multihost
from mirror_maze_tpu_torch.parallel.multiplayer import (make_multiplayer_engine,
                                                         make_position_exchange)
from mirror_maze_tpu_torch.runtime.state import FrameInputs, save_state

assert initialize_multihost(rendezvous, 2, pid, timeout_s=30) == 2
cfg = P.EngineConfig(
    maze=P.MazeConfig(width=4, height=4), camera=P.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
    tracer=P.TracerConfig(bounce_limit=2, mirror_limit=2),
    screen=P.ScreenConfig(width=32, height=32, samples_per_pixel=2, chunks_per_frame=64,
                          fps=10.0),
    intersector="brute")
dev, init_fn, step_fn = make_multiplayer_engine(cfg, device="cpu")
exchange = make_position_exchange()
st = init_fn(0)
for i in range(8):
    if mode == "leave" and pid == 1 and i == 3:
        sys.exit(0)
    try:
        st, frame = step_fn(st, FrameInputs.make(w=pid == 1))
    except RuntimeError as e:
        print(f"player {pid} raised: {e}", flush=True)
        sys.exit(3)
positions = exchange(st.cam_center)
save_state(f"{out}/state{pid}.npz", st)
_, frame = step_fn(st, FrameInputs.idle())
np.savez(f"{out}/player{pid}.npz", positions=positions.numpy(), frame=frame.numpy(),
         cam=st.cam_center.numpy())
print(f"player {pid} ok", flush=True)
"""


def _players(tmp_path, mode, timeout=120):
    # The players meet through a file under tmp_path: a port found free and
    # closed again before player 0's store binds it could be taken by another
    # process in between (the other test workers start servers and groups).
    env = dict(os.environ, PYTHONPATH=REPO)
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", MP_WORKER, str(i), rendezvous, mode,
                               str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("player processes timed out:\n" + "\n".join(outs))
    return [p.returncode for p in procs], outs


def test_two_players_over_gloo(tmp_path):
    rcs, outs = _players(tmp_path, "play")
    assert rcs == [0, 0], outs
    got = [np.load(tmp_path / f"player{i}.npz") for i in range(2)]
    for g in got:                      # every player gathers the same positions,
        for i in range(2):             # row i player i's camera centre
            assert np.array_equal(g["positions"][i], got[i]["cam"])
    assert got[0]["cam"][2] == -15.0 and got[1]["cam"][2] > -12.0
    # Player 0's last frame = a single-process step of its state with player
    # 1's avatar at the gathered position.
    cfg = port_config(_jcfg(fps=10.0))
    scene, slots = mp.avatar_scene(build_scene(cfg.maze), 2, 0, glow=0.25)
    dev = upload_scene(scene, device="cpu")
    st = load_state(str(tmp_path / "state0.npz"), cfg, device="cpu")
    step = make_step_fn(cfg)
    _, frame = step(mp.update_avatars(dev, slots, torch.from_numpy(got[0]["positions"][1:])),
                    st, FrameInputs.idle())
    assert np.array_equal(frame.numpy(), got[0]["frame"])
    # ... in which the avatar shows.
    _, parked = step(dev, st, FrameInputs.idle())
    assert (parked.numpy() != got[0]["frame"]).any()
    assert isinstance(st, EngineState)


def test_a_player_leaving_ends_the_session_for_the_other(tmp_path):
    rcs, outs = _players(tmp_path, "leave")
    assert rcs == [3, 0], outs
    assert "a peer left the session" in outs[0]
