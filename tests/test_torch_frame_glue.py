"""The step's glue (runtime/step.py frame_setup, render/frame_glue.py
pinhole_rays and resolve): each plain version against the JAX package's
functions, the kernel wrappers' dispatch, and the kernel library hash.

Inputs come from the golden configuration (64x48, 8 spp), config_v0
(256x256, 1 spp) and a band of the golden screen, with states, moves and
light made by NumPy from a seed. The JAX side runs under ``jax.jit``, as the
JAX package's step does. Tolerances:

- the setup's window, cursor, frame, keys and seed bitwise; the centre
  within atol 1e-6 (XLA contracts the move's multiply-adds into FMAs, as
  test_torch_engine.py holds the camera);
- the pixels and the jitter bitwise; the directions within atol 2e-7 (an ulp
  or two of a unit vector: the same FMA contraction);
- the resolve bitwise (tolerance 0): the plain version sums the samples in
  the order of the jitted ``jnp.mean`` and multiplies by the same float32
  reciprocal, for spp <= 32, multiples of 32 up to 1,024 and multiples of
  1,024; at other spp (3,817) the golden rule, and within rtol 1e-6.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mirror_maze_tpu.config as JC
import mirror_maze_tpu_torch as P
from _torch_tools import assert_frames_match, golden_config, port_config, walk_into_wall
from mirror_maze_tpu.ops.sampling import ray_jitter as j_jitter
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.render.accumulate import scatter_chunk_rows as j_scatter
from mirror_maze_tpu.render.camera import Camera as JCamera
from mirror_maze_tpu.render.camera import ray_directions as j_rays
from mirror_maze_tpu.render.scheduler import chunk_origin_xy as j_origin
from mirror_maze_tpu.render.scheduler import chunk_pixels as j_pixels
from mirror_maze_tpu.render.scheduler import sort_window_morton as j_sort
from mirror_maze_tpu.render.scheduler import take_chunks as j_take
from mirror_maze_tpu.render.tracer import tone_map as j_tone_map
from mirror_maze_tpu.runtime.step import integrate_movement as j_move
from mirror_maze_tpu.runtime.step import resolve_collision as j_collide
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.ops.sampling import ray_jitter
from mirror_maze_tpu_torch.render import frame_glue
from mirror_maze_tpu_torch.render.camera import ray_directions
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.runtime import graph, step
from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
from mirror_maze_tpu_torch.scene import build_scene

SEED = 14


def _jcfg(name):
    if name == "v0":
        return JC.config_v0()
    g = golden_config()
    return JC.EngineConfig(
        maze=JC.MazeConfig(**dataclasses.asdict(g.maze)),
        tracer=JC.TracerConfig(**dataclasses.asdict(g.tracer)),
        camera=JC.CameraConfig(**dataclasses.asdict(g.camera)),
        screen=JC.ScreenConfig(**dataclasses.asdict(g.screen)),
        intersector=g.intersector)


def _grid(jcfg, band: bool, sort: bool):
    """(JAX grid, port grid, row0): the whole screen, or the second of two
    row bands (parallel/shard.py _band_screen_cfg) at row0 = height / 2."""
    s = dataclasses.replace(jcfg.screen, sort_chunk_window=sort)
    row0 = 0
    if band:
        row0 = s.height // 2
        s = dataclasses.replace(s, height=row0,
                                chunks_per_frame=max(1, s.effective_chunks_per_frame // 2))
    return s, P.ScreenConfig(**dataclasses.asdict(s)), row0


def _state(cfg, grid, rng, frame_no):
    """An initial state with a random queue of the grid's chunks, cursor,
    key and frame number."""
    st = init_state(cfg, device="cpu")
    perm = torch.from_numpy(rng.permutation(grid.total_chunks).astype(np.int32))
    key = torch.from_numpy(rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.int64))
    return st._replace(perm=perm, cursor=torch.tensor(int(rng.integers(grid.total_chunks)),
                                                      dtype=torch.int32),
                       key=key, frame=torch.tensor(frame_no, dtype=torch.int32),
                       screen=torch.zeros(grid.total_chunks, grid.pixels_per_chunk * 3))


def _j_setup(jcfg, jscene, jgrid, n, sort):
    @jax.jit
    def setup(perm, cursor, key, frame, center, quat, keys):
        ids, cur = j_take(perm, cursor, n)
        if sort:
            ids = j_sort(ids, jgrid)
        center2 = j_collide(jcfg, jscene, j_move(jcfg, center, quat, keys), center)
        rkey, key2 = jax.random.split(key)
        jkey, tkey = jax.random.split(jax.random.fold_in(key2, frame + 1))
        seed = jax.random.randint(tkey, (), 0, jnp.iinfo(jnp.int32).max)
        return ids, cur, frame + 1, center2, key2, rkey, jkey, tkey, seed

    return setup


@pytest.mark.parametrize("config,band,sort,move", [
    ("golden", False, False, "idle"), ("golden", False, True, "walk"),
    ("golden", False, True, "collide"), ("golden", True, True, "strafe"),
    ("v0", False, False, "walk"), ("v0", True, False, "all"),
])
def test_frame_setup_plain_matches_jax(config, band, sort, move):
    jcfg = _jcfg(config)
    jgrid, grid, _ = _grid(jcfg, band, sort)
    cfg = port_config(jcfg).replace(
        screen=dataclasses.replace(port_config(jcfg).screen, sort_chunk_window=sort))
    rng = np.random.default_rng(SEED)
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    st = _state(cfg, grid, rng, int(rng.integers(0, 1000)))
    inp = {"idle": FrameInputs.idle(), "walk": FrameInputs.make(w=True),
           "collide": FrameInputs.make(w=True), "strafe": FrameInputs.make(a=True, s=True),
           "all": FrameInputs.make(a=True, s=True, d=True, w=True)}[move]
    if move == "collide":
        st, walked = walk_into_wall(scene, cfg, st)
        assert walked < 2000
    row = torch.from_numpy(step.input_stack([inp])[0])
    n = grid.effective_chunks_per_frame
    got = step.frame_setup(scene, cfg, st, row, n, grid)
    want = _j_setup(jcfg, j_upload(j_build(jcfg.maze)), jgrid, n, sort)(
        jnp.asarray(st.perm.numpy()), jnp.int32(int(st.cursor)),
        jnp.asarray(st.key.numpy().astype(np.uint32)), jnp.int32(int(st.frame)),
        jnp.asarray(st.cam_center.numpy()), jnp.asarray(st.quat.numpy()),
        jnp.asarray(np.array(inp.keys, np.float32)))
    for f, w in zip(("ids", "cursor", "frame", "center", "key", "rkey", "jkey", "tkey", "seed"),
                    want):
        g = getattr(got, f).numpy()
        w = np.asarray(w)
        if f == "center":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.astype(np.int64).reshape(w.shape),
                                          w.astype(np.int64), err_msg=f)
    # Idle, all four keys (they cancel) and the move into a wall stay put.
    assert torch.equal(got.center, st.cam_center) == (move in ("idle", "all", "collide"))


@pytest.mark.parametrize("config,band", [("golden", False), ("golden", True), ("v0", False)])
def test_pinhole_rays_plain_match_jax(config, band):
    jcfg = _jcfg(config)
    jgrid, grid, row0 = _grid(jcfg, band, True)
    cfg = port_config(jcfg)
    rng = np.random.default_rng(SEED + 1)
    spp, sc = cfg.screen.samples_per_pixel, cfg.screen
    ids = torch.from_numpy(rng.permutation(grid.total_chunks)[:grid.effective_chunks_per_frame]
                           .astype(np.int32))
    jkey = torch.from_numpy(rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.int64))
    st = init_state(cfg, device="cpu")
    quat = torch.from_numpy(np.array([0.1, -0.6, 0.05, 0.79], np.float32))
    cam = st._replace(quat=quat / torch.linalg.norm(quat)).camera(cfg)
    win = frame_glue.Window(ids, grid, row0)
    ori, dirs, seed_row = frame_glue.pinhole_rays(cam, win, jkey, cfg)
    assert seed_row is None

    pix = np.array(j_pixels(j_origin(jnp.asarray(ids.numpy()), jgrid)
                              + jnp.array([0, row0], jnp.int32), jgrid.chunk_width))
    np.testing.assert_array_equal(frame_glue.window_pixels(
        frame_glue.Window(ids, grid, row0)).numpy(), pix)
    jcam = JCamera(*(jnp.asarray(t.numpy()) for t in cam))
    k = pix.shape[0]
    jk = jnp.asarray(jkey.numpy().astype(np.uint32))
    base = jax.jit(lambda p: j_rays(jcam, p, float(sc.width), float(sc.height)))(pix)
    jit = jax.jit(lambda key: j_jitter(key, (k, spp), cfg.tracer.jitter))(jk)
    np.testing.assert_array_equal(ray_jitter(jkey, (k, spp), cfg.tracer.jitter).numpy(),
                                  np.asarray(jit))
    np.testing.assert_allclose(ray_directions(cam, torch.from_numpy(pix), float(sc.width),
                                              float(sc.height)).numpy(), np.asarray(base),
                               rtol=0, atol=2e-7)
    want = np.asarray(jax.jit(lambda b, j: (b[:, None, :] + j).reshape(k * spp, 3))(base, jit))
    np.testing.assert_allclose(dirs.numpy(), want, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(ori.numpy(), np.broadcast_to(cam.center.numpy(), (k * spp, 3)))


@pytest.mark.parametrize("n", [16385, 32400])
def test_frame_setup_plain_orders_large_windows_as_jax(n):
    """Windows past one block of the kernel's sort (MAX_SORT = 16,384): 16,385
    ids and config_scale's window at 7680x4320 (32,400 of its 1,920 x 1,080
    chunks), popped across the end of a random queue: frame_setup_plain's
    ids bitwise the JAX package's take_chunks + sort_window_morton."""
    jcfg = _jcfg("golden")
    jgrid = dataclasses.replace(jcfg.screen, width=7680, height=4320, sort_chunk_window=True)
    grid = P.ScreenConfig(**dataclasses.asdict(jgrid))
    assert jgrid.effective_chunks_per_frame == 32400
    cfg = golden_config()
    cfg = cfg.replace(screen=dataclasses.replace(cfg.screen, sort_chunk_window=True))
    rng = np.random.default_rng(n)
    st = init_state(cfg, device="cpu")._replace(
        perm=torch.from_numpy(rng.permutation(grid.total_chunks).astype(np.int32)),
        cursor=torch.tensor(grid.total_chunks - n // 3, dtype=torch.int32))
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    got = step.frame_setup_plain(scene, cfg, st, torch.zeros(5), n, grid)

    @jax.jit
    def window(perm, cursor):
        ids, cur = j_take(perm, cursor, n)
        return j_sort(ids, jgrid), cur

    ids, cur = window(jnp.asarray(st.perm.numpy()), jnp.int32(int(st.cursor)))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ids))
    assert int(got.cursor) == int(cur)


@pytest.mark.parametrize("spp", [3817, 4096])
def test_resolve_plain_past_the_staged_spp_against_jax(spp):
    """spp past RESOLVE_MAX_SPP (the kernel's pieces route), on 8 pixels of
    two chunks: at 4,096 (a multiple of 32) the screen's rows and the colours
    bitwise the jitted reference mean (tone_map, jnp.mean,
    scatter_chunk_rows); at 3,817 jnp.mean sums in another order, so the
    8-bit colours by the golden rule and the float colours within 1e-6."""
    rng = np.random.default_rng(SEED + spp)
    c, ppc, k = 5, 4, 2
    light = rng.random((k * ppc * spp, 3)).astype(np.float32) * 4 - 1
    screen = rng.random((c, ppc * 3)).astype(np.float32)
    ids = np.array([3, 1], dtype=np.int32)

    @jax.jit
    def jresolve(light, screen, ids):
        colors = jnp.mean(j_tone_map(light).reshape(k * ppc, spp, 3), axis=1)
        return j_scatter(screen, ids, colors), colors

    want_screen, want_colors = (np.asarray(a) for a in jresolve(light, screen, ids))
    t = torch.from_numpy
    got_screen = frame_glue.resolve(t(light), spp, t(screen), t(ids)).numpy()
    got_colors = frame_glue.resolve(t(light), spp).numpy()
    if spp % frame_glue.RUN == 0:
        np.testing.assert_array_equal(got_screen.view(np.int32), want_screen.view(np.int32))
        np.testing.assert_array_equal(got_colors.view(np.int32), want_colors.view(np.int32))
    else:
        eight = lambda x: np.round(np.clip(x, 0, 1) * 255).astype(np.uint8)   # noqa: E731
        assert_frames_match(eight(got_screen), eight(want_screen))
        np.testing.assert_allclose(got_colors, want_colors, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(np.delete(got_screen, ids, 0),
                                      np.delete(screen, ids, 0))


def test_pinhole_rays_seed_row_is_the_pixels_texel():
    cfg = golden_config()
    cfg = cfg.replace(tracer=dataclasses.replace(cfg.tracer, noise_rng=True))
    rng = np.random.default_rng(SEED + 2)
    noise = torch.from_numpy(rng.random((16, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.permutation(cfg.screen.total_chunks)[:12].astype(np.int32))
    win = frame_glue.Window(ids, cfg.screen, 0)
    cam = init_state(cfg, device="cpu").camera(cfg)
    _, _, row = frame_glue.pinhole_rays(cam, win, prng.PRNGKey(1), cfg, noise)
    pix = frame_glue.window_pixels(win).numpy()
    want = noise.numpy()[pix[:, 1] % 16, pix[:, 0] % 8]
    np.testing.assert_array_equal(row.numpy(), np.repeat(want, cfg.screen.samples_per_pixel))
    with pytest.raises(ValueError, match="noise texture"):
        frame_glue.pinhole_rays(cam, win, prng.PRNGKey(1), cfg)


@pytest.mark.parametrize("spp", [1, 3, 8, 64, 1024, 2048])
def test_resolve_plain_matches_jax_bitwise(spp):
    rng = np.random.default_rng(SEED + spp)
    c, ppc, k = 40, 16, 6
    light = rng.random((k * ppc * spp, 3)).astype(np.float32) * 4 - 1
    screen = rng.random((c, ppc * 3)).astype(np.float32)
    ids = rng.permutation(c)[:k].astype(np.int32)

    @jax.jit
    def jresolve(light, screen, ids):
        colors = jnp.mean(j_tone_map(light).reshape(k * ppc, spp, 3), axis=1)
        return j_scatter(screen, ids, colors), colors

    want_screen, want_colors = (np.asarray(a) for a in jresolve(light, screen, ids))
    t = torch.from_numpy
    got = frame_glue.resolve(t(light), spp, t(screen), t(ids))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want_screen.view(np.int32))
    np.testing.assert_array_equal(frame_glue.resolve(t(light), spp).numpy().view(np.int32),
                                  want_colors.view(np.int32))


def test_resolve_writes_a_copy_unless_in_place():
    rng = np.random.default_rng(SEED)
    light = torch.from_numpy(rng.random((4 * 16 * 2, 3)).astype(np.float32))
    screen = torch.zeros(8, 48)
    ids = torch.tensor([5, 0, 7, 2], dtype=torch.int32)
    out = frame_glue.resolve(light, 2, screen, ids)
    assert out is not screen and float(screen.abs().sum()) == 0.0
    same = frame_glue.resolve(light, 2, screen, ids, in_place=True)
    assert same is screen and torch.equal(screen, out)


def test_sample_mean_sums_runs_of_32():
    """For 33 samples: the first 32 left to right, then the 33rd added."""
    rng = np.random.default_rng(SEED)
    s = torch.from_numpy(rng.random((50, 33, 3)).astype(np.float32))
    run = s[:, 0]
    for i in range(1, 32):
        run = run + s[:, i]
    want = (run + s[:, 32]) * float(np.float32(1) / np.float32(33))
    assert torch.equal(frame_glue.sample_mean(s), want)


def test_sample_mean_adds_blocks_of_32_runs():
    """For 2,080 samples (65 runs): runs 0-31 left to right into a block, runs
    32-63 into the next, run 64 alone, then the three blocks left to right."""
    rng = np.random.default_rng(SEED)
    s = torch.from_numpy(rng.random((20, 2080, 3)).astype(np.float32))
    runs = []
    for r0 in range(0, 2080, 32):
        run = s[:, r0]
        for i in range(r0 + 1, r0 + 32):
            run = run + s[:, i]
        runs.append(run)
    blocks = []
    for b in (0, 32, 64):
        block = runs[b]
        for r in runs[b + 1:b + 32]:
            block = block + r
        blocks.append(block)
    want = ((blocks[0] + blocks[1]) + blocks[2]) * float(np.float32(1) / np.float32(2080))
    assert torch.equal(frame_glue.sample_mean(s), want)


def test_state_is_owned_only_inside_a_capture():
    assert not graph.state_owned()
    with graph._owning():
        assert graph.state_owned()
    assert not graph.state_owned()


# --- No fallback --------------------------------------------------------------


def _setup_args(device="cpu"):
    cfg = golden_config()
    scene = upload_scene(build_scene(cfg.maze), device=device)
    st = init_state(cfg, device=device)
    return scene, cfg, st, torch.zeros(5, device=device), cfg.screen.effective_chunks_per_frame, \
        cfg.screen


def test_kernel_wrappers_raise_on_cpu_tensors():
    """Asked for a kernel where there is no card, each wrapper raises rather
    than running its plain version."""
    scene, cfg, st, row, n, grid = _setup_args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        step.frame_setup_kernel(scene, cfg, st, row, n, grid)
    setup = step.frame_setup(scene, cfg, st, row, n, grid)
    win = frame_glue.Window(setup.ids, grid, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        frame_glue.pinhole_rays_kernel(st.camera(cfg), win, setup.jkey, cfg)
    light = torch.zeros(n * 16 * 8, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        frame_glue.resolve_kernel(light, 8, st.screen.clone(), setup.ids)
    with pytest.raises(ValueError, match="CUDA tensors"):
        frame_glue.resolve_kernel(light, 8, torch.empty(n * 16, 3))
    before = dict(kernels.launches)
    assert kernels.launches == before


@pytest.mark.parametrize("name", ["frame_setup", "pinhole_rays", "resolve"])
def test_a_tensor_neither_on_the_cpu_nor_on_the_card_raises(name):
    meta = torch.empty(3, device="meta")
    cfg = golden_config()
    with pytest.raises(ValueError, match="runs on cuda or cpu tensors"):
        if name == "frame_setup":
            step.frame_setup(None, cfg, init_state(cfg, device="cpu")._replace(cam_center=meta),
                             meta, 12, cfg.screen)
        elif name == "pinhole_rays":
            frame_glue.pinhole_rays(None, None, torch.empty(2, device="meta"), cfg)
        else:
            frame_glue.resolve(torch.empty(8, 3, device="meta"), 8)


def test_frame_setup_guards_the_window_before_the_launch():
    """A sorted window of any size up to the queue is the kernel's (past
    MAX_SORT its tiled route): the only size raise is for a window larger
    than the queue, and for a grid side past 2^16 chunks, where the
    reference's 16-bit Morton codes collide; otherwise a CPU tensor raises
    for being off the card, before any launch."""
    scene, cfg, st, row, _, _ = _setup_args()
    wide = dataclasses.replace(cfg.screen, width=1024, height=512, sort_chunk_window=True)
    cfg = cfg.replace(screen=wide)
    st = st._replace(perm=torch.arange(wide.total_chunks, dtype=torch.int32))
    before = dict(kernels.launches)
    for n in (step.MAX_SORT + 1, wide.total_chunks):
        with pytest.raises(ValueError, match="CUDA tensors"):
            step.frame_setup_kernel(scene, cfg, st, row, n, wide)
    with pytest.raises(ValueError, match="a window of"):
        step.frame_setup_kernel(scene, cfg, st, row, wide.total_chunks + 1, wide)
    tall = dataclasses.replace(wide, width=4, height=4 * (step.MAX_GRID_SIDE + 1))
    with pytest.raises(ValueError, match="2\\^16 x 2\\^16"):
        step.frame_setup_kernel(scene, cfg, st, row, 12, tall)
    assert kernels.launches == before


# --- The kernel library hash --------------------------------------------------


def test_library_names_hash_every_included_header(tmp_path, monkeypatch):
    """An edited threefry.cuh renames (so rebuilds) the three libraries whose
    sources include it, and no other; quat.cuh the two that include it."""
    assert kernels.sources("frame_setup.cu") == ["frame_setup.cu", "quat.cuh", "threefry.cuh"]
    assert kernels.sources("camera_rays.cu") == ["camera_rays.cu", "quat.cuh", "threefry.cuh"]
    assert kernels.sources("threefry.cu") == ["threefry.cu", "threefry.cuh"]
    assert kernels.sources("resolve.cu") == ["resolve.cu"]
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    names = {n: kernels._lib_path(n).name for n in kernels.LIBRARIES}
    for header, users in (("threefry.cuh", {"threefry", "frame_setup", "camera_rays"}),
                          ("quat.cuh", {"frame_setup", "camera_rays"})):
        (csrc / header).write_text((csrc / header).read_text() + "\n// edited\n")
        now = {n: kernels._lib_path(n).name for n in kernels.LIBRARIES}
        assert {n for n in names if now[n] != names[n]} == users, header
        names = now
