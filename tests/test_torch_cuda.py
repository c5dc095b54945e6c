"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import mirror_maze_tpu_torch as P
from _torch_tools import (
    INTERSECT_SCENES,
    aimed_rays,
    assert_frames_match,
    checker_floor,
    cornell_scene,
    golden_config,
    golden_script,
    intersect_scene,
    mesh_gallery_scene,
    multi_tile_config,
    multi_tile_script,
    eager_multiplayer_step,
    glue_check,
    glue_inputs,
    ndiff as glue_ndiff,
    primitive_zoo,
    scene_rays,
    scene_subset,
    soup_arrays,
    textured_cornell,
    textured_maze_scene,
    tied_floor_scene,
    zero_component_rays,
)
from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.config import MazeConfig, ScreenConfig, TracerConfig, config_interactive
from mirror_maze_tpu_torch.render.fused_tracer import (
    COUNT_BYTES,
    trace_paths_fused,
    trace_paths_plain,
)
from mirror_maze_tpu_torch.render.present import present, present_plain
from mirror_maze_tpu_torch.parallel import shard
from mirror_maze_tpu_torch.render.accumulate import cm_to_spatial
from mirror_maze_tpu_torch.render.scenebuf import make_sphere_refresh, upload_scene
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.scene.builder import Scene

pytestmark = pytest.mark.cuda
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "script_pallas.npz")


@pytest.fixture
def cuda_device():
    """The CUDA card; skips the test on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("quantize", [True, False])
def test_present_kernel_matches_plain_bitwise(cuda_device, quantize):
    cfg = ScreenConfig(width=1920, height=1080)
    x = np.random.default_rng(0).random(
        (cfg.total_chunks, cfg.pixels_per_chunk * 3)).astype(np.float32) * 1.2 - 0.1
    s = torch.from_numpy(x).to(cuda_device)
    before = kernels.launches["present"]
    got = present(s, cfg, quantize)
    assert kernels.launches["present"] == before + 1
    want = present_plain(s, cfg, quantize)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("cw,w,h", [(1, 64, 48), (2, 64, 48), (4, 64, 48), (5, 60, 45),
                                    (4, 4, 64), (5, 5, 40)])
def test_present_kernel_chunk_widths_match_plain_bitwise(cuda_device, cw, w, h, halo):
    """Chunk width 4 (three float4s a strip, neighbours by shuffles) and the
    generic instance (1, 2, 5), a screen one chunk wide, and halo rows."""
    cfg = ScreenConfig(width=w, height=h, chunk_width=cw)
    rng = np.random.default_rng(cw * 100 + w)
    x = rng.random((cfg.total_chunks, cfg.pixels_per_chunk * 3)).astype(np.float32) * 1.2 - 0.1
    s = torch.from_numpy(x).to(cuda_device)
    halos = (None, None)
    if halo:
        halos = tuple(torch.from_numpy(rng.random(w * 3).astype(np.float32)).to(cuda_device)
                      for _ in range(2))
    for quantize in (True, False):
        got = present(s, cfg, quantize, *halos)
        want = present_plain(s, cfg, quantize, *halos)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _rays(n, seed, extent, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-7, 1, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    row = rng.random(n).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (o, d, row))


def _kernel_vs_plain(scene, o, d, tracer, rows, lib="tracer", **kw):
    """Both on the card, same inputs: >= 99.9% of rays within rtol 1e-5 /
    atol 1e-6 (same arithmetic; the sky's expf may differ by an ulp). The
    launch is counted under ``lib``, the library the scene runs."""
    seed = torch.tensor([7], dtype=torch.int32, device=o.device)
    before = kernels.launches[lib]
    got = trace_paths_fused(scene, o, d, seed, tracer, rows, **kw)
    assert kernels.launches[lib] == before + 1
    want = trace_paths_plain(scene, o, d, seed, tracer, rows, **kw)
    torch.cuda.synchronize()
    close = torch.isclose(got, want, rtol=1e-5, atol=1e-6).all(dim=1)
    assert float(close.float().mean()) >= 0.999
    assert float(want.mean()) > 0
    return got


@pytest.mark.parametrize("bounce,mirror", [(1, 2), (5, 8)])
def test_tracer_kernel_matches_plain(cuda_device, bounce, mirror):
    scene = upload_scene(build_scene(config_interactive().maze), device=cuda_device)
    o, d, _ = _rays(100_001, bounce, 45, cuda_device)
    _kernel_vs_plain(scene, o, d, TracerConfig(bounce_limit=bounce, mirror_limit=mirror), 96)


@pytest.mark.parametrize("tiles", [None, {0: 16, 1: 32}, {0: 8, 1: 8, 2: 4}])
@pytest.mark.parametrize("bounce,mirror", [(1, 2), (5, 8)])
def test_multi_tile_tracer_kernel_matches_plain(cuda_device, tiles, bounce, mirror):
    """The 16x16 maze in the reference's tiles of 128 (1 + 2 + 1) and cut
    small (many tiles in every group), with a tile-order anchor off the
    origin and the noise seed row."""
    scene = upload_scene(build_scene(MazeConfig(width=16, height=16)), device=cuda_device,
                         tile_by_mode=tiles)
    assert max(g[2] for g in scene.group_meta) > 1
    o, d, row = _rays(100_001, bounce, 79, cuda_device)
    anchor = torch.tensor([3.0, -1.0, 7.0], device=cuda_device)
    tracer = TracerConfig(bounce_limit=bounce, mirror_limit=mirror)
    plain = _kernel_vs_plain(scene, o, d, tracer, 32, anchor=anchor)
    seeded = _kernel_vs_plain(scene, o, d, tracer, 32, anchor=anchor, seed_row=row)
    assert torch.equal(plain, seeded) == (bounce == 1)


@pytest.mark.parametrize("lighting_factor", [0.25, 0.0])
def test_sky_term_kernel_matches_plain(cuda_device, lighting_factor):
    """The random soup is an open scene in two tiles: rays miss on every
    segment and gather the sky."""
    scene = upload_scene(Scene(**soup_arrays()), device=cuda_device)
    o, d, _ = _rays(50_000, 3, 25, cuda_device)
    tracer = TracerConfig(bounce_limit=3, mirror_limit=2, sky_strength=0.7,
                          lighting_factor=lighting_factor)
    lit = _kernel_vs_plain(scene, o, d, tracer, 8)
    dark = trace_paths_fused(scene, o, d, torch.tensor([7], dtype=torch.int32, device=o.device),
                             TracerConfig(bounce_limit=3, mirror_limit=2), 8)
    assert float(lit.sum()) > float(dark.sum())


ZOO_TILES = {1: 16, 3: 4, 4: 16, 5: 2, 6: 8, 7: 8}


@pytest.mark.parametrize("fresnel", [False, True])
@pytest.mark.parametrize("tiles", [None, ZOO_TILES])
@pytest.mark.parametrize("modes", [(3,), (4,), (5,), (6,), (7,), (3, 4, 5, 6, 7)])
def test_spheres_triangles_glass_kernel_matches_plain(cuda_device, modes, tiles, fresnel):
    """Each of the test modes 3-7 alone in an 8x8 maze, and all eight modes
    together, every group in one tile and cut into several (some of padding
    only); half the rays aim at the primitives. Glass triangles (mode 7)
    are on no driven path: this is where the kernel's branch for them is
    held against the plain version."""
    scene = scene_subset(primitive_zoo(8), set(modes))
    dev = upload_scene(scene, device=cuda_device, tile_by_mode=tiles)
    assert {g[0] for g in dev.group_meta} == {0, 1, 2} | set(modes)
    assert (max(g[2] for g in dev.group_meta) > 1) == (tiles is not None)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in aimed_rays(scene, 100_001, 9, 39.0))
    tracer = TracerConfig(bounce_limit=4, mirror_limit=6, fresnel=fresnel)
    anchor = torch.tensor([2.0, -1.0, -4.0], device=cuda_device)
    got = _kernel_vs_plain(dev, o, d, tracer, 32, anchor=anchor)
    if dev.has_glass:
        other = trace_paths_fused(dev, o, d, torch.tensor([7], dtype=torch.int32, device=o.device),
                                  TracerConfig(bounce_limit=4, mirror_limit=6,
                                               fresnel=not fresnel), 32, anchor=anchor)
        assert not torch.equal(got, other)


@pytest.mark.parametrize("variant", ["spheres", "glass"])
def test_cornell_box_kernel_matches_plain(cuda_device, variant):
    """Rays from inside the room, and for the glass variant also from inside
    the glass sphere (the far root)."""
    scene = cornell_scene(variant)
    dev = upload_scene(scene, device=cuda_device)
    o, d = aimed_rays(scene, 100_000, 5, 4.5)
    if variant == "glass":
        o[:1000] = np.asarray(scene.sph_center)[0] + 0.5 * d[:1000]
    o, d = (torch.from_numpy(a).to(cuda_device) for a in (o, d))
    _kernel_vs_plain(dev, o, d, TracerConfig(), 32)


TEXTURED = {
    "cornell_blocks": (lambda: textured_cornell("blocks"), 4.5, None),
    "cornell_spheres": (lambda: textured_cornell("spheres"), 4.5, None),
    "tie_with_untextured": (tied_floor_scene, 4.5, None),
    "maze_many_tiles": (textured_maze_scene, 39.0, {0: 8, 1: 16, 2: 4, 3: 4}),
}


@pytest.mark.parametrize("name", list(TEXTURED))
def test_textured_kernel_matches_plain(cuda_device, name):
    """The texture stage (library ``tracer_tex``): UV and world checkers on
    planes, a world checker on a sphere, a textured plane tied exactly with an
    untextured one, and random textures over many tiles. The light must differ
    from the same scene's with its textures taken off."""
    build, extent, tiles = TEXTURED[name]
    scene = build()
    dev = upload_scene(scene, device=cuda_device, tile_by_mode=tiles)
    assert dev.textured
    o, d = (torch.from_numpy(a).to(cuda_device) for a in aimed_rays(scene, 100_001, 4, extent))
    tracer = TracerConfig(bounce_limit=4, mirror_limit=6)
    got = _kernel_vs_plain(dev, o, d, tracer, 32, lib="tracer_tex")
    bare = dev._replace(plane_tex=dev.plane_tex[:0], sphere_tex=dev.sphere_tex[:0])
    assert not bare.textured
    assert not torch.equal(got, _kernel_vs_plain(bare, o, d, tracer, 32))


DIAG_SCENES = {
    "maze10_one_tile": (lambda: build_scene(config_interactive().maze), 45.0, None),
    "maze16_tiles": (lambda: build_scene(MazeConfig(width=16, height=16)), 79.0, {0: 16, 1: 32}),
    "zoo_tiled": (lambda: primitive_zoo(8), 39.0, ZOO_TILES),
    "textured_maze": (textured_maze_scene, 39.0, {0: 8, 1: 16, 2: 4, 3: 4}),
}


@pytest.mark.parametrize("name", list(DIAG_SCENES))
def test_diagnostics_kernel_matches_plain(cuda_device, name):
    """The per-block diagnostics (libraries ``tracer_diag`` and
    ``tracer_tex_diag``) equal the plain version's on every block, the last
    one padded; the light is the launch's without them, bitwise."""
    build, extent, tiles = DIAG_SCENES[name]
    scene = build()
    dev = upload_scene(scene, device=cuda_device, tile_by_mode=tiles)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in aimed_rays(scene, 50_001, 6, extent))
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    tracer = TracerConfig(bounce_limit=4, mirror_limit=6)
    lib = "tracer_tex_diag" if dev.textured else "tracer_diag"
    before = kernels.launches[lib]
    light, diag = trace_paths_fused(dev, o, d, seed, tracer, 8, return_block_segments=True)
    assert kernels.launches[lib] == before + 1
    want_light, want = trace_paths_plain(dev, o, d, seed, tracer, 8, return_block_segments=True)
    torch.cuda.synchronize()
    assert diag.dtype == torch.int32 and tuple(diag.shape) == (5, -(-50_001 // 1024))
    assert torch.equal(light, trace_paths_fused(dev, o, d, seed, tracer, 8))
    # Blocks whose rays all carry the plain version's light bit for bit took
    # the same path; the counts of all blocks are expected equal too.
    assert torch.equal(diag, want)
    assert float(torch.isclose(light, want_light, rtol=1e-5, atol=1e-6).all(dim=1)
                 .float().mean()) >= 0.999


GRID_SCENES = {
    "staged_maze": (lambda: build_scene(config_interactive().maze), 45.0, None),
    "walked_maze": (lambda: build_scene(MazeConfig(width=16, height=16)), 79.0, {0: 16, 1: 32}),
}


@pytest.mark.parametrize("name", list(GRID_SCENES))
def test_tracer_light_does_not_depend_on_the_grid(cuda_device, name):
    """The persistent grid forced to one block and at its full size give the
    same light and diagnostics, bit for bit, and the plain version's light."""
    build, extent, tiles = GRID_SCENES[name]
    scene = build()
    dev = upload_scene(scene, device=cuda_device, tile_by_mode=tiles)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in aimed_rays(scene, 50_001, 8, extent))
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    tracer = TracerConfig(bounce_limit=4, mirror_limit=6)
    geo_full, geo_one = {}, {}
    full = trace_paths_fused(dev, o, d, seed, tracer, 8, geometry=geo_full)
    one = trace_paths_fused(dev, o, d, seed, tracer, 8, grid_blocks=1, geometry=geo_one)
    assert geo_full["blocks"] > 1 and geo_one["blocks"] == 1
    full_diag = trace_paths_fused(dev, o, d, seed, tracer, 8, return_block_segments=True)[1]
    one_diag = trace_paths_fused(dev, o, d, seed, tracer, 8, return_block_segments=True,
                                 grid_blocks=1)[1]
    want = trace_paths_plain(dev, o, d, seed, tracer, 8)
    torch.cuda.synchronize()
    assert torch.equal(full, one) and torch.equal(full_diag, one_diag)
    assert torch.equal(full, want)


@pytest.mark.parametrize("width", [16, 96])
def test_resident_and_global_paths_match_plain_bitwise(cuda_device, width):
    """The 16x16 maze's records fit a block's shared memory and the kernel
    walks its tiles there; the 96x96 maze's (6,057 planes, 486,516 bytes)
    do not, and it reads them from global memory. Both bitwise the plain
    version."""
    scene = build_scene(MazeConfig(width=width, height=width))
    dev = upload_scene(scene, device=cuda_device)
    assert max(g[2] for g in dev.group_meta) > 1
    o, d = (torch.from_numpy(a).to(cuda_device)
            for a in aimed_rays(scene, 50_001, 11, 5.0 * width - 1.0))
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    tracer = TracerConfig(bounce_limit=4, mirror_limit=6)
    anchor = torch.tensor([3.0, -1.0, 7.0], device=cuda_device)
    geo = {}
    got = trace_paths_fused(dev, o, d, seed, tracer, 8, anchor=anchor, geometry=geo)
    assert geo["resident"] == (width == 16)
    want = trace_paths_plain(dev, o, d, seed, tracer, 8, anchor=anchor)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(want.mean()) > 0


def _maze(name, **maze):
    return lambda: build_scene(dataclasses.replace(P.NAMED_CONFIGS[name]().maze, **maze))


# name -> (scene, (resident, axis route) on a card whose block may opt in to
# 232,448 B). The mazes' scans take the axis route; the Cornell box's and the
# mesh gallery's rooms hold too few axis records for it.
RESIDENCY_SCENES = {
    "interactive": (_maze("interactive"), (True, True)),
    "scale": (_maze("scale"), (False, True)),
    "scale_glass": (_maze("scale", glass_prob=0.5), (False, True)),
    "fuzzy": (_maze("fuzzy"), (True, True)),
    "cornell_glass": (lambda: cornell_scene("glass"), (True, False)),
    "mesh": (mesh_gallery_scene, (True, False)),
    "mesh_checker": (lambda: checker_floor(mesh_gallery_scene()), (True, False)),
    "maze80": (lambda: build_scene(MazeConfig(width=80, height=80)), (False, True)),
}


@pytest.mark.parametrize("t_min", [None, 0.0])
@pytest.mark.parametrize("name", list(RESIDENCY_SCENES))
def test_resident_decision_from_byte_counts(cuda_device, name, t_min):
    """The launcher takes the axis route for a scene with pass-1 tables and
    t_min > 0 when the pass-1 tables, tile table and walk order fit what a
    block may opt in to beside its warps' counts: with the whole scene's
    records and texture rows beside them where those fit too, else with
    the records in global memory. Otherwise, and with t_min <= 0, it keeps
    the whole scene in shared memory where it fits. It reports the route
    with the bytes it staged. config_scale's 64x64 maze is 216,276 bytes of
    records and tables, inside the H100's 232,448 less 1,280, but not with
    its 52,816 bytes of pass-1 tables, which alone fit."""
    build, (resident, axis) = RESIDENCY_SCENES[name]
    dev = upload_scene(build(), device=cuda_device)
    walked = sum(g[2] for g in dev.group_meta if g[2] > 1)
    tex = 32 * (dev.num_planes + dev.num_spheres) if dev.textured else 0
    records = 80 * dev.num_planes + 64 * dev.num_spheres + tex
    tables = 36 * dev.tiles.shape[0] + 4 * walked
    passes = 16 * (dev.axis_entries.shape[0] + dev.tiles.shape[0] + dev.axis_runs.shape[0])
    if name == "scale":
        assert records + tables == 2692 * 80 + 23 * 36 + 22 * 4 == 216_276
        assert passes == 16 * (548 * 2 + 2138 + 23 + 44) == 52_816
    # Beside them each block keeps its warps' counts (fused_tracer.COUNT_BYTES).
    limit = (torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
             - COUNT_BYTES)
    tracer = TracerConfig() if t_min is None else TracerConfig(t_min=t_min)
    want_axis = (tracer.t_min > 0 and dev.axis_entries.shape[0] > 0
                 and passes + tables <= limit)
    want_resident = records + (passes if want_axis else 0) + tables <= limit
    if limit == 232_448 - COUNT_BYTES and t_min is None:      # the H100's
        assert (want_resident, want_axis) == (resident, axis)
    o = torch.zeros((4096, 3), device=cuda_device)
    d = torch.nn.functional.normalize(torch.rand((4096, 3), device=cuda_device) - 0.5, dim=1)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    geo = {}
    trace_paths_fused(dev, o, d, seed, tracer, 8, geometry=geo)
    assert (geo["resident"], geo["axis"]) == (want_resident, want_axis)
    assert geo["smem"] == ((records if want_resident else 0) + (passes if want_axis else 0)
                           + tables)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("w,h,n_bands", [(1920, 1080, 2), (3840, 2160, 4), (64, 48, 3)])
def test_halo_present_kernel_bands_are_the_whole_screen(cuda_device, w, h, n_bands, quantize):
    """The halo variant band by band, with the rows ``_exchange_halo_rows``
    takes from the neighbours, put together is bitwise the no-halo kernel on
    the whole screen, and each band is bitwise its plain version."""
    cfg = ScreenConfig(width=w, height=h)
    band = ScreenConfig(width=w, height=h // n_bands)
    x = np.random.default_rng(1).random(
        (cfg.total_chunks, cfg.pixels_per_chunk * 3)).astype(np.float32) * 1.2 - 0.1
    s = torch.from_numpy(x).to(cuda_device)
    bands = list(s.chunk(n_bands))
    tops, bots = shard._exchange_halo_rows(bands, band)
    before = kernels.launches["present_halo"]
    got = [present(b, band, quantize, t, u) for b, t, u in zip(bands, tops, bots)]
    assert kernels.launches["present_halo"] == before + n_bands
    whole = present(s, cfg, quantize)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(got).view(torch.int32), whole.view(torch.int32))
    for g, b, t, u in zip(got, bands, tops, bots):
        assert torch.equal(g.view(torch.int32),
                           present_plain(b, band, quantize, t, u).view(torch.int32))
    # A halo that is not the neighbour's row shows in the band's edge rows only.
    other = present(bands[0], band, quantize, tops[0] + 0.5, bots[0])
    rows = cm_to_spatial(other != got[0], band).any(dim=2).any(dim=1)
    assert bool(rows[0]) and not bool(rows[1:].any())


def test_sphere_refresh_on_the_card(cuda_device):
    """A sphere moved on the device and refreshed is traced where it is:
    kernel against plain version on the refreshed scene, equal to a fresh
    upload of the moved scene, and the light differs from the unmoved one."""
    import dataclasses

    scene = cornell_scene("spheres")
    dev = upload_scene(scene, device=cuda_device)
    refresh = make_sphere_refresh(dev)
    centre = dev.sph_center.clone()
    centre[1] += torch.tensor([0.75, -0.5, 0.25], device=cuda_device)
    moved = refresh(dev._replace(sph_center=centre))
    fresh = upload_scene(dataclasses.replace(scene, sph_center=centre.cpu().numpy()),
                         device=cuda_device)
    assert torch.equal(moved.spheres, fresh.spheres) and torch.equal(moved.tiles, fresh.tiles)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in aimed_rays(scene, 100_000, 5, 4.5))
    got = _kernel_vs_plain(moved, o, d, TracerConfig(), 32)
    assert not torch.equal(got, _kernel_vs_plain(dev, o, d, TracerConfig(), 32))
    assert make_sphere_refresh(upload_scene(cornell_scene("blocks"), device=cuda_device)) is None


@pytest.mark.parametrize("n_bands", [2, 4])
def test_band_engine_on_the_card(cuda_device, n_bands):
    """The row-band engine with all bands on the one card: one tracer launch
    and one halo present per band and frame, the camera the single engine's,
    the bands' screens bitwise those of the plain halo blur
    (``pallas_present=False``), and the frame the CPU run's (golden rule)."""
    import dataclasses

    cfg = multi_tile_config(P, width=64, height=16 * n_bands)
    script = multi_tile_script(FrameInputs)
    scene = build_scene(cfg.maze)
    devices = [cuda_device] * n_bands
    init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, devices)
    kernels.reset_launches()
    st, frame = scan_fn(upload_scene(scene, device=cuda_device), init_fn(0), script)
    assert kernels.launches["tracer"] == kernels.launches["present_halo"] \
        == n_bands * len(script)
    assert kernels.launches["present"] == 0
    plain_cfg = dataclasses.replace(
        cfg, screen=dataclasses.replace(cfg.screen, pallas_present=False))
    p_init, p_scan = shard.make_sharded_scan_engine(plain_cfg, devices)
    pst, _ = p_scan(upload_scene(scene, device=cuda_device), p_init(0), script)
    for t in range(n_bands):
        assert torch.equal(st.screen[t], pst.screen[t])
        assert torch.equal(st.cam_center[t], st.cam_center[0])
    c_init, c_scan = shard.make_sharded_scan_engine(cfg, ["cpu"] * n_bands)
    _, want = c_scan(upload_scene(scene, device="cpu"), c_init(0), script)
    assert_frames_match(frame.cpu().numpy(), want.numpy())
    assert frame.float().mean() > 1.0


def test_scripted_run_on_the_card_matches_golden(cuda_device):
    cfg = golden_config()
    script = golden_script(FrameInputs)
    kernels.reset_launches()
    _, frame = run_scripted(upload_scene(build_scene(cfg.maze), device=cuda_device), cfg,
                            inputs=script)
    assert kernels.launches["tracer"] == kernels.launches["present"] == len(script)
    with np.load(GOLDEN) as z:
        assert_frames_match(frame, z["img"])


def test_multi_tile_scripted_run_on_the_card(cuda_device):
    """12 frames of the multi-tile, noise-seeded configuration: one launch
    of each kernel per frame, and the frame the plain versions give on the
    CPU (golden rule)."""
    cfg = multi_tile_config(P)
    script = multi_tile_script(FrameInputs)
    scene = build_scene(cfg.maze)
    kernels.reset_launches()
    _, frame = run_scripted(upload_scene(scene, device=cuda_device), cfg, inputs=script)
    assert kernels.launches["tracer"] == kernels.launches["present"] == len(script)
    _, want = run_scripted(upload_scene(scene, device="cpu"), cfg, inputs=script)
    assert_frames_match(frame, want)
    assert frame.mean() > 1.0


def test_float32_sqrt_on_the_card_is_correctly_rounded(cuda_device):
    """ops/vecmath.py sqrt takes the float64 root for PyTorch's CPU float32
    sqrt, which is not correctly rounded; the card's float32 sqrt is, so
    there the two are the same."""
    from mirror_maze_tpu_torch.ops.vecmath import sqrt

    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0)) * 100
    x = x.to(cuda_device)
    assert torch.equal(torch.sqrt(x), sqrt(x))
    assert torch.equal(sqrt(x).cpu(), sqrt(x.cpu()))


def test_normal_and_unit_sphere_on_the_card_are_the_cpus(cuda_device):
    """The jnp tracer's draws (XLA's erf_inv and log1p in float32 ops, each
    FMA emulated in float64) are the same bits on the card as on the CPU."""
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.ops.sampling import unit_sphere

    g = prng.normal(prng.PRNGKey(5, device=cuda_device), (4096, 3))
    assert g.device.type == "cuda"
    assert torch.equal(g.cpu(), prng.normal(prng.PRNGKey(5), (4096, 3)))
    ids = torch.arange(2048)
    u = unit_sphere(prng.fold_in(prng.PRNGKey(3, device=cuda_device), ids.to(cuda_device)), ())
    assert torch.equal(u.cpu(), unit_sphere(prng.fold_in(prng.PRNGKey(3), ids), ()))


@pytest.mark.parametrize("backend", ["brute", "exact", "bvh"])
def test_jnp_backends_on_the_card_match_the_cpu(cuda_device, backend):
    """The golden script with each jnp backend on the card and on the CPU:
    exact and bvh sum their products in the same order on both (frames
    bitwise), brute's matrix products may round otherwise (golden rule)."""
    cfg = golden_config().replace(intersector=backend)
    script = golden_script(FrameInputs)
    st_c, frame_c = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                                 inputs=script)
    st_g, frame_g = run_scripted(upload_scene(build_scene(cfg.maze), device=cuda_device), cfg,
                                 inputs=script)
    assert_frames_match(frame_g, frame_c)
    if backend != "brute":
        assert np.array_equal(frame_g, frame_c)
    for f in ("perm", "cursor", "key", "frame"):
        assert torch.equal(getattr(st_g, f).cpu(), getattr(st_c, f)), f


def test_server_frame_on_the_card_is_the_step_frame(cuda_device, monkeypatch):
    """The HTTP server driving an engine on the card: its /frame (as PNG) is
    bitwise the frame ``make_step`` gives at the same step, and the engine
    thread launched one tracer and one present a frame."""
    import json
    import time
    import urllib.request

    from mirror_maze_tpu_torch.runtime.loop import InteractiveLoop
    from mirror_maze_tpu_torch.runtime.server import EngineServer
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.runtime.step import make_step
    from mirror_maze_tpu_torch.utils import imageio

    cfg = golden_config()
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    n = 6
    base = make_step(scene, cfg)
    held = {"n": 0}

    def step_fn(st, inp):          # n idle frames, then the same state and frame
        if held["n"] < n:
            held["n"] += 1
            held["state"], held["frame"] = base(st, FrameInputs.idle())
        return held["state"], held["frame"]

    monkeypatch.setattr(imageio, "jpeg_bytes", lambda img, quality=85: None)
    kernels.reset_launches()
    eng = InteractiveLoop.from_engine(cfg, step_fn, init_state(cfg, 0, device=cuda_device))
    srv = EngineServer(None, cfg, port=0, engine=eng)
    srv.start()
    try:
        t0 = time.monotonic()
        while srv.stats()["frame"] < n + 2 and time.monotonic() - t0 < 60:
            time.sleep(0.02)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/frame", timeout=30) as r:
            assert r.headers["Content-Type"] == "image/png"
            got = imageio.decode_png(r.read())
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/stats", timeout=30).read())
    finally:
        srv.stop()
    assert stats["error"] is None
    assert kernels.launches["tracer"] == kernels.launches["present"] == n
    _, want = run_scripted(scene, cfg, n_frames=n)
    assert np.array_equal(got, want)


def test_thumb_slices_on_the_device(cuda_device):
    """The terminal thumbnail is a strided view on the card: only its pixels
    cross to the host."""
    from mirror_maze_tpu_torch.runtime.loop import InteractiveLoop

    frame = torch.randint(0, 255, (1080, 1920, 3), dtype=torch.uint8, device=cuda_device)
    small = InteractiveLoop._thumb(frame, 20)
    assert small.device == frame.device and small.shape == (54, 96, 3)
    assert small.data_ptr() == frame.data_ptr()
    assert np.array_equal(small.cpu().numpy(), frame.cpu().numpy()[::20, ::20])


def test_gloo_position_exchange_with_one_process_on_the_card(cuda_device):
    """A gloo process group of one: the exchange stages the position through
    the host and returns [1, 3] on the card."""
    import socket

    import torch.distributed as dist

    from mirror_maze_tpu_torch.parallel import initialize_multihost
    from mirror_maze_tpu_torch.parallel.multiplayer import make_position_exchange

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert initialize_multihost(f"localhost:{port}", 1, 0, timeout_s=30) == 1
    try:
        me = torch.tensor([1.5, -2.0, 3.25], device=cuda_device)
        got = make_position_exchange()(me)
        assert got.device == me.device and got.shape == (1, 3)
        assert torch.equal(got[0], me)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("seed", range(12))
def test_soak_scenes_on_the_card(cuda_device, seed):
    """The soak's random soups (tools/soak_kernel.py) at 4,096 rays: the
    kernel bitwise its plain version, under the default grid and the seed's
    drawn one, and within 1e-4 of the jnp tracer on >= 99% of rays."""
    from mirror_maze_tpu_torch.tools import soak_kernel

    rec = soak_kernel.check_case(soak_kernel.soak_case(seed, 4096, soak_kernel.CARD_ROWS),
                                 cuda_device)
    assert rec["geometry"]["blocks"] > 0
    assert rec["ok"], soak_kernel.format_record(rec)


# --- The step as captured CUDA graphs (runtime/graph.py) ---------------------


def _graph_vs_eager(cuda_device, cfg, script):
    """(graph state, graph frame, eager state, eager frame, the runner's
    StepGraphs, launches counted around the graph run) of one script."""
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn

    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    # The eager run first: it builds the kernels and the step's constants.
    est, eframe = make_scan_step_fn(cfg, len(script))(scene, init_state(cfg, device=cuda_device),
                                                      script)
    run = make_scan_step(scene, cfg)
    st = init_state(cfg, device=cuda_device)
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")     # no hidden host sync in the glue
    try:
        st, frame = run(st, script)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = dict(kernels.launches)
    torch.cuda.synchronize()
    return st, frame, est, eframe, run.runner.graphs[st.screen.device], counts


def _prng_free(counts: dict) -> dict:
    """The launch counts but the threefry kernel's: every draw of
    ops/prng.py launches it (counted as threefry, threefry_uniform,
    threefry_normal, threefry_normal_listed), and a test checks those
    apart."""
    return {k: v for k, v in counts.items() if not k.startswith("threefry")}


def _step_draws(cfg, script) -> dict:
    """The threefry launches of the step over ``script``: the frame's keys
    and seed are drawn inside the frame_setup launch and the jitter inside
    the camera_rays launch, so only a rotating frame launches the threefry
    kernel, for the permutation's split and bit draw a round."""
    from mirror_maze_tpu_torch.ops.prng import permutation_rounds

    turns = sum(bool(inp.rot_updated) for inp in script)
    return {"threefry": 2 * permutation_rounds(cfg.screen.total_chunks) * turns,
            "threefry_uniform": 0}


def _glue(n: int) -> dict:
    """The glue kernels' launches of n frames (or band frames): one each."""
    return {"frame_setup": n, "camera_rays": n, "resolve": n}


def _states_bitwise(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("intersector", ["pallas", "brute", "exact", "bvh"])
def test_graph_step_is_bitwise_the_eager_step(cuda_device, intersector):
    """The golden script through make_scan_step (a graph per input kind, the
    first frame of each kind eager) against the eager loop: every state
    field and the frame bitwise; one tracer and one present launch a frame,
    with a jnp backend one shade launch a segment, and with bvh one walk
    kernel launch a segment."""
    cfg = golden_config().replace(intersector=intersector)
    script = golden_script(FrameInputs)
    st, frame, est, eframe, graphs, counts = _graph_vs_eager(cuda_device, cfg, script)
    assert _states_bitwise(st, est) and torch.equal(frame, eframe)
    assert graphs.kinds == (False, True)
    assert graphs.eager_frames == 2 and graphs.replays == len(script) - 2
    want = {"present": len(script), **_glue(len(script))}
    if intersector == "pallas":
        want["tracer"] = len(script)
    else:
        want["shade"] = len(script) * cfg.tracer.max_segments
    if intersector == "bvh":
        want["bvh_walk"] = len(script) * cfg.tracer.max_segments
    assert _prng_free(counts) == want
    if intersector == "pallas":
        assert counts.get("threefry", 0) == _step_draws(cfg, script)["threefry"]
        assert counts.get("threefry_uniform", 0) == 0
    else:
        assert counts["threefry_normal"] == len(script)
        assert counts["threefry_normal_listed"] == len(script) * (cfg.tracer.max_segments - 1)
    assert float(frame.float().mean()) > 1.0


def test_graph_band_engine_is_bitwise_the_eager_bands(cuda_device):
    """Two bands on the one card, one graph per input kind holding both
    bands' steps, the halo rows and the halo presents: against the same
    body stepped eagerly on the card."""
    from mirror_maze_tpu_torch.runtime.graph import StepRunner
    from mirror_maze_tpu_torch.runtime.step import run_frames

    cfg = golden_config()
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    script = golden_script(FrameInputs)
    init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, [cuda_device] * 2)
    kernels.reset_launches()
    st, frame = scan_fn(scene, init_fn(0), script)
    counts = dict(kernels.launches)
    runner = scan_fn.runner_of(scene)
    graphs = runner.graphs[st.screen[0].device]
    eager = StepRunner(runner._body, graphs=False)
    est = run_frames(eager, init_fn(0), script)
    eframe = shard.assemble_frame(shard.band_frames(est, shard._band_screen_cfg(cfg, 2)))
    assert all(_states_bitwise(a, b) for a, b in zip(zip(*st), zip(*est)))
    assert torch.equal(frame, eframe)
    assert graphs.kinds == (False, True) and graphs.replays == len(script) - 2
    assert _prng_free(counts) == {"tracer": 2 * len(script), "present_halo": 2 * len(script),
                                  **_glue(2 * len(script))}
    # init_fn's draws are counted too: at least the turning frames' draws.
    band = cfg.replace(screen=shard._band_screen_cfg(cfg, 2))
    assert counts.get("threefry", 0) >= 2 * _step_draws(band, script)["threefry"]
    assert counts.get("threefry_uniform", 0) == 0


def test_graph_step_hands_back_states_no_later_call_writes(cuda_device):
    """A state and frame handed back stay as they were through later calls;
    a state passed again (no longer the last handed back) or changed in place
    is copied in, and the step gives what the eager step gives."""
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn, make_step

    cfg = golden_config()
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    script = golden_script(FrameInputs)
    run = make_scan_step(scene, cfg)
    eager = lambda st, frames: make_scan_step_fn(cfg, len(frames))(scene, st, frames)
    st0 = init_state(cfg, device=cuda_device)
    keep0 = [t.clone() for t in st0]
    st1, f1 = run(st0, script[:18])
    keep1, keep_f1 = [t.clone() for t in st1], f1.clone()
    st2, f2 = run(st1, script[18:])                     # chained: no copy in
    st2b, f2b = run(st1, script[18:])                   # st1 again: copied in
    for got, kept in ((st0, keep0), (st1, keep1)):
        assert all(torch.equal(a, b) for a, b in zip(got, kept))
    assert torch.equal(f1, keep_f1)
    assert _states_bitwise(st2, st2b) and torch.equal(f2, f2b)
    est, ef = eager(st1, script[18:])
    assert _states_bitwise(st2, est) and torch.equal(f2, ef)
    st2.screen.mul_(0.5)                                # changed in place after handing back
    got, gf = run(st2, script[:3])
    est, ef = eager(st2, script[:3])
    assert _states_bitwise(got, est) and torch.equal(gf, ef)
    # make_step, one frame a call, the state chained through.
    step, st = make_step(scene, cfg), init_state(cfg, device=cuda_device)
    frames = []
    for inp in script:
        st, f = step(st, inp)
        frames.append(f)
    est, ef = eager(init_state(cfg, device=cuda_device), script)
    assert _states_bitwise(st, est) and torch.equal(frames[-1], ef)
    assert not torch.equal(frames[0], frames[-1])


def test_graph_step_accepts_a_watchdog_rollback(cuda_device):
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn
    from mirror_maze_tpu_torch.runtime.watchdog import Watchdog

    cfg = golden_config()
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    script = golden_script(FrameInputs)
    run, wd = make_scan_step(scene, cfg), Watchdog(interval=1)
    st, _ = run(init_state(cfg, device=cuda_device), script[:10])
    assert wd.check(st) is st                           # snapshot taken
    st, _ = run(st, script[10:14])
    bad = st._replace(cam_center=torch.full_like(st.cam_center, float("nan")))
    back = wd.check(bad)
    assert wd.rollbacks == 1 and torch.isfinite(back.cam_center).all()
    got, frame = run(back, script[14:])
    est, eframe = make_scan_step_fn(cfg, len(script) - 14)(scene, back, script[14:])
    assert _states_bitwise(got, est) and torch.equal(frame, eframe)


# What each tracer launch of a ray adds to the counters whatever warp traces
# it; the warp counts depend on which rays the refill hands a warp.
PER_RAY_COUNTERS = ("ray_segments", "tests_needed")


@pytest.mark.parametrize("name", ["golden", "multi_tile"])
def test_graph_replays_add_to_the_tracer_counters_as_eager_launches(cuda_device, name):
    """A script through the eager loop and through make_scan_step (one eager
    frame a kind, the rest graph replays) adds the same per-ray counts to
    the tracer's counters; the call records the runner's spans once each,
    the eager frames and captures once a kind."""
    from mirror_maze_tpu_torch.render import fused_tracer
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn
    from mirror_maze_tpu_torch.utils import profiling

    if name == "golden":
        cfg, script = golden_config(), golden_script(FrameInputs)
    else:
        cfg, script = multi_tile_config(P), multi_tile_script(FrameInputs)
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    fused_tracer.reset_counters(cuda_device)
    est, _ = make_scan_step_fn(cfg, len(script))(scene, init_state(cfg, device=cuda_device),
                                                 script)
    eager = fused_tracer.counters(cuda_device)
    run = make_scan_step(scene, cfg)
    fused_tracer.reset_counters(cuda_device)
    profiling.reset_totals()
    st, _ = run(init_state(cfg, device=cuda_device), script)
    graphed = fused_tracer.counters(cuda_device)
    spans = profiling.totals()
    assert _states_bitwise(st, est)
    assert eager["ray_segments"] > 0
    assert {k: graphed[k] for k in PER_RAY_COUNTERS} == {k: eager[k] for k in PER_RAY_COUNTERS}
    graphs = run.runner.graphs[st.screen.device]
    assert {k: spans[k]["count"] for k in ("step.call", "step.upload", "step.replays",
                                           "step.hand_back", "step.display")} == dict.fromkeys(
        ("step.call", "step.upload", "step.replays", "step.hand_back", "step.display"), 1)
    assert spans["graph.eager"]["count"] == graphs.eager_frames == len(graphs.kinds)
    assert spans["graph.capture"]["count"] == len(graphs.kinds)
    assert spans["graph.capture"]["seconds"] == pytest.approx(graphs.capture_s)
    assert spans["step.replays"]["self_seconds"] < spans["step.replays"]["seconds"]


@pytest.mark.parametrize("name,rays", [("interactive", None), ("scale", 1 << 18)])
def test_tracer_counters_count_what_the_plain_version_counts(cuda_device, name, rays,
                                                             monkeypatch):
    """Frame 1 of config_interactive (every ray) and of config_scale (its
    first 2^18 rays): the kernel's light bitwise the plain version's, its
    live ray-segments and needed record tests those the plain version counts
    on the same rays, and the lane slots it issued at
    least those needed (32 lanes a warp-segment); its lane slots of the axis
    test at least the plain version's axis tests of the rays with finite o
    and d (``axis_tests``).

    One kind of ray is counted apart: a diffuse scatter that draws exactly
    the reversed normal leaves a zero direction, NaN once normalized. The
    kernel's slab test (fminf/fmaxf, which drop a NaN) can pass such a ray
    into a walked tile, where the plain version's (torch's min/max, which
    keep it) fails it; it hits nothing either way and dies, so the light
    is the same. The kernel's extra tests are those of the tiles that the
    plain slab test passes when run with the kernel's clamped reciprocal of
    a NaN, -BIG."""
    from _torch_tools import frame1_inputs
    from mirror_maze_tpu_torch.render import fused_tracer
    from mirror_maze_tpu_torch.render.pipeline import tracer_seed
    from mirror_maze_tpu_torch.runtime.state import init_state

    extra = dict(visits=0, tests=0, nan_tests=0)
    plain_slab = fused_tracer._slab_pass

    def slab(box, o, inv_d, tmin, alive):
        reach = plain_slab(box, o, inv_d, tmin, alive)
        kernel = plain_slab(box, o, torch.nan_to_num(inv_d, nan=-fused_tracer.BIG), tmin, alive)
        assert not bool((reach & ~kernel).any())
        if int(box[7]) > 0:
            n = int((kernel & ~reach).sum())
            extra["visits"] += n
            extra["tests"] += n * int(box[7])
            # (at most: the tile may hold fewer axis records than records)
            extra["nan_tests"] += int((reach & extra["bad"]).sum()) * int(box[7])
        return reach

    plain_nearest = fused_tracer._nearest

    def nearest(single, walk, o, d, t_min, alive, *args, **kw):
        # The rays whose o or d is not finite take the general test.
        extra["bad"] = alive & ~(torch.isfinite(o).all(dim=1) & torch.isfinite(d).all(dim=1))
        extra["nan_tests"] += int(extra["bad"].sum()) * sum(g[3] for g in single)
        return plain_nearest(single, walk, o, d, t_min, alive, *args, **kw)

    monkeypatch.setattr(fused_tracer, "_slab_pass", slab)
    monkeypatch.setattr(fused_tracer, "_nearest", nearest)

    cfg = P.NAMED_CONFIGS[name]()
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    ori, dirs, tkey, row = frame1_inputs(cfg, scene)
    ori, dirs = ori[:rays].contiguous(), dirs[:rays].contiguous()
    row = None if row is None else row[:rays].contiguous()
    seed, tc = tracer_seed(tkey), cfg.tracer
    anchor = init_state(cfg, device=cuda_device).camera(cfg).center
    fused_tracer.reset_counters(cuda_device)
    got = trace_paths_fused(scene, ori, dirs, seed, tc, tc.block_rows, anchor=anchor,
                            seed_row=row)
    c = fused_tracer.counters(cuda_device)
    stats = {}
    want = trace_paths_plain(scene, ori, dirs, seed, tc, tc.block_rows, anchor=anchor,
                             seed_row=row, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert c["ray_segments"] == stats["ray_segments"] > ori.shape[0]
    assert c["tests_needed"] == stats["plane_tests"] + stats["sphere_tests"] + extra["tests"]
    assert extra["visits"] <= 1e-5 * stats["tile_visits"]
    assert c["tests_needed"] <= c["tests_issued"]
    assert c["ray_segments"] <= 32 * c["warp_segments"]
    # Every record of the maze is an axis record, every one of
    # config_interactive's takes the axis route (config_scale's 6 of the
    # single-tile group do not): the plain version counts the tests of those
    # that do, and the kernel's lane slots of pass 1 hold at least those its
    # rays with finite o and d need.
    assert 0 < stats["axis_tests"] <= stats["plane_tests"]
    assert (stats["axis_tests"] == stats["plane_tests"]) == (name == "interactive")
    assert 0 < c["axis_tests"] <= c["tests_issued"]
    assert c["axis_tests"] >= stats["axis_tests"] - extra["nan_tests"]
    fused_tracer.reset_counters(cuda_device)
    assert set(fused_tracer.counters(cuda_device).values()) == {0}


def _glass_maze(cfg):
    return dataclasses.replace(cfg, maze=dataclasses.replace(cfg.maze, glass_prob=0.5),
                               tracer=dataclasses.replace(cfg.tracer, fresnel=True))


@pytest.mark.parametrize("name,rays", [("interactive", None), ("scale", 1 << 18),
                                       ("fuzzy", None), ("glass", None)])
def test_axis_route_light_of_frame_1_is_the_plain_tracers(cuda_device, name, rays):
    """Frame 1 of config_interactive, config_scale (its first 2^18 rays: the
    walk, pass 1 resident and the records in global memory), config_fuzzy
    (the seed row) and config_interactive with glass panes and Fresnel on
    (mode 6): every record of a maze is an axis record, the kernel takes the
    axis route, and its light is the plain version's bit for bit."""
    from _torch_tools import frame1_inputs
    from mirror_maze_tpu_torch.render.pipeline import tracer_seed
    from mirror_maze_tpu_torch.runtime.state import init_state

    cfg = (_glass_maze(P.NAMED_CONFIGS["interactive"]()) if name == "glass"
           else P.NAMED_CONFIGS[name]())
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    assert scene.has_glass == (name == "glass")
    ori, dirs, tkey, row = frame1_inputs(cfg, scene)
    ori, dirs = ori[:rays].contiguous(), dirs[:rays].contiguous()
    row = None if row is None else row[:rays].contiguous()
    seed, tc = tracer_seed(tkey), cfg.tracer
    anchor = init_state(cfg, device=cuda_device).camera(cfg).center
    geo = {}
    got = trace_paths_fused(scene, ori, dirs, seed, tc, tc.block_rows, anchor=anchor,
                            seed_row=row, geometry=geo)
    want = trace_paths_plain(scene, ori, dirs, seed, tc, tc.block_rows, anchor=anchor,
                             seed_row=row)
    torch.cuda.synchronize()
    assert geo["axis"] and geo["resident"] == (name != "scale")
    assert torch.equal(got, want)
    assert float(want.mean()) > 0


def _edge_rays(scene, n, seed):
    """Rays at the axis test's edges, a third each: along an axis (the other
    components +0 or -0); aimed through a corner of a quad (o = corner - 2 d
    with d of components +-1 or +-0.5: every plane through the corner is
    met at t = 2 exactly, so two, three or four records tie); and, among the
    rest, o or d with an infinite or NaN component. The others are random."""
    rng = np.random.default_rng(seed)
    o, d = scene_rays(scene, n, seed)
    k = n // 3
    axis = rng.integers(0, 3, k)
    d[:k] = np.where(rng.random((k, 3)) < 0.5, 0.0, -0.0)
    d[np.arange(k), axis] = rng.choice([1.0, -1.0], k)
    quads = np.asarray(scene.kind) != 3
    org, u, v = (np.asarray(a, np.float32)[quads] for a in (scene.origin, scene.u, scene.v))
    corners = np.concatenate([org, org + u, org + v, org + u + v]).astype(np.float32)
    c = corners[rng.integers(0, len(corners), k)]
    dc = rng.choice([1.0, -1.0, 0.5, -0.5], (k, 3)).astype(np.float32)
    d[k:2 * k], o[k:2 * k] = dc, c - np.float32(2) * dc
    bad = np.float32([np.nan, np.inf, -np.inf])
    m = n - 2 * k
    for arr in (o, d):
        pick = 2 * k + np.flatnonzero(rng.random(m) < 0.15)
        arr[pick, rng.integers(0, 3, len(pick))] = bad[rng.integers(0, 3, len(pick))]
    return o, d


@pytest.mark.parametrize("tiles", [None, {0: 16, 1: 32}])
def test_axis_route_at_the_edges_of_the_axis_test(cuda_device, tiles):
    """config_interactive's maze in its one tile a group, and the 16x16 maze
    in walked tiles of 16 and 32 (pass 1 by each lane alone and by the warp
    for one ray): rays along an axis, through the corners of the walls
    (exact ties of two to four records, summed in record order by the
    rescan), and rays whose o or d is infinite or NaN (the general test):
    the light bitwise the plain version's. With t_min = 0 the launcher
    takes the general route, bitwise too."""
    maze = config_interactive().maze if tiles is None else MazeConfig(width=16, height=16)
    scene = build_scene(maze)
    dev = upload_scene(scene, device=cuda_device, tile_by_mode=tiles)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in _edge_rays(scene, 60_000, 13))
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    anchor = torch.tensor([3.0, -1.0, 7.0], device=cuda_device)
    # Ties on the first segment: the most records at the nearest t of one
    # scan, the single-tile groups' joint one or a walked tile's.
    from mirror_maze_tpu_torch.render import fused_tracer

    t_min = float(np.float32(TracerConfig().t_min))
    ts = [fused_tracer._hit_ts(int(r[8]), dev.planes[int(r[6]):int(r[6]) + int(r[7])], o, d,
                               t_min, None, None) for r in dev.tiles.tolist()]
    n_single = sum(1 for g in dev.group_meta if g[2] == 1)
    scans = [torch.cat(ts[:n_single], dim=1)] + ts[n_single:]
    most = torch.stack([((t == t.min(dim=1).values[:, None]) & (t < fused_tracer.BIG)).sum(dim=1)
                        for t in scans]).max(dim=0).values
    assert int((most >= 2).sum()) > 100
    assert tiles is not None or int((most >= 3).sum()) > 100
    for tracer in (TracerConfig(bounce_limit=4, mirror_limit=6),
                   TracerConfig(bounce_limit=4, mirror_limit=6, t_min=0.0)):
        geo = {}
        got = trace_paths_fused(dev, o, d, seed, tracer, 8, anchor=anchor, geometry=geo)
        want = trace_paths_plain(dev, o, d, seed, tracer, 8, anchor=anchor)
        torch.cuda.synchronize()
        assert geo["axis"] == (tracer.t_min > 0)
        assert torch.equal(got, want)
        assert float(want.mean()) > 0


def test_graph_runners_on_two_streams_keep_their_own_work_counters(cuda_device):
    """Two runners replaying on two streams at once: each graph launches the
    tracer with its own refill counter pair (left zeroed), and each result
    is the eager step's."""
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.runtime.step import make_scan_step, make_scan_step_fn

    cfg = golden_config()
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    script = golden_script(FrameInputs)
    runs = [make_scan_step(scene, cfg) for _ in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    for run, s in zip(runs, streams):                   # capture both kinds
        with torch.cuda.stream(s):
            run(init_state(cfg, device=cuda_device), script[15:17])
    torch.cuda.synchronize()
    out = []
    for run, s in zip(runs, streams):                   # queued side by side
        with torch.cuda.stream(s):
            out.append(run(init_state(cfg, device=cuda_device), script))
    torch.cuda.synchronize()
    work = [run.runner.graphs[out[0][0].screen.device]._work for run in runs]
    assert work[0].data_ptr() != work[1].data_ptr()
    assert all(int(w.abs().sum()) == 0 for w in work)
    est, eframe = make_scan_step_fn(cfg, len(script))(scene, init_state(cfg, device=cuda_device),
                                                      script)
    for st, frame in out:
        assert _states_bitwise(st, est) and torch.equal(frame, eframe)


def test_failed_capture_raises(cuda_device):
    """A body that reads a tensor on the host cannot be captured: the call
    raises, and no graph of that kind is kept."""
    from mirror_maze_tpu_torch.runtime.graph import StepGraphs

    def body(state, inp, rotate):
        scale = float(inp[4])                           # a host read
        return state._replace(screen=state.screen * scale)

    from mirror_maze_tpu_torch.runtime.state import init_state

    cfg = golden_config()
    graphs = StepGraphs(body, cuda_device)
    rows = torch.ones((3, 5), device=cuda_device)
    with pytest.raises(RuntimeError):
        graphs.run(init_state(cfg, device=cuda_device), rows, [False] * 3)
    assert graphs.kinds == ()
    torch.cuda.synchronize()
    x = torch.ones(4, device=cuda_device)               # the context still works
    assert float((x * 2).sum()) == 8.0


# --- The BVH walk kernel (csrc/bvh_walk.cu) and the last graphed routes ------


@pytest.mark.parametrize("rays", ["random", "zero_components"])
@pytest.mark.parametrize("name", list(INTERSECT_SCENES))
def test_bvh_walk_kernel_matches_plain_bitwise(cuda_device, name, rays):
    """The walk kernel against the plain walk on the same rays on the card
    and on the CPU: t and idx bitwise; one launch a call."""
    from mirror_maze_tpu_torch.render import intersect
    from mirror_maze_tpu_torch.scene.bvh import traversal_bounds

    scene = intersect_scene(name)
    make = zero_component_rays if rays == "zero_components" else scene_rays
    o, d = make(scene, 4096, seed=7)
    dev = upload_scene(scene, device=cuda_device)
    p = dev.prims
    depth, leaf = traversal_bounds(p.bvh_left_first.cpu().numpy(), p.bvh_count.cpu().numpy())
    go, gd = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    before = kernels.launches["bvh_walk"]
    t, i = intersect.nearest_hit_bvh_kernel(p, go, gd, 0.1, depth, leaf)
    assert kernels.launches["bvh_walk"] == before + 1
    pt, pi = intersect.nearest_hit_bvh(p, go, gd, 0.1, depth, leaf)
    torch.cuda.synchronize()
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32)) and torch.equal(i, pi)
    cpu = upload_scene(scene, device="cpu").prims
    ct, ci = intersect.nearest_hit_bvh(cpu, torch.from_numpy(o), torch.from_numpy(d), 0.1, depth,
                                       leaf)
    assert torch.equal(t.cpu().view(torch.int32), ct.view(torch.int32))
    assert torch.equal(i.cpu(), ci)
    assert (ct < intersect.BIG).float().mean() > 0.05


def test_bvh_walk_kernel_folds_the_spheres_in_one_launch(cuda_device):
    """The Cornell box with a mirror and a glass sphere, rays from inside
    each sphere among random ones (the glass sphere's far root, the mirror
    sphere's none): one launch, bitwise the plain walk and its
    _merge_spheres, the spheres hit."""
    from mirror_maze_tpu_torch.render import intersect
    from mirror_maze_tpu_torch.scene.bvh import traversal_bounds

    scene = intersect_scene("spheres")
    o, d = scene_rays(scene, 8192, seed=19)
    o[:1024] = np.repeat(scene.sph_center, 512, axis=0)
    p = upload_scene(scene, device=cuda_device).prims
    depth, leaf = traversal_bounds(p.bvh_left_first.cpu().numpy(), p.bvh_count.cpu().numpy())
    go, gd = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    before = dict(kernels.launches)
    t, i = intersect.nearest_hit_bvh_kernel(p, go, gd, 0.1, depth, leaf)
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in kernels.launches.items()
                if v != before.get(k, 0)}
    assert launched == {"bvh_walk": 1}
    pt, pi = intersect.nearest_hit_bvh(p, go, gd, 0.1, depth, leaf)
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32)) and torch.equal(i, pi)
    assert not bool((pi[:512] == p.num_planes).any())           # no root from inside
    assert bool((pi[512:1024] == p.num_planes + 1).any())       # the far root
    assert float((pi >= p.num_planes).float().mean()) > 0.05


def test_bvh_walk_kernel_with_the_stack_at_its_limit(cuda_device):
    """A walk told the tree is BVH_STACK - 2 deep (the stack's 64 levels,
    the most the kernel takes) gives the plain walk's result."""
    from mirror_maze_tpu_torch.render import intersect
    from mirror_maze_tpu_torch.scene.bvh import traversal_bounds

    scene = intersect_scene("maze")
    o, d = scene_rays(scene, 4096, seed=29)
    p = upload_scene(scene, device=cuda_device).prims
    _, leaf = traversal_bounds(p.bvh_left_first.cpu().numpy(), p.bvh_count.cpu().numpy())
    go, gd = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    depth = intersect.BVH_STACK - 2
    pt, pi = intersect.nearest_hit_bvh(p, go, gd, 0.1, depth, leaf)
    t, i = intersect.nearest_hit_bvh_kernel(p, go, gd, 0.1, depth, leaf)
    assert torch.equal(t.view(torch.int32), pt.view(torch.int32)) and torch.equal(i, pi)


def test_bvh_walk_kernel_is_the_backend_on_the_card(cuda_device):
    """make_nearest_fn's bvh backend on a scene on the card launches the
    kernel and never the plain walk."""
    from mirror_maze_tpu_torch.render import intersect
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn

    cfg = golden_config().replace(intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    fn = scene_nearest_fn(scene, cfg)
    o, d = (torch.from_numpy(x).to(cuda_device) for x in scene_rays(intersect_scene("maze"),
                                                                     256, seed=3))
    intersect.walk_counts.clear()
    before = kernels.launches["bvh_walk"]
    fn(o, d)
    assert kernels.launches["bvh_walk"] == before + 1
    assert intersect.walk_counts["walks"] == 0
    with pytest.raises(ValueError, match="stack levels"):
        intersect.nearest_hit_bvh_kernel(scene.prims, o, d, 0.1, intersect.BVH_STACK, 2)


def test_graph_band_engine_with_the_bvh_walk(cuda_device):
    """Two bands with bvh on the one card: a graph per input kind (the walk
    kernel inside), bitwise the band body stepped eagerly."""
    from mirror_maze_tpu_torch.runtime.graph import StepRunner
    from mirror_maze_tpu_torch.runtime.step import run_frames

    cfg = golden_config().replace(intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    script = golden_script(FrameInputs)
    init_fn, scan_fn = shard.make_sharded_scan_engine(cfg, [cuda_device] * 2)
    kernels.reset_launches()
    st, frame = scan_fn(scene, init_fn(0), script)
    counts = dict(kernels.launches)
    runner = scan_fn.runner_of(scene)
    graphs = runner.graphs[st.screen[0].device]
    eager = StepRunner(runner._body, graphs=False)
    est = run_frames(eager, init_fn(0), script)
    eframe = shard.assemble_frame(shard.band_frames(est, shard._band_screen_cfg(cfg, 2)))
    assert all(_states_bitwise(a, b) for a, b in zip(zip(*st), zip(*est)))
    assert torch.equal(frame, eframe)
    assert graphs.kinds == (False, True) and graphs.replays == len(script) - 2
    assert _prng_free(counts) == {"bvh_walk": 2 * len(script) * cfg.tracer.max_segments,
                                  "shade": 2 * len(script) * cfg.tracer.max_segments,
                                  "present_halo": 2 * len(script), **_glue(2 * len(script))}
    assert counts["threefry_normal"] >= len(script)
    assert counts["threefry_normal_listed"] >= len(script) * (cfg.tracer.max_segments - 1)


@pytest.mark.parametrize("intersector", ["pallas", "bvh"])
def test_multiplayer_graph_is_bitwise_the_eager_step(cuda_device, intersector):
    """Player 1 of 3, both avatars moved by scripted positions: the body
    the engine captures (one replay a frame on the card) against the eager
    step given the same positions, states and frames bitwise."""
    from mirror_maze_tpu_torch.parallel import multiplayer as mp
    from mirror_maze_tpu_torch.runtime.graph import StepRunner
    from mirror_maze_tpu_torch.runtime.state import init_state
    from mirror_maze_tpu_torch.runtime.step import (
        derive_traversal_bounds,
        display,
        input_stack,
        upload_rows,
    )

    cfg = golden_config().replace(intersector=intersector)
    scene, slots = mp.avatar_scene(build_scene(cfg.maze), 3, 1, glow=0.25)
    dev = upload_scene(scene, device=cuda_device)
    bounds = derive_traversal_bounds(dev, cfg, None, None)
    runner = StepRunner(mp.multiplayer_body(cfg, dev, slots, [0, 2], *bounds), graphs=True)
    eager = eager_multiplayer_step(cfg, dev, slots, [0, 2], bounds)
    script = golden_script(FrameInputs)
    a = b = init_state(cfg, 0, device=cuda_device)
    kernels.reset_launches()
    for i, inp in enumerate(script):
        pos = np.array([[-6.0 + 0.1 * i, 0.0, -10.0], [0.0, 0.0, 0.0],
                        [-4.0, 0.5, -9.0 + 0.2 * i]], np.float32)
        row = np.concatenate([input_stack([inp]), pos.reshape(1, -1)], axis=1)
        a = runner(a, upload_rows(row, cuda_device), [inp.rot_updated])
        b, fb = eager(b, inp, torch.from_numpy(pos).to(cuda_device))
    graphs = runner.graphs[a.screen.device]
    assert _states_bitwise(a, b) and torch.equal(display(a, cfg), fb)
    assert graphs.kinds == (False, True) and graphs.replays == len(script) - 2
    assert graphs.eager_frames == 2


# --- The threefry kernel (csrc/threefry.cu) ----------------------------------

# Raw keys: PRNGKey(0), PRNGKey(7), PRNGKey(2^31 - 1) and one with both words
# above 2^31; counts around the kernel's 256-thread block and a large draw.
THREEFRY_KEYS = [(0, 0), (0, 7), (0, 2 ** 31 - 1), (0x9E3779B9, 0xDEADBEEF)]
THREEFRY_COUNTS = [1, 3, 1023, 1024, 1025, 2 ** 20 + 7]


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _threefry_launches() -> int:
    return sum(v for k, v in kernels.launches.items() if k.startswith("threefry"))


@pytest.mark.parametrize("n", THREEFRY_COUNTS)
def test_threefry_kernel_is_bitwise_the_plain_version_in_every_mode(cuda_device, n):
    """split, fold_in (int, int32 and int64 words), random_bits, uniform on
    two ranges and normal, each one launch, bitwise the plain version."""
    from mirror_maze_tpu_torch.ops import prng

    data = torch.arange(n, dtype=torch.int32, device=cuda_device) * 7919 - 5
    for words in THREEFRY_KEYS:
        key = torch.tensor(words, dtype=torch.int64, device=cuda_device)
        draws = [
            (lambda f: f(key, n), prng.split, prng.split_plain),
            (lambda f: f(key, data), prng.fold_in, prng.fold_in_plain),
            (lambda f: f(key, data.long() << 20), prng.fold_in, prng.fold_in_plain),
            (lambda f: f(key, n), prng.fold_in, prng.fold_in_plain),
            (lambda f: f(key, (n,)), prng.random_bits, prng.random_bits_plain),
            (lambda f: f(key, (n,), -1.0, 1.0), prng.uniform, prng.uniform_plain),
            (lambda f: f(key, (n, 1)), prng.uniform, prng.uniform_plain),
            (lambda f: f(key, (n,)), prng.normal, prng.normal_plain),
        ]
        for call, kernel, plain in draws:
            before = _threefry_launches()
            got = call(kernel)
            assert _threefry_launches() == before + 1, kernel.__name__
            assert _same_bits(got, call(plain)), (kernel.__name__, words, n)


def test_threefry_key_batches_as_the_jnp_tracer_draws(cuda_device):
    """Per-ray keys (render/tracer.py: two chained fold_in over the rays, the
    bounce folded in, normal triples and one uniform a key), a broadcast
    fold_in and a batched random_bits: bitwise the plain version."""
    from mirror_maze_tpu_torch.ops import prng

    n = 12288
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    key = torch.tensor(THREEFRY_KEYS[3], dtype=torch.int64, device=cuda_device)
    idx = torch.arange(n, dtype=torch.int32, device=cuda_device)
    seeds = (torch.rand(n, generator=gen, device=cuda_device) * float(1 << 24)).to(torch.int32)
    keys = prng.fold_in(prng.fold_in(key, idx), seeds)
    assert _same_bits(keys, prng.fold_in_plain(prng.fold_in_plain(key, idx), seeds))
    it_keys = prng.fold_in(keys, 3)
    assert _same_bits(it_keys, prng.fold_in_plain(keys, 3))
    assert _same_bits(prng.normal(it_keys, (3,)), prng.normal_plain(it_keys, (3,)))
    assert _same_bits(prng.uniform(prng.fold_in(it_keys, 1), ()),
                      prng.uniform_plain(prng.fold_in_plain(it_keys, 1), ()))
    assert _same_bits(prng.random_bits(keys[:7], (5,)), prng.random_bits_plain(keys[:7], (5,)))
    grid, words = keys[:3].reshape(3, 1, 2), torch.arange(4, device=cuda_device) * 1000003
    assert _same_bits(prng.fold_in(grid, words), prng.fold_in_plain(grid, words))
    assert _same_bits(prng.split(keys[5], 3), prng.split_plain(keys[5], 3))


def test_threefry_erf_inv_on_every_uniform_and_the_edges(cuda_device):
    """erf_inv on all 2^23 floats that uniform gives on [nextafter(-1, 0), 1),
    and on the edges no draw reaches or few do: +-1 (x * inf), +-0, the
    values around w = 5 (Giles' branch) and around |x| = sqrt(2) - 1 after
    squaring (log1p's branch), both signs; bitwise the plain version."""
    from mirror_maze_tpu_torch.ops import prng

    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    m = torch.arange(2 ** 23, dtype=torch.int32, device=cuda_device)
    floats = (m | 0x3F800000).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, device=cuda_device)
    u = torch.maximum(lo_t, floats * (torch.tensor(1.0, device=cuda_device) - lo_t) + lo_t)
    edges = []
    for centre in (np.sqrt(1.0 - np.exp(-5.0)), np.sqrt(float(prng._LOG1P_SMALL))):
        c = np.float32(centre).view(np.int32)
        edges += list((np.arange(c - 64, c + 65, dtype=np.int32)).view(np.float32))
    edges += [1.0, 0.0, float(np.nextafter(np.float32(1), np.float32(0))), 2.0 ** -24]
    e = torch.tensor(edges, dtype=torch.float32, device=cuda_device)
    x = torch.cat([u, e, -e])
    before = kernels.launches["threefry_erf_inv"]
    got = prng.erf_inv(x)
    assert kernels.launches["threefry_erf_inv"] == before + 1
    assert _same_bits(got, prng.erf_inv_plain(x))
    w = -prng.log1p(e * -e)
    assert bool((w < 5.0).any()) and bool((w >= 5.0).any())
    assert int(torch.isinf(got).sum()) == 2                 # +-1 -> +-inf


def test_threefry_erf_inv_on_every_float32_of_minus_one_one(cuda_device):
    """The ERFINV output on all 2,130,706,434 float32 patterns of [-1, 1]
    (tools/erf_inv_check.py): the step check finds no step where a native
    fmaf differs from prng.fma on the float64 chain, the all-native route
    never differs from the float64 route, and prng.erf_inv is erf_inv_plain
    bitwise."""
    from mirror_maze_tpu_torch.tools import erf_inv_check

    out = erf_inv_check.check(1, cuda_device)
    assert out["patterns"] == 2130706434
    assert erf_inv_check.differing_steps(out) == [], out["steps"]
    assert out["native_differs"] == 0 and out["output_differs"] == 0


def test_threefry_normal_on_2_26_counts(cuda_device):
    """normal over 2^26 counts (nearly all of the uniform's 2^23 values, both
    of Giles' branches and both of log1p's), one launch: bitwise the plain
    version."""
    from mirror_maze_tpu_torch.ops import prng

    key = torch.tensor(THREEFRY_KEYS[1], dtype=torch.int64, device=cuda_device)
    before = kernels.launches["threefry_normal"]
    got = prng.normal(key, (2 ** 26,))
    assert kernels.launches["threefry_normal"] == before + 1
    assert _same_bits(got, prng.normal_plain(key, (2 ** 26,)))


def test_threefry_in_a_graph_reads_the_key_and_data_on_every_replay(cuda_device):
    """The main path's draws captured into a CUDA graph (under the sync debug
    mode "error": no host read of a key): each replay draws from the key and
    frame the static buffers hold then, as the CPU does from the same ones."""
    from mirror_maze_tpu_torch.ops import prng

    key = torch.tensor([0, 1], dtype=torch.int64, device=cuda_device)
    frame = torch.tensor(1, dtype=torch.int32, device=cuda_device)

    def body(key, frame):
        rkey, key = prng.split(key)
        jkey, tkey = prng.split(prng.fold_in(key, frame))
        return (prng.uniform(jkey, (1025, 2), -1.0, 1.0), prng.randint(tkey, (), 0, 2 ** 31 - 1),
                prng.normal(prng.fold_in(jkey, 3), (3, 5)), prng.permutation(rkey, 192))

    body(key, frame)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with kernels.counting_capture() as counted, torch.cuda.graph(graph):
            outs = body(key, frame)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counted == {"threefry": 9, "threefry_uniform": 1, "threefry_normal": 1}
    for words, f in (((0x9E3779B9, 0xDEADBEEF), 2), ((0, 123456), 3), ((5, 6), -7)):
        key.copy_(torch.tensor(words, dtype=torch.int64))
        frame.fill_(f)
        graph.replay()
        want = body(key.cpu(), frame.cpu())
        for got, w in zip(outs, want):
            assert _same_bits(got.cpu(), w), (words, f)


# The shade kernel (csrc/shade.cu): name -> (scene, tracer settings, seed
# row), each stage of the kernel on rays from inside the scene.
SHADE_SETS = {
    "maze": ("maze", {}, False),
    "spheres": ("cornell-spheres", {}, False),
    "glass": ("spheres", dict(fresnel=True), False),
    "glass-no-fresnel": ("spheres", dict(fresnel=False), False),
    "textured": ("textured", {}, False),
    "seed_row": ("maze", {}, True),
    "sky": ("maze", dict(sky_strength=0.7), False),
}


def _shade_case(name, device):
    """(prims, tracer config, o, d, seed row or None, backend) of a set."""
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn

    kind, extra, use_row = SHADE_SETS[name]
    scene = {"cornell-spheres": lambda: cornell_scene("spheres"),
             "textured": lambda: textured_cornell("blocks")}.get(kind, lambda: intersect_scene(kind))()
    o, d = (torch.from_numpy(x).to(device) for x in scene_rays(scene, 4096, seed=4))
    row = torch.rand(4096, generator=torch.Generator().manual_seed(4)).to(device)
    cfg = P.EngineConfig(tracer=TracerConfig(bounce_limit=3, mirror_limit=3, **extra)).replace(
        intersector="bvh")
    dev = upload_scene(scene, device=device)
    return dev.prims, cfg.tracer, o, d, (row if use_row else None), scene_nearest_fn(dev, cfg)


@pytest.mark.parametrize("name", list(SHADE_SETS))
def test_shade_kernel_matches_plain_bitwise(cuda_device, name):
    """Every segment of the loop: the kernel's state (o, d, thr, light, mh,
    dc, alive) bitwise shade_segment_plain's on the same inputs, its live
    count and id list the live rays; one launch a segment."""
    from _torch_tools import shade_records_ok, shade_segments
    from mirror_maze_tpu_torch.ops import prng

    prims, tc, o, d, row, nearest = _shade_case(name, cuda_device)
    before = kernels.launches["shade"]
    records, st = shade_segments(prims, tc, o, d, prng.PRNGKey(11, device=cuda_device), nearest,
                                 seed_row=row)
    assert kernels.launches["shade"] == before + tc.max_segments
    assert shade_records_ok(records), records
    assert records[-1]["live_out"] < records[0]["live_in"] and float(st.light.mean()) > 0


def test_shade_kernel_on_the_sign_and_clamp_edges(cuda_device):
    """Directions along the hit plane (d.n = +0 and -0) and NaN ones, in the
    glass instance with Fresnel: bitwise the plain version on the card (side
    is -sign(d.n), 0 for +-0 and NaN as torch.sign has it)."""
    from _torch_tools import bits, edge_segment
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render.tracer import (
        PathState,
        shade_segment_kernel,
        shade_segment_plain,
    )

    prims = upload_scene(intersect_scene("spheres"), device=cuda_device).prims
    tc = TracerConfig(bounce_limit=3, mirror_limit=3, fresnel=True, sky_strength=0.5)
    st, t, idx, g = edge_segment(prims, 4096, cuda_device)
    u3 = prng.uniform(prng.PRNGKey(2, device=cuda_device), (4096,))
    want = shade_segment_plain(prims, tc, st, t, idx, g, u3, 1)
    got = shade_segment_kernel(prims, tc, st, t, idx, g, u3, 1)
    for f in PathState._fields:
        assert torch.equal(bits(getattr(got, f)), bits(getattr(want, f))), f


@pytest.mark.parametrize("name", ["maze", "spheres"])
def test_bvh_walk_kernel_walks_only_the_listed_rays(cuda_device, name):
    """With a live-id list the walk's t and idx on the listed rays are those
    of the walk of every ray, whatever their order; an empty list walks
    nothing; one launch a call either way."""
    from mirror_maze_tpu_torch.render import intersect
    from mirror_maze_tpu_torch.scene.bvh import traversal_bounds

    scene = intersect_scene(name)
    o, d = (torch.from_numpy(x).to(cuda_device) for x in scene_rays(scene, 8192, seed=23))
    p = upload_scene(scene, device=cuda_device).prims
    depth, leaf = traversal_bounds(p.bvh_left_first.cpu().numpy(), p.bvh_count.cpu().numpy())
    full_t, full_i = intersect.nearest_hit_bvh_kernel(p, o, d, 0.1, depth, leaf)
    gen = torch.Generator().manual_seed(1)
    ids = torch.randperm(8192, generator=gen).int().to(cuda_device)
    for n in (0, 1, 1000, 8192):
        count = torch.tensor([n], dtype=torch.int32, device=cuda_device)
        before = kernels.launches["bvh_walk"]
        t, i = intersect.nearest_hit_bvh_kernel(p, o, d, 0.1, depth, leaf, live=(ids, count))
        assert kernels.launches["bvh_walk"] == before + 1
        sel = ids[:n].long()
        assert torch.equal(t[sel].view(torch.int32), full_t[sel].view(torch.int32))
        assert torch.equal(i[sel], full_i[sel])


def test_trace_paths_on_the_card_is_the_parents(cuda_device):
    """config_bvh's frame 1 through trace_paths on the card (the shade
    kernel, the walk of the live rays from the second segment on): bitwise
    the loop that walks and shades every ray in torch ops, and the CPU's
    trace_paths; one walk, one shade and one normal draw a segment, the
    first over every ray and the others over the segment's live-id list."""
    from _torch_tools import frame1_rays, parent_trace_paths
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn
    from mirror_maze_tpu_torch.render.tracer import trace_paths

    cfg = P.NAMED_CONFIGS["bvh"]().replace(intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    ori, dirs, key = frame1_rays(cfg, scene, with_key=True)
    nearest = scene_nearest_fn(scene, cfg)
    kernels.reset_launches()
    got = trace_paths(scene.prims, ori, dirs, key, cfg.tracer, nearest)
    counts = dict(kernels.launches)
    segs = cfg.tracer.max_segments
    assert {k: counts.get(k) for k in ("shade", "bvh_walk", "threefry_normal",
                                       "threefry_normal_listed")} == dict(
        shade=segs, bvh_walk=segs, threefry_normal=1, threefry_normal_listed=segs - 1)
    want = parent_trace_paths(scene.prims, ori, dirs, key, cfg.tracer, nearest)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    cpu = upload_scene(build_scene(cfg.maze), device="cpu")
    on_cpu = trace_paths(cpu.prims, ori.cpu(), dirs.cpu(), key.cpu(), cfg.tracer,
                         scene_nearest_fn(cpu, cfg))
    assert torch.equal(got.cpu().view(torch.int32), on_cpu.view(torch.int32))


# The listed normal draw (ops/prng.py normal(..., rows=), the segment loop's
# draw from the second segment on): an int32 pattern no float32 draw gives
# (a NaN's), pre-filled in the output, marks the rows it must not write.
CANARY = -0x0BADF00D


def _listed_is_full(key, shape, rows) -> int:
    """Hold the listed draw against prng.normal's full draw: prng.normal(...,
    rows=) bitwise on the listed rows in one threefry_normal_listed launch,
    and its launch into a CANARY-filled output (tests/_torch_tools.py
    listed_normal) the same on those rows, every other row still CANARY.
    Returns the rows listed."""
    from _torch_tools import listed_normal
    from mirror_maze_tpu_torch.ops import prng

    full = prng.normal(key, shape)
    before = dict(kernels.launches)
    drawn = prng.normal(key, shape, rows=rows)
    assert kernels.launches["threefry_normal_listed"] == before.get(
        "threefry_normal_listed", 0) + 1
    assert kernels.launches["threefry_normal"] == before.get("threefry_normal", 0)
    got = listed_normal(key, shape, rows, CANARY)
    ids, count = rows
    n = int(count)
    listed = torch.zeros(full.shape[0], dtype=torch.bool, device=full.device)
    listed[ids[:n].long()] = True
    got, drawn, full = got.view(torch.int32), drawn.view(torch.int32), full.view(torch.int32)
    assert torch.equal(drawn[listed], full[listed]) and torch.equal(got[listed], full[listed])
    assert bool((got[~listed] == CANARY).all())
    return n


@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("count", ["0", "1", "a third", "R - 1", "R"])
def test_threefry_listed_normal_is_the_full_draw_on_the_listed_rows(cuda_device, count,
                                                                     per_ray):
    """A shuffled list over an odd R (the rest of ids garbage ids): one key
    and shape (R, 3), or per-ray keys [R, 2] and shape (3,); the rows drawn
    are the rows listed."""
    from mirror_maze_tpu_torch.ops import prng

    n_rays = 2 ** 20 + 7
    n = {"0": 0, "1": 1, "a third": n_rays // 3, "R - 1": n_rays - 1, "R": n_rays}[count]
    gen = torch.Generator().manual_seed(n)
    ids = torch.randperm(n_rays, generator=gen).int()
    ids[n:] = torch.randint(0, n_rays, (n_rays - n,), generator=gen, dtype=torch.int32)
    rows = (ids.to(cuda_device), torch.tensor([n], dtype=torch.int32, device=cuda_device))
    key = torch.tensor(THREEFRY_KEYS[3], dtype=torch.int64, device=cuda_device)
    if per_ray:
        idx = torch.arange(n_rays, dtype=torch.int32, device=cuda_device)
        key, shape = prng.fold_in(prng.fold_in(key, idx), 5), (3,)
    else:
        shape = (n_rays, 3)
    assert _listed_is_full(key, shape, rows) == n


@pytest.mark.parametrize("seed_row", [False, True])
def test_threefry_listed_normal_on_the_lists_of_a_frame(cuda_device, seed_row):
    """config_interactive's frame 1 through the segment loop with the walk
    (2,027,520 rays): at every segment from the second on, the listed draw
    on the shade kernel's own list is the full draw on the listed rows, from
    the segment key or (with a seed row) the rays' own keys."""
    from _torch_tools import frame1_rays, segment_lists
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn
    from mirror_maze_tpu_torch.render.tracer import seed_row_keys

    cfg = config_interactive().replace(intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    ori, dirs, key = frame1_rays(cfg, scene, with_key=True)
    n_rays = ori.shape[0]
    row = (torch.rand(n_rays, generator=torch.Generator().manual_seed(3)).to(cuda_device)
           if seed_row else None)
    _, lists = segment_lists(scene.prims, ori, dirs, key, cfg.tracer,
                             scene_nearest_fn(scene, cfg), seed_row=row)
    assert sorted(lists) == list(range(1, cfg.tracer.max_segments))
    ray_keys = None if row is None else seed_row_keys(key, row)
    drawn = []
    for it, rows in sorted(lists.items()):
        if ray_keys is None:
            drawn.append(_listed_is_full(prng.fold_in(key, it), (n_rays, 3), rows))
        else:
            drawn.append(_listed_is_full(prng.fold_in(ray_keys, it), (3,), rows))
    assert n_rays >= drawn[0] > drawn[-1]


@pytest.mark.parametrize("intersector", ["bvh", "brute"])
def test_trace_paths_with_listed_draws_is_the_full_draw_route(cuda_device, intersector,
                                                               monkeypatch):
    """One frame of config_interactive through trace_paths on the card, the
    normal triples drawn for the listed rays from the second segment on:
    bitwise the light of the same loop with every ray's triples drawn (the
    route before the list); one normal draw a segment, all but the first
    listed."""
    from _torch_tools import frame1_rays
    from mirror_maze_tpu_torch.ops import prng
    from mirror_maze_tpu_torch.render import tracer
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn

    cfg = config_interactive().replace(intersector=intersector)
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    ori, dirs, key = frame1_rays(cfg, scene, with_key=True)
    nearest = scene_nearest_fn(scene, cfg)
    listed = []
    draw_listed = prng.listed
    monkeypatch.setattr(prng, "listed", lambda d, rows: listed.append(1) or draw_listed(d, rows))
    kernels.reset_launches()
    got = tracer.trace_paths(scene.prims, ori, dirs, key, cfg.tracer, nearest)
    segs = cfg.tracer.max_segments
    assert kernels.launches["threefry_normal"] == 1 and len(listed) == segs - 1
    assert kernels.launches["threefry_normal_listed"] == segs - 1
    draws = tracer.segment_draws
    monkeypatch.setattr(tracer, "segment_draws",
                        lambda *a, rows=None: draws(*a))
    want = tracer.trace_paths(scene.prims, ori, dirs, key, cfg.tracer, nearest)
    assert len(listed) == segs - 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(got.mean()) > 0


def _route_frame(tkey):
    """A frame of the benchmark's reference whose only draw its route reads
    is the tracer key ``tkey``."""
    from portbench.reference import sim

    key = tuple(int(k) & 0xFFFFFFFF for k in tkey.tolist())
    return sim.Frame(1, None, None, None, None, 0, None, None, key, 0, None)


@pytest.mark.parametrize("name", ["interactive", "bvh"])
def test_walk_counters_are_the_segment_routes_counts(cuda_device, name):
    """The walk kernel's counters over a frame's segment loop on the card
    (every ray at the first segment, the live list after) are the
    benchmark's route ``segments`` counts on the same rays, its threads a
    grid for every ray at each segment, and its light the route's bit for
    bit."""
    from _torch_tools import frame1_rays
    from mirror_maze_tpu_torch.render import intersect
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn
    from mirror_maze_tpu_torch.render.tracer import trace_paths
    from portbench.reference import segments

    cfg = P.NAMED_CONFIGS[name]().replace(intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    ori, dirs, key = frame1_rays(cfg, scene, with_key=True)
    nearest = scene_nearest_fn(scene, cfg)
    intersect.reset_counters(cuda_device)
    got = trace_paths(scene.prims, ori, dirs, key, cfg.tracer, nearest)
    counts = intersect.counters(cuda_device)
    tc = dataclasses.asdict(cfg.tracer)
    route_scene = segments.build(dataclasses.asdict(cfg), cuda_device)
    stats = {}
    want = segments.trace(route_scene, ori, dirs, torch.arange(ori.shape[0], device=cuda_device),
                          [(_route_frame(key), ori.shape[0])], None, tc, stats=stats)
    assert counts == dict(walk_rays=stats["walk_rays"], walk_nodes=stats["walk_nodes"],
                          walk_threads=cfg.tracer.max_segments * -(-ori.shape[0] // 128) * 128)
    assert counts["walk_nodes"] > counts["walk_rays"] > ori.shape[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_walk_counters_add_under_graph_replay(cuda_device):
    """A walk captured into a CUDA graph adds its counts at every replay, as
    many as the eager launch; reset_counters zeroes them."""
    from _torch_tools import frame1_rays
    from mirror_maze_tpu_torch.render import intersect
    from mirror_maze_tpu_torch.render.pipeline import scene_nearest_fn

    cfg = P.NAMED_CONFIGS["bvh"]().replace(intersector="bvh")
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    ori, dirs = frame1_rays(cfg, scene)
    nearest = scene_nearest_fn(scene, cfg)
    ids = torch.randperm(ori.shape[0], device=cuda_device).int()
    count = torch.tensor([ori.shape[0] // 3], dtype=torch.int32, device=cuda_device)
    intersect.reset_counters(cuda_device)
    nearest(ori, dirs, live=(ids, count))
    eager = intersect.counters(cuda_device)
    assert eager["walk_rays"] == ori.shape[0] // 3 and eager["walk_nodes"] > 0
    assert eager["walk_threads"] == -(-ori.shape[0] // 128) * 128
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        nearest(ori, dirs, live=(ids, count))
    assert intersect.counters(cuda_device) == eager      # a capture runs nothing
    for _ in range(3):
        graph.replay()
    assert intersect.counters(cuda_device) == {k: 4 * v for k, v in eager.items()}
    intersect.reset_counters(cuda_device)
    assert set(intersect.counters(cuda_device).values()) == {0}


# --- The step's glue kernels (runtime/step.py frame_setup, render/frame_glue.py) ----


GLUE_CASES = ["golden:frame1", "golden:collide", "golden:walk", "golden:turn", "v0:frame1",
              "bvh:walk", "bands:frame1", "fuzzy:frame1", "scale:frame1"]


@pytest.mark.parametrize("name", GLUE_CASES)
def test_glue_kernels_match_plain_bitwise(cuda_device, name):
    """frame_setup, camera_rays and resolve each bitwise their plain versions
    on every buffer they write: the golden configuration's frame 1, a W move
    into a wall and a free one, a turn; config_v0 (1 spp) and config_bvh
    (4 spp) through the jnp tracer; config_interactive's second band (row0
    540); config_fuzzy's seed row; config_scale's window of 8,040 ids."""
    inputs = glue_inputs(name, cuda_device)
    before = {k: kernels.launches[k] for k in ("frame_setup", "camera_rays", "resolve")}
    out = glue_check(*inputs)
    assert all(v == 0 for v in out.values()), out
    assert {k: kernels.launches[k] - v for k, v in before.items()} == {
        "frame_setup": 1, "camera_rays": 1, "resolve": 2}


def test_frame_setup_collides_as_the_plain_version(cuda_device):
    """The colliding input's move is reverted by both, the free one is not."""
    from mirror_maze_tpu_torch.runtime import step

    for name, reverted in (("golden:collide", True), ("golden:walk", False)):
        cfg, scene, state, row, grid, _, _ = glue_inputs(name, cuda_device)
        got = step.frame_setup_kernel(scene, cfg, state, row, grid.effective_chunks_per_frame, grid)
        assert torch.equal(got.center, state.cam_center) == reverted, name


def test_frame_setup_raises_on_a_window_it_cannot_sort(cuda_device):
    """The guards run before the launch: a window larger than the queue and a
    sorted window of a grid past 2^16 chunks a side raise with no launch
    counted; MAX_SORT ids and one more (the tiled route) are one counted
    frame_setup launch each, and only the tiled route counts merge passes."""
    from mirror_maze_tpu_torch.runtime import step
    from mirror_maze_tpu_torch.runtime.state import init_state

    cfg = golden_config()
    cfg = cfg.replace(screen=dataclasses.replace(cfg.screen, width=1024, height=512,
                                                 sort_chunk_window=True))
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    state = init_state(cfg, device=cuda_device)
    row = torch.zeros(5, device=cuda_device)
    tall = dataclasses.replace(cfg.screen, width=4, height=4 * (step.MAX_GRID_SIDE + 1))
    before = kernels.launches["frame_setup"]
    merges = kernels.launches["frame_setup_merge"]
    with pytest.raises(ValueError, match="a window of"):
        step.frame_setup_kernel(scene, cfg, state, row, cfg.screen.total_chunks + 1, cfg.screen)
    with pytest.raises(ValueError, match="2\\^16 x 2\\^16"):
        step.frame_setup_kernel(scene, cfg, state, row, 12, tall)
    assert kernels.launches["frame_setup"] == before
    step.frame_setup_kernel(scene, cfg, state, row, step.MAX_SORT, cfg.screen)
    assert kernels.launches["frame_setup_merge"] == merges
    step.frame_setup_kernel(scene, cfg, state, row, step.MAX_SORT + 1, cfg.screen)
    assert kernels.launches["frame_setup"] == before + 2
    assert kernels.launches["frame_setup_merge"] == merges + 4     # 9 tiles
    torch.cuda.synchronize()


@pytest.mark.parametrize("spp", [1, 3, 8, 33, 64, 96])
def test_resolve_kernel_sums_in_the_plain_order(cuda_device, spp):
    """Light with negatives, -0 and NaN: NaN where the plain version has
    NaN, every other value bitwise; the rows of a screen, and in place."""
    from mirror_maze_tpu_torch.render import frame_glue

    rng = np.random.default_rng(spp)
    light = rng.random((16 * 24 * spp, 3)).astype(np.float32) * 3 - 0.5
    light[::97] = -0.0
    light[5::1013, 1] = np.nan
    light = torch.from_numpy(light).to(cuda_device)
    screen = torch.from_numpy(rng.random((100, 48)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.permutation(100)[:24].astype(np.int32)).to(cuda_device)
    want = frame_glue.resolve_plain(light, spp, screen, ids)
    assert glue_ndiff(frame_glue.resolve(light, spp, screen, ids), want) == 0
    same = screen.clone()
    assert frame_glue.resolve(light, spp, same, ids, in_place=True) is same
    assert glue_ndiff(same, want) == 0
    assert glue_ndiff(frame_glue.resolve(light, spp), frame_glue.resolve_plain(light, spp)) == 0


# Window sizes across the sort's regimes: one code, a warp's lanes, one
# warp's codes (128), the shared-memory steps past it, [main]'s 1,980,
# config_scale's 8,040 (8 codes a thread) and the most the kernel sorts (16).
SORT_WINDOWS = [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257, 1980, 2048, 2049, 8040, 16384]


# Windows past one block's sort (the tiled route): one id more than MAX_SORT
# on the 256 x 128 grid, config_scale's window at 7680x4320 (32,400 ids) and
# that grid's whole queue (2,073,600 ids, 1,013 tiles).
TILED_WINDOWS = [(16385, 1024, 512), (32400, 7680, 4320), (2073600, 7680, 4320)]


@pytest.mark.parametrize("n,width,height", TILED_WINDOWS)
def test_frame_setup_kernel_sorts_windows_past_one_block(cuda_device, n, width, height):
    """A sorted window of n > MAX_SORT ids popped across the end of a random
    queue, with a D + W move, a random key and frame: every tensor the
    kernel writes bitwise frame_setup_plain's; one counted frame_setup launch
    (the tiles and the setup block) and ceil(log2(tiles)) counted merge
    passes."""
    from mirror_maze_tpu_torch.runtime import step
    from mirror_maze_tpu_torch.runtime.state import init_state

    rng = np.random.default_rng(n)
    cfg = golden_config()
    cfg = cfg.replace(screen=dataclasses.replace(cfg.screen, sort_chunk_window=True))
    grid = dataclasses.replace(cfg.screen, width=width, height=height)
    total = grid.total_chunks
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    state = init_state(cfg, device=cuda_device)._replace(
        perm=torch.from_numpy(rng.permutation(total).astype(np.int32)).to(cuda_device),
        cursor=torch.tensor(total - n // 2 - 1 if n < total else 7, dtype=torch.int32,
                            device=cuda_device),
        key=torch.from_numpy(rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.int64))
        .to(cuda_device),
        frame=torch.tensor(int(rng.integers(1000)), dtype=torch.int32, device=cuda_device))
    row = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0], device=cuda_device)
    before = {k: kernels.launches[k] for k in ("frame_setup", "frame_setup_merge")}
    got = step.frame_setup_kernel(scene, cfg, state, row, n, grid)
    merges = {16385: 4, 32400: 4, 2073600: 10}[n]
    assert step.merge_passes(n, True) == merges
    assert {k: kernels.launches[k] - v for k, v in before.items()} == dict(
        frame_setup=1, frame_setup_merge=merges)
    want = step.frame_setup_plain(scene, cfg, state, row, n, grid)
    for f in want._fields:
        assert glue_ndiff(getattr(got, f), getattr(want, f)) == 0, f


@pytest.mark.parametrize("sort,n", [(True, n) for n in SORT_WINDOWS] + [(False, 1980)])
def test_frame_setup_kernel_is_bitwise_its_plain_version(cuda_device, sort, n):
    """A window of n ids popped across the end of the queue (the cursor n // 2
    + 1 before it) of a 256 x 128 chunk grid, sorted or not, with a D + W
    move, a random key and frame: every tensor the kernel writes bitwise
    frame_setup_plain's; one launch."""
    from mirror_maze_tpu_torch.runtime import step
    from mirror_maze_tpu_torch.runtime.state import init_state

    rng = np.random.default_rng(n)
    cfg = golden_config()
    grid = dataclasses.replace(cfg.screen, width=1024, height=512, sort_chunk_window=sort)
    cfg = cfg.replace(screen=grid)
    total = grid.total_chunks
    scene = upload_scene(build_scene(cfg.maze), device=cuda_device)
    state = init_state(cfg, device=cuda_device)._replace(
        perm=torch.from_numpy(rng.permutation(total).astype(np.int32)).to(cuda_device),
        cursor=torch.tensor(total - n // 2 - 1, dtype=torch.int32, device=cuda_device),
        key=torch.from_numpy(rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.int64))
        .to(cuda_device),
        frame=torch.tensor(int(rng.integers(1000)), dtype=torch.int32, device=cuda_device))
    row = torch.tensor([0.0, 0.0, 1.0, 1.0, 0.0], device=cuda_device)
    before = kernels.launches["frame_setup"]
    got = step.frame_setup_kernel(scene, cfg, state, row, n, grid)
    assert kernels.launches["frame_setup"] == before + 1
    want = step.frame_setup_plain(scene, cfg, state, row, n, grid)
    for f in want._fields:
        assert glue_ndiff(getattr(got, f), getattr(want, f)) == 0, f


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("spp", [1, 3, 8, 32, 33, 64, 96, 2048, 2080, 3816, 3817, 4096, 5000])
def test_resolve_kernel_is_bitwise_its_plain_version(cuda_device, spp, aligned):
    """112 pixels (3.5 blocks of 32) of light with negatives, -0 and NaN, on
    a 16-byte boundary or 12 bytes past one: the screen's rows and the
    colours without ids bitwise resolve_plain; one launch each. 2,048 and
    2,080 sum blocks of 32 runs; 3,816 is RESOLVE_MAX_SPP, the most a block
    stages, and 3,817, 4,096 and 5,000 take the pieces route."""
    from mirror_maze_tpu_torch.render import frame_glue

    assert frame_glue.RESOLVE_MAX_SPP == 3816
    rng = np.random.default_rng(spp)
    k = 16 * 7
    raw = rng.random((k * spp + 1, 3)).astype(np.float32) * 3 - 0.5
    raw[::97] = -0.0
    raw[5::1013, 1] = np.nan
    light = torch.from_numpy(raw).to(cuda_device)
    light = light[:-1] if aligned else light[1:]
    assert light.is_contiguous() and (light.data_ptr() % 16 == 0) == aligned
    screen = torch.from_numpy(rng.random((20, 48)).astype(np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.permutation(20)[:7].astype(np.int32)).to(cuda_device)
    before = kernels.launches["resolve"]
    got = frame_glue.resolve_kernel(light, spp, screen.clone(), ids)
    colours = frame_glue.resolve_kernel(light, spp, torch.empty(k, 3, device=cuda_device))
    assert kernels.launches["resolve"] == before + 2
    assert glue_ndiff(got, frame_glue.resolve_plain(light, spp, screen, ids)) == 0
    assert glue_ndiff(colours, frame_glue.resolve_plain(light, spp)) == 0


def test_resolve_kernel_takes_any_spp(cuda_device):
    """The C entry takes RESOLVE_MAX_SPP, the spp after it and 100,003 (a
    piece route of 3,126 runs, the last of 3 samples), bitwise the plain
    version; the wrapper raises only past 2^31 - 1 light values, before any
    launch."""
    from mirror_maze_tpu_torch.render import frame_glue

    most = frame_glue.RESOLVE_MAX_SPP
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for spp in (most, most + 1, 100003):
        light = torch.rand((3 * spp, 3), generator=gen, device=cuda_device) * 2 - 0.5
        before = kernels.launches["resolve"]
        got = frame_glue.resolve_kernel(light, spp, torch.empty(3, 3, device=cuda_device))
        assert kernels.launches["resolve"] == before + 1
        assert glue_ndiff(got, frame_glue.resolve_plain(light, spp)) == 0, spp
    spp = 1 << 20
    before = kernels.launches["resolve"]
    with pytest.raises(ValueError, match="2\\^31 - 1 light values"):
        frame_glue.resolve_kernel(torch.zeros(4, 3, device=cuda_device), spp,
                                  torch.empty(683, 3, device=cuda_device))
    assert kernels.launches["resolve"] == before
    torch.cuda.synchronize()
