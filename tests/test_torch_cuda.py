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
    aimed_rays,
    assert_frames_match,
    checker_floor,
    cornell_scene,
    golden_config,
    golden_script,
    mesh_gallery_scene,
    multi_tile_config,
    multi_tile_script,
    primitive_zoo,
    scene_subset,
    soup_arrays,
    textured_cornell,
    textured_maze_scene,
    tied_floor_scene,
)
from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.config import MazeConfig, ScreenConfig, TracerConfig, config_interactive
from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused, trace_paths_plain
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


# name -> (scene, resident on a card whose block may opt in to 232,448 B)
RESIDENCY_SCENES = {
    "interactive": (_maze("interactive"), True),
    "scale": (_maze("scale"), True),
    "scale_glass": (_maze("scale", glass_prob=0.5), True),
    "fuzzy": (_maze("fuzzy"), True),
    "cornell_glass": (lambda: cornell_scene("glass"), True),
    "mesh": (mesh_gallery_scene, True),
    "mesh_checker": (lambda: checker_floor(mesh_gallery_scene()), True),
    "maze80": (lambda: build_scene(MazeConfig(width=80, height=80)), False),
}


@pytest.mark.parametrize("name", list(RESIDENCY_SCENES))
def test_resident_decision_from_byte_counts(cuda_device, name):
    """The launcher keeps the whole scene in shared memory when its records,
    texture rows, tile table and walk order fit what a block may opt in to,
    and reports that with the bytes it staged. config_scale's 64x64 maze is
    216,276 bytes, inside the H100's 232,448."""
    build, resident = RESIDENCY_SCENES[name]
    dev = upload_scene(build(), device=cuda_device)
    walked = sum(g[2] for g in dev.group_meta if g[2] > 1)
    tex = 32 * (dev.num_planes + dev.num_spheres) if dev.textured else 0
    records = 80 * dev.num_planes + 64 * dev.num_spheres + tex
    tables = 36 * dev.tiles.shape[0] + 4 * walked
    if name == "scale":
        assert records + tables == 2692 * 80 + 23 * 36 + 22 * 4 == 216_276
    limit = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    if limit == 232_448:                    # the H100's
        assert (records + tables <= limit) == resident
    o = torch.zeros((4096, 3), device=cuda_device)
    d = torch.nn.functional.normalize(torch.rand((4096, 3), device=cuda_device) - 0.5, dim=1)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda_device)
    geo = {}
    trace_paths_fused(dev, o, d, seed, TracerConfig(), 8, geometry=geo)
    assert geo["resident"] == (records + tables <= limit)
    assert geo["smem"] == (records if geo["resident"] else 0) + tables


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
