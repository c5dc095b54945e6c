"""Plain Python models of the index schedules of two glue kernels, held
against the kernels' own constants and the plain versions.

- ``csrc/frame_setup.cu``: the bitonic sort of a window's Morton codes, a
  block of CODES codes a thread in registers. Each step of distance j is a
  register step (j < CODES: both codes in one thread), a lane step (j below
  a warp's codes: the partner is lane ``lane ^ (j / CODES)``'s register of the
  same index) or a shared-memory step. The model sorts with exactly that
  partition and checks where every partner lies.
  Past MAX_SORT ids the tiled route: a block a tile of TILE ids sorted by
  that network, then merge passes, each element placed at its index in
  its run plus the other run's codes below it; the model places every
  element as the merge kernel does and checks that each place is taken
  once.
- ``csrc/resolve.cu``: a block's pixels staged in shared memory in the
  light's order with PAD words after every run's floats; a lane a run of a
  pixel sums its three channels left to right; a lane a pixel's channel adds
  the runs. The model follows every index and checks that each staged word
  is written once, each run reads its samples in order, each output is
  written once, and the result is bitwise ``resolve_plain``. Past
  RESOLVE_MAX_SPP the pieces route: a block a pixel, a block of BLOCK_RUNS
  runs staged at a time, a lane a run's channel, lanes 0-2 carrying the
  channel's total from piece to piece; modelled the same way.

The constants (codes a thread, threads, RUN, pixels a block, the staging
budget) are read from the ``.cu`` sources' text, so model and kernel cannot
drift apart. No card needed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mirror_maze_tpu_torch.config import ScreenConfig
from mirror_maze_tpu_torch.render import frame_glue
from mirror_maze_tpu_torch.render.scheduler import sort_window_morton
from mirror_maze_tpu_torch.render.tracer import tone_map
from mirror_maze_tpu_torch.runtime import step

CSRC = Path(frame_glue.__file__).resolve().parent.parent / "csrc"
PAD_CODE = 0xFFFFFFFF


def constants(source: str) -> dict:
    """The arithmetic ``constexpr int NAME = expr;`` lines at the top level
    of a source, evaluated in order (an expression may name the constants
    before it)."""
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([\w\s*+-]+);",
                                 (CSRC / source).read_text(), re.M):
        out[name] = eval(expr, {}, dict(out))
    return out


SORT = constants("frame_setup.cu")
RESOLVE = constants("resolve.cu")


def test_the_models_read_the_kernels_constants():
    """The constants the models use are the sources', and the wrappers'
    limits agree with them."""
    assert {k: SORT[k] for k in ("MAX_SORT", "CODES", "WARP", "MAX_THREADS")} == dict(
        MAX_SORT=16384, CODES=4, WARP=32, MAX_THREADS=1024)
    assert SORT["MAX_SORT"] == step.MAX_SORT and SORT["MERGE_THREADS"] == 256
    assert SORT["TILE"] == step.TILE
    tile = SORT["TILE"]
    assert tile & (tile - 1) == 0 and SORT["WARP"] * SORT["CODES"] <= tile <= SORT["MAX_SORT"]
    assert {k: RESOLVE[k] for k in ("THREADS", "RUN", "RUN_FLOATS", "PAD", "PIXELS",
                                    "SMEM_BYTES", "BLOCK_RUNS")} == dict(
        THREADS=128, RUN=32, RUN_FLOATS=96, PAD=4, PIXELS=16, SMEM_BYTES=48 * 1024,
        BLOCK_RUNS=32)
    assert (RESOLVE["RUN"], RESOLVE["BLOCK_RUNS"]) == (frame_glue.RUN, frame_glue.BLOCK_RUNS)


# --- frame_setup's sort -------------------------------------------------------


def sort_geometry(n: int) -> tuple:
    """(width, codes a thread, threads) of a window of n ids: mm_frame_setup's
    choice (a power of two of at least a warp's CODES codes; more codes a
    thread where the width needs more than MAX_THREADS threads)."""
    width = SORT["WARP"] * SORT["CODES"]
    while width < n:
        width <<= 1
    codes = max(SORT["CODES"], width // SORT["MAX_THREADS"])
    return width, codes, max(width // codes, 2 * SORT["WARP"])


def sort_steps(width: int, codes: int) -> list:
    """The network's steps (k, j, kind) in the kernel's order."""
    steps, k = [], 2
    while k <= width:
        j = k >> 1
        while j > 0:
            kind = ("shared" if j >= SORT["WARP"] * codes else "lanes" if j >= codes
                    else "registers")
            steps.append((k, j, kind))
            j >>= 1
        k <<= 1
    return steps


def model_sort(codes_in: np.ndarray, width: int | None = None) -> np.ndarray:
    """The window's codes sorted as the kernel sorts them: padded to the
    width (mm_frame_setup's choice, or ``width``), element i held by thread
    i // codes, each step's partner checked against the step's kind."""
    n = codes_in.shape[0]
    width, codes, threads = sort_geometry(width or n)
    v = np.full(width, PAD_CODE, dtype=np.uint32)
    v[:n] = codes_in
    i = np.arange(width)
    thread, warp = i // codes, i // (codes * SORT["WARP"])
    assert threads * codes >= width and threads <= SORT["MAX_THREADS"]
    for k, j, kind in sort_steps(width, codes):
        partner = i ^ j
        if kind == "registers":
            assert (partner // codes == thread).all()
        elif kind == "lanes":
            lane = thread % SORT["WARP"]
            # lane ^ (j / codes), register e: the same element index ^ j
            assert ((thread ^ (j // codes)) * codes + i % codes == partner).all()
            assert (partner // (codes * SORT["WARP"]) == warp).all()
            assert ((lane ^ (j // codes)) < SORT["WARP"]).all()
        else:
            assert (partner // (codes * SORT["WARP"]) != warp).all()
        keep_min = ((i & j) == 0) == ((i & k) == 0)
        v = np.where(keep_min, np.minimum(v, v[partner]), np.maximum(v, v[partner]))
    return v


def morton(ids: np.ndarray, chunks_x: int) -> np.ndarray:
    def spread(x):
        x = x.astype(np.uint64) & 0xFFFF
        for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
            x = (x | (x << shift)) & mask
        return x
    return (spread(ids % chunks_x) | (spread(ids // chunks_x) << 1)).astype(np.uint32)


def unmorton(codes: np.ndarray, chunks_x: int) -> np.ndarray:
    def compact(x):
        x = x.astype(np.uint64) & 0x55555555
        for shift, mask in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF), (8, 0x0000FFFF)):
            x = (x | (x >> shift)) & mask
        return x
    return (compact(codes >> 1) * chunks_x + compact(codes)).astype(np.int32)


@pytest.mark.parametrize("n,counts", [
    (1, (13, 15, 0)), (128, (13, 15, 0)), (129, (15, 20, 1)), (1980, (21, 35, 10)),
    (8040, (36, 40, 15)), (16384, (50, 40, 15))])
def test_sort_steps_split_into_registers_lanes_and_shared_memory(n, counts):
    """(register, lane, shared-memory) steps: [main]'s 1,980 ids take 10 of
    the 66 steps through shared memory (4 codes a thread), config_scale's
    8,040 take 15 of 91 (8 codes a thread); a window of at most a warp's
    codes none."""
    width, codes, _ = sort_geometry(n)
    kinds = [kind for _, _, kind in sort_steps(width, codes)]
    assert tuple(kinds.count(k) for k in ("registers", "lanes", "shared")) == counts


def _window(rng, n: int, grid: ScreenConfig) -> np.ndarray:
    return rng.permutation(grid.total_chunks)[:n].astype(np.int32)


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 127, 128, 129, 255, 256, 257, 1980, 2048,
                               2049, 8040, 16384])
def test_sort_model_gives_the_plain_window_order(n):
    """Decoded, the model's first n codes are sort_window_morton's window on
    a 256 x 128 chunk grid (1024 x 512, chunks of 4), the padding last."""
    grid = ScreenConfig(width=1024, height=512, chunk_width=4, sort_chunk_window=True)
    ids = _window(np.random.default_rng(n), n, grid)
    v = model_sort(morton(ids, grid.chunks_x))
    assert (v[n:] == PAD_CODE).all()
    want = sort_window_morton(torch.from_numpy(ids), grid).numpy()
    assert np.array_equal(unmorton(v[:n], grid.chunks_x), want)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(2, 16384), seed=st.integers(0, 2 ** 32 - 1))
def test_sort_model_sorts_distinct_codes_at_every_width(n, seed):
    """Random distinct codes of a 480 x 270 chunk grid ([main]'s), any window
    from 2 to MAX_SORT: ascending, the padding codes last."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(480 * 270)[:n]
    codes = morton(ids, 480)
    v = model_sort(codes)
    assert np.array_equal(v[:n], np.sort(codes)) and (v[n:] == PAD_CODE).all()


def model_tiled_sort(codes_in: np.ndarray) -> tuple:
    """The tiled route of mm_frame_setup on a window of n > MAX_SORT codes:
    tiles of TILE sorted by the block network at the tile's width
    (``model_sort``; the padding left out of the scratch), then the merge
    passes, each element of run r placed at its index in r plus the codes of
    run r ^ 1 below it. Returns (the sorted codes, the launches: the tiles'
    and one a pass)."""
    n, tile = codes_in.shape[0], SORT["TILE"]
    assert n > SORT["MAX_SORT"]
    tiles = -(-n // tile)
    v = np.concatenate([model_sort(codes_in[t * tile:(t + 1) * tile], tile)[:min(tile, n - t * tile)]
                        for t in range(tiles)])
    i = np.arange(n, dtype=np.int64)
    run, launches = tile, 1
    while run < n:
        r = i // run
        other = (r ^ 1) * run
        length = np.clip(n - other, 0, run)
        below = np.zeros(n, dtype=np.int64)
        for o in np.unique(other[length > 0]):      # each run's codes, sorted
            mine = other == o
            below[mine] = np.searchsorted(v[o:o + run], v[mine], side="left")
        at = (r & ~1) * run + (i - r * run) + below
        assert np.array_equal(np.sort(at), i)       # every place taken once
        out = np.empty_like(v)
        out[at] = v
        v, run, launches = out, run * 2, launches + 1
    return v, launches


@pytest.mark.parametrize("n,grid", [
    (16385, (1024, 512)), (32400, (7680, 4320)), (32768, (1024, 512)), (32769, (2048, 1024)),
    (49153, (2048, 1024)), (100000, (2048, 1024)), (2073600, (7680, 4320))])
def test_tiled_sort_model_gives_the_plain_window_order(n, grid):
    """Windows past MAX_SORT: 16,385, the 8K window of config_scale at
    7680x4320 (32,400 of 1,920 x 1,080 chunks), whole tiles and one id more,
    odd tile counts, and the whole 8K queue: decoded, the model's codes are
    sort_window_morton's window, after one launch for the tiles and one a
    merge pass."""
    sc = ScreenConfig(width=grid[0], height=grid[1], chunk_width=4, sort_chunk_window=True)
    ids = _window(np.random.default_rng(n), n, sc)
    v, made = model_tiled_sort(morton(ids, sc.chunks_x))
    assert made == 1 + (-(-n // SORT["TILE"]) - 1).bit_length() == 1 + step.merge_passes(n, True)
    want = sort_window_morton(torch.from_numpy(ids), sc).numpy()
    assert np.array_equal(unmorton(v, sc.chunks_x), want)


# --- resolve's staging --------------------------------------------------------


def slot(f: int) -> int:
    return f + RESOLVE["PAD"] * (f // RESOLVE["RUN_FLOATS"])


def block_words(pixels: int, spp: int) -> int:
    floats, runs = pixels * 3 * spp, -(-spp // RESOLVE["RUN"])
    return (floats + RESOLVE["PAD"] * -(-floats // RESOLVE["RUN_FLOATS"])
            + pixels * 3 * runs)


def block_pixels(spp: int) -> int:
    """Pixels a block of mm_resolve: the most, up to PIXELS, that fit the
    staging budget; 0 past RESOLVE_MAX_SPP."""
    pixels = RESOLVE["PIXELS"]
    while pixels > 0 and block_words(pixels, spp) * 4 > RESOLVE["SMEM_BYTES"]:
        pixels -= 1
    return pixels


def test_resolve_max_spp_is_what_one_pixel_stages():
    most = frame_glue.RESOLVE_MAX_SPP
    assert block_pixels(most) == 1 and block_pixels(most + 1) == 0
    assert block_pixels(64) == RESOLVE["PIXELS"]


def model_resolve(light: np.ndarray, spp: int, k: int, ids, ppc: int, out: np.ndarray,
                  vector: bool) -> np.ndarray:
    """resolve_kernel's blocks, every index followed: ``light`` [k * spp * 3]
    float32 already tone-mapped (the kernel maps each value once, as it
    stages it), ``out`` the screen rows flattened (or the colours [k * 3]).
    Returns the writes an output element got."""
    run_, rf, threads = RESOLVE["RUN"], RESOLVE["RUN_FLOATS"], RESOLVE["THREADS"]
    pixels, span, runs = block_pixels(spp), 3 * spp, -(-spp // run_)
    writes = np.zeros(out.shape[0], dtype=np.int64)
    for k0 in range(0, k, pixels):
        n_px = min(pixels, k - k0)
        words = block_words(pixels, spp)
        sums_at = words - pixels * 3 * runs
        smem = np.full(words, np.nan, dtype=np.float32)
        staged = np.zeros(words, dtype=np.int64)
        # 1. The span in the light's order (the 16-byte route in fours).
        for f in range(n_px * span):
            smem[slot(f)] = light[k0 * span + f]
            staged[slot(f)] += 1
            if vector and f % 4 == 0:
                assert slot(f) % 4 == 0 and slot(f + 3) == slot(f) + 3
        assert staged[:sums_at].max() == 1 and staged[sums_at:].sum() == 0
        # 2. A lane a run: three channels, samples in order.
        sums = {}
        for t in range(n_px * runs):
            px, r = divmod(t, runs)
            f0 = px * span + r * rf
            if vector:
                assert slot(f0) % 4 == 0
            length = min(run_, spp - r * run_)
            acc = [None, None, None]
            for s in range(length):
                for c in range(3):
                    f = f0 + 3 * s + c
                    assert staged[slot(f)] == 1 and f // span == px and (f % span) // 3 == r * run_ + s
                    x = smem[slot(f)]
                    acc[c] = x if acc[c] is None else np.float32(acc[c] + x)
            for c in range(3):
                assert (px * 3 + c) * runs + r not in sums
                sums[(px * 3 + c) * runs + r] = acc[c]
        assert len(sums) == n_px * 3 * runs and max(sums) < pixels * 3 * runs
        # 3. A lane a pixel's channel: runs in order by blocks, the mean, the row.
        for t in range(3 * n_px):
            total = None
            for b in range(0, runs, RESOLVE["BLOCK_RUNS"]):
                block = sums[t * runs + b]
                for r in range(b + 1, min(runs, b + RESOLVE["BLOCK_RUNS"])):
                    block = np.float32(block + sums[t * runs + r])
                total = block if total is None else np.float32(total + block)
            px, c = divmod(t, 3)
            kk = k0 + px
            o = 3 * kk + c if ids is None else int(ids[kk // ppc]) * ppc * 3 + 3 * (kk % ppc) + c
            out[o] = np.float32(total * np.float32(frame_glue.reciprocal(spp)))
            writes[o] += 1
    assert threads >= 3 * pixels
    return writes


@pytest.mark.parametrize("spp", [1, 3, 8, 32, 33, 64, 96, 3816])
@pytest.mark.parametrize("with_ids", [True, False])
def test_resolve_model_writes_every_output_once_in_the_plain_order(spp, with_ids):
    """112 pixels (not a multiple of a block's) of light with negatives, -0
    and NaN: each output written once and bitwise resolve_plain, through the
    16-byte route where spp is a multiple of RUN."""
    rng = np.random.default_rng(spp)
    k, ppc = (16 * 7, 16) if spp < 3816 else (3, 1)
    raw = rng.random((k * spp, 3)).astype(np.float32) * 3 - 0.5
    raw[::97] = -0.0
    raw[5::1013, 1] = np.nan
    light = torch.from_numpy(raw)
    toned = tone_map(light).numpy().reshape(-1)
    vector = spp % RESOLVE["RUN"] == 0
    if with_ids:
        chunks = k // ppc
        screen = torch.from_numpy(rng.random((chunks + 13, ppc * 3)).astype(np.float32))
        ids = torch.from_numpy(rng.permutation(chunks + 13)[:chunks].astype(np.int32))
        out = screen.numpy().copy().reshape(-1)
        writes = model_resolve(toned, spp, k, ids.numpy(), ppc, out, vector)
        want = frame_glue.resolve_plain(light, spp, screen, ids).numpy().reshape(-1)
        rows = np.zeros(screen.shape[0], dtype=bool)
        rows[ids.numpy()] = True
        assert (writes.reshape(screen.shape)[rows] == 1).all()
        assert (writes.reshape(screen.shape)[~rows] == 0).all()
    else:
        out = np.full(k * 3, np.nan, dtype=np.float32)
        writes = model_resolve(toned, spp, k, None, 1, out, vector)
        want = frame_glue.resolve_plain(light, spp).numpy().reshape(-1)
        assert (writes == 1).all()
    same = (out.view(np.int32) == want.view(np.int32)) | (np.isnan(out) & np.isnan(want))
    assert same.all()


def model_resolve_pieces(light: np.ndarray, spp: int, k: int, ids, ppc: int,
                         out: np.ndarray) -> np.ndarray:
    """resolve_pieces_kernel's blocks (one a pixel), every index followed:
    ``light`` tone-mapped as in ``model_resolve``. Returns the writes an
    output element got."""
    run_, rf, pad, pr = RESOLVE["RUN"], RESOLVE["RUN_FLOATS"], RESOLVE["PAD"], \
        RESOLVE["BLOCK_RUNS"]
    span, runs = 3 * spp, -(-spp // run_)
    stage_words = pr * (rf + pad)
    assert 3 * pr <= RESOLVE["THREADS"] and stage_words * 4 + 3 * pr * 4 <= 48 * 1024
    writes = np.zeros(out.shape[0], dtype=np.int64)
    for kk in range(k):
        total = [None, None, None]
        for r0 in range(0, runs, pr):
            nr = min(pr, runs - r0)
            nf = min(nr * rf, span - r0 * rf)
            stage = np.full(stage_words, np.nan, dtype=np.float32)
            staged = np.zeros(stage_words, dtype=np.int64)
            for f in range(nf):                      # 1. the piece, in the light's order
                stage[slot(f)] = light[kk * span + r0 * rf + f]
                staged[slot(f)] += 1
            assert staged.max() == 1
            sums = {}
            for t in range(3 * nr):                  # 2. a lane a run's channel
                r, c = divmod(t, 3)
                length = min(run_, spp - (r0 + r) * run_)
                base = slot(r * rf)
                a = None
                for smp in range(length):
                    w = base + 3 * smp + c
                    assert w == slot(r * rf + 3 * smp + c) and staged[w] == 1
                    a = stage[w] if a is None else np.float32(a + stage[w])
                sums[(c, r)] = a
            for c in range(3):                       # 3. the piece's runs, then the total
                block = sums[(c, 0)]
                for r in range(1, nr):
                    block = np.float32(block + sums[(c, r)])
                total[c] = block if total[c] is None else np.float32(total[c] + block)
        for c in range(3):
            o = 3 * kk + c if ids is None else int(ids[kk // ppc]) * ppc * 3 + 3 * (kk % ppc) + c
            out[o] = np.float32(total[c] * np.float32(frame_glue.reciprocal(spp)))
            writes[o] += 1
    return writes


@pytest.mark.parametrize("spp", [3817, 4096, 5000])
@pytest.mark.parametrize("with_ids", [True, False])
def test_resolve_pieces_model_writes_every_output_once_in_the_plain_order(spp, with_ids):
    """Past RESOLVE_MAX_SPP (no pixel fits a block's staging: block_pixels is
    0): 4 pixels of light with negatives, -0 and NaN, every output written
    once and bitwise resolve_plain, through three whole pieces and a short
    one (3,817: 120 runs, the last of 9 samples), four whole pieces (4,096)
    and a last piece of 29 runs (5,000)."""
    assert block_pixels(spp) == 0
    rng = np.random.default_rng(spp)
    k, ppc = 4, 2
    raw = rng.random((k * spp, 3)).astype(np.float32) * 3 - 0.5
    raw[::97] = -0.0
    raw[5::1013, 1] = np.nan
    light = torch.from_numpy(raw)
    toned = tone_map(light).numpy().reshape(-1)
    if with_ids:
        screen = torch.from_numpy(rng.random((5, ppc * 3)).astype(np.float32))
        ids = torch.from_numpy(np.array([3, 0], dtype=np.int32))
        out = screen.numpy().copy().reshape(-1)
        writes = model_resolve_pieces(toned, spp, k, ids.numpy(), ppc, out)
        want = frame_glue.resolve_plain(light, spp, screen, ids).numpy().reshape(-1)
        assert (writes.reshape(screen.shape)[[3, 0]] == 1).all()
        assert writes.reshape(screen.shape)[[1, 2, 4]].sum() == 0
    else:
        out = np.full(k * 3, np.nan, dtype=np.float32)
        writes = model_resolve_pieces(toned, spp, k, None, 1, out)
        want = frame_glue.resolve_plain(light, spp).numpy().reshape(-1)
        assert (writes == 1).all()
    same = (out.view(np.int32) == want.view(np.int32)) | (np.isnan(out) & np.isnan(want))
    assert same.all()


def test_resolve_vector_reads_hit_distinct_bank_quads():
    """The 16-byte routes' shared-memory accesses at [main]'s 64 spp: the
    eight lanes of each quarter warp in phase 2 (a run a lane) read eight
    different 4-bank quads, and phase 3's lanes read runs' sums of one warp
    at most two to a bank."""
    spp, runs = 64, 2
    pixels = block_pixels(spp)
    starts = [slot(px * 3 * spp + r * RESOLVE["RUN_FLOATS"])
              for px in range(pixels) for r in range(runs)]
    for q in range(0, len(starts), 8):
        for step4 in range(RESOLVE["RUN_FLOATS"] // 4):
            quads = {((a + 4 * step4) % 32) // 4 for a in starts[q:q + 8]}
            assert len(quads) == len(starts[q:q + 8])
    for w in range(0, 3 * pixels, 32):
        for r in range(runs):
            banks = [(t * runs + r) % 32 for t in range(w, min(w + 32, 3 * pixels))]
            assert max(banks.count(b) for b in set(banks)) <= 2
