"""The normal draw at the rows of a live-id list (ops/prng.py ``normal(...,
rows=)``, ``listed``; csrc/threefry.cu ``mm_threefry_rows``) on the CPU.

From the second segment on, the card's segment loop (render/tracer.py
trace_paths) draws a segment's normal triples for the rays on the walk's
live-id list alone. Here the launch that ``segment_draws`` makes on the card
is read element by element as the kernel reads it: element e' < 3 * count
stands for the full draw's element e = 3 * ids[e' // 3] + e' % 3, hashed as
the full draw hashes e. Every listed row must be bitwise the full draw's
row, for one segment key and for the per-ray keys of a seed row, and every
other row must keep what the output held. On a CPU tensor the draw takes
every row. A malformed list raises on either device. The kernel itself is
held against the full draw on the card (tests/test_torch_cuda.py).
"""

import collections
import ctypes

import numpy as np
import pytest
import torch

from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.render.tracer import seed_row_keys, segment_draws

CANARY = -0x0BADF00D     # an int32 pattern no float32 draw gives (a NaN's)


def kernel_read(d: prng.Draw, out: torch.Tensor) -> torch.Tensor:
    """One launch of the threefry kernel into ``out``, element by element as
    csrc/threefry.cu reads its operands: every element, or with a live-id
    list the full draw's elements 3 * ids[e' // 3] + e' % 3 for e' < 3 *
    count; the plain versions' hash and float arithmetic."""
    if d.ids is None:
        e = torch.arange(d.total, dtype=torch.int64)
    else:
        i = torch.arange(min(prng.ROW * int(d.count[0]), d.total), dtype=torch.int64)
        e = prng.ROW * d.ids[i // prng.ROW].to(torch.int64) + i % prng.ROW
    if d.source == prng._IOTA:
        m, c = e // d.per_key, e % d.per_key
    else:
        m = e
        c = (torch.full_like(e, d.data_imm) if d.data is None
             else d.data.reshape(-1)[e * d.data_stride].to(torch.int64) & prng.MASK)
    keys = d.keys.reshape(-1, 2)[m * d.key_stride]
    b1, b2 = prng.threefry2x32(keys[:, 0], keys[:, 1], 0, c)
    flat = out.view(-1, 2) if d.output == prng._PAIR else out.view(-1)
    if d.output == prng._PAIR:
        flat[e] = torch.stack([b1, b2], dim=-1)
    else:
        assert d.output == prng._NORMAL, "the segment loop draws keys and normals"
        bits = b1 ^ b2
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        lo = torch.tensor(float(np.nextafter(np.float32(-1.0), np.float32(0.0))))
        u = torch.maximum(lo, floats * (torch.tensor(1.0) - lo) + lo)
        flat[e] = prng.erf_inv_plain(u) * prng._SQRT2
    return out


def card_route(monkeypatch) -> collections.Counter:
    """Make ops/prng.py take its card route on CPU tensors, each launch read
    by ``kernel_read`` into an output pre-filled with CANARY; returns the
    launches by kind (listed or full)."""
    made = collections.Counter()

    def launch(d):
        made["listed" if d.ids is not None else "full"] += 1
        out = torch.full(d.shape, CANARY, dtype=torch.int32).view(d.dtype) \
            if d.dtype == torch.float32 else torch.full(d.shape, CANARY, dtype=d.dtype)
        return kernel_read(d, out)

    monkeypatch.setattr(prng, "on_card", lambda t, name: True)
    monkeypatch.setattr(prng, "launch_draw", launch)
    return made


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def live_list(n_rays: int, count: int, seed: int):
    """(ids, count): ``count`` distinct rays in a shuffled order, as the
    shade kernel appends them, the rest of ``ids`` garbage ids."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randperm(n_rays, generator=gen).to(torch.int32)
    ids[count:] = torch.randint(0, n_rays, (n_rays - count,), generator=gen, dtype=torch.int32)
    return ids, torch.tensor([count], dtype=torch.int32)


# (rays, listed rays as a share of them, the segment, per-ray keys)
LISTS = {
    "odd R, a third, one key": (1001, 1 / 3, 1, False),
    "odd R, a third, seed row": (1001, 1 / 3, 1, True),
    "R = 2^17 + 3, one percent, one key": (2 ** 17 + 3, 0.01, 6, False),
    "R = 2^17 + 3, one percent, seed row": (2 ** 17 + 3, 0.01, 6, True),
    "count 0, one key": (777, 0.0, 12, False),
    "count 0, seed row": (777, 0.0, 12, True),
    "count R, one key": (4099, 1.0, 2, False),
    "count R, seed row": (4099, 1.0, 2, True),
}


@pytest.mark.parametrize("case", list(LISTS))
def test_a_listed_draw_is_the_full_draw_at_every_listed_row(case, monkeypatch):
    """``segment_draws`` with a list: on the CPU every row of the full draw;
    on the card's route one listed launch whose rows on the list are bitwise
    the full draw's and whose other rows keep the output's CANARY."""
    n_rays, share, it, per_ray = LISTS[case]
    key = prng.fold_in(prng.PRNGKey(2 ** 31 + 5), n_rays)
    row = torch.rand(n_rays, generator=torch.Generator().manual_seed(it)) if per_ray else None
    ray_keys = None if row is None else seed_row_keys(key, row)
    n_live = round(share * n_rays)
    rows = live_list(n_rays, n_live, seed=n_rays + it)
    full, u3 = segment_draws(key, ray_keys, it, n_rays, False)
    assert u3 is None and full.shape == (n_rays, 3)
    on_cpu, _ = segment_draws(key, ray_keys, it, n_rays, False, rows=rows)
    assert torch.equal(bits(on_cpu), bits(full))

    made = card_route(monkeypatch)
    g, _ = segment_draws(key, ray_keys, it, n_rays, False, rows=rows)
    assert made["listed"] == 1 and g.shape == (n_rays, 3)
    listed = torch.zeros(n_rays, dtype=torch.bool)
    listed[rows[0][:n_live].long()] = True
    assert torch.equal(bits(g)[listed], bits(full)[listed])
    assert bool((bits(g)[~listed] == CANARY).all())
    monkeypatch.undo()
    # Without a list the card's route draws every row, as before.
    made = card_route(monkeypatch)
    g, _ = segment_draws(key, ray_keys, it, n_rays, False)
    assert made["listed"] == 0 and torch.equal(bits(g), bits(full))


def _bad(kind: str, n_rays: int):
    ids, count = live_list(n_rays, n_rays // 2, seed=1)
    return {"short ids": (ids[:-1], count), "int64 ids": (ids.long(), count),
            "two counts": (ids, torch.zeros(2, dtype=torch.int32)),
            "float count": (ids, count.float()),
            "strided ids": (torch.zeros(2 * n_rays, dtype=torch.int32)[::2], count),
            "ids on another device": (ids.to("meta"), count),
            "not a tensor": (ids, n_rays // 2)}[kind]


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("kind", ["short ids", "int64 ids", "two counts", "float count",
                                  "strided ids", "ids on another device", "not a tensor",
                                  "rows of one", "rows of six"])
def test_a_malformed_list_or_draw_raises(kind, card, monkeypatch):
    """The list is the walk's (int32 [R] ids, int32 [1] count, contiguous,
    on the keys' device) and the draw has rows of 3 over the list's R, on
    the CPU as on the card's route; nothing is launched."""
    n_rays = 64
    key = prng.PRNGKey(9)
    made = card_route(monkeypatch) if card else collections.Counter()
    if kind == "rows of one":
        call = lambda: prng.normal(key, (n_rays,), rows=live_list(n_rays, 3, seed=2))  # noqa: E731
    elif kind == "rows of six":
        call = lambda: prng.normal(key, (n_rays, 6), rows=live_list(n_rays, 3, seed=2))  # noqa: E731
    else:
        call = lambda: prng.normal(key, (n_rays, 3), rows=_bad(kind, n_rays))  # noqa: E731
    with pytest.raises(ValueError, match="live-id list|rows of 3"):
        call()
    assert not made


def test_the_listed_entry_is_the_full_draws_with_the_list():
    """mm_threefry_rows takes mm_threefry's operands and the list's two
    pointers, and launches the full draw's template instance: no new source
    or output, one kernel template."""
    (_, _, (symbol, argtypes)) = kernels.LIBRARIES["threefry"]
    rows = kernels.ENTRIES[("threefry", "mm_threefry_rows")]
    assert rows == argtypes[:-1] + [ctypes.c_void_p] * 3
    text = (kernels.CSRC / "threefry.cu").read_text()
    assert 'extern "C" int mm_threefry_rows(' in text
    assert "enum Source { IOTA = 0, DATA32 = 1, DATA64 = 2, VALUES = 3 };" in text
    assert text.count("__global__ void __launch_bounds__(THREADS) threefry_kernel(") == 1
    assert "constexpr unsigned ROW = 3;" in text and prng.ROW == 3
