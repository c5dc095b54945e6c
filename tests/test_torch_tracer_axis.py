"""The tracer kernel's axis route, modelled in NumPy float32 on the CPU.

csrc/tracer.cu tests an axis record (scenebuf.py ``axis_tables``) in pass 1
as t = (sign(n_A) d - o_A) * (1 / d_A), s = (w_B o_B - b) + t (w_B d_B),
takes the record at the nearest t as the general scan (``row_t``) would,
and where records tie on it, scans again in record order. Here both tests
are written with one IEEE float32 operation a step in the kernel's order,
and held to each other: the same t bits, or no effect in both (a value that
is not below BIG changes no running hit). Then the two passes against the
sequential scan on built ties, and the upload's tables.
"""

import dataclasses

import numpy as np
import pytest

import mirror_maze_tpu_torch as P
from _torch_tools import cornell_scene, mesh_gallery_scene, primitive_zoo, scene_subset
from mirror_maze_tpu_torch.render.fused_tracer import COUNT_BYTES
from mirror_maze_tpu_torch.render.scenebuf import (
    AXIS_EDGES,
    AXIS_GENERAL,
    AXIS_MIN_RECORDS,
    axis_classes,
    axis_tables,
    build_sphere_table,
    plane_records,
    ordered_plane_table,
    tile_table,
    upload_scene,
)
from mirror_maze_tpu_torch.scene import build_scene

F = np.float32
BIG = F(1e30)
T_MIN = F(P.TracerConfig().t_min)
OPTIN = 232_448          # the shared memory an H100 block may opt in to


def _f(x):
    return np.asarray(x, np.float32)


def general_t(rec, mode, o, d, t_min=T_MIN):
    """row_t: records [N, 20] against rays o, d [N, 3], one op a step."""
    n, w1, w2 = rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]
    dot = lambda w, v: (w[:, 0] * v[:, 0] + w[:, 1] * v[:, 1]) + w[:, 2] * v[:, 2]
    numer = rec[:, 3] - dot(n, o)
    t = numer * (F(1) / dot(n, d))
    ok = t > t_min
    if AXIS_EDGES.get(mode, 2) or mode in (4, 7):
        s1 = (dot(w1, o) - rec[:, 7]) + t * dot(w1, d)
        if mode in (0, 1, 6):
            ok &= (s1 >= 0) & (F(1) - s1 >= 0)
        if mode in (0, 4, 6, 7):
            s2 = (dot(w2, o) - rec[:, 11]) + t * dot(w2, d)
            if mode in (4, 7):
                ok &= (s1 >= 0) & (s2 >= 0) & (F(1) - (s1 + s2) >= 0)
            else:
                ok &= (s2 >= 0) & (F(1) - s2 >= 0)
    return np.where(ok, t, BIG)


def axis_t(ent, code, mode, o, d, t_min=T_MIN):
    """axis_min's test: pass-1 entries [N, 8] (two float4s) of classes
    ``code`` [N], against rays o, d [N, 3], with 1 / d per ray."""
    rows = np.arange(len(code))
    a, b, c = code % 3, code // 3 % 3, code // 9
    inv = F(1) / d
    t = (ent[:, 0] - o[rows, a]) * inv[rows, a]
    ok = t > t_min
    if AXIS_EDGES[mode] >= 1:
        s1 = (ent[:, 1] * o[rows, b] - ent[:, 2]) + t * (ent[:, 1] * d[rows, b])
        ok &= (s1 >= 0) & (s1 <= 1)
    if AXIS_EDGES[mode] == 2:
        s2 = (ent[:, 4] * o[rows, c] - ent[:, 5]) + t * (ent[:, 4] * d[rows, c])
        ok &= (s2 >= 0) & (s2 <= 1)
    return np.where(ok, t, BIG)


def entries_of(rec, mode):
    """Each axis record's pass-1 entry [N, 8] and class [N], from the
    record alone (what axis_tables lays out)."""
    code = axis_classes(rec, mode)
    assert (code != AXIS_GENERAL).all()
    rows = np.arange(len(rec))
    ent = np.zeros((len(rec), 8), np.float32)
    ent[:, 0] = rec[rows, code % 3] * rec[:, 3]
    ent[:, 1], ent[:, 2] = rec[rows, 4 + code // 3 % 3], rec[:, 7]
    ent[:, 4], ent[:, 5] = rec[rows, 8 + code // 9], rec[:, 11]
    return ent, code


def assert_same_effect(g, a):
    """The same t bits, or no effect in both."""
    with np.errstate(invalid="ignore"):
        same = (g.view(np.int32) == a.view(np.int32)) | (~(g < BIG) & ~(a < BIG))
    assert same.all(), (g[~same][:5], a[~same][:5])


def _preset_records():
    """(records [P, 20], mode [P]) of both presets' quad tiles."""
    out = []
    for name in ("interactive", "scale"):
        table = ordered_plane_table(build_scene(P.NAMED_CONFIGS[name]().maze))
        rec, counts = plane_records(table)
        mode = np.repeat(np.arange(len(counts)), counts)
        out.append((rec, mode))
    return (np.concatenate([r for r, _ in out]), np.concatenate([m for _, m in out]))


@pytest.fixture(scope="module")
def preset_records():
    return _preset_records()


def _aimed(rec, mode, n, rng):
    """n rays aimed at points of the records' planes around their quads (s
    in [-0.2, 1.2] along each tested edge), from 0.001 to 60 units away,
    and every fourth in a uniform direction."""
    pick = rng.integers(0, len(rec), n)
    r = rec[pick]
    m = mode[pick]
    p = rng.uniform(-330, 330, (n, 3)).astype(np.float32)
    rows = np.arange(n)
    a = np.argmax(r[:, 0:3] != 0, axis=1)
    p[rows, a] = r[rows, a] * r[:, 3]
    tested = np.array([AXIS_EDGES.get(k, 0) for k in range(8)])[m]
    for cols, bcol, edges in ((slice(4, 7), 7, 1), (slice(8, 11), 11, 2)):
        w = r[:, cols]
        k = np.argmax(w != 0, axis=1)
        use = tested >= edges
        s = rng.uniform(-0.2, 1.2, n).astype(np.float32)
        wk = w[rows, k]
        with np.errstate(divide="ignore", invalid="ignore"):
            val = ((s + r[:, bcol]) / wk).astype(np.float32)
        p[rows[use], k[use]] = val[use]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.exp(rng.uniform(np.log(1e-3), np.log(60), n)).astype(np.float32)
    o = (p - d * dist[:, None]).astype(np.float32)
    free = rng.random(n) < 0.25
    o[free] = rng.uniform(-330, 330, (free.sum(), 3)).astype(np.float32)
    return r, m, o, d


def test_axis_test_gives_the_general_tests_bits_on_the_presets_records(preset_records):
    """2^20 seeded (ray, record) pairs drawn from both presets' records,
    every mode they have: the axis form's t is the general form's, bit for
    bit, or neither has an effect."""
    rec, mode = preset_records
    rng = np.random.default_rng(20)
    n = 1 << 20
    r, m, o, d = _aimed(rec, mode, n, rng)
    hits = 0
    with np.errstate(all="ignore"):
        for md in np.unique(m):
            sel = m == md
            ent, code = entries_of(r[sel], int(md))
            g = general_t(r[sel], int(md), o[sel], d[sel])
            a = axis_t(ent, code, int(md), o[sel], d[sel])
            assert_same_effect(g, a)
            hits += int((g < BIG).sum())
    assert hits > n // 4


def _axis_record(a, sa, dval, b=None, w1=0.0, b1=0.0, c=None, w2=0.0, b2=0.0):
    rec = np.zeros(20, np.float32)
    rec[a] = sa
    rec[3] = dval
    if b is not None:
        rec[4 + b], rec[7] = w1, b1
    if c is not None:
        rec[8 + c], rec[11] = w2, b2
    return rec


def _edge_rays():
    """Rays at the forms' edges: +-0 in o and d, d_A = +-0, origins on the
    plane, tiny (subnormal) and huge directions and origins, t at t_min."""
    vals = [0.0, -0.0, 1.0, -1.0, 0.5, 2.0, 1e-30, -1e-30, 1e-40, -1e-40, 1e30, -1e30,
            3.0e38, 1e-7, 2.0 - 1e-7, 4.0]
    rng = np.random.default_rng(5)
    o = _f(rng.choice(vals, (20000, 3)))
    d = _f(rng.choice(vals, (20000, 3)))
    return o, d


@pytest.mark.parametrize("mode", [0, 1, 2, 6])
@pytest.mark.parametrize("sa", [1.0, -1.0])
def test_axis_test_at_the_edges_of_the_forms(mode, sa):
    """Built records (normal +-x, +-y or +-z; edge vectors of power-of-two
    and of real maze widths) against rays with +-0, d_A = +-0, origins on
    the plane, subnormal and huge components: the same bits or no effect
    in both. The cases t = t_min, s = 0 and s = 1 exactly occur."""
    o, d = _edge_rays()
    seen = dict(t_min=0, s0=0, s1=0)
    with np.errstate(all="ignore"):
        for a in range(3):
            b, c = (a + 1) % 3, (a + 2) % 3
            for w1, b1 in ((0.5, -1.0), (-0.05, -0.1), (1.5625e-03, -0.5), (0.25, 0.0)):
                for dval in (0.0, -0.0, 2.0, -320.00098, 1e-7):
                    rec = _axis_record(a, sa, dval, b, w1, b1, c, w1, b1)
                    recs = np.repeat(rec[None], len(o), axis=0)
                    ent, code = entries_of(recs, mode)
                    g = general_t(recs, mode, o, d)
                    assert_same_effect(g, axis_t(ent, code, mode, o, d))
                    # t exactly t_min: the ray starts t_min before the plane.
                    oo = np.zeros((1, 3), np.float32)
                    dd = np.zeros((1, 3), np.float32)
                    dd[0, a] = 1.0
                    oo[0, a] = sa * dval - T_MIN
                    for _ in range(8):   # walk o_A by ulps until t == t_min
                        t = (F(sa * dval) - oo[0, a]) * (F(1) / dd[0, a])
                        if t == T_MIN:
                            break
                        oo[0, a] = np.nextafter(oo[0, a], F(-np.inf) if t < T_MIN else F(np.inf))
                    r1 = rec[None]
                    e1, c1 = entries_of(r1, mode)
                    assert_same_effect(general_t(r1, mode, oo, dd), axis_t(e1, c1, mode, oo, dd))
                    seen["t_min"] += int((F(sa * dval) - oo[0, a]) * (F(1) / dd[0, a]) == T_MIN)
                    # s exactly 0 and 1: o_B on the edge line, d_B = 0.
                    for s in (0.0, 1.0):
                        oe = np.zeros((1, 3), np.float32)
                        oe[0, b] = F((F(s) + F(b1)) / F(w1))
                        de = np.zeros((1, 3), np.float32)
                        de[0, a] = -sa
                        assert_same_effect(general_t(r1, mode, oe, de),
                                           axis_t(e1, c1, mode, oe, de))
                        sv = F(w1) * oe[0, b] - F(b1)
                        seen["s0" if s == 0 else "s1"] += int(sv == F(s))
    assert seen["t_min"] > 0 and seen["s0"] > 0 and seen["s1"] > 0


# ---- the two passes against the sequential scan -------------------------

def sequential(rec, mode, props, o, d, t, own):
    """scan_rows on one ray: the running (t, summed properties) after the
    records in order; ``own`` as the kernel's flag."""
    t0, acc = t, None
    for k in range(len(rec)):
        tv = general_t(rec[k:k + 1], mode, o[None], d[None])[0]
        if tv < t0:
            t0, acc, own = tv, props[k].copy(), True
        elif tv == t0 and own and tv < BIG:
            acc = acc + props[k]
    return t0, acc


TIED = -1


def fold(ts, ks):
    """axis_min's fold (csrc/tracer.cu fold_min) of hit distances ``ts``
    (+inf on a miss) of records ``ks``, in the order given: the nearest t
    and the record at it, or TIED where two records or more are at it."""
    lm, li = BIG, 0
    for tv, k in zip(ts, ks):
        li = k if tv < lm else (TIED if tv == lm else li)
        lm = min(lm, tv)
    return lm, li


def two_pass(rec, mode, props, o, d, t, own):
    """Pass 1 in class order (the axis form), then, in record order with the
    general form, the record at the nearest t, or where records tie on it,
    the whole scan: as the kernel's single-tile groups (own) and walked
    tiles (not own)."""
    code = axis_classes(rec, mode)
    order = np.argsort(code, kind="stable")
    ent, _ = entries_of(rec, mode)
    ts = axis_t(ent[order], code[order], mode, np.repeat(o[None], len(rec), 0),
                np.repeat(d[None], len(rec), 0))
    lm, li = fold(np.where(ts < BIG, ts, F(np.inf)), order)
    if not lm < t:
        return t, None
    lo, hi = (0, len(rec) - 1) if li == TIED else (li, li)
    return sequential(rec[lo:hi + 1], mode, props[lo:hi + 1], o, d, t, own)


def _corner_scene():
    """Axis quads around the corner (1, 1, 1) of a unit cell and beyond:
    three mutually perpendicular faces meeting there, two coplanar faces
    sharing the edge x = 1 on the plane z = 1, and distant walls, in an
    order that is not their class order."""
    q = lambda a, sa, dv, b, c: _axis_record(a, sa, dv, b, 1.0, 0.0, c, 1.0, 0.0)
    return np.stack([
        q(1, 1.0, 7.0, 0, 2),         # a far floor
        q(0, 1.0, 1.0, 1, 2),         # x = 1, y and z in [0, 1]
        q(2, 1.0, 1.0, 0, 1),         # z = 1, x and y in [0, 1]
        q(1, -1.0, -1.0, 2, 0),       # y = 1 (normal -y), z and x in [0, 1]
        _axis_record(2, 1.0, 1.0, 0, 1.0, 1.0, 1, 1.0, 0.0),    # z = 1, x in [1, 2]
        q(0, -1.0, -9.0, 2, 1),       # a far wall
    ])


@pytest.mark.parametrize("own,t_in", [(True, BIG), (False, BIG), (False, F(1.5)),
                                      (False, F(1.0)), (False, F(0.5))])
def test_ordered_rescan_sums_ties_as_the_sequential_scan(own, t_in):
    """Rays at the corner (1, 1, 1) (four records: three faces and the
    coplanar neighbour), the 3-way corner (1, 0, 1), the 2-way shared edge
    x = 1 of the plane z = 1, and elsewhere, with an incoming running hit:
    pass 1 and the rescan (the record at the nearest t, or on a tie the
    whole scan in record order) give the sequential scan's nearest t and
    its properties summed in its order, bit for bit (the properties are
    picked so that another order of summing rounds differently)."""
    rec = _corner_scene()
    rng = np.random.default_rng(3)
    props = _f(rng.uniform(0.1, 1.0, (len(rec), 6)) * np.array([1, 1e-7, 1e7, 3, 1e-3, 7]))
    rays = [((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5)),
            ((0.25, 0.5, 0.0), (0.75, 0.25, 1.0)), ((2.0, 0.5, 0.0), (-1.0, 0.0, 1.0)),
            ((0.5, -0.5, 0.0), (0.5, 0.5, 1.0)), ((1.0, 0.25, 0.0), (0.0, 0.0, 0.5)),
            ((1.0, 0.5, 0.0), (0.0, 0.0, 1.0)), ((0.5, 0.5, -3.0), (0.0, 0.0, 1.0))]
    rays += [(tuple(rng.uniform(-2, 3, 3)), tuple(rng.normal(size=3))) for _ in range(200)]
    ties = set()
    with np.errstate(all="ignore"):
        for o, d in rays:
            o, d = _f(o), _f(d)
            for mode in (0, 1, 2):
                want = sequential(rec, mode, props, o, d, t_in, own)
                got = two_pass(rec, mode, props, o, d, t_in, own)
                assert want[0].view(np.int32) == got[0].view(np.int32)
                if want[1] is None:
                    assert got[1] is None
                else:
                    assert np.array_equal(want[1].view(np.int32), got[1].view(np.int32))
                    ts = general_t(rec, mode, np.repeat(o[None], len(rec), 0),
                                   np.repeat(d[None], len(rec), 0))
                    ties.add(int((ts == want[0]).sum()))
    if t_in > 1.0:
        assert {2, 3, 4} <= ties


# ---- the upload's tables ---------------------------------------------------

def _decode(entries, rows, runs, tiles):
    """For each tile: [(the record's index in its scan, class, entry)] in
    entry order."""
    out = []
    for ti, tile in enumerate(tiles):
        first_run, n_runs, n_axis, slots = rows[ti]
        got = []
        for r in runs[first_run:first_run + n_runs]:
            width = max(1, AXIS_EDGES[int(tile[8])])
            for e in range(r[1]):
                ent = entries[r[0] + e * width:r[0] + (e + 1) * width].reshape(-1)
                got.append((int(ent[3:4].view(np.int32)[0]), int(r[2]), ent))
        out.append(got)
    return out


def _tables(scene, tiles=None):
    table = ordered_plane_table(scene)
    rec, _ = plane_records(table)
    tiles, meta = tile_table(table, tiles, build_sphere_table(scene))
    n_single = sum(1 for g in meta if g[2] == 1)
    base = np.cumsum([0] + [int(t[7]) for t in tiles[:n_single]] + [0] * (len(tiles) - n_single))
    base[n_single:] = 0
    return rec, tiles, base, axis_tables(rec, tiles, meta)


@pytest.mark.parametrize("name", ["interactive", "scale", "fuzzy"])
def test_axis_tables_of_the_presets(name):
    """Every quad record of the maze presets is an axis record, and every
    scan that holds at least AXIS_MIN_RECORDS takes the axis route. For each
    of its tiles, the entries are a bijection onto its records (indexed in
    their scan: the single-tile groups' joint one, or the walked tile's), in
    classes sorted stably (record order within a class), each run one class
    with its axes, and each entry's values the record's: sign(n_A) d exactly,
    w1_B, b1, w2_C, b2."""
    rec, tiles, base, (entries, rows, runs) = _tables(
        build_scene(P.NAMED_CONFIGS[name]().maze))
    for r in runs:
        assert r[3] == (r[2] % 3 | (r[2] // 3 % 3) << 8 | (r[2] // 9) << 16)
    engaged = 0
    for tile, row, off, got in zip(tiles, rows, base, _decode(entries, rows, runs, tiles)):
        first, count, mode = int(tile[6]), int(tile[7]), int(tile[8])
        if row[1] == 0:
            assert count < AXIS_MIN_RECORDS and got == []
            continue
        engaged += count
        assert row[2] == count                       # every record an axis record
        assert sorted(k - off for k, _, _ in got) == list(range(count))
        codes = [c for _, c, _ in got]
        assert codes == sorted(codes)
        for (k, c, ent), (k2, c2, _) in zip(got, got[1:]):
            assert c < c2 or k < k2
        r = rec[first:first + count]
        for k, c, ent in got:
            k -= off
            assert axis_classes(r[k:k + 1], mode)[0] == c
            a, b, cc = c % 3, c // 3 % 3, c // 9
            assert ent[0].view(np.int32) == (r[k, a] * r[k, 3]).view(np.int32)
            assert abs(r[k, a]) == 1 and abs(ent[0]) == abs(r[k, 3])
            if AXIS_EDGES[mode] >= 1:
                assert (ent[1], ent[2]) == (r[k, 4 + b], r[k, 7])
            if AXIS_EDGES[mode] == 2:
                assert (ent[4], ent[5]) == (r[k, 8 + cc], r[k, 11])
        lengths = [r_[1] for r_ in runs[row[0]:row[0] + row[1]]]
        assert row[3] == sum(-(-n // 32) for n in lengths)
    assert engaged >= 0.95 * len(rec)


def test_pass_1_over_the_uploaded_tables_finds_the_general_tests_winner():
    """interactive's joint single-tile groups (72 records in three tiles)
    through the tables as uploaded, on seeded rays: the fold over the
    entries in their order gives the general test's nearest t, bit for bit,
    whether records tie on it, and where none does, its record."""
    scene = upload_scene(build_scene(P.NAMED_CONFIGS["interactive"]().maze), device="cpu")
    rec, tiles = scene.planes.numpy(), scene.tiles.numpy()
    entries, rows, runs = (x.numpy() for x in (scene.axis_entries, scene.axis_tiles,
                                               scene.axis_runs))
    modes = np.concatenate([np.full(int(t[7]), int(t[8])) for t in tiles])
    joint = np.concatenate([rec[int(t[6]):int(t[6]) + int(t[7])] for t in tiles])
    n = 4000
    _, _, o, d = _aimed(joint, modes, n, np.random.default_rng(11))
    gen, ax, idx = [], [], []
    with np.errstate(all="ignore"):
        for tile, got in zip(tiles, _decode(entries, rows, runs, tiles)):
            mode, count = int(tile[8]), int(tile[7])
            ro, rd = np.repeat(o, count, 0), np.repeat(d, count, 0)
            r = np.tile(rec[int(tile[6]):int(tile[6]) + count], (n, 1))
            gen.append(general_t(r, mode, ro, rd).reshape(n, count))
            ent = np.stack([np.pad(e, (0, 8 - e.size)) for _, _, e in got])
            code = np.array([c for _, c, _ in got])
            ax.append(axis_t(np.tile(ent, (n, 1)), np.tile(code, n), mode, ro, rd)
                      .reshape(n, count))
            idx += [k for k, _, _ in got]
    gen, ax, idx = np.concatenate(gen, 1), np.concatenate(ax, 1), np.array(idx)
    want = gen.min(1)
    hit = want < BIG
    ties = (gen == want[:, None]).sum(1) > 1
    for ray in range(n):
        lm, li = fold(np.where(ax[ray] < BIG, ax[ray], F(np.inf)), idx)
        if not hit[ray]:
            assert not lm < BIG
            continue
        assert lm.view(np.int32) == want[ray].view(np.int32)
        assert (li == TIED) == ties[ray]
        if not ties[ray]:
            assert li == np.argmax(gen[ray] == want[ray])
    assert hit.sum() > n // 2


def _mixed_tile_scene():
    """The 8x8 maze, one of whose walls is turned off the axes: its tile
    mixes axis records with one that is not."""
    scene = build_scene(P.MazeConfig(width=8, height=8))
    kind = np.asarray(scene.kind)
    u = np.array(scene.u, np.float32)
    v = np.array(scene.v, np.float32)
    wall = int(np.flatnonzero(kind == 1)[3])
    u[wall] = u[wall] + np.float32(0.3) * np.abs(u[wall]).max()
    v[wall] = v[wall] + np.float32(0.2)
    return dataclasses.replace(scene, u=u, v=v)


def test_axis_tables_list_a_turned_quad_last_in_its_tile():
    """A quad turned off the axes is no axis record; in a tile that takes
    the axis route beside it, it stands in the last run, of class
    AXIS_GENERAL, in record order."""
    rec, tiles, base, (entries, rows, runs) = _tables(_mixed_tile_scene())
    mixed = 0
    for tile, row, off, got in zip(tiles, rows, base, _decode(entries, rows, runs, tiles)):
        first, count, mode = int(tile[6]), int(tile[7]), int(tile[8])
        if row[1] == 0:
            continue
        cls = axis_classes(rec[first:first + count], mode)
        assert row[2] == int((cls != AXIS_GENERAL).sum())
        general = [k - off for k, c, _ in got if c == AXIS_GENERAL]
        assert general == np.flatnonzero(cls == AXIS_GENERAL).tolist()
        assert all(c == AXIS_GENERAL for _, c, _ in got[len(got) - len(general):])
        mixed += len(general)
    assert mixed == 1


@pytest.mark.parametrize("name", ["mesh", "cornell_spheres", "cornell_glass",
                                  "cornell_blocks"])
def test_small_and_non_quad_scenes_take_no_axis_route(name):
    """Triangles (modes 4, 7) and spheres (3, 5) are never axis records,
    and the Cornell boxes' and the mesh gallery's rooms hold fewer than
    AXIS_MIN_RECORDS: their tables are empty, so their launches run the
    general scan's instantiations."""
    scene = {"mesh": mesh_gallery_scene, "cornell_spheres": lambda: cornell_scene("spheres"),
             "cornell_glass": lambda: cornell_scene("glass"),
             "cornell_blocks": lambda: cornell_scene("blocks")}[name]()
    rec, tiles, base, (entries, rows, runs) = _tables(scene)
    assert entries.shape == (0, 4) and runs.shape == (0, 4) and not rows.any()
    for tile in tiles:
        first, count, mode = int(tile[6]), int(tile[7]), int(tile[8])
        if mode not in AXIS_EDGES:
            continue
        assert int((axis_classes(rec[first:first + count], mode) != AXIS_GENERAL).sum()) \
            < AXIS_MIN_RECORDS


@pytest.mark.parametrize("keep", [{3}, {4}, {5}, {7}])
def test_a_maze_beside_triangles_or_spheres_takes_no_axis_route(keep):
    """The primitive zoo's 8x8 maze holds a scan of AXIS_MIN_RECORDS axis
    records and more. Its quads alone (and the free glass panes, mode 6)
    take the axis route; beside spheres (3, 5) or triangles (4, 7) the
    scene has no tables, since no kernel with those stages has the route."""
    zoo = primitive_zoo(8)
    *_, (entries, rows, runs) = _tables(scene_subset(zoo, {6}))
    assert entries.shape[0] > 0 and int(rows[:, 2].max()) >= AXIS_MIN_RECORDS
    *_, (entries, rows, runs) = _tables(scene_subset(zoo, {6} | keep))
    assert entries.shape == (0, 4) and runs.shape == (0, 4) and not rows.any()


def test_a_turned_quad_is_no_axis_record():
    q = _axis_record(0, 1.0, 2.0, 1, 0.5, 0.0, 2, 0.5, 0.0)
    turned = q.copy()
    turned[0:3] = _f([0.8, 0.6, 0.0])
    tilted_edge = q.copy()
    tilted_edge[4:7] = _f([0.0, 0.3, 0.4])
    scaled = q.copy()
    scaled[0] = 2.0                              # a normal of length 2
    recs = np.stack([q, turned, tilted_edge, scaled])
    assert axis_classes(recs, 0).tolist() == [0 + 3 * 1 + 9 * 2] + [AXIS_GENERAL] * 3
    # Mode 2 tests no edge, so its edge vectors may point anywhere.
    assert axis_classes(recs, 2).tolist() == [0, AXIS_GENERAL, 0, AXIS_GENERAL]


def test_scale_keeps_its_pass_1_tables_resident():
    """config_scale's pass-1 tables (entries, a row a tile, the runs), its
    tile table and walk order, beside the warps' counts, fit the H100's
    232,448 bytes a block; its full records beside them do not, so pass 2
    reads those from global memory."""
    rec, tiles, _, (entries, rows, runs) = _tables(build_scene(P.NAMED_CONFIGS["scale"]().maze))
    walked = len(tiles) - 1
    tables = 36 * len(tiles) + 4 * walked
    axis = 16 * (len(entries) + len(tiles) + len(runs))
    assert axis + tables + COUNT_BYTES <= OPTIN
    assert 80 * len(rec) + axis + tables + COUNT_BYTES > OPTIN
    # 32 B a mode-0 record, 16 B a mode-1 one; the single-tile group (6
    # floor, ceiling and boundary records) is too small for the route.
    assert len(entries) == 548 * 2 + 2138
