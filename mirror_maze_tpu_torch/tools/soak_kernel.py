"""Kernel exactness soak (counterpart of the repository's
``tools/soak_kernel.py``): the fused tracer over many random quad-soup
scenes, generated seed for seed as the JAX tool generates them.

    python -m mirror_maze_tpu_torch.tools.soak_kernel [n_scenes] [--device cpu]

Scene ``seed`` is a soup of 15-300 quads with zero-area rows (v = 0) and a
row whose edges are parallel; every odd seed also carries 1-159 spheres
(test mode 3, several tiles past 128), every third seed turns a random
subset of its quads into TRIANGLES (mode 4), seeds ending in 4 or 9 make a
random subset GLASS (modes 5-7, traced with ``fresnel=False``, the
deterministic refraction seam), seeds ending in 2 or 7 TEXTURE a random
subset (7 is glass and texture together). Each scene is traced with
``TracerConfig(bounce_limit=1, mirror_limit=1..3, fresnel=False)``: one
diffuse segment after mirror chains, so every tracer computes the same
light without sharing a random stream.

Per scene:

(a) ``trace_paths_fused`` against ``trace_paths_plain`` on the same device,
    bitwise on every ray; on the card also under a persistent grid of
    ``grid_blocks`` drawn per seed from {1, 7, the default} (a ray's light
    depends only on its id);
(b) ``trace_paths_fused`` against the jnp tracer (``render/tracer.py
    trace_paths``, brute backend) by the JAX tool's gate: per-ray max abs
    difference < 1e-4 on >= 99% of rays.

On the CPU (the plain version) 130 rays a scene and rows_per_block from
{1, 2, 4}, as the JAX tool; on the card 65,536 rays and rows from
{1, 2, 4, 8, 16}. Prints a line per scene and the failures at the end, and
exits non-zero if there is one. Runs on the CUDA card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..scene.builder import Scene

CPU_RAYS, CPU_ROWS = 130, (1, 2, 4)
CARD_RAYS, CARD_ROWS = 65536, (1, 2, 4, 8, 16)
GRIDS = (1, 7, None)            # None: as many blocks as fill the card
TOL, GATE = 1e-4, 0.99


@dataclasses.dataclass
class SoakCase:
    seed: int
    scene: Scene
    cfg: object                 # TracerConfig
    ori: np.ndarray             # [R, 3] float32
    dirs: np.ndarray            # [R, 3] float32, unit
    anchor: np.ndarray          # [3] float32 tile-order anchor
    rows: int                   # rows_per_block
    grid_blocks: int | None     # the card's second launch

    @property
    def n(self) -> int:
        return self.scene.num_planes

    @property
    def s(self) -> int:
        return self.scene.num_spheres


def soak_case(seed: int, n_rays: int = CPU_RAYS, rows=CPU_ROWS) -> SoakCase:
    """Scene, tracer configuration, rays and anchor of soak scene ``seed``:
    the JAX tool's draws from ``default_rng(1000 + seed)`` and
    ``default_rng(seed)``, in its order."""
    from ..config import TracerConfig

    r = np.random.default_rng(1000 + seed)
    n = int(r.integers(15, 300))
    origin = r.uniform(-20, 20, (n, 3))
    v = r.normal(size=(n, 3)) * r.uniform(0.5, 4)
    u = r.normal(size=(n, 3)) * r.uniform(0.5, 4)
    if n > 8:
        v[:: max(7, n // 4)] = 0.0
        u[3] = v[3] * r.uniform(0.5, 3)
    em = np.concatenate(
        [r.uniform(0, 1, (n, 3)),
         (r.random((n, 1)) < 0.4) * r.uniform(0, 3, (n, 1))], axis=1)
    s = int(r.integers(1, 160)) if seed % 2 else 0
    sph = dict(
        sph_center=r.uniform(-20, 20, (s, 3)).astype(np.float32),
        sph_radius=r.uniform(0.3, 2.0, s).astype(np.float32),
        sph_color=r.uniform(0, 1, (s, 3)).astype(np.float32),
        sph_is_mirror=r.random(s) < 0.3,
        sph_emission=np.concatenate(
            [r.uniform(0, 1, (s, 3)),
             (r.random((s, 1)) < 0.4) * r.uniform(0, 3, (s, 1))],
            axis=1).astype(np.float32),
    ) if s else {}
    kind = np.zeros(n, np.uint8)
    if seed % 3 == 0:
        kind[r.random(n) < float(r.uniform(0.2, 0.8))] = 3
    ior = np.zeros(n, np.float32)
    if seed % 5 == 4 or seed % 10 == 7:
        ior[r.random(n) < 0.4] = r.uniform(1.1, 2.0)
        if s:
            sph["sph_ior"] = np.where(
                r.random(s) < 0.5, r.uniform(1.1, 2.0, s), 0.0).astype(np.float32)
    tex = {}
    if seed % 5 == 2 or seed % 10 == 7:
        tex = dict(
            tex_kind=r.integers(0, 3, n).astype(np.uint8),
            tex_scale=r.uniform(0.5, 3.0, n).astype(np.float32),
            tex_color2=r.uniform(0, 1, (n, 3)).astype(np.float32),
        )
        if s:
            tex.update(
                sph_tex_kind=(2 * (r.random(s) < 0.5)).astype(np.uint8),
                sph_tex_scale=r.uniform(0.5, 3.0, s).astype(np.float32),
                sph_tex_color2=r.uniform(0, 1, (s, 3)).astype(np.float32),
            )
    # Keyword arguments are evaluated left to right: color, then is_mirror.
    scene = Scene(
        origin=origin.astype(np.float32), v=v.astype(np.float32),
        u=u.astype(np.float32),
        color=r.uniform(0, 1, (n, 3)).astype(np.float32),
        is_mirror=r.random(n) < float(r.uniform(0, 0.5)),
        emission=em.astype(np.float32), grid=np.zeros((1, 1), np.uint8),
        kind=kind, ior=ior, **sph, **tex)
    cfg = TracerConfig(bounce_limit=1, mirror_limit=int(r.integers(1, 4)), fresnel=False)
    rr = np.random.default_rng(seed)
    o = rr.uniform(-25, 25, (n_rays, 3)).astype(np.float32)
    d = rr.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    anchor = rr.uniform(-5, 5, (3,)).astype(np.float32)
    return SoakCase(seed=seed, scene=scene, cfg=cfg, ori=o, dirs=d, anchor=anchor,
                    rows=int(r.choice(rows)), grid_blocks=GRIDS[int(rr.integers(len(GRIDS)))])


def _bitwise_share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.view(torch.int32) == b.view(torch.int32)).all(dim=1).float().mean())


def check_case(case: SoakCase, device) -> dict:
    """Checks (a) and (b) of one scene on ``device``; returns the record the
    scene's line is printed from."""
    from ..ops import prng
    from ..render import trace_paths, trace_paths_fused, trace_paths_plain, upload_scene

    dev = torch.device(device)
    scene = upload_scene(case.scene, device=dev)
    o, d = (torch.from_numpy(x).to(dev) for x in (case.ori, case.dirs))
    seed = torch.tensor([case.seed], dtype=torch.int32, device=dev)
    anchor = torch.from_numpy(case.anchor).to(dev)
    geometry = {}
    fused = trace_paths_fused(scene, o, d, seed, case.cfg, case.rows, anchor=anchor,
                              geometry=geometry)
    plain = trace_paths_plain(scene, o, d, seed, case.cfg, case.rows, anchor=anchor)
    bitwise = {"default": _bitwise_share(fused, plain)}
    if dev.type == "cuda" and case.grid_blocks is not None:
        again = trace_paths_fused(scene, o, d, seed, case.cfg, case.rows, anchor=anchor,
                                  grid_blocks=case.grid_blocks)
        bitwise[f"grid {case.grid_blocks}"] = _bitwise_share(again, plain)
    jnp_light = trace_paths(scene.prims, o, d, prng.PRNGKey(0, device=dev), case.cfg)
    per_ray = (jnp_light - fused).abs().amax(dim=1)
    agree = float((per_ray < TOL).float().mean())
    ok = all(b == 1.0 for b in bitwise.values()) and agree >= GATE
    return dict(seed=case.seed, n=case.n, s=case.s, rows=case.rows, geometry=geometry,
                walked_tiles=sum(t for _, _, t in scene.group_meta if t > 1),
                segments=case.cfg.max_segments, bitwise=bitwise, agree=agree,
                max=float(per_ray.max()), ok=ok)


def format_record(rec: dict) -> str:
    g = rec["geometry"]
    where = (f"resident={g['resident']} grid={g['blocks']}x{g['threads']} "
             f"regs={g['registers']}" if g else "plain version")
    bits = " ".join(f"{k}={v:.4f}" for k, v in rec["bitwise"].items())
    return (f"seed {rec['seed']:2d} n={rec['n']:3d} s={rec['s']:3d} rows={rec['rows']:2d} "
            f"walked_tiles={rec['walked_tiles']} {where} bitwise {bits} "
            f"agree={rec['agree']:.4f} max={rec['max']:.2e} {'OK' if rec['ok'] else 'FAIL'}")


def run_soak(n_scenes: int, device=None, log=print) -> list:
    """Soak scenes 0 .. n_scenes - 1 on ``device`` (None = the CUDA card);
    logs a line per scene and returns the records."""
    from ..device import resolve_device

    dev = resolve_device(device)
    n_rays, rows = (CARD_RAYS, CARD_ROWS) if dev.type == "cuda" else (CPU_RAYS, CPU_ROWS)
    records = []
    for seed in range(n_scenes):
        rec = check_case(soak_case(seed, n_rays, rows), dev)
        log(format_record(rec))
        records.append(rec)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_scenes", type=int, nargs="?", default=40)
    p.add_argument("--device", default=None,
                   help="device to run on (default: the CUDA card; fails without one. "
                        "'cpu' runs the plain PyTorch version of the kernel)")
    args = p.parse_args(argv)
    from ..device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e} (on the command line: --device cpu)") from None
    records = run_soak(args.n_scenes, dev)
    fails = [(r["seed"], r["n"], r["rows"], r["bitwise"], r["agree"])
             for r in records if not r["ok"]]
    n_rays = CARD_RAYS if dev.type == "cuda" else CPU_RAYS
    print(f"device={dev} rays={n_rays} tol={TOL} gate={GATE} FAILURES: {fails}")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
