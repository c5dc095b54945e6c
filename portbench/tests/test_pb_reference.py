"""The plain reference against the port's own plain versions at small sizes
on the CPU, and the frozen tracer count against chip_smoke.py's."""

import importlib.util

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import frame as fr
from portbench.reference import scene as sc
from portbench.reference import tracer
from portbench.roofline import FP32_OPS_PER_S, HBM_BYTES_PER_S
from portbench.roofline import tracer as roof

from . import tiny


def port_scene(cfg_file: dict, **kw):
    from mirror_maze_tpu_torch.render.scenebuf import upload_scene
    from mirror_maze_tpu_torch.scene.builder import build_scene

    return upload_scene(build_scene(run.engine_config(cfg_file["engine"]).maze), device="cpu",
                        **kw)


@pytest.mark.parametrize("name,seed", [("interactive", 3), ("scale", 2 ** 31 + 1)])
def test_reference_scene_is_the_ports_upload(name, seed):
    cfg = run.load_json(run.PKG / "configs" / f"{name}.json")
    for maze_seed in (cfg["engine"]["maze"]["seed"], seed):
        cfg["engine"]["maze"]["seed"] = maze_seed
        same_scene(sc.build(cfg["engine"], "cpu"), port_scene(cfg))


def same_scene(got, want):
    assert torch.equal(got.planes, want.planes)
    assert torch.equal(got.tiles, want.tiles)
    assert got.group_meta == want.group_meta
    assert np.array_equal(got.leaf_min, want.leaf_min.numpy())
    assert np.array_equal(got.leaf_max, want.leaf_max.numpy())


def rays(scene, n: int, seed: int):
    """n camera-ish rays from the spawn of the 8x8 maze, seeded."""
    g = torch.Generator().manual_seed(seed)
    d = torch.randn((n, 3), generator=g)
    d[:, 2] = d[:, 2].abs() + 0.5
    ori = torch.tensor([-5.0, 0.0, -35.0]).expand(n, 3).contiguous()
    return ori, fr.normalize(d)


def multi_tile_scene():
    cfg = tiny.config("interactive")
    cfg["engine"]["maze"].update(width=8, height=8)
    # Tiles of 8 walls and 2 world planes: a walk over many tiles.
    cfg["engine"]["maze"]["seed"] = 5
    return cfg, port_scene(cfg, tile_by_mode={1: 8, 2: 2})


def test_reference_tracer_is_the_ports_plain_version_bitwise_with_its_statistics():
    from mirror_maze_tpu_torch.config import TracerConfig
    from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_plain

    cfg, scene = multi_tile_scene()
    assert sum(g[2] for g in scene.group_meta if g[2] > 1) >= 8
    ori, dirs = rays(scene, 3000, 1)
    tc = cfg["engine"]["tracer"]
    ids = torch.arange(100, 3100, dtype=torch.int64)
    want_stats, got_stats = {}, {}
    want = trace_paths_plain(scene, ori, dirs, torch.tensor([12345], dtype=torch.int32),
                             TracerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                             for k, v in tc.items()}),
                             tc["block_rows"], anchor=ori[0], ray_ids=ids, stats=want_stats)
    got = tracer.trace_paths(scene.planes, scene.tiles, scene.group_meta, ori, dirs, 12345, tc,
                             ids, ori[0], stats=got_stats)
    assert torch.equal(got, want)
    for k in got_stats:
        assert got_stats[k] == want_stats[k], k


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", run.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_frozen_tracer_count_is_chip_smokes_for_the_same_rays():
    from mirror_maze_tpu_torch.config import TracerConfig
    from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_plain

    cs = chip_smoke()
    cfg, scene = multi_tile_scene()
    ori, dirs = rays(scene, 2048, 2)
    tc = cfg["engine"]["tracer"]
    stats = {}
    got = trace_paths_plain(scene, ori, dirs, torch.tensor([7], dtype=torch.int32),
                            TracerConfig(**{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in tc.items()}),
                            tc["block_rows"], anchor=ori[0], stats=stats)
    n_walk = sum(n for n in (g[2] for g in scene.group_meta) if n > 1)
    segs = stats["ray_segments"]
    # chip_smoke.py's tracer row: ops and bytes on the plain version's rays.
    ops = 1.0 * (16 * (stats["plane_tests"] + stats["edge_tests"])
                 + 20 * stats["sphere_tests"] + 30 * segs * n_walk
                 + 60 * stats["glass_hits"] + cs.TEXTURE_OPS * stats["textured_hits"])
    n_bytes = (ori.numel() + dirs.numel() + got.numel()) * 4
    assert roof.operations(stats, n_walk) == ops and segs > 0 and n_walk >= 8
    assert roof.bytes_moved(ori.shape[0]) == n_bytes
    assert (roof.TEXTURE_OPS, FP32_OPS_PER_S) == (cs.TEXTURE_OPS, cs.FP32_OPS_PER_S)
    assert HBM_BYTES_PER_S == 3.35e12
    bound, by = roof.bound_ms(ops, n_bytes)
    assert bound == max(ops / cs.FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
    assert by == ("operations" if ops / cs.FP32_OPS_PER_S > n_bytes / HBM_BYTES_PER_S
                  else "bytes")
