"""Math, camera, scheduler and collision: the port against the JAX package.

Integer results are bitwise. Float results hold to atol=1e-6: PyTorch's and
XLA's CPU transcendentals may differ by an ulp, and XLA contracts
multiply-adds under jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mirror_maze_tpu.config as JC
from mirror_maze_tpu.ops import quat as jq
from mirror_maze_tpu.ops.morton import morton2 as j_morton
from mirror_maze_tpu.render.camera import make_camera as j_make_camera
from mirror_maze_tpu.render.camera import ray_directions as j_rays
from mirror_maze_tpu.render.scheduler import sort_window_morton as j_sort
from mirror_maze_tpu.render.scheduler import take_chunks as j_take
from mirror_maze_tpu.scene.collision import collides as j_collides
from mirror_maze_tpu_torch.ops import quat as pq
from mirror_maze_tpu_torch.ops.morton import morton2
from mirror_maze_tpu_torch.render.camera import make_camera, ray_directions
from mirror_maze_tpu_torch.render.scheduler import (
    chunk_origin_xy,
    chunk_pixels,
    sort_window_morton,
    take_chunks,
)
from mirror_maze_tpu_torch.scene.collision import collides
from _torch_tools import port_config

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, p):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=ATOL)


def test_rotate_and_from_look_dir(rng):
    v = rng.normal(size=(64, 3)).astype(np.float32)
    look = rng.normal(size=(64, 3)).astype(np.float32)
    look[0] = (0.0, 0.0, 1.0)                     # zero rotation axis
    jqs = jq.from_look_dir(jnp.asarray(look))
    pqs = pq.from_look_dir(_t(look))
    _close(jqs, pqs)
    assert torch.isfinite(pqs).all()
    _close(jq.rotate(jnp.asarray(v), jqs), pq.rotate(_t(v), _t(np.asarray(jqs))))


def test_update_angle_including_degenerate_inputs(rng):
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = (0.0, 0.0, 0.0, 1.0)                   # no axis: inf/NaN result
    q[1] = (np.inf, 0.0, 0.0, 0.5)
    q[2] = (np.nan, 0.0, 0.0, 0.5)
    theta = rng.uniform(0, np.pi, 32).astype(np.float32)
    theta[3] = np.inf
    j = np.asarray(jq.update_angle(jnp.asarray(q), jnp.asarray(theta)))
    p = pq.update_angle(_t(q), _t(theta)).numpy()
    np.testing.assert_array_equal(np.isfinite(j), np.isfinite(p))
    np.testing.assert_array_equal(np.isnan(j), np.isnan(p))
    fin = np.isfinite(j)
    np.testing.assert_allclose(p[fin], j[fin], rtol=0, atol=ATOL)
    _close(jq.half_theta_of(jnp.asarray(q[4:])), pq.half_theta_of(_t(q[4:])))


def test_morton2_bitwise(rng):
    x = rng.integers(0, 1 << 16, 1000)
    y = rng.integers(0, 1 << 16, 1000)
    j = np.asarray(j_morton(jnp.asarray(x, jnp.uint32), jnp.asarray(y, jnp.uint32)))
    np.testing.assert_array_equal(morton2(_t(x), _t(y)).numpy(), j.astype(np.int64))
    np.testing.assert_array_equal(
        morton2(x.astype(np.uint64), y.astype(np.uint64)), j.astype(np.uint64))


@pytest.mark.parametrize("preset", ["interactive", "v0"])
def test_ray_directions(preset):
    jcfg = JC.NAMED_CONFIGS[preset]()
    cfg = port_config(jcfg)
    sc = cfg.screen
    aspect = sc.width / sc.height
    jcam = j_make_camera(jcfg.camera, aspect)
    cam = make_camera(cfg.camera, aspect, "cpu")
    for a, b in zip(jcam, cam):
        _close(a, b)
    ys, xs = np.meshgrid(np.arange(0, sc.height, 7), np.arange(0, sc.width, 5))
    pix = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)
    j = j_rays(jcam, jnp.asarray(pix), float(sc.width), float(sc.height))
    _close(j, ray_directions(cam, _t(pix), float(sc.width), float(sc.height)))


def test_take_chunks_and_morton_window_bitwise(rng):
    cfg = JC.ScreenConfig(width=96, height=64)
    perm = rng.permutation(cfg.total_chunks).astype(np.int32)
    for cursor, n in ((0, 24), (350, 24), (380, 24), (5, cfg.total_chunks)):
        j_ids, j_cur = j_take(jnp.asarray(perm), jnp.int32(cursor), n)
        ids, cur = take_chunks(_t(perm), torch.tensor(cursor, dtype=torch.int32), n)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        assert int(cur) == int(j_cur)
        np.testing.assert_array_equal(sort_window_morton(ids, cfg).numpy(),
                                      np.asarray(j_sort(j_ids, cfg)))
    from mirror_maze_tpu.render.scheduler import chunk_origin_xy as j_origin
    from mirror_maze_tpu.render.scheduler import chunk_pixels as j_pixels

    np.testing.assert_array_equal(
        chunk_pixels(chunk_origin_xy(ids, cfg), cfg.chunk_width).numpy(),
        np.asarray(j_pixels(j_origin(j_ids, cfg), cfg.chunk_width)))


def test_collides_bitwise(rng):
    lo = rng.uniform(-50, 50, (78, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 10, (78, 3)).astype(np.float32)
    c = rng.uniform(-55, 55, (500, 3)).astype(np.float32)
    half = np.float32([0.5, 0.2, 0.5])
    j = np.asarray(j_collides(jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(c - half), jnp.asarray(c + half)))
    p = collides(_t(lo), _t(hi), _t(c - half), _t(c + half)).numpy()
    np.testing.assert_array_equal(p, j)
    assert 0 < p.sum() < p.size


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
