"""The thin-lens camera (CameraConfig.aperture / focus_dist): the port's
``frame_rays`` against the rays the JAX package's ``render_pixels`` hands
its tracer.

Tolerance: the lens sample's bits are the same on both sides
(``prng.uniform`` against ``jax.random.uniform``, bitwise), but the disk
offset goes through sin and cos, where PyTorch (here: float64, rounded
once) and XLA's float32 may differ by an ulp, and XLA contracts
multiply-adds under jit in the rotation and the normalization: origins and
directions hold to atol=1e-6, as the camera glue in tests/test_torch_ops.py.
With aperture 0 nothing of the lens is computed: the rays are bitwise the
pinhole's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mirror_maze_tpu.config as JC
from _torch_tools import port_config
from mirror_maze_tpu.render import pallas_tracer as j_pallas
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.render.camera import make_camera as j_make_camera
from mirror_maze_tpu.render.pipeline import render_pixels as j_render_pixels
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.ops.sampling import ray_jitter
from mirror_maze_tpu_torch.render.camera import make_camera, ray_directions
from mirror_maze_tpu_torch.render.pipeline import frame_rays

ATOL = 1e-6


def _cfg(aperture, focus_dist=7.5):
    return JC.EngineConfig(
        maze=JC.MazeConfig(width=4, height=4),
        camera=JC.CameraConfig(spawn=(-5.0, 0.0, -15.0), look_dir=(0.3, 0.0, 1.0),
                               aperture=aperture, focus_dist=focus_dist),
        screen=JC.ScreenConfig(width=64, height=48, samples_per_pixel=8),
        intersector="pallas",
    )


def _pixels():
    ys, xs = np.meshgrid(np.arange(0, 48, 5), np.arange(0, 64, 7))
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)


def _jax_rays(jcfg, monkeypatch):
    """The (ori, dirs, seed) render_pixels passes to trace_paths_pallas."""
    seen = {}

    def capture(table, ori, dirs, seed, *args, **kw):
        seen.update(ori=np.asarray(ori), dirs=np.asarray(dirs), seed=int(seed))
        return jnp.zeros_like(ori)

    monkeypatch.setattr(j_pallas, "trace_paths_pallas", capture)
    cam = j_make_camera(jcfg.camera, 64 / 48)
    j_render_pixels(j_upload(j_build(jcfg.maze)), cam, jnp.asarray(_pixels()),
                    jax.random.PRNGKey(3), jcfg)
    return seen


@pytest.mark.parametrize("aperture,focus", [(0.15, 7.5), (0.6, 2.0)])
def test_thin_lens_rays_match_jax(monkeypatch, aperture, focus):
    jcfg = _cfg(aperture, focus)
    want = _jax_rays(jcfg, monkeypatch)
    cfg = port_config(jcfg)
    cam = make_camera(cfg.camera, 64 / 48, "cpu")
    ori, dirs, seed, row = frame_rays(cam, torch.from_numpy(_pixels()), prng.PRNGKey(3, "cpu"), cfg)
    assert row is None and int(seed) == want["seed"]
    np.testing.assert_allclose(ori.numpy(), want["ori"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(dirs.numpy(), want["dirs"], rtol=0, atol=ATOL)
    # The lens is there: origins spread over a disk of the aperture's radius
    # in the camera plane, directions are unit vectors.
    off = ori - cam.center
    assert float(off.norm(dim=1).max()) <= aperture + ATOL
    assert float(off.norm(dim=1).max()) > 0.8 * aperture
    np.testing.assert_allclose(dirs.norm(dim=1).numpy(), 1.0, atol=ATOL)


def test_aperture_zero_is_bitwise_the_pinhole(monkeypatch):
    jcfg = _cfg(0.0)
    cfg = port_config(jcfg)
    cam = make_camera(cfg.camera, 64 / 48, "cpu")
    pix = torch.from_numpy(_pixels())
    key = prng.PRNGKey(3, "cpu")
    ori, dirs, seed, _ = frame_rays(cam, pix, key, cfg)
    jkey, _ = prng.split(key)
    base = ray_directions(cam, pix, 64.0, 48.0)
    pinhole = (base[:, None, :] + ray_jitter(jkey, (len(pix), 8), cfg.tracer.jitter)).reshape(-1, 3)
    assert torch.equal(dirs, pinhole)
    assert torch.equal(ori, cam.center.expand(len(pix) * 8, 3))
    want = _jax_rays(jcfg, monkeypatch)
    np.testing.assert_allclose(dirs.numpy(), want["dirs"], rtol=0, atol=ATOL)
    # focus_dist alone changes nothing.
    other = port_config(dataclasses.replace(
        jcfg, camera=dataclasses.replace(jcfg.camera, focus_dist=3.0)))
    assert torch.equal(frame_rays(cam, pix, key, other)[1], dirs)


def test_lens_uniform_bits_match_jax():
    """prng.uniform against jax.random.uniform at the lens sample's shape,
    (2, K * spp), under the key the lens folds."""
    n = len(_pixels()) * 8
    jkey, _ = jax.random.split(jax.random.PRNGKey(3))
    want = np.asarray(jax.random.uniform(jax.random.fold_in(jkey, 1), (2, n)))
    pkey, _ = prng.split(prng.PRNGKey(3, "cpu"))
    got = prng.uniform(prng.fold_in(pkey, 1), (2, n)).numpy()
    assert got.tobytes() == want.tobytes()
