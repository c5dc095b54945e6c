"""The port's jnp tracer (mirror_maze_tpu_torch/render/tracer.py trace_paths)
and its draws against the JAX package's, and the brute backend against the
committed goldens.

- ``prng.normal`` against ``jax.random.normal``: >= 99.9% of draws bitwise,
  the rest within 2 ulp (the port evaluates XLA-CPU's erf_inv and log1p term
  for term, each FMA rounded once from float64; the double rounding of an
  FMA emulated in float64 may differ). ``erf_inv`` on a dense grid of
  float32 inputs: the bitwise share and the largest ulp gap are printed.
- ``unit_sphere``: bitwise, for one key and for a key per ray (the squared
  length summed as XLA-CPU contracts it, the root correctly rounded as
  XLA's is; PyTorch's CPU float32 sqrt is not, ops/vecmath.py sqrt).
- ``trace_paths`` against the JAX one (jitted, as the engine runs it) on the
  plain maze, the Cornell box with spheres, glass with ``fresnel`` on, a
  textured scene and a ``seed_row``: the tracer rule, >= 99% of rays within
  rtol 1e-5 and the mean light within 1e-3 (ROADMAP.md C).
- ``render_full_frame`` and the 28-frame script of the golden configuration
  with ``intersector="brute"`` against tests/goldens/frame_brute.npz and
  script_brute.npz by the rule of tests/test_golden.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_tools import as_jax_scene, assert_tracer_rule
from _torch_jax_tools import one_torch_thread  # noqa: F401 (autouse)
from _torch_tools import (
    assert_frames_match,
    cornell_scene,
    golden_config,
    golden_script,
    textured_cornell,
)
from mirror_maze_tpu.config import TracerConfig as JTracer
from mirror_maze_tpu.ops.sampling import unit_sphere as j_unit_sphere
from mirror_maze_tpu.render.scenebuf import upload_scene as j_upload
from mirror_maze_tpu.render.tracer import trace_paths as j_trace_paths
from mirror_maze_tpu_torch.config import MazeConfig, TracerConfig
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.ops.sampling import unit_sphere
from mirror_maze_tpu_torch.render import make_camera, render_full_frame, upload_scene
from mirror_maze_tpu_torch.render.tracer import trace_paths
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs
from mirror_maze_tpu_torch.scene import build_scene

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_erf_inv_on_a_dense_grid():
    x = np.concatenate([np.linspace(-1, 1, 400_001, dtype=np.float32),
                        np.float32([-1.0, 1.0, np.nextafter(np.float32(1), np.float32(0))])])
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    gap = _ulps(got, want)
    print(f"erf_inv: {(gap == 0).mean():.6f} of {x.size} float32 inputs bitwise, "
          f"largest gap {gap.max()} ulp")
    assert (gap == 0).mean() >= 0.999 and gap.max() <= 2


@pytest.mark.parametrize("seed,shape", [(0, (4096, 3)), (7, (33, 5, 3)), (123, (2048,))])
def test_normal_matches_jax(seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    gap = _ulps(got, want)
    print(f"normal {shape}: {(gap == 0).mean():.6f} bitwise, largest gap {gap.max()} ulp")
    assert got.shape == want.shape
    assert (gap == 0).mean() >= 0.999 and gap.max() <= 2


def test_unit_sphere_matches_jax_for_one_key_and_per_ray_keys():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    want = np.asarray(jax.jit(lambda k: j_unit_sphere(k, (8192,)))(key))
    got = unit_sphere(prng.fold_in(prng.PRNGKey(3), 2), (8192,)).numpy()
    # Per-ray keys (the seed_row path): the reference vmaps over keys.
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(jnp.arange(2048))
    want_k = np.asarray(jax.jit(jax.vmap(lambda k: j_unit_sphere(k, ())))(jkeys))
    keys = prng.fold_in(prng.PRNGKey(9), torch.arange(2048))
    assert np.array_equal(keys.numpy().astype(np.uint32), np.asarray(jkeys))
    got_k = unit_sphere(keys, ()).numpy()
    for g, w in ((got, want), (got_k, want_k)):
        print(f"unit_sphere {g.shape}: {(_ulps(g, w) == 0).mean():.5f} bitwise")
        assert g.shape == w.shape and np.array_equal(g, w)


def _scene(name):
    if name in ("maze", "seed_row"):
        return build_scene(MazeConfig(width=4, height=4))
    if name == "spheres":
        return cornell_scene("spheres")
    if name == "glass":
        # A mirror sphere and a glass one, in a box with a tall mirror block.
        return dataclasses.replace(cornell_scene("spheres"), sph_ior=np.float32([0.0, 1.5]))
    return textured_cornell("blocks")


def _rays(scene, n, seed=4):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([scene.origin, scene.origin + scene.u + scene.v])
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    o = (mid + rng.uniform(-0.7, 0.7, (n, 3)) * half).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, rng.uniform(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("name", ["maze", "spheres", "glass", "textured", "seed_row"])
def test_trace_paths_matches_jax(name):
    scene = _scene(name)
    tracer = dict(bounce_limit=3, mirror_limit=3, fresnel=True)
    dev = upload_scene(scene, device="cpu")
    jdev = j_upload(as_jax_scene(scene))
    assert (dev.prims.sph_ior is not None) == (jdev.sph_ior is not None) == (name == "glass")
    assert (dev.prims.tex is not None) == (jdev.tex is not None) == (name == "textured")
    o, d, row = _rays(scene, 3000)
    use_row = name == "seed_row"
    jrow = jnp.asarray(row) if use_row else None
    want = np.asarray(jax.jit(lambda o, d, k, r: j_trace_paths(
        jdev, o, d, k, JTracer(**tracer), seed_row=r))(
        jnp.asarray(o), jnp.asarray(d), jax.random.PRNGKey(11), jrow))
    got = trace_paths(dev.prims, torch.from_numpy(o), torch.from_numpy(d),
                      prng.PRNGKey(11), TracerConfig(**tracer),
                      seed_row=torch.from_numpy(row) if use_row else None).numpy()
    assert_tracer_rule(f"trace_paths {name}", want, got)
    if use_row:
        plain = trace_paths(dev.prims, torch.from_numpy(o), torch.from_numpy(d),
                            prng.PRNGKey(11), TracerConfig(**tracer)).numpy()
        assert not np.array_equal(plain, got)


def test_full_frame_matches_golden_brute():
    cfg = golden_config().replace(intersector="brute")
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    cam = make_camera(cfg.camera, cfg.screen.width / cfg.screen.height, "cpu")
    img = render_full_frame(scene, cam, prng.PRNGKey(0, device="cpu"), cfg).clamp(0, 1).numpy()
    with np.load(os.path.join(GOLDENS, "frame_brute.npz")) as z:
        ref = z["img"]
    close = np.isclose(img, ref, atol=2e-3).mean()
    print(f"frame_brute: {close:.5f} of values within 2e-3, {(img == ref).mean():.5f} bitwise")
    assert close > 0.999
    np.testing.assert_allclose(img.mean(), ref.mean(), atol=1e-4)


def test_script_matches_golden_brute():
    cfg = golden_config().replace(intersector="brute")
    _, frame = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg,
                            inputs=golden_script(FrameInputs))
    with np.load(os.path.join(GOLDENS, "script_brute.npz")) as z:
        assert_frames_match(frame, z["img"])
