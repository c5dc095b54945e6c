"""The port's offline and IO modules against the JAX package's: camera paths
and ``render_path``, the image encoders and ``read_png``, scene files, the
minimap, the noise PNG, the spatial accumulate helpers and the profiling
helpers.

Rules: camera paths within rtol 1e-6 (atol 1e-6 for components near 0; the
angles are evaluated in float64 and rounded once, jnp's float32 sin and cos
may be an ulp off); ``render_path`` frames by the golden rule of
tests/test_golden.py; encoders, scene files and the minimap byte for byte;
the spatial blur bitwise."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tools import assert_frames_match, cornell_scene, port_config
from _torch_jax_tools import as_jax_scene
from mirror_maze_tpu import config as j_config
from mirror_maze_tpu.render import accumulate as j_acc
from mirror_maze_tpu.render import campath as j_campath
from mirror_maze_tpu.render import make_camera as j_make_camera
from mirror_maze_tpu.render import upload_scene as j_upload
from mirror_maze_tpu.scene import build_scene as j_build
from mirror_maze_tpu.scene import io as j_io
from mirror_maze_tpu.utils import imageio as j_imageio
from mirror_maze_tpu.utils import minimap as j_minimap
from mirror_maze_tpu.utils import noise as j_noise
from mirror_maze_tpu_torch.config import ScreenConfig
from mirror_maze_tpu_torch.ops import prng
from mirror_maze_tpu_torch.render import accumulate, campath, make_camera, upload_scene
from mirror_maze_tpu_torch.scene import build_scene, io
from mirror_maze_tpu_torch.utils import imageio, minimap, noise, profiling

TINY = j_config.EngineConfig(
    maze=j_config.MazeConfig(width=4, height=4),
    tracer=j_config.TracerConfig(bounce_limit=2, mirror_limit=2),
    camera=j_config.CameraConfig(spawn=(-5.0, 0.0, -15.0)),
    screen=j_config.ScreenConfig(width=24, height=16, samples_per_pixel=2),
    intersector="brute")


def _cams_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("path", ["spin", "orbit", "waypoint-target", "waypoint-looks",
                                  "waypoint-travel"])
def test_camera_paths_match_jax(path):
    jbase = j_make_camera(TINY.camera, 1.5)
    base = make_camera(port_config(TINY).camera, 1.5, "cpu")
    pts = [(-5.0, 0.0, -15.0), (0.0, -1.0, 0.0), (5.0, 0.0, 5.0), (5.0, 0.0, 5.0)]
    looks = [(0, 0, 1), (1, 0, 0), (0, 0.5, -1), (-1, 0, 0)]
    args = {"spin": ("spin_cameras", ((0.3, -0.2, 1.0), 7), dict(turns=1.5)),
            "orbit": ("orbit_cameras", ((1.0, -2.0, 0.5), 12.0, -3.0, 9), {}),
            "waypoint-target": ("waypoint_cameras", (pts, 10), dict(target=(0, -2, 0))),
            "waypoint-looks": ("waypoint_cameras", (pts, 10), dict(looks=looks)),
            "waypoint-travel": ("waypoint_cameras", (pts, 10), {})}[path]
    name, a, kw = args
    want = getattr(j_campath, name)(jbase, *a, **kw)
    got = getattr(campath, name)(base, *a, **kw)
    assert tuple(got.center.shape) == tuple(want.center.shape)
    _cams_close(got, want)


def test_render_path_matches_jax():
    cfg = port_config(TINY)
    jscene = j_upload(j_build(TINY.maze))
    scene = upload_scene(build_scene(cfg.maze), device="cpu")
    jcams = j_campath.orbit_cameras(j_make_camera(TINY.camera, 1.5), (0.0, -2.0, 0.0), 12.0,
                                    -1.0, 3)
    cams = campath.orbit_cameras(make_camera(cfg.camera, 1.5, "cpu"), (0.0, -2.0, 0.0), 12.0,
                                 -1.0, 3)
    want = np.asarray(j_campath.render_path(jscene, jcams, jax.random.PRNGKey(4), TINY))
    got = campath.render_path(scene, cams, prng.PRNGKey(4, device="cpu"), cfg).numpy()
    assert got.shape == want.shape == (3, 16, 24, 3) and got.dtype == np.uint8
    for g, w in zip(got, want):
        assert_frames_match(g, w)
    assert not np.array_equal(got[0], got[1])


def _frames(n=3, h=20, w=30, seed=1):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return np.stack([np.roll(base, 3 * i, axis=1) for i in range(n)])


def test_encoders_are_byte_identical(tmp_path):
    frames = _frames()
    img = frames[0]
    for level in (1, 6):
        assert imageio.png_bytes(img, level) == j_imageio.png_bytes(img, level)
    floats = img.astype(np.float32) / 255.0
    assert imageio.png_bytes(floats) == j_imageio.png_bytes(floats)
    assert imageio.ansi_frame(img, max_cols=16) == j_imageio.ansi_frame(img, max_cols=16)
    assert imageio.kitty_frame(img) == j_imageio.kitty_frame(img)
    assert imageio.jpeg_bytes(img) == j_imageio.jpeg_bytes(img)
    for mod, name in ((imageio, "a"), (j_imageio, "b")):
        mod.write_gif(str(tmp_path / f"{name}.gif"), frames, fps=10)
        mod._write_gif_builtin(str(tmp_path / f"{name}-builtin.gif"), frames, 100, 0)
        mod.write_png(str(tmp_path / f"{name}.png"), img)
    for suffix in (".gif", "-builtin.gif", ".png"):
        assert (tmp_path / f"a{suffix}").read_bytes() == (tmp_path / f"b{suffix}").read_bytes()


def test_read_png_round_trip_with_and_without_pil(tmp_path, monkeypatch):
    img = _frames(1, 13, 17)[0]
    path = tmp_path / "f.png"
    imageio.write_png(str(path), img)
    assert np.array_equal(imageio.read_png(str(path)), img)      # PIL written, PIL read
    # The built-in decoder on the built-in encoder's bytes and on PIL's
    # (which filters its rows: Sub, Up, Average, Paeth).
    assert np.array_equal(imageio.decode_png(imageio.png_bytes(img)), img)
    assert np.array_equal(imageio.decode_png(path.read_bytes()), img)
    smooth = np.stack(np.meshgrid(np.arange(40), np.arange(30), indexing="xy"), -1)
    smooth = np.concatenate([smooth * 3, smooth[..., :1] * 5], -1).astype(np.uint8)
    imageio.write_png(str(path), smooth)
    assert np.array_equal(imageio.decode_png(path.read_bytes()), smooth)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    assert np.array_equal(imageio.read_png(str(path)), smooth)
    with pytest.raises(ValueError):
        imageio.decode_png(b"not a png")


def test_noise_png_loads_as_the_reference_loads_it(tmp_path):
    tex = (noise.generate_noise(64) * 255).astype(np.uint8)
    path = str(tmp_path / "noise.png")
    imageio.write_png(path, np.repeat(tex[..., None], 3, axis=-1))
    got = noise.load_noise_png(path)
    assert got.dtype == np.float32 and got.shape == (64, 64)
    assert np.array_equal(got, j_noise.load_noise_png(path))


def test_scene_files_load_in_either_package(tmp_path):
    scene = dataclasses.replace(cornell_scene("spheres"), sph_ior=np.float32([0.0, 1.5]))
    maze = build_scene(port_config(TINY).maze)
    for s in (scene, maze):
        a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        io.save_scene(a, s)
        back = j_io.load_scene(a)            # written by the port, read by JAX
        j_io.save_scene(b, back)
        again = io.load_scene(b)             # written by JAX, read by the port
        for f in dataclasses.fields(s):
            x, y, z = (getattr(o, f.name) for o in (s, back, again))
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name
            assert np.array_equal(np.asarray(x), np.asarray(z)), f.name
        assert type(again).__module__.startswith("mirror_maze_tpu_torch")
    np.savez(str(tmp_path / "bad.npz"), origin=np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="lacks"):
        io.load_scene(str(tmp_path / "bad.npz"))


def test_minimap_matches_jax():
    scene = build_scene(port_config(TINY).maze)
    jscene = j_build(TINY.maze)
    cam = make_camera(port_config(TINY).camera, 1.5, "cpu")
    got = minimap.render_minimap(scene, size=160, camera_center=cam.center,
                                 camera_quat=cam.rotation)
    want = j_minimap.render_minimap(jscene, size=160, camera_center=np.asarray(cam.center),
                                    camera_quat=np.asarray(cam.rotation))
    assert got.shape == (160, 160, 3) and np.array_equal(got, want)
    spheres = cornell_scene("spheres")
    assert np.array_equal(minimap.render_minimap(spheres, size=96),
                          j_minimap.render_minimap(as_jax_scene(spheres), size=96))


def test_spatial_accumulate_helpers_match_jax():
    sc = ScreenConfig(width=32, height=24, samples_per_pixel=1)
    rng = np.random.default_rng(2)
    screen = rng.uniform(-0.1, 1.1, (24, 32, 3)).astype(np.float32)
    pix = np.stack([rng.permutation(40)[:30] - 4, rng.integers(-2, 26, 30)], -1).astype(np.int32)
    pix = pix[np.unique(pix[:, 0] * 100 + pix[:, 1], return_index=True)[1]]
    cols = rng.uniform(0, 1, (pix.shape[0], 3)).astype(np.float32)
    got = accumulate.scatter_chunks(torch.from_numpy(screen), torch.from_numpy(pix),
                                    torch.from_numpy(cols)).numpy()
    want = np.asarray(j_acc.scatter_chunks(jnp.asarray(screen), jnp.asarray(pix),
                                           jnp.asarray(cols)))
    assert np.array_equal(got, want) and not np.array_equal(got, screen)
    cm = accumulate.spatial_to_cm(torch.from_numpy(screen), sc)
    assert np.array_equal(cm.numpy(), np.asarray(j_acc.spatial_to_cm(jnp.asarray(screen), sc)))
    assert torch.equal(accumulate.cm_to_spatial(cm, sc), torch.from_numpy(screen))
    blur = accumulate.feedback_blur(torch.from_numpy(screen))
    assert np.array_equal(blur.numpy(), np.asarray(jax.jit(j_acc.feedback_blur)(screen)))
    assert torch.equal(accumulate.spatial_to_cm(blur, sc), accumulate.feedback_blur_cm(cm, sc))


def test_profiling_helpers(tmp_path):
    path = str(tmp_path / "trace.json")
    with profiling.trace(path) as prof:
        torch.ones(8).sum()
    assert os.path.getsize(path) > 0 and len(prof.key_averages()) > 0
    with pytest.raises(ValueError):
        profiling.device_memory_stats("cpu")
