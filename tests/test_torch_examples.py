"""The port's examples (``python -m mirror_maze_tpu_torch.examples.*``)
against the repository's ``examples/`` on the CPU (``--device cpu``):

- the scene builders equal the JAX examples' array for array: the Cornell
  box's three variants, its checker floor, the mesh gallery;
- ``main()`` of the Cornell box and the mesh gallery (48x48, 16 spp, brute):
  the PNG against the JAX example's by the golden rule (>= 99.9% of pixels
  within 1 LSB, none off by more than 4; the bitwise share printed) and the
  saved scene equal to the JAX example's;
- the multiplayer demo with two players over gloo: each player's final
  position equals ``make_multiplayer_engine`` stepped in this process with
  the same configuration and inputs, and player 0's GIF is written."""

import dataclasses
import importlib.util
import json
import os
import re

import numpy as np
import pytest

from _torch_tools import assert_frames_match, gif_frame_count
from mirror_maze_tpu_torch.examples import cornell_box, mesh_gallery, multiplayer_demo
from mirror_maze_tpu_torch.scene import load_scene
from mirror_maze_tpu_torch.utils.imageio import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_example(name):
    path = os.path.join(REPO, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location("_jax_example_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_examples():
    return {name: _load_example(name) for name in ("cornell_box", "mesh_gallery")}


def _assert_scenes_equal(got, want):
    for f in dataclasses.fields(got):
        g, w = np.asarray(getattr(got, f.name)), np.asarray(getattr(want, f.name))
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


@pytest.mark.parametrize("name", ["blocks", "spheres", "glass", "checker", "mesh_gallery"])
def test_builders_are_the_jax_examples(jax_examples, name):
    jcb, jmg = jax_examples["cornell_box"], jax_examples["mesh_gallery"]
    if name == "mesh_gallery":
        got, want = mesh_gallery.build_mesh_gallery(), jmg.build_mesh_gallery()
        assert got.num_planes == 367 and int((np.asarray(got.kind) == 3).sum()) == 360
    elif name == "checker":
        got = cornell_box.checker_floor(cornell_box.build_cornell_box("blocks"))
        want = jcb.checker_floor(jcb.build_cornell_box("blocks"))
        assert int(got.tex_kind[0]) == 1 and got.tex_kind[1:].max() == 0
    else:
        got, want = cornell_box.build_cornell_box(name), jcb.build_cornell_box(name)
        assert got.num_spheres == {"blocks": 0, "spheres": 2, "glass": 1}[name]
    _assert_scenes_equal(got, want)


def test_unknown_variant_is_refused():
    with pytest.raises(ValueError, match="variant"):
        cornell_box.build_cornell_box("torus")


@pytest.mark.parametrize("name", ["cornell_box", "mesh_gallery"])
def test_main_renders_the_jax_examples_frame(jax_examples, name, tmp_path, capsys):
    port = {"cornell_box": cornell_box, "mesh_gallery": mesh_gallery}[name]
    paths = {}
    for side, fn, extra in (("jax", jax_examples[name].main, []),
                            ("port", port.main, ["--device", "cpu"])):
        png, npz = str(tmp_path / f"{side}.png"), str(tmp_path / f"{side}.npz")
        assert fn(["--size", "48", "--spp", "16", "--out", png, "--save-scene", npz]
                  + extra) == 0
        paths[side] = (png, npz)
    assert "wrote" in capsys.readouterr().out
    got, want = read_png(paths["port"][0]), read_png(paths["jax"][0])
    print(f"{name}: {(got == want).mean():.4f} of values bitwise")
    assert got.shape == (48, 48, 3) and got.mean() > 1.0
    assert_frames_match(got, want)
    _assert_scenes_equal(load_scene(paths["port"][1]), load_scene(paths["jax"][1]))


def test_multiplayer_demo_positions_and_gif(tmp_path, capfd):
    """Two player processes step 4 frames; the walker (player 1) moves, the
    spectator stays, and both end where a one-process run of the same engine
    ends."""
    from mirror_maze_tpu_torch.parallel.multiplayer import make_multiplayer_engine

    n_frames = 4
    gif = tmp_path / "mp.gif"
    assert multiplayer_demo.main(["--players", "2", "--frames", str(n_frames), "--device", "cpu",
                                  "--out", str(gif)]) == 0
    out = capfd.readouterr().out
    done = dict((int(pid), json.loads(pos)) for pid, pos in
                re.findall(r"player (\d) done at z=\S+ (\[.*\])", out))
    assert sorted(done) == [0, 1], out
    assert f"wrote {gif} (1 frames)" in out
    assert gif_frame_count(str(gif)) == n_frames // multiplayer_demo.GIF_EVERY
    for pid in (0, 1):
        cfg = multiplayer_demo.player_config(pid)
        _, init_fn, step_fn = make_multiplayer_engine(cfg, me=pid, radius=1.2, device="cpu")
        st = init_fn(seed=0)
        for inp in multiplayer_demo.player_inputs(pid, n_frames):
            st, _ = step_fn(st, inp)
        assert [float(c).hex() for c in st.cam_center.tolist()] == done[pid], pid
    z = [float.fromhex(done[pid][2]) for pid in (0, 1)]
    assert z[0] == multiplayer_demo.player_config(0).camera.spawn[2]
    assert z[1] > multiplayer_demo.player_config(1).camera.spawn[2]
