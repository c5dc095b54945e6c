"""The port's CLI (``python -m mirror_maze_tpu_torch``, __main__.py) against
the JAX package's on tiny configurations on the CPU (``--device cpu``):

- the parser: the same subcommands, option strings, defaults and choices,
  plus ``--device``;
- ``render`` / ``multicam`` / ``animate`` / ``demo`` frames against the JAX
  CLI's by the golden rule (>= 99.9% of pixels within 1 LSB, none off by
  more than 4), ``minimap`` bitwise (it is host NumPy on both sides);
- ``play`` headless bitwise ``run_scripted`` (per frame, batched, and
  through a checkpoint);
- ``render`` without ``--device`` on a machine without a card exits
  non-zero with the device message."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_tools import assert_frames_match
from mirror_maze_tpu import __main__ as j_cli
from mirror_maze_tpu_torch import __main__ as cli
from mirror_maze_tpu_torch.utils.imageio import _to_u8, read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--config", "v0", "--width", "32", "--height", "24", "--spp", "1"]


class _Stop(Exception):
    pass


def _subparsers(parser):
    act = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return act.choices


def _options(sub):
    return {a.option_strings[0]: (tuple(a.option_strings), a.dest, a.default, a.choices,
                                  a.type, type(a).__name__)
            for a in sub._actions if a.option_strings and a.dest != "help"}


def test_parser_has_the_reference_flags_and_device(monkeypatch):
    """Capture the JAX CLI's parser (it is built inside its main) and hold
    the port's against it subcommand by subcommand."""
    got = {}

    def grab(self, args=None, namespace=None):
        got["parser"] = self
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Stop):
            j_cli.main(["render"])
    ref, port = _subparsers(got["parser"]), _subparsers(cli.build_parser())
    assert list(port) == list(ref) == ["render", "demo", "play", "multicam", "animate",
                                       "minimap", "serve"]
    for name in ref:
        want, have = _options(ref[name]), _options(port[name])
        assert have.pop("--device")[2] is None
        assert have == want, name


def test_overrides_preserve_named_config_fields():
    """--width/--spp/--seed replace single fields: config_interactive's
    sort_chunk_window and block_rows survive."""
    args = cli.build_parser().parse_args(
        ["render", "--config", "interactive", "--width", "64", "--height", "48", "--spp", "2",
         "--seed", "3"])
    cfg, scene, _ = cli._build_world(args)
    assert (cfg.screen.width, cfg.screen.height, cfg.screen.samples_per_pixel) == (64, 48, 2)
    assert cfg.screen.sort_chunk_window is True and cfg.tracer.block_rows == 96
    assert cfg.maze.seed == 3 and cfg.maze.width == 10


def _both(tmp_path, argv, out_name):
    """Run one command through the JAX CLI and the port's (on the CPU);
    returns the two output paths."""
    outs = []
    for side, fn in (("jax", j_cli.main), ("port", cli.main)):
        out = str(tmp_path / f"{side}_{out_name}")
        extra = ["--device", "cpu"] if side == "port" else []
        assert fn(argv + ["--out", out] + extra) == 0
        outs.append(out)
    return outs


def test_render_matches_reference(tmp_path, capsys):
    j, p = _both(tmp_path, ["render"] + TINY, "f.png")
    assert_frames_match(read_png(p), read_png(j))
    assert "kernel launches {}" in capsys.readouterr().out     # the CPU runs no kernel


def test_minimap_is_bitwise_the_reference(tmp_path):
    j, p = _both(tmp_path, ["minimap", "--config", "interactive", "--map-size", "128"], "m.png")
    a, b = read_png(p), read_png(j)
    assert a.shape == (128, 128, 3) and np.array_equal(a, b)


def test_multicam_matches_reference(tmp_path, monkeypatch):
    """Three cameras fanned around the spawn, on one device each side (the
    JAX CLI sees one of the test session's virtual CPU devices, as the port
    sees the one CPU): a 2x2 grid, one slot black."""
    import jax

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
    j, p = _both(tmp_path, ["multicam", "--cameras", "3"] + TINY, "mc.png")
    a = read_png(p)
    assert a.shape == (48, 64, 3) and not a[24:, 32:].any()
    assert_frames_match(a, read_png(j))


@pytest.mark.parametrize("anim", [["--anim", "spin"],
                                  ["--anim", "orbit", "--orbit-center", "0,-3,0",
                                   "--orbit-radius", "12"]])
def test_animate_matches_reference(tmp_path, monkeypatch, anim):
    """The GIF's frames (taken as the writer gets them) by the golden rule."""
    import mirror_maze_tpu.utils.imageio as j_io
    import mirror_maze_tpu_torch.utils.imageio as p_io

    frames = {}
    for side, mod in (("jax", j_io), ("port", p_io)):
        real = mod.write_gif

        def keep(path, fr, fps=20, loop=0, side=side, real=real):
            frames[side] = _to_u8(np.asarray(fr))
            real(path, fr, fps=fps, loop=loop)

        monkeypatch.setattr(mod, "write_gif", keep)
    j, p = _both(tmp_path, ["animate", "--anim-frames", "3"] + anim + TINY, "a.gif")
    assert frames["port"].shape == (3, 24, 32, 3)
    for a, b in zip(frames["port"], frames["jax"]):
        assert_frames_match(a, b)
    with open(p, "rb") as f:
        assert f.read(6) == b"GIF89a"


def test_demo_matches_reference(tmp_path):
    """The fixed 640-frame script: the six phase snapshots by the golden
    rule."""
    j, p = _both(tmp_path, ["demo"] + TINY, "demo")
    names = sorted(os.listdir(p))
    assert names == sorted(os.listdir(j)) and len(names) == 6
    assert names[-1] == "0640_final.png"
    for name in names:
        assert_frames_match(read_png(os.path.join(p, name)), read_png(os.path.join(j, name)))


@pytest.fixture
def headless(monkeypatch):
    with open(os.devnull) as f:
        monkeypatch.setattr(sys, "stdin", f)
        yield


def test_play_headless_is_run_scripted(tmp_path, headless):
    from mirror_maze_tpu_torch import NAMED_CONFIGS
    from mirror_maze_tpu_torch.render import upload_scene
    from mirror_maze_tpu_torch.runtime.loop import run_scripted
    from mirror_maze_tpu_torch.scene import build_scene

    args = cli.build_parser().parse_args(["play"] + TINY)
    cfg, _, _ = cli._build_world(args)
    assert cfg.screen.width == 32 and cfg == NAMED_CONFIGS["v0"]().replace(screen=cfg.screen)
    _, want = run_scripted(upload_scene(build_scene(cfg.maze), device="cpu"), cfg, n_frames=6)
    base = ["play", "--display", "none", "--device", "cpu"] + TINY
    one, batched, resumed = (str(tmp_path / n) for n in ("one.png", "batch.png", "resume.png"))
    ckpt = str(tmp_path / "s.npz")
    assert cli.main(base + ["--frames", "6", "--out", one]) == 0
    assert cli.main(base + ["--frames", "6", "--batch-frames", "3", "--out", batched]) == 0
    assert cli.main(base + ["--frames", "4", "--save-state", ckpt]) == 0
    assert cli.main(base + ["--frames", "2", "--load-state", ckpt, "--out", resumed]) == 0
    for path in (one, batched, resumed):
        assert np.array_equal(read_png(path), want), path


def test_render_without_device_needs_the_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "mirror_maze_tpu_torch", "render"] + TINY
                         + ["--out", str(tmp_path / "f.png")], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr and "--device cpu" in out.stderr
    assert not (tmp_path / "f.png").exists()
