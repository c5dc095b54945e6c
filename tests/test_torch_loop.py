"""The port's terminal driver (runtime/loop.py) and multi-frame inputs
(runtime/step.py stack_inputs / repeat_input) against the JAX package's.

- ``FramePacer`` with an injected clock and sleep: the same sleeps and
  deadlines as the reference's (a late frame resets the deadline);
- ``_parse_input`` / ``_mouse_cell`` on a table of byte streams and on
  seeded byte soups split at random points into polls: the same
  FrameInputs, carry, mouse anchor and KeyboardInterrupt, exactly;
- ``choose_step``'s adaptive policy on seeded (frame, input) sequences;
- ``stack_inputs`` / ``repeat_input`` and a stacked multi-frame step;
- headless ``run()`` bitwise ``run_scripted`` (single, batched, adaptive,
  bands), the tty path under a pseudo-terminal, and one brute-backend run
  bitwise the JAX loop's frame.

Everything on the CPU at 32x32."""

import io
import os
import pty
import sys
import termios
import types

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_tools import port_config
from mirror_maze_tpu.config import (
    CameraConfig as JCamera,
    EngineConfig as JEngine,
    MazeConfig as JMaze,
    ScreenConfig as JScreen,
    TracerConfig as JTracer,
)
from mirror_maze_tpu.runtime import loop as j_loop
from mirror_maze_tpu.runtime.state import FrameInputs as JInputs
from mirror_maze_tpu.runtime.step import repeat_input as j_repeat_input
from mirror_maze_tpu.runtime.step import stack_inputs as j_stack_inputs
from mirror_maze_tpu_torch.parallel import shard
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime import loop
from mirror_maze_tpu_torch.runtime.loop import FramePacer, InteractiveLoop, run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs, init_state
from mirror_maze_tpu_torch.runtime.step import (
    frame_inputs,
    make_scan_step,
    repeat_input,
    stack_inputs,
)
from mirror_maze_tpu_torch.scene import build_scene

JCFG = JEngine(
    maze=JMaze(width=4, height=4),
    camera=JCamera(spawn=(-5.0, 0.0, -15.0)),
    tracer=JTracer(bounce_limit=2, mirror_limit=2),
    screen=JScreen(width=32, height=32, samples_per_pixel=2, chunks_per_frame=8),
    intersector="brute",
)
CFG = port_config(JCFG)


@pytest.fixture(scope="module")
def scene():
    return upload_scene(build_scene(CFG.maze), device="cpu")


@pytest.fixture
def headless(monkeypatch):
    """stdin is not a terminal (a pipe at end of file)."""
    with open(os.devnull) as f:
        monkeypatch.setattr(sys, "stdin", f)
        yield


# --- FramePacer -----------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 100.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


@pytest.mark.parametrize("work", [
    [0.004] * 6,                                # always early: sleeps fill the frame
    [0.004, 0.05, 0.004, 0.004],                # one late frame: the deadline resets
    [0.03, 0.03, 0.001, 0.02, 0.0],             # behind, then ahead
])
@pytest.mark.parametrize("stepped", [1, 4])
def test_frame_pacer_matches_reference(monkeypatch, work, stepped):
    runs = []
    for side in ("jax", "port"):
        clock = FakeClock()
        if side == "jax":
            monkeypatch.setattr(j_loop, "time", types.SimpleNamespace(
                monotonic=clock.monotonic, sleep=clock.sleep))
            pacer = j_loop.FramePacer(60)
        else:
            pacer = FramePacer(60, clock=clock.monotonic)
        deadlines = []
        for w in work:
            clock.now += w
            slept = len(clock.sleeps)
            pacer.wait(stepped, sleep=clock.sleep)
            deadlines.append(pacer.deadline)
            # Early: slept exactly to the deadline. Late: the deadline is
            # reset to "now", not accumulated.
            assert pacer.deadline == clock.now
            if len(clock.sleeps) > slept:
                assert clock.sleeps[-1] > 0
        runs.append((clock.sleeps, deadlines))
    assert runs[0] == runs[1]


# --- The input parser -------------------------------------------------------------


def _parsers():
    j = j_loop.InteractiveLoop.__new__(j_loop.InteractiveLoop)
    j._last_mouse_x = None
    j._carry = b""
    p = InteractiveLoop.__new__(InteractiveLoop)
    p._finish_init()
    return j, p


def _parse(parser, data, jax_side):
    try:
        inp = parser._parse_input(data)
    except KeyboardInterrupt:
        return "quit", parser._carry, parser._last_mouse_x
    if jax_side:
        got = (tuple(bool(k) for k in np.asarray(inp.keys)), np.float32(inp.mouse_dx),
               bool(inp.rot_updated))
    else:
        got = (tuple(inp.keys), np.float32(inp.mouse_dx), bool(inp.rot_updated))
    return got, parser._carry, parser._last_mouse_x


def _assert_same_parse(polls):
    j, p = _parsers()
    for data in polls:
        want, got = _parse(j, data, True), _parse(p, data, False)
        assert got == want, (polls, data)
        if want[0] == "quit":
            return


X10 = b"\x1b[M"
PARSE_CASES = {
    "wasd and yaw keys": [b"w", b"wasd", b"jjl", b"", b"sd"],
    "sgr mouse motion": [b"w\x1b[<35;10;5M\x1b[<35;14;5M", b"\x1b[<32;11;5M"],
    "sgr truncated": [b"\x1b[<35;10;5M", b"\x1b[<35;2", b"0;5M", b"\x1b[<35;1", b"4;5m"],
    "csi arrows and release": [b"\x1b[D\x1b[<35;20;5m", b"\x1b[C", b"\x1b[1;5C"],
    "x10 never keys": [X10 + bytes([67, 32 + 81, 37]), X10 + bytes([67, 32 + 85, 37]),
                       X10 + bytes([67, 32 + 87, 37]), X10 + bytes([67]),
                       bytes([32 + 89, 37])],
    "x10 truncated at M": [X10, bytes([67, 32 + 70, 37]), b"w"],
    "bare esc then key": [b"\x1b", b"w", b"\x1b", b"", b"q"],
    "alt chords": [b"\x1bq\x1bw\x1ba", b"\x1bOC", b"\x1bOD", b"\x1bO", b"C", b"\x1bO", b"x"],
    "mouse re-entry": [b"\x1b[<35;10;5M", b"\x1b[<35;200;5M", b"\x1b[<35;198;5M",
                       b"\x1b[<35;230;5M"],
    "malformed sgr": [b"\x1b[<35;x;5M", b"\x1b[<35;5M", b"\x1b[<;;;M", b"w"],
    "quit mid poll": [b"wa", b"dq", b"w"],
    "x10 column q": [X10 + bytes([67, ord("q"), 37]), b"d"],
}


@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_parse_input_table_matches_reference(name):
    _assert_same_parse(PARSE_CASES[name])


SOUP = b"\x1b\x1b\x1b[[[<<;;;0123456789MmOCDwasdjlxq "


def _soup_polls(data: bytes, cuts) -> list:
    cuts = sorted({c % (len(data) + 1) for c in cuts})
    return [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(st.sampled_from(list(SOUP)), max_size=60).map(bytes),
       st.lists(st.integers(0, 1000), max_size=8))
def test_parse_input_byte_soup_matches_reference(data, cuts):
    _assert_same_parse(_soup_polls(data, cuts))


def test_parse_input_seeded_long_soup_matches_reference():
    """Long seeded streams without 'q', split at random points: the
    parsers stay in step poll after poll (the mouse anchor and the carry
    included)."""
    rng = np.random.default_rng(7)
    alphabet = np.frombuffer(SOUP.replace(b"q", b""), np.uint8)
    for _ in range(20):
        data = rng.choice(alphabet, size=400).tobytes()
        _assert_same_parse(_soup_polls(data, list(rng.integers(0, 400, size=40))))


def test_term_poll_drains_every_pending_byte():
    """The Python drain returns every pending byte (more than one chunk),
    as the reference's native pump does, and nothing once drained."""
    from mirror_maze_tpu.native.bindings import get_library, term_poll_native

    payload = bytes(range(256)) * 5 + b"\x1b[<35;10;5M"
    r, w = os.pipe()
    try:
        os.write(w, payload)
        assert loop.term_poll(r, cap=256) == payload
        assert loop.term_poll(r) == b""
        if get_library() is not None:
            os.write(w, payload)
            assert term_poll_native(r) == payload
    finally:
        os.close(r)
        os.close(w)


# --- choose_step -------------------------------------------------------------------


@pytest.mark.parametrize("batch,adaptive", [(1, True), (4, True), (4, False), (8, True)])
def test_choose_step_policy_matches_reference(batch, adaptive):
    sides = []
    for cls in (j_loop.InteractiveLoop, InteractiveLoop):
        o = cls.__new__(cls)
        o.cfg = CFG
        o.batch_frames = batch
        o.adaptive = adaptive and batch > 1
        o._active_until = 0
        o.step, o.step_one = "batch", ("one" if o.adaptive else None)
        sides.append(o)
    rng = np.random.default_rng(batch)
    n = 0
    for _ in range(400):
        active = bool(rng.random() < 0.1)
        picks = [o.choose_step(n, active) for o in sides]
        assert picks[0] == picks[1]
        n += picks[0][1]


# --- Multi-frame inputs -------------------------------------------------------------


def _script(fi):
    return ([fi.idle()] * 2 + [fi.make(w=True, mouse_dx=4.0)] + [fi.make(a=True, d=True)]
            + [fi.make(mouse_dx=-27.0)] + [fi.idle()])


def test_stack_and_repeat_inputs_match_reference():
    js, ps = j_stack_inputs(_script(JInputs)), stack_inputs(_script(FrameInputs))
    for f in FrameInputs._fields:
        j, p = np.asarray(getattr(js, f)), getattr(ps, f)
        assert p.dtype == j.dtype and p.shape == j.shape, f
        np.testing.assert_array_equal(p, j, err_msg=f)
    jr = j_repeat_input(JInputs.make(w=True, mouse_dx=2.0), 5)
    pr = repeat_input(FrameInputs.make(w=True, mouse_dx=2.0), 5)
    for f in FrameInputs._fields:
        np.testing.assert_array_equal(getattr(pr, f), np.asarray(getattr(jr, f)), err_msg=f)
    assert frame_inputs(ps) == _script(FrameInputs)
    with pytest.raises(TypeError):
        frame_inputs(FrameInputs.idle())


def test_scan_step_takes_stacked_inputs(scene):
    run = make_scan_step(scene, CFG)
    a_st, a_fr = run(init_state(CFG, 3, device="cpu"), _script(FrameInputs))
    b_st, b_fr = run(init_state(CFG, 3, device="cpu"), stack_inputs(_script(FrameInputs)))
    assert np.array_equal(a_fr.numpy(), b_fr.numpy())
    for a, b in zip(a_st, b_st):
        assert np.array_equal(a.numpy(), b.numpy())


# --- run() ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,adaptive", [(1, True), (3, False), (3, True)])
def test_headless_run_is_run_scripted(scene, headless, tmp_path, batch, adaptive):
    from mirror_maze_tpu_torch.utils.imageio import read_png

    lp = InteractiveLoop(scene, CFG, seed=4, batch_frames=batch, adaptive=adaptive)
    out = str(tmp_path / "final.png")
    lp.run(max_frames=6, out_png=out, display=None)
    st, frame = run_scripted(scene, CFG, n_frames=6, seed=4)
    assert np.array_equal(lp.frame.numpy(), frame)
    assert np.array_equal(read_png(out), frame)
    for a, b in zip(lp.state, st):
        assert np.array_equal(a.numpy(), b.numpy())


def test_headless_run_on_bands_is_the_band_engine(scene, headless):
    lp = InteractiveLoop(scene, CFG, seed=1, sharded_bands=2, batch_frames=2)
    lp.run(max_frames=4, display=None)
    init_fn, step_fn = shard.make_sharded_engine(CFG, ["cpu"] * 2)
    st = init_fn(seed=1)
    for _ in range(4):
        st, frame = step_fn(scene, st, FrameInputs.idle())
    assert np.array_equal(lp.frame.numpy(), frame.numpy())
    assert int(lp.state.frame[0]) == 4


def _run_under_pty(lp, pending: bytes, **kw):
    """run() with stdin the slave of a fresh pseudo-terminal, stdout
    captured; returns (output, termios before, termios after). The slave
    starts non-canonical (so bytes written before run() are readable) with
    echo ON and VMIN 0, so that run()'s cbreak mode (echo off, VMIN 1) is a
    change that must be undone."""
    master, slave = pty.openpty()
    old_stdin, old_stdout = sys.stdin, sys.stdout
    buf = io.StringIO()
    try:
        mode = termios.tcgetattr(slave)
        mode[3] = (mode[3] & ~termios.ICANON) | termios.ECHO
        mode[6][termios.VMIN], mode[6][termios.VTIME] = 0, 0
        termios.tcsetattr(slave, termios.TCSANOW, mode)
        before = termios.tcgetattr(slave)
        sys.stdin = os.fdopen(slave, "r", closefd=False)
        sys.stdout = buf
        if pending:
            os.write(master, pending)
        lp.run(**kw)
        after = termios.tcgetattr(slave)
    finally:
        sys.stdin, sys.stdout = old_stdin, old_stdout
        os.close(master)
        os.close(slave)
    return buf.getvalue(), before, after


def test_tty_run_reads_keys_paints_and_restores_the_terminal(scene):
    lp = InteractiveLoop(scene, CFG, seed=2)
    out, before, after = _run_under_pty(lp, b"w", max_frames=3, display="ansi",
                                        display_every=1, display_cols=16,
                                        watchdog_interval=None)
    assert after == before
    assert InteractiveLoop.MOUSE_ON in out and InteractiveLoop.MOUSE_OFF in out
    assert "\x1b[H\x1b[2J" in out and "\x1b[38;2;" in out and "▀" in out
    assert "frame 3" in out
    # The 'w' drained by the first poll walked the first frame only.
    st, frame = run_scripted(scene, CFG, inputs=[FrameInputs.make(w=True)]
                             + [FrameInputs.idle()] * 2, seed=2)
    assert np.array_equal(lp.frame.numpy(), frame)
    assert np.array_equal(lp.state.cam_center.numpy(), st.cam_center.numpy())


def test_tty_adaptive_batches_step_per_frame_on_input(scene):
    """Adaptive batching: a key (and the hot window after it) is served by
    per-frame steps; an idle session stays batched; 'q' quits at once."""
    def counted(pending, frames):
        lp = InteractiveLoop(scene, CFG, seed=1, batch_frames=4)
        calls = {"one": 0, "batch": 0}
        one, batch = lp.step_one, lp.step

        def step_one(s, i):
            calls["one"] += 1
            return one(s, i)

        def step(s, i):
            calls["batch"] += 1
            return batch(s, i)

        lp.step_one, lp.step = step_one, step
        _, before, after = _run_under_pty(lp, pending, max_frames=frames, display=None,
                                          watchdog_interval=None)
        assert after == before
        return calls

    assert counted(b"w", 3) == {"one": 3, "batch": 0}
    assert counted(b"", 8) == {"one": 0, "batch": 2}
    assert counted(b"q", 8) == {"one": 0, "batch": 0}


def test_brute_run_is_the_reference_loops_frame(headless, tmp_path):
    """One tiny brute-backend session through both packages' run(): the
    final frames bitwise equal."""
    from mirror_maze_tpu.render import upload_scene as j_upload
    from mirror_maze_tpu.scene import build_scene as j_build

    jl = j_loop.InteractiveLoop(j_upload(j_build(JCFG.maze)), JCFG, seed=0)
    jl.run(max_frames=4, display=None)
    lp = InteractiveLoop(upload_scene(build_scene(CFG.maze), device="cpu"), CFG, seed=0)
    lp.run(max_frames=4, display=None)
    assert np.array_equal(lp.frame.numpy(), np.asarray(jl.frame))
    assert np.array_equal(lp.state.perm.numpy(), np.asarray(jl.state.perm))
