"""Frame-loop drivers (counterpart of the JAX package's ``runtime/loop.py``):
headless scripted runs and interactive play in a terminal.

The reference's loop (`main.rs:767-939`) is an AppKit event pump and a 60 fps
frame-deadline gate around one compute + render dispatch. Here the device
work is the engine step (runtime/step.py, the two CUDA kernels on the card);
these drivers supply the host side: input, pacing and display.

- ``run_scripted``: a deterministic input script (tests, goldens, demos);
  returns the final state and the last frame.
- ``InteractiveLoop``: the terminal driver. It reads WASD, arrow keys and
  SGR-1006 / X10 mouse reports from stdin in cbreak mode, the closest
  headless analog of the reference's KeyDown/KeyUp/MouseMoved pump
  (`main.rs:896-937`), paces to the configured fps, and paints frames as
  ANSI half-blocks or kitty graphics (or not at all).

The JAX package drains the terminal with a native helper
(``native/term_present.cpp``) and keeps byte-identical Python forms; the
port uses the Python forms: ``term_poll`` here and ``utils/imageio.py
ansi_frame``.
"""

from __future__ import annotations

import os
import select
import time
from typing import Iterable

import numpy as np

from ..config import EngineConfig
from ..render.scenebuf import DeviceScene
from .state import EngineState, FrameInputs, init_state
from .step import make_scan_step, make_step


def run_scripted(
    scene: DeviceScene,
    cfg: EngineConfig,
    inputs: Iterable[FrameInputs] | None = None,
    n_frames: int = 64,
    seed: int = 0,
    state: EngineState | None = None,
):
    """Run the given per-frame inputs (``n_frames`` idle frames if None) on
    the scene's device. Returns (final_state, last_frame_u8 as NumPy); only
    the final frame is fetched."""
    step = make_step(scene, cfg)
    st = state if state is not None else init_state(cfg, seed, device=scene.planes.device)
    script = [FrameInputs.idle()] * n_frames if inputs is None else list(inputs)
    frame = None
    for inp in script:
        st, frame = step(st, inp)
    if frame is not None:
        frame = frame.cpu().numpy()
    return st, frame


def host_field(state, name: str) -> np.ndarray:
    """One field of an engine state on the host: of the single engine's
    EngineState, or of the first band of a band engine's
    ShardedEngineState (the camera fields and the frame counter are the
    same on every band)."""
    x = getattr(state, name)
    if isinstance(x, tuple):
        x = x[0]
    return x.detach().cpu().numpy()


def term_poll(fd: int, cap: int = 256) -> bytes:
    """Every byte pending on ``fd``, without blocking: the reference's
    drain-until-None event pump (`main.rs:896-904`), read in chunks of
    ``cap`` so a deep backlog (key autorepeat across a stall) leaves no stale
    input queued. The Python form of the JAX package's native
    ``mmx_term_poll``."""
    out = b""
    while select.select([fd], [], [], 0.0)[0]:
        chunk = os.read(fd, cap)
        if not chunk:           # end of file: readable, nothing to read
            break
        out += chunk
    return out


class FramePacer:
    """Frame-deadline gate shared by every interactive driver.

    The reference gates on an NSDate deadline compare (`main.rs:775-776`).
    This is the host twin: advance the deadline by frames * spf, sleep the
    remainder, and RESET (not accumulate) when behind, so a slow stretch does
    not turn into a permanent sprint. ``sleep`` is injectable so the HTTP
    server can pace with its stop event's interruptible wait; ``clock`` is
    the monotonic clock."""

    def __init__(self, fps: float, clock=time.monotonic):
        self.spf = 1.0 / float(fps)
        self.clock = clock
        self.deadline = clock()

    def wait(self, stepped: int, sleep=time.sleep) -> None:
        self.deadline += self.spf * stepped
        delay = self.deadline - self.clock()
        if delay > 0:
            sleep(delay)
        else:
            self.deadline = self.clock()


def _lead_first_frame(k: int, inp: FrameInputs) -> list:
    """A batch's inputs: the polled input on its first frame, idle frames
    after it."""
    return [inp] + [FrameInputs.idle()] * (k - 1)


class InteractiveLoop:
    """Interactive terminal driver with the reference's control scheme:
    WASD to move (`main.rs:786-815`), continuous mouse-x yaw from SGR-1006
    terminal mouse reports (`main.rs:922-925`: half_theta -= DX/512), 'j'/'l'
    or the arrow keys as discrete yaw, 'q' to quit; frames paced by the
    reference's deadline gate (`main.rs:775-776`)."""

    YAW_STEP = 16.0  # pixels of synthetic mouse delta per keypress
    # Terminals report mouse positions in character CELLS; the reference's
    # sensitivity (DX/512, `main.rs:923`) is in pixels. A text cell is ~8 px
    # wide in common fonts, so one cell of motion maps to 8 px.
    MOUSE_PX_PER_CELL = 8.0
    # A per-event jump of more cells than this is a pointer re-entry (events
    # stop at the window edge) or a dropped-event gap, not motion: terminal
    # reports are ABSOLUTE positions, and integrating a re-entry difference
    # would whip the camera round in one frame. Such events only re-anchor.
    MOUSE_REANCHOR_CELLS = 32
    # Enable/disable any-motion mouse tracking with SGR-1006 encoding.
    MOUSE_ON = "\x1b[?1003h\x1b[?1006h"
    MOUSE_OFF = "\x1b[?1003l\x1b[?1006l"

    def __init__(
        self,
        scene: DeviceScene,
        cfg: EngineConfig,
        seed: int = 0,
        batch_frames: int = 1,
        adaptive: bool = True,
        sharded_bands: int | None = None,
    ):
        """The engine runs on the scene's device.

        ``batch_frames`` > 1 steps that many frames per call through
        ``make_scan_step`` (a host loop of steps): the polled keys apply on
        the batch's first frame and idle frames follow, so input latency
        grows to ``batch_frames`` frame times; 1 samples input every frame
        as the reference does.

        ``adaptive`` (on by default; it matters only with ``batch_frames`` >
        1) steps PER FRAME while input is active and for about a second
        after (``choose_step``), and batches again when idle.

        ``sharded_bands`` runs the row-band engine (parallel/shard.py
        ``make_sharded_engine`` / ``make_sharded_scan_engine``) with that
        many bands, every band on the scene's device: the screen splits into
        horizontal bands with their own chunk queues, the camera simulation
        is replicated, and the present reads the neighbouring bands' rows.

        One frame is stepped on a scratch state before the session starts,
        so that its first-use costs (on the card: the nvcc build of the
        kernels the step launches, where they are not built yet) are paid
        here, not on the first frame the user sees."""
        dev = scene.planes.device
        self.cfg = cfg
        self.batch_frames = max(1, int(batch_frames))
        self.adaptive = adaptive and self.batch_frames > 1
        self._active_until = 0   # frame index until which input is "hot"
        self._had_input = False
        k = self.batch_frames
        if sharded_bands:
            from ..parallel.shard import make_sharded_engine, make_sharded_scan_engine

            devices = [dev] * int(sharded_bands)
            init_fn, step1 = make_sharded_engine(cfg, devices)

            def one(st, inp):
                return step1(scene, st, inp)

            if k > 1:
                _, scan_bands = make_sharded_scan_engine(cfg, devices)

                def batched(st, inp):
                    return scan_bands(scene, st, _lead_first_frame(k, inp))
        else:
            one = make_step(scene, cfg)

            def init_fn(seed):
                return init_state(cfg, seed, device=dev)

            if k > 1:
                scan = make_scan_step(scene, cfg)

                def batched(st, inp):
                    return scan(st, _lead_first_frame(k, inp))
        self.step = batched if k > 1 else one
        # The per-frame twin of the adaptive input path.
        self.step_one = one if self.adaptive else None
        self.state = init_fn(seed)
        self.frame = None
        one(init_fn(seed), FrameInputs.idle())     # the warm-up frame
        self._finish_init()

    @classmethod
    def from_engine(cls, cfg: EngineConfig, step_fn, state) -> "InteractiveLoop":
        """Wrap an EXTERNALLY built engine (e.g. the multiplayer step,
        parallel/multiplayer.py make_multiplayer_engine) in the terminal
        driver (input pump, display, pacing, watchdog) without building the
        standard step. ``step_fn(state, inputs) -> (state, frame)``;
        per-frame stepping only (a multiplayer exchange runs every frame)."""
        self = cls.__new__(cls)
        self.cfg = cfg
        self.batch_frames = 1
        self.adaptive = False
        self._active_until = 0
        self._had_input = False
        self.step = step_fn
        self.step_one = None
        self.state = state
        self.frame = None
        self._finish_init()
        return self

    def choose_step(self, n: int, active: bool):
        """THE adaptive per-frame-vs-batch policy, shared by the terminal
        loop and the HTTP server (runtime/server.py) so the two drivers
        cannot drift: while input is active (and for ~1 s after, the hot
        window), step PER FRAME so keys land on the next frame; otherwise run
        the batch. Returns (step_fn, frames it steps)."""
        if self.adaptive and active:
            self._active_until = n + int(self.cfg.screen.fps)
        if (
            self.adaptive
            and self.step_one is not None
            and (active or n < self._active_until)
        ):
            return self.step_one, 1
        return self.step, self.batch_frames

    @staticmethod
    def _thumb(frame, step_px: int):
        """Every ``step_px``-th pixel of every ``step_px``-th row of a
        frame, as a strided view on the frame's device: the terminal needs
        only ~display_cols pixels a row, so only those cross to the host."""
        return frame[::step_px, ::step_px]

    def _finish_init(self) -> None:
        self._last_mouse_x: int | None = None
        self._carry = b""  # escape sequence split across polls

    def _mouse_cell(self, x: int) -> float:
        """Turn one absolute mouse-cell column into a pixel delta against
        the running anchor; oversized jumps (pointer re-entry, dropped
        events) only re-anchor — see MOUSE_REANCHOR_CELLS."""
        dx = 0.0
        if self._last_mouse_x is not None:
            dcell = x - self._last_mouse_x
            if abs(dcell) <= self.MOUSE_REANCHOR_CELLS:
                dx = dcell * self.MOUSE_PX_PER_CELL
        self._last_mouse_x = x
        return dx

    def _poll_keys(self) -> FrameInputs:
        import sys

        if sys.stdin is None or not sys.stdin.isatty():
            # Headless invocation (piped stdin, or fd 0 closed at start-up,
            # when CPython sets sys.stdin to None): no cbreak mode, no key
            # pump, idle frames. Reading here would spin on end of file.
            # Idle frames are not input: clear the flag so that a stale hot
            # window cannot pin adaptive play at per-frame stepping.
            self._had_input = False
            return FrameInputs.idle()
        return self._parse_input(term_poll(sys.stdin.fileno()))

    def _parse_input(self, pending: bytes) -> FrameInputs:
        """Decode one poll's byte drain: WASD keys, SGR-1006 mouse frames
        (``ESC [ < b ; x ; y M|m``) integrated into a pixel mouse_dx like
        the reference's MouseMoved arm (`main.rs:922-928`), arrow keys as
        discrete yaw. Truncated escape sequences carry to the next poll."""
        carried = len(self._carry)
        data = self._carry + pending
        self._carry = b""
        a = s = d = w = False
        dx = 0.0
        i, n = 0, len(data)
        while i < n:
            b = data[i]
            if b == 0x1B:
                if i + 1 >= n:
                    # Trailing ESC: a truncated escape sequence (its bytes
                    # land next poll) or a bare ESC keypress. Carry it ONCE;
                    # if it was carried already and nothing followed within a
                    # whole poll interval, it is a bare ESC: drop it.
                    if i >= carried:
                        self._carry = data[i:]
                    break
                if data[i + 1] != ord("["):
                    if data[i + 1] == ord("O"):
                        # SS3 (application cursor mode): ESC O C/D are the
                        # arrow keys, honoured like CSI arrows.
                        if i + 2 >= n:
                            self._carry = data[i:]
                            break
                        if data[i + 2] == ord("C"):
                            dx += self.YAW_STEP
                        elif data[i + 2] == ord("D"):
                            dx -= self.YAW_STEP
                        i += 3
                        continue
                    # Alt chord: terminals send ESC + char within ONE poll's
                    # drain; consume both bytes, so Alt+Q does not quit and
                    # Alt+W does not walk. An ESC CARRIED from the previous
                    # poll was a bare ESC tap, and the char after it is a
                    # real keypress: drop only the ESC.
                    if i < carried:
                        i += 1
                    else:
                        i += 2
                    continue
                j = i + 2
                while j < n and not 0x40 <= data[j] <= 0x7E:
                    j += 1
                if j >= n:
                    self._carry = data[i:]
                    break
                fin, body = data[j], data[i + 2: j]
                if fin == ord("M") and not body:
                    # X10-encoded mouse report (a terminal that honours
                    # ?1003 but not ?1006): ESC [ M Cb Cx Cy carries three
                    # RAW payload bytes after the final 'M'. They are
                    # consumed here: parsed as keys, column 81 (byte 'q')
                    # would quit.
                    if j + 3 >= n:
                        self._carry = data[i:]
                        break
                    dx += self._mouse_cell(data[j + 2] - 32)
                    i = j + 4
                    continue
                if fin in (ord("M"), ord("m")) and body.startswith(b"<"):
                    parts = body[1:].split(b";")
                    if len(parts) == 3:
                        try:
                            x = int(parts[1])
                        except ValueError:
                            x = None
                        if x is not None:
                            dx += self._mouse_cell(x)
                elif fin == ord("C"):   # right arrow = 'l'
                    dx += self.YAW_STEP
                elif fin == ord("D"):   # left arrow = 'j'
                    dx -= self.YAW_STEP
                i = j + 1
                continue
            ch = chr(b)
            if ch == "q":
                raise KeyboardInterrupt
            a |= ch == "a"
            s |= ch == "s"
            d |= ch == "d"
            w |= ch == "w"
            if ch == "j":
                dx -= self.YAW_STEP
            if ch == "l":
                dx += self.YAW_STEP
            i += 1
        self._had_input = a or s or d or w or dx != 0.0
        return FrameInputs.make(a=a, s=s, d=d, w=w, mouse_dx=dx)

    def run(
        self,
        max_frames: int | None = None,
        out_png: str | None = None,
        display: str | None = "ansi",
        display_every: int = 6,
        display_cols: int = 100,
        watchdog_interval: int | None = 128,
    ):
        """Run the interactive loop.

        ``display="ansi"`` paints the view into the terminal as 24-bit
        half-block art every ``display_every`` frames (the headless stand-in
        for the reference's CAMetalLayer window), ``"kitty"`` as a
        full-resolution kitty graphics image, None not at all. With
        ``batch_frames`` > 1, ``max_frames`` rounds UP to whole batches.
        ``watchdog_interval`` enables runtime/watchdog.py's periodic state
        validation with rollback to the last good snapshot (None disables;
        the reference's whole failure story is a "Help!" print,
        `main.rs:828-844`). The final frame is written to ``out_png``.
        """
        import sys
        import termios

        from .watchdog import Watchdog

        wd = Watchdog(watchdog_interval) if watchdog_interval else None
        # Fresh decoder state per run: a stale mouse anchor would turn the
        # first event into a spurious yaw, and a stale hot window would force
        # per-frame stepping for up to a second.
        self._last_mouse_x = None
        self._carry = b""
        self._had_input = False
        self._active_until = 0
        # Headless stdin (pipe, /dev/null, CI): no cbreak mode and no mouse
        # pump (_poll_keys returns idle frames), instead of dying on
        # tcgetattr.
        tty_in = sys.stdin is not None and sys.stdin.isatty()
        fd = sys.stdin.fileno() if tty_in else -1
        old = termios.tcgetattr(fd) if tty_in else None
        pacer = FramePacer(self.cfg.screen.fps)
        try:
            if tty_in:
                # cbreak with TCSADRAIN, not tty.setcbreak's TCSAFLUSH: the
                # flush variant DISCARDS input typed before the loop starts.
                mode = termios.tcgetattr(fd)
                mode[3] &= ~(termios.ECHO | termios.ICANON)
                mode[6][termios.VMIN] = 1
                mode[6][termios.VTIME] = 0
                termios.tcsetattr(fd, termios.TCSADRAIN, mode)
                # Continuous mouse-look: any-motion tracking, SGR encoding
                # (parsed in _parse_input). Terminals without it ignore the
                # sequences; j/l and the arrows remain.
                sys.stdout.write(self.MOUSE_ON)
                sys.stdout.flush()
            n = 0
            shown = 0
            t_start = time.monotonic()
            while max_frames is None or n < max_frames:
                inp = self._poll_keys()
                step_fn, stepped = self.choose_step(n, self._had_input)
                self.state, self.frame = step_fn(self.state, inp)
                if wd is not None:
                    self.state = wd.check(self.state, n=stepped)
                n += stepped
                if display is not None and n >= shown + display_every:
                    shown = n
                    if display == "kitty":
                        from ..utils.imageio import kitty_frame

                        art = kitty_frame(self.frame.cpu().numpy())
                    else:
                        from ..utils.imageio import ansi_frame

                        step_px = max(1, -(-self.cfg.screen.width // display_cols))
                        small = self._thumb(self.frame, step_px).cpu().numpy()
                        art = ansi_frame(small, display_cols)
                    wall = time.monotonic() - t_start
                    c = host_field(self.state, "cam_center")
                    status = (
                        f"\nframe {n}  ({c[0]:+.1f}, {c[2]:+.1f})  "
                        f"{n / wall:.1f} fps  [wasd move, j/l turn, q quit]"
                    )
                    sys.stdout.write("\x1b[H\x1b[2J" + art + status + "\n")
                    sys.stdout.flush()
                pacer.wait(stepped)
        except KeyboardInterrupt:
            pass
        finally:
            if tty_in:
                sys.stdout.write(self.MOUSE_OFF)
                sys.stdout.flush()
                termios.tcsetattr(fd, termios.TCSADRAIN, old)
        if out_png and self.frame is not None:
            from ..utils.imageio import write_png

            write_png(out_png, self.frame.cpu().numpy())
