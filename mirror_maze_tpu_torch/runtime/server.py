"""HTTP serving (counterpart of the JAX package's ``runtime/server.py``):
the engine streamed to, and driven from, a browser.

The reference's only presentation surface is a local AppKit window on the
machine that owns the GPU (`main.rs:767-939`). A card in a datacenter is
reached over the network, so ``EngineServer`` wraps the same engine wiring
the terminal loop drives (per-frame or batched steps, the adaptive input
path, row bands; runtime/loop.py) and presents it over plain HTTP with the
standard library's ``http.server``:

  GET  /        control page: live <img> stream, WASD key capture,
                pointer-drag mouse-look (the browser's stand-in for the
                reference's KeyDown/KeyUp/MouseMoved pump), minimap overlay
                (when the server has the host scene)
  GET  /stream  multipart/x-mixed-replace live frame stream
  GET  /frame   one current frame (image/jpeg through PIL, else image/png)
  GET  /map     live top-down minimap PNG with the camera marker
                (utils/minimap.py; host NumPy, no device work)
  GET  /stats   JSON: frame counter, fps, camera position and yaw, clients,
                the streaming stages' counts and times, rollbacks, error,
                and the process's span totals (utils/profiling.py)
  POST /input   JSON {w,a,s,d: bool, dx: float}: key HOLD state plus an
                accumulated mouse-x delta in reference pixels
  POST /ckpt    checkpoint the live session to the server's configured
                ckpt_path (CLI --save-state); the engine thread saves at
                its next frame boundary (runtime/state.py save_state; resume
                with --load-state). 409 when no path was configured.

Input follows the reference's hold model (`main.rs:786-815`): a POST sets
the held keys it names and ADDS its ``dx``; every engine frame samples the
held keys and drains the accumulated ``dx``, as the terminal pump does.

Threads. The engine steps in ONE thread, the only one that launches the
kernels or touches the engine state. It hands the newest frame tensor to a
FETCHER thread, which copies it to the host (``.cpu()``), and that hands the
host array to an ENCODER thread (JPEG or PNG), each handoff latest-wins, so
stepping, the device-to-host copy and the encode overlap. Every thread uses
the card's default stream (PyTorch's current stream is per thread, and each
starts on the default one), so the copy is ordered after the step that wrote
the frame, and the frame a step returns is a new tensor, never written again
while it is fetched. HTTP handler threads touch only encoded bytes, the
input bus and the host snapshot the engine thread writes.

Frames cross to the host only when a client is connected (or asked for one
through /frame), every ``stream_every`` frames, optionally stride-sampled on
the device first (``stream_scale``).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..config import EngineConfig
from ..render.scenebuf import DeviceScene
from ..utils.profiling import span, totals
from .loop import InteractiveLoop, host_field
from .state import FrameInputs

_PAGE = """<!doctype html>
<html><head><title>mirror-maze-tpu</title><style>
  body { background:#111; color:#ccc; font:14px monospace; margin:0;
         display:flex; flex-direction:column; align-items:center }
  img { image-rendering:pixelated; max-width:100vw; max-height:90vh }
  #bar { padding:6px }
  #map { position:fixed; top:8px; right:8px; width:160px; height:160px;
         opacity:0.85; border:1px solid #333; display:none }
</style></head><body>
<img id="view" src="/stream" draggable="false">
<img id="map" draggable="false">
<div id="bar">WASD move &middot; drag to look &middot; [click view first]
  <span id="stat"></span></div>
<script>
const held = {w:false, a:false, s:false, d:false};
let dx = 0, dirty = false;
function post() {
  if (!dirty) return;
  dirty = false;
  const body = JSON.stringify({...held, dx});
  dx = 0;
  fetch('/input', {method:'POST', body}).catch(()=>{});
}
setInterval(post, 50);
setInterval(async () => {
  try {
    const s = await (await fetch('/stats')).json();
    document.getElementById('stat').textContent =
      ` | frame ${s.frame} @ ${s.fps.toFixed(1)} fps ` +
      `(${s.cam[0].toFixed(1)}, ${s.cam[2].toFixed(1)})`;
  } catch (e) {}
}, 1000);
const map = document.getElementById('map');
let mapOk = true;
setInterval(async () => {
  if (!mapOk) return;
  try {
    // fetch (not an Image probe) so the HTTP status is visible: only a
    // 404 — "this server has no host scene" — disables the overlay for
    // the session; transient network/5xx errors just retry next tick.
    const r = await fetch('/map?t=' + Date.now());
    if (r.status === 404) { mapOk = false; return; }
    if (!r.ok) return;
    const u = URL.createObjectURL(await r.blob());
    // Revoke the PREVIOUS blob unconditionally (onload-only revocation
    // leaked URLs when a body failed to decode or a newer tick
    // superseded a pending load — slow growth in long sessions).
    if (map.dataset.blob) URL.revokeObjectURL(map.dataset.blob);
    map.dataset.blob = u;
    map.onload = () => { map.style.display = 'block'; };
    map.src = u;
  } catch (e) {}
}, 2000);
const keymap = {KeyW:'w', KeyA:'a', KeyS:'s', KeyD:'d'};
addEventListener('keydown', e => {
  const k = keymap[e.code];
  if (k && !held[k]) { held[k] = true; dirty = true; }
});
addEventListener('keyup', e => {
  const k = keymap[e.code];
  if (k) { held[k] = false; dirty = true; }
});
let drag = false;
const img = document.getElementById('view');
img.addEventListener('pointerdown', e => {
  drag = true; img.setPointerCapture(e.pointerId);
});
addEventListener('pointerup', () => { drag = false; });
addEventListener('pointermove', e => {
  if (drag) { dx += e.movementX; dirty = true; }
});
addEventListener('blur', () => {
  for (const k in held) held[k] = false;
  dirty = true;
});
</script></body></html>
"""


def _camera_snapshot(state) -> tuple:
    """(camera centre, yaw half-angle, quaternion) of an engine state as
    host floats (of the first band of a band engine's)."""
    return ([float(c) for c in host_field(state, "cam_center")],
            float(host_field(state, "half_theta")),
            [float(q) for q in host_field(state, "quat")])


class InputBus:
    """Thread-safe held-keys + accumulated mouse-dx, sampled per frame."""

    def __init__(self):
        self._lock = threading.Lock()
        self._held = {"w": False, "a": False, "s": False, "d": False}
        self._dx = 0.0
        self._seen = False  # any input since the last poll

    def push(self, event: dict) -> None:
        with self._lock:
            for k in self._held:
                if k in event:
                    self._held[k] = bool(event[k])
            self._dx += float(event.get("dx", 0.0))
            self._seen = True

    def poll(self) -> tuple[FrameInputs, bool]:
        """(inputs, active): the frame's inputs; ``active`` mirrors the
        terminal pump's _had_input (drives adaptive batching)."""
        with self._lock:
            held, dx, seen = dict(self._held), self._dx, self._seen
            self._dx, self._seen = 0.0, False
        active = seen or any(held.values()) or dx != 0.0
        return FrameInputs.make(**held, mouse_dx=dx), active


class FrameHub:
    """Latest-frame buffer with a wakeup for streaming handlers.

    Holds exactly ONE encoded frame: stream consumers that fall behind
    skip to the newest (a live view must not buffer a backlog). The
    client counter and the one-shot encode request are guarded by the
    same condition lock — handler threads and the engine thread both
    touch them (an unsynchronized lost update on ``clients`` could
    under-count to 0 with a live stream attached and stall it)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._seq = 0
        self._buf: bytes | None = None
        self._ctype = "image/png"
        self._clients = 0
        self._want_encode = False

    @property
    def clients(self) -> int:
        with self._cond:
            return self._clients

    def attach(self) -> None:
        with self._cond:
            self._clients += 1

    def detach(self) -> None:
        with self._cond:
            self._clients -= 1

    def current_seq(self) -> int:
        with self._cond:
            return self._seq

    def request_encode(self) -> None:
        """One-shot ask for a fresh encode: the engine thread honors it on
        its next frame even with zero stream clients attached (the /frame
        endpoint's freshness hook — without it, a stream-less /frame
        would serve the first-ever banked frame forever)."""
        with self._cond:
            self._want_encode = True
            self._cond.notify_all()

    def take_encode_request(self) -> bool:
        with self._cond:
            want, self._want_encode = self._want_encode, False
            return want

    def publish(self, buf: bytes, ctype: str) -> None:
        with self._cond:
            self._seq += 1
            self._buf, self._ctype = buf, ctype
            self._cond.notify_all()

    def wait_next(self, seen_seq: int, timeout: float = 1.0):
        """Block until a frame newer than seen_seq exists (or timeout);
        returns (seq, bytes, ctype) — bytes is None on timeout/no frame."""
        end = time.monotonic() + timeout
        with self._cond:
            while self._seq <= seen_seq:
                remaining = end - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
            if self._seq <= seen_seq or self._buf is None:
                return seen_seq, None, self._ctype
            return self._seq, self._buf, self._ctype


class EngineServer:
    """Serve an interactive engine session over HTTP.

    Reuses InteractiveLoop's engine wiring (per-frame or batched steps, the
    adaptive input path, row bands) and replaces its stdin pump and
    terminal display with the network surface above. ``port=0`` binds an
    ephemeral port (see ``.port``). The engine runs on the scene's device.
    """

    def __init__(
        self,
        scene: DeviceScene,
        cfg: EngineConfig,
        seed: int = 0,
        host: str = "127.0.0.1",
        port: int = 8000,
        batch_frames: int = 1,
        adaptive: bool = True,
        sharded_bands: int | None = None,
        stream_every: int = 2,
        stream_scale: int = 1,
        jpeg_quality: int = 85,
        host_scene=None,
        map_size: int = 320,
        engine=None,
        watchdog_interval: int | None = 128,
        ckpt_path: str | None = None,
    ):
        """``host_scene`` (the builder's Scene, optional) enables the
        live ``/map`` endpoint + page overlay — the DeviceScene carries
        derived intersection constants, not the raw quad geometry the
        minimap rasterizer draws.

        ``engine`` (optional) serves an EXTERNALLY built engine instead
        of constructing the standard InteractiveLoop — any object with
        the loop's driving surface (``state``/``frame``/``choose_step``/
        ``_thumb``), e.g. ``InteractiveLoop.from_engine`` wrapping the
        multiplayer step: that is how ``serve --players N`` puts each
        player's view in a browser. ``scene`` may then be None.

        ``watchdog_interval`` wires runtime/watchdog.py into the serve
        engine loop, same as the terminal driver (InteractiveLoop.run):
        the state is validated every that many frames and rolled back to
        the last good snapshot if it went non-finite, for the single,
        band and externally built (multiplayer) engines alike, with the
        rollback count in /stats. None disables.

        ``ckpt_path`` enables the POST /ckpt endpoint and the save-on-
        stop checkpoint (runtime/state.py save_state .npz; bit-exact
        resume through ``serve --load-state`` / ``play --load-state``). The
        path is FIXED at construction (CLI --save-state): clients can
        trigger a save but never choose where it lands."""
        self.cfg = cfg
        self.host_scene = host_scene
        self.map_size = int(map_size)
        self.engine = engine if engine is not None else InteractiveLoop(
            scene, cfg, seed=seed, batch_frames=batch_frames,
            adaptive=adaptive, sharded_bands=sharded_bands,
        )
        self.bus = InputBus()
        self.hub = FrameHub()
        self.stream_every = max(1, int(stream_every))
        self.stream_scale = max(1, int(stream_scale))
        self.jpeg_quality = int(jpeg_quality)
        self._stop = threading.Event()
        self._fps = 0.0
        self._frames_stepped = 0
        self._error: str | None = None
        self.watchdog_interval = watchdog_interval
        self._rollbacks = 0
        self.ckpt_path = ckpt_path
        # Checkpoint handshake: HTTP handlers REQUEST a save; only the
        # engine thread touches the state, so it performs the save between
        # frames, where the state is whole, and bumps _ckpt_done.
        self._ckpt_cond = threading.Condition()
        self._ckpt_req = 0
        self._ckpt_done = 0
        self._ckpt_info: dict | None = None
        # Host camera snapshot, written ONLY by the engine thread: stats()
        # and /map never touch device tensors from an HTTP thread.
        self._cam_snapshot = _camera_snapshot(self.engine.state)
        self._thumb = self.engine._thumb

        hub, bus, me = self.hub, self.bus, self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet access log
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path == "/stats":
                    self._send(200, "application/json",
                               json.dumps(me.stats()).encode())
                elif self.path.split("?")[0] == "/map":
                    buf = me.render_map()
                    if buf is None:
                        self._send(404, "text/plain",
                                   b"no host scene for map\n")
                    else:
                        self._send(200, "image/png", buf)
                elif self.path == "/frame":
                    # Ask the engine for a FRESH encode and wait for it:
                    # without the request, a stream-less session would
                    # serve its first banked frame forever (encoding is
                    # otherwise gated on stream clients).
                    cur = hub.current_seq()
                    hub.request_encode()
                    seq, buf, ctype = hub.wait_next(cur, timeout=5.0)
                    if buf is None:
                        # Engine stalled/stopped: fall back to whatever
                        # frame is banked rather than erroring a viewer.
                        seq, buf, ctype = hub.wait_next(0, timeout=0.0)
                    if buf is None:
                        self._send(503, "text/plain", b"no frame yet\n")
                    else:
                        self._send(200, ctype, buf)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=mmxframe",
                    )
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    hub.attach()
                    seen = 0
                    try:
                        while not me._stop.is_set():
                            seen, buf, ctype = hub.wait_next(seen, 1.0)
                            if buf is None:
                                continue
                            self.wfile.write(
                                b"--mmxframe\r\n"
                                + f"Content-Type: {ctype}\r\n"
                                  f"Content-Length: {len(buf)}"
                                  "\r\n\r\n".encode()
                                + buf + b"\r\n"
                            )
                    except (BrokenPipeError, ConnectionResetError,
                            TimeoutError):
                        pass
                    finally:
                        hub.detach()
                else:
                    self._send(404, "text/plain", b"not found\n")

            def do_POST(self):
                if self.path == "/input":
                    if not me._input_allowed(self.headers):
                        self._send(403, "text/plain", b"cross-origin\n")
                        return
                    n = int(self.headers.get("Content-Length", 0) or 0)
                    try:
                        event = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        self._send(400, "text/plain", b"bad json\n")
                        return
                    if isinstance(event, dict):
                        bus.push(event)
                    self._send(200, "application/json", b"{}")
                elif self.path == "/ckpt":
                    # Session persistence: save the full engine state to
                    # the server's FIXED ckpt_path (never client-chosen).
                    # Same abuse gate as /input — a cross-site page must
                    # not be able to trigger disk writes.
                    if not me._input_allowed(self.headers):
                        self._send(403, "text/plain", b"cross-origin\n")
                        return
                    if me.ckpt_path is None:
                        self._send(
                            409, "text/plain",
                            b"no checkpoint path configured "
                            b"(serve --save-state PATH)\n",
                        )
                        return
                    info = me.request_checkpoint()
                    if info is None:
                        self._send(503, "text/plain", b"engine stalled\n")
                    elif "error" in info:
                        self._send(500, "application/json",
                                   json.dumps(info).encode())
                    else:
                        self._send(200, "application/json",
                                   json.dumps(info).encode())
                else:
                    self._send(404, "text/plain", b"not found\n")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._engine_thread = threading.Thread(
            target=self._run_engine, daemon=True
        )
        # Streaming pipeline, THREE stages overlapped (latest-wins
        # handoffs): the engine thread hands the newest device frame to
        # the FETCHER (the device-to-host copy), which hands the host
        # array to the ENCODER (JPEG/PNG), so the encode of frame N runs
        # under the copy of frame N+1 and both under the stepping.
        self._enc_cond = threading.Condition()
        self._enc_frame = None
        self._fetch_cond = threading.Condition()
        self._fetched = None
        self._fetched_n = 0
        self._fetch_ms = 0.0
        self._encoded_n = 0
        self._encode_ms = 0.0
        self._fetcher_thread = threading.Thread(
            target=self._run_fetcher, daemon=True
        )
        self._encoder_thread = threading.Thread(
            target=self._run_encoder, daemon=True
        )

    # -- engine side ------------------------------------------------------

    def _fetch(self, frame) -> np.ndarray:
        """Device-to-host copy of one frame (stride-sampled on the device
        first with ``stream_scale`` > 1)."""
        if self.stream_scale > 1:
            frame = self._thumb(frame, self.stream_scale)
        return frame.cpu().numpy()

    def _encode_arr(self, arr: np.ndarray) -> tuple[bytes, str]:
        from ..utils.imageio import jpeg_bytes, png_bytes

        buf = jpeg_bytes(arr, quality=self.jpeg_quality)
        if buf is not None:
            return buf, "image/jpeg"
        return png_bytes(arr, level=1), "image/png"

    def _run_engine(self) -> None:
        # A dead engine thread must not look like a healthy server: log
        # the traceback, record it for /stats, and stop the session so
        # clients observe the failure instead of stale frames forever.
        try:
            self._engine_loop()
        except Exception:  # noqa: BLE001 — terminal: report and stop
            import sys
            import traceback

            self._error = traceback.format_exc()
            sys.stderr.write(self._error)
            self._stop.set()

    def _engine_loop(self) -> None:
        from .loop import FramePacer
        from .watchdog import Watchdog

        eng = self.engine
        # Watchdog parity with the terminal driver (InteractiveLoop.run):
        # periodic finite-state validation + rollback, on every engine
        # kind this server drives (single, band, and from_engine /
        # multiplayer, whose own run() is bypassed).
        wd = (
            Watchdog(self.watchdog_interval)
            if self.watchdog_interval else None
        )
        fps = self.cfg.screen.fps
        n = 0
        encoded_at = -self.stream_every
        snapped_at = 0
        # Sliding-window fps over the trailing ~1 s: a cumulative average
        # would carry a slow start forever.
        win_n, win_t = 0, time.monotonic()
        pacer = FramePacer(fps)
        while not self._stop.is_set():
            inp, active = self.bus.poll()
            # THE shared adaptive policy (InteractiveLoop.choose_step):
            # per-frame stepping while input is hot, batches when idle.
            step_fn, stepped = eng.choose_step(n, active)
            eng.state, eng.frame = step_fn(eng.state, inp)
            if wd is not None:
                eng.state = wd.check(eng.state, n=stepped)
                self._rollbacks = wd.rollbacks
            if self._ckpt_req > self._ckpt_done:
                self._do_checkpoint(eng)
            n += stepped
            self._frames_stepped = n
            now = time.monotonic()
            if now - win_t >= 1.0:
                self._fps = (n - win_n) / (now - win_t)
                win_n, win_t = n, now
            # Encode when someone is (or could be) watching: the first
            # frame is always banked for /frame; after that, fetch+encode
            # with stream clients attached (at stream_every cadence) or
            # immediately when a /frame request asked for a fresh one.
            # The engine thread only HANDS OVER the device frame: the
            # fetcher and encoder threads pay the copy and the encode.
            want = self.hub.take_encode_request()
            if want or (
                n >= encoded_at + self.stream_every
                and (self.hub.clients > 0 or encoded_at < 0)
            ):
                encoded_at = n
                with self._enc_cond:
                    self._enc_frame = eng.frame
                    self._enc_cond.notify()
            # Camera snapshot for /stats: a small device fetch (it waits for
            # the step), so it rides the encode cadence with clients
            # attached and drops to ~1 Hz idle.
            snap_every = (
                self.stream_every if self.hub.clients > 0
                else max(int(fps), 1)
            )
            if n >= snapped_at + snap_every:
                snapped_at = n
                self._cam_snapshot = _camera_snapshot(eng.state)
            pacer.wait(stepped, sleep=self._stop.wait)

    def _run_fetcher(self) -> None:
        """Fetch device frames handed over by the engine thread, newest
        first, and hand the host arrays to the encoder (latest-wins: a
        slow encode drops to the newest fetched frame). Runs until stop;
        a failure here is as terminal as an engine failure (clients
        would silently stop receiving frames)."""
        try:
            while not self._stop.is_set():
                with self._enc_cond:
                    while self._enc_frame is None:
                        if self._stop.is_set():
                            return
                        self._enc_cond.wait(0.5)
                    frame, self._enc_frame = self._enc_frame, None
                with span("server.fetch") as fetched:
                    arr = self._fetch(frame)
                self._fetch_ms = 1000.0 * fetched.seconds
                with self._fetch_cond:
                    self._fetched = arr
                    self._fetched_n += 1
                    self._fetch_cond.notify()
        except Exception:  # noqa: BLE001 — terminal: report and stop
            import sys
            import traceback

            self._error = traceback.format_exc()
            sys.stderr.write(self._error)
            self._stop.set()

    def _run_encoder(self) -> None:
        """Encode fetched host arrays and publish them to the hub,
        overlapping the next frame's device-to-host copy."""
        try:
            while not self._stop.is_set():
                with self._fetch_cond:
                    while self._fetched is None:
                        if self._stop.is_set():
                            return
                        self._fetch_cond.wait(0.5)
                    arr, self._fetched = self._fetched, None
                with span("server.encode") as encoded:
                    buf, ctype = self._encode_arr(arr)
                    self.hub.publish(buf, ctype)
                self._encoded_n += 1
                self._encode_ms = 1000.0 * encoded.seconds
        except Exception:  # noqa: BLE001 — terminal: report and stop
            import sys
            import traceback

            self._error = traceback.format_exc()
            sys.stderr.write(self._error)
            self._stop.set()

    def _do_checkpoint(self, eng) -> None:
        """Save the engine state (engine thread only: between frames the
        state is whole) and release every waiting /ckpt handler."""
        from .state import save_state

        try:
            save_state(self.ckpt_path, eng.state)
            info = {
                "path": self.ckpt_path,
                "frame": int(host_field(eng.state, "frame").reshape(-1)[0]),
            }
        except Exception as e:  # noqa: BLE001 — surface to the requester
            info = {"error": f"{type(e).__name__}: {e}"}
        with self._ckpt_cond:
            self._ckpt_done = self._ckpt_req
            self._ckpt_info = info
            self._ckpt_cond.notify_all()

    def request_checkpoint(self, timeout: float = 30.0) -> dict | None:
        """Ask the engine thread to checkpoint at its next frame boundary
        and wait for the result dict (None on timeout / stopped engine /
        no ckpt_path configured)."""
        if self.ckpt_path is None:
            return None
        with self._ckpt_cond:
            my = self._ckpt_req = self._ckpt_req + 1
            end = time.monotonic() + timeout
            while self._ckpt_done < my and not self._stop.is_set():
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return None
                self._ckpt_cond.wait(min(remaining, 0.5))
            return self._ckpt_info if self._ckpt_done >= my else None

    # -- public surface ----------------------------------------------------

    _LOOPBACK = ("127.0.0.1", "localhost", "::1")

    def _input_allowed(self, headers) -> bool:
        """Gate POST /input against web-page-driven abuse.

        Two independent checks:
        - Origin (when a browser sends one) must be a real authority
          matching the request's Host — classic cross-site POSTs fail;
          ``Origin: null`` (sandboxed iframes, data: pages) is REJECTED
          rather than skipped.
        - When the server is bound to loopback, the Host header's
          hostname must itself be a loopback name: a DNS-rebinding page
          controls BOTH Origin and Host (they match each other), but it
          cannot make its hostname literally "127.0.0.1"/"localhost"
          without losing the rebinding. (Bound to a public address the
          legitimate Host is deployment-specific; only the Origin check
          applies.)
        Non-browser clients (curl, scripts) send no Origin and pass the
        Origin check; the Host check still applies on loopback binds —
        which also means a reverse proxy on the same box forwarding to a
        loopback bind must rewrite Host to a loopback name (or the bind
        must be non-loopback) for /input to be accepted.
        """
        from urllib.parse import urlsplit

        origin = headers.get("Origin")
        if origin is not None:
            netloc = urlsplit(origin).netloc
            if not netloc or netloc != headers.get("Host"):
                return False
        bound = self.httpd.server_address[0]
        if bound in self._LOOPBACK:
            # urlsplit-based hostname: strips the port AND the IPv6
            # brackets (a naive rsplit(":") turned "[::1]" into "[:").
            try:
                host = urlsplit("//" + (headers.get("Host") or "")).hostname
            except ValueError:
                return False
            if (host or "") not in self._LOOPBACK:
                return False
        return True

    def render_map(self) -> bytes | None:
        """Live top-down minimap PNG with the camera marker, from the
        LATEST host-side camera snapshot — pure NumPy rasterization
        (utils/minimap.py), no device work from HTTP threads. Cached by
        snapshot, so idle sessions re-serve the same bytes."""
        if self.host_scene is None:
            return None
        cam, _half, quat = self._cam_snapshot
        key = (tuple(cam), tuple(quat))
        cached = getattr(self, "_map_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        from ..utils.imageio import png_bytes
        from ..utils.minimap import render_minimap

        img = render_minimap(
            self.host_scene, size=self.map_size,
            camera_center=np.asarray(cam, np.float32),
            camera_quat=np.asarray(quat, np.float32),
        )
        buf = png_bytes(img, level=1)
        self._map_cache = (key, buf)
        return buf

    def stats(self) -> dict:
        cam, half_theta, _quat = self._cam_snapshot
        return {
            "frame": int(self._frames_stepped),
            "fps": float(self._fps),
            "cam": cam,
            "half_theta": half_theta,
            "clients": int(self.hub.clients),
            "width": self.cfg.screen.width,
            "height": self.cfg.screen.height,
            # Streaming pipeline: frames fetched / encoded so far and
            # the last per-stage durations (the spans server.fetch and
            # server.encode, host clock); encode_ms overlaps the next
            # fetch.
            "fetched": int(self._fetched_n),
            "fetch_ms": round(float(self._fetch_ms), 1),
            "encoded": int(self._encoded_n),
            "encode_ms": round(float(self._encode_ms), 1),
            # Watchdog rollbacks this session (0 on a healthy run;
            # None when the watchdog is disabled).
            "rollbacks": (
                int(self._rollbacks) if self.watchdog_interval else None
            ),
            "error": self._error,
            # Where the process's host time went: every span's count,
            # seconds and self seconds so far (utils/profiling.py), the
            # steps' upload, replays, hand-back and display, the graphs'
            # eager frames and captures, the kernels' build and load, the
            # fetch and the encode.
            "spans": totals(),
        }

    def start(self) -> None:
        self._engine_thread.start()
        self._fetcher_thread.start()
        self._encoder_thread.start()
        self._http_thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._ckpt_cond:
            self._ckpt_cond.notify_all()
        with self._enc_cond:
            self._enc_cond.notify_all()
        with self._fetch_cond:
            self._fetch_cond.notify_all()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._engine_thread.join(timeout=10.0)
        self._fetcher_thread.join(timeout=10.0)
        self._encoder_thread.join(timeout=10.0)
        if self.ckpt_path is not None and not self._engine_thread.is_alive():
            # Save-on-stop (play --save-state parity): the engine thread
            # has joined, so the state is stable and safe to fetch here.
            from .state import save_state

            try:
                save_state(self.ckpt_path, self.engine.state)
            except Exception as e:  # noqa: BLE001 — shutdown best-effort
                import sys

                sys.stderr.write(f"checkpoint on stop failed: {e}\n")

    def serve_forever(self) -> None:
        """start() and block until KeyboardInterrupt."""
        self.start()
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
