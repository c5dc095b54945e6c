"""The port's HTTP server (runtime/server.py) against the JAX package's:
the cases of tests/test_server.py on ``device="cpu"`` at 32x32 over real
sockets, plus ``InputBus``, ``FrameHub`` and the ``_input_allowed`` gate
driven through the same event and header tables as the JAX classes, with
the same results, and a live checkpoint that the JAX package's
``load_state`` restores bit for bit."""

import json
import socket
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_tools import port_config
from mirror_maze_tpu.config import (
    CameraConfig as JCamera,
    EngineConfig as JEngine,
    MazeConfig as JMaze,
    ScreenConfig as JScreen,
    TracerConfig as JTracer,
)
from mirror_maze_tpu.runtime import server as j_server
from mirror_maze_tpu_torch.render import upload_scene
from mirror_maze_tpu_torch.runtime.server import EngineServer, FrameHub, InputBus
from mirror_maze_tpu_torch.scene import build_scene
from mirror_maze_tpu_torch.utils import imageio

JCFG = JEngine(
    maze=JMaze(width=4, height=4),
    camera=JCamera(spawn=(-5.0, 0.0, -15.0)),
    tracer=JTracer(bounce_limit=2, mirror_limit=2),
    screen=JScreen(width=32, height=32, samples_per_pixel=2, chunks_per_frame=8, fps=30),
    intersector="brute",
)
CFG = port_config(JCFG)


def _get(port, path, timeout=10.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _post(port, path, obj, timeout=10.0, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(), method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _wait_stats(port, pred, timeout=30.0):
    t0 = time.monotonic()
    s = None
    while time.monotonic() - t0 < timeout:
        s = json.loads(_get(port, "/stats")[2])
        assert s["error"] is None, s["error"]
        if pred(s):
            return s
        time.sleep(0.02)
    raise AssertionError(f"stats predicate not met within {timeout}s: {s}")


def _decode(ctype, body):
    if ctype == "image/png":
        assert body.startswith(b"\x89PNG\r\n\x1a\n")
        return imageio.decode_png(body)
    import io

    from PIL import Image

    assert ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
    return np.asarray(Image.open(io.BytesIO(body)))


@pytest.fixture(scope="module")
def host_scene():
    return build_scene(CFG.maze)


@pytest.fixture(scope="module")
def scene(host_scene):
    return upload_scene(host_scene, device="cpu")


@pytest.fixture(scope="module")
def server(scene, host_scene):
    srv = EngineServer(scene, CFG, seed=0, port=0, stream_every=1, host_scene=host_scene,
                       map_size=96)
    srv.start()
    yield srv
    srv.stop()
    assert srv.stats()["error"] is None


def test_page_and_stats(server):
    status, ctype, body = _get(server.port, "/")
    assert status == 200 and "text/html" in ctype
    assert body == j_server._PAGE.encode()
    s = _wait_stats(server.port, lambda s: s["frame"] > 0)
    assert s["width"] == 32 and s["height"] == 32
    assert len(s["cam"]) == 3 and all(np.isfinite(s["cam"]))
    assert s["rollbacks"] == 0


@pytest.mark.parametrize("pil", [True, False])
def test_single_frame_endpoint(server, monkeypatch, pil):
    """/frame serves JPEG where PIL is present and PNG where it is not (the
    GPU machine may lack PIL): both decode to the 32x32 frame."""
    if not pil:
        monkeypatch.setattr(imageio, "jpeg_bytes", lambda img, quality=85: None)
    status, ctype, body = _get(server.port, "/frame")
    assert status == 200 and ctype == ("image/jpeg" if pil else "image/png")
    assert _decode(ctype, body).shape == (32, 32, 3)


def test_input_moves_and_turns_camera(server):
    s0 = _wait_stats(server.port, lambda s: s["frame"] > 0)
    # Hold W: the camera advances along +z (the reference's hold model).
    assert _post(server.port, "/input", {"w": True})[0] == 200
    s1 = _wait_stats(server.port, lambda s: abs(s["cam"][2] - s0["cam"][2]) > 0.5)
    assert _post(server.port, "/input", {"w": False})[0] == 200
    s2 = _wait_stats(server.port, lambda s: s["frame"] > s1["frame"] + 10)
    s3 = _wait_stats(server.port, lambda s: s["frame"] > s2["frame"] + 10)
    assert abs(s3["cam"][2] - s2["cam"][2]) < 0.2
    # A mouse delta turns: half_theta integrates -dx/512.
    ht0 = s3["half_theta"]
    assert _post(server.port, "/input", {"dx": 256.0})[0] == 200
    s4 = _wait_stats(server.port, lambda s: abs(s["half_theta"] - ht0) > 0.1)
    assert np.isfinite(s4["half_theta"])


def _open_stream(port):
    sk = socket.create_connection(("127.0.0.1", port), 10)
    sk.settimeout(20.0)
    sk.sendall(b"GET /stream HTTP/1.1\r\nHost: t\r\n\r\n")
    return sk


def _read_parts(sk, want, buf=b""):
    while buf.count(b"--mmxframe") < want:
        chunk = sk.recv(65536)
        assert chunk, "stream closed early"
        buf += chunk
    return buf


def test_stream_delivers_multipart_frames(server):
    with _open_stream(server.port) as sk:
        buf = _read_parts(sk, 3)
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b"200" in head.split(b"\r\n")[0]
    assert b"multipart/x-mixed-replace" in head
    part = rest.split(b"--mmxframe")[1]
    assert b"Content-Type: image/" in part
    payload = part.partition(b"\r\n\r\n")[2]
    assert payload.startswith(b"\x89PNG") or payload[:2] == b"\xff\xd8"


def test_stats_stage_times_are_the_fetch_and_encode_spans(server):
    """The fetcher's device-to-host copy and the encoder's encode are the
    spans server.fetch and server.encode; /stats reports the last of each."""
    from mirror_maze_tpu_torch.utils import profiling

    with _open_stream(server.port) as sk:
        _read_parts(sk, 2)
    s = _wait_stats(server.port, lambda s: s["fetched"] >= 2 and s["encoded"] >= 2)
    t = profiling.totals()
    assert t["server.fetch"]["count"] >= s["fetched"] and t["server.encode"]["count"] >= 2
    assert 0.0 <= s["fetch_ms"] <= 1e3 * t["server.fetch"]["seconds"] + 0.05
    assert 0.0 <= s["encode_ms"] <= 1e3 * t["server.encode"]["seconds"] + 0.05


def test_stats_report_the_span_totals(server):
    """/stats holds the process's span totals: the engine's steps (their
    upload, replays or eager frames, display) and the streaming stages."""
    with _open_stream(server.port) as sk:
        _read_parts(sk, 2)
    s = _wait_stats(server.port, lambda s: s["encoded"] >= 2)
    spans = s["spans"]
    assert {"step.call", "step.upload", "step.display", "server.fetch",
            "server.encode"} <= set(spans)
    for k in ("step.call", "server.fetch"):
        assert set(spans[k]) == {"count", "seconds", "self_seconds"}
        assert spans[k]["count"] >= 1
        assert 0.0 <= spans[k]["self_seconds"] <= spans[k]["seconds"]
    assert spans["step.call"]["self_seconds"] < spans["step.call"]["seconds"]


def test_stream_multiple_clients(server):
    """Two concurrent stream clients both receive frames; one dropping
    does not stall the other, and the client count settles back to 0."""
    a, b = _open_stream(server.port), _open_stream(server.port)
    try:
        buf_a = _read_parts(a, 2)
        assert b"multipart/x-mixed-replace" in _read_parts(b, 2)
        b.close()
        _read_parts(a, 5, buf_a)
    finally:
        a.close()
    t0 = time.monotonic()
    while server.hub.clients > 0 and time.monotonic() - t0 < 10:
        time.sleep(0.05)
    assert server.hub.clients == 0


def test_bad_requests(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.port, "/nope")
    assert e.value.code == 404
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/input", data=b"not json",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/ckpt", {})
    assert e.value.code == 409          # no checkpoint path configured


def test_frame_endpoint_is_fresh(server):
    """/frame with no stream client serves a current frame (each request
    asks the engine for a fresh encode)."""
    _wait_stats(server.port, lambda s: s["frame"] > 0)
    body1 = _get(server.port, "/frame")[2]
    assert _post(server.port, "/input", {"dx": 512.0})[0] == 200
    s = _wait_stats(server.port, lambda s: s["frame"] > 0)
    _wait_stats(server.port, lambda t: t["frame"] > s["frame"] + 8)
    assert _get(server.port, "/frame")[2] != body1


def test_input_rejects_cross_origin(server):
    for headers, code in (({"Origin": "http://evil.example:8000"}, 403),
                          ({"Origin": f"http://127.0.0.1:{server.port}"}, 200),
                          ({"Origin": "null"}, 403),
                          ({"Origin": "http://evil.example:80", "Host": "evil.example:80"}, 403)):
        try:
            got = _post(server.port, "/input", {"w": False}, headers=headers)[0]
        except urllib.error.HTTPError as e:
            got = e.code
        assert got == code, headers


def test_live_map_endpoint(server):
    """/map serves the minimap PNG with the camera marker; without a host
    scene it 404s."""
    from mirror_maze_tpu_torch.utils.minimap import render_minimap

    status, ctype, body = _get(server.port, "/map")
    assert status == 200 and ctype == "image/png"
    img = imageio.decode_png(body)
    assert img.shape == (96, 96, 3)
    assert (img[..., 0].astype(int) - img[..., 2].astype(int) > 100).any()
    cam, _half, quat = server._cam_snapshot
    want = render_minimap(server.host_scene, size=96, camera_center=np.float32(cam),
                          camera_quat=np.float32(quat))
    assert server.render_map() == imageio.png_bytes(want, level=1)
    saved = server.host_scene
    server.host_scene = None
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.port, "/map")
        assert e.value.code == 404
    finally:
        server.host_scene = saved


# --- The host classes against the JAX package's, on the same tables ---------------


BUS_EVENTS = [
    [{"w": True, "dx": 3.0}, {"dx": 4.0}, "poll", "poll", {"w": False}, "poll", "poll"],
    [{"a": 1, "d": True, "dx": -2.5}, "poll", {"a": 0, "s": True}, {"dx": 0.0}, "poll",
     {"x": True, "dx": 1e3}, "poll", "poll"],
    ["poll", {}, "poll", "poll", {"w": True, "a": True, "s": True, "d": True}, "poll"],
]


def _bus_run(bus, events, jax_side):
    out = []
    for ev in events:
        if ev == "poll":
            inp, active = bus.poll()
            keys = tuple(bool(k) for k in (np.asarray(inp.keys) if jax_side else inp.keys))
            out.append((keys, np.float32(inp.mouse_dx), bool(inp.rot_updated), active))
        else:
            bus.push(ev)
    return out


@pytest.mark.parametrize("i", range(len(BUS_EVENTS)))
def test_input_bus_matches_reference(i):
    assert (_bus_run(InputBus(), BUS_EVENTS[i], False)
            == _bus_run(j_server.InputBus(), BUS_EVENTS[i], True))


HUB_OPS = [("attach",), ("attach",), ("clients",), ("detach",), ("clients",),
           ("take",), ("request",), ("take",), ("take",), ("publish", b"a"),
           ("publish", b"b"), ("wait", 0, 0.1), ("wait", 2, 0.05), ("seq",),
           ("detach",), ("clients",), ("publish", b"c"), ("wait", 1, 0.0)]


def _hub_run(hub):
    out = []
    for op in HUB_OPS:
        if op[0] == "attach":
            hub.attach()
        elif op[0] == "detach":
            hub.detach()
        elif op[0] == "clients":
            out.append(hub.clients)
        elif op[0] == "take":
            out.append(hub.take_encode_request())
        elif op[0] == "request":
            hub.request_encode()
        elif op[0] == "publish":
            hub.publish(op[1], "image/png")
        elif op[0] == "wait":
            out.append(hub.wait_next(op[1], timeout=op[2]))
        else:
            out.append(hub.current_seq())
    return out


def test_frame_hub_matches_reference():
    assert _hub_run(FrameHub()) == _hub_run(j_server.FrameHub())


GATE_HEADERS = [
    {}, {"Host": "127.0.0.1:8000"}, {"Host": "localhost"}, {"Host": "Localhost:8000"},
    {"Host": "[::1]"}, {"Host": "[::1]:8000"}, {"Host": "evil.example"}, {"Host": ""},
    {"Host": "[::1"}, {"Origin": "null", "Host": "127.0.0.1"},
    {"Origin": "http://127.0.0.1:8000", "Host": "127.0.0.1:8000"},
    {"Origin": "http://127.0.0.1:8001", "Host": "127.0.0.1:8000"},
    {"Origin": "http://evil.example:80", "Host": "evil.example:80"},
    {"Origin": "https://example.org", "Host": "example.org"},
]


@pytest.mark.parametrize("bound", ["127.0.0.1", "::1", "0.0.0.0", "10.1.2.3"])
def test_input_allowed_matches_reference(bound):
    for cls in (EngineServer, j_server.EngineServer):
        cls.fake = types.SimpleNamespace(
            httpd=types.SimpleNamespace(server_address=(bound, 8000)),
            _LOOPBACK=cls._LOOPBACK)
    try:
        for h in GATE_HEADERS:
            assert (EngineServer._input_allowed(EngineServer.fake, h)
                    == j_server.EngineServer._input_allowed(j_server.EngineServer.fake, h)), h
    finally:
        del EngineServer.fake, j_server.EngineServer.fake


# --- Watchdog, bands, checkpoints -----------------------------------------------------


def test_serve_watchdog_rolls_back_poisoned_state(scene):
    """A poisoned state in a live session rolls back (the watchdog in the
    engine loop), and the rollback shows in /stats."""
    srv = EngineServer(scene, CFG, seed=0, port=0, watchdog_interval=4)
    orig = srv.engine.choose_step

    def poisoned(n, active):
        step_fn, stepped = orig(n, active)
        if n >= 8 and srv._rollbacks == 0:
            def bad(st, inp):
                st2, f = step_fn(st, inp)
                return st2._replace(cam_center=st2.cam_center * float("nan")), f
            return bad, stepped
        return step_fn, stepped

    srv.engine.choose_step = poisoned
    srv.start()
    try:
        s = _wait_stats(srv.port, lambda s: (s["rollbacks"] or 0) >= 1, timeout=60)
        s2 = _wait_stats(srv.port, lambda t: t["frame"] > s["frame"] + 8, timeout=60)
        assert all(np.isfinite(s2["cam"]))
    finally:
        srv.stop()


def test_serve_band_engine_session_and_checkpoint(scene, tmp_path):
    """The server driving the row-band engine (2 bands on the CPU): frames
    stream, input moves the camera, and a live /ckpt of the band state
    restores through the port's band loader and the JAX package's."""
    from mirror_maze_tpu.parallel.shard import load_sharded_state as j_load_sharded
    from mirror_maze_tpu_torch.parallel.shard import load_sharded_state

    path = str(tmp_path / "bands.npz")
    srv = EngineServer(scene, CFG, seed=0, port=0, sharded_bands=2, stream_every=1,
                       ckpt_path=path)
    srv.start()
    try:
        _wait_stats(srv.port, lambda s: s["frame"] > 0, timeout=60)
        status, ctype, body = _get(srv.port, "/frame")
        assert status == 200 and _decode(ctype, body).shape == (32, 32, 3)
        assert _post(srv.port, "/input", {"w": True})[0] == 200
        _wait_stats(srv.port, lambda s: abs(s["cam"][2] - (-15.0)) > 0.5, timeout=60)
        status, body = _post(srv.port, "/ckpt", {}, timeout=60)
        info = json.loads(body)
        assert status == 200 and info["path"] == path and info["frame"] > 0
        st = load_sharded_state(path, CFG, ["cpu"] * 2)
        assert int(st.frame[0]) == info["frame"]
        jst = j_load_sharded(path, JCFG, 2)
        assert int(np.asarray(jst.frame).reshape(-1)[0]) == info["frame"]
        np.testing.assert_array_equal(np.asarray(jst.cam_center).reshape(-1, 3)[0],
                                      st.cam_center[0].numpy())
    finally:
        srv.stop()


def test_serve_checkpoint_endpoint_and_resume(scene, tmp_path):
    """POST /ckpt saves the live session to the server's fixed path at a
    frame boundary: the file restores bit for bit in the port and in the JAX
    package (the state the engine thread saved); stop() saves again, and a
    new server resumes from it."""
    from mirror_maze_tpu.runtime.state import load_state as j_load_state
    from mirror_maze_tpu_torch.runtime.state import EngineState, load_state

    path = str(tmp_path / "serve_ckpt.npz")
    srv = EngineServer(scene, CFG, seed=0, port=0, ckpt_path=path)
    saved = {}
    orig = srv._do_checkpoint

    def keep(eng):
        saved["state"] = EngineState(*(x.clone() for x in eng.state))
        orig(eng)

    srv._do_checkpoint = keep
    srv.start()
    try:
        _wait_stats(srv.port, lambda s: s["frame"] > 2)
        status, body = _post(srv.port, "/ckpt", {}, timeout=30)
        info = json.loads(body)
        assert status == 200 and info["path"] == path and info["frame"] > 0
        st = load_state(path, CFG, device="cpu")
        jst = j_load_state(path, JCFG)
        assert int(st.frame) == info["frame"] == int(saved["state"].frame)
        for f in EngineState._fields:
            want = getattr(saved["state"], f).numpy()
            np.testing.assert_array_equal(getattr(st, f).numpy(), want, err_msg=f)
            np.testing.assert_array_equal(np.asarray(getattr(jst, f)).astype(want.dtype), want,
                                          err_msg=f)
    finally:
        srv.stop()
    st2 = load_state(path, CFG, device="cpu")
    assert int(st2.frame) >= info["frame"]
    srv2 = EngineServer(scene, CFG, seed=0, port=0)
    srv2.engine.state = st2
    srv2.start()
    try:
        s = _wait_stats(srv2.port, lambda s: s["frame"] > 0)
        assert s["error"] is None
    finally:
        srv2.stop()


def test_engine_failure_is_reported_and_stops_the_session(scene):
    """An engine thread that dies records its traceback in /stats and stops
    the session instead of serving stale frames."""
    srv = EngineServer(scene, CFG, seed=0, port=0)

    def broken(n, active):
        raise RuntimeError("step failed on purpose")

    srv.engine.choose_step = broken
    srv.start()
    try:
        t0 = time.monotonic()
        while srv.stats()["error"] is None and time.monotonic() - t0 < 10:
            time.sleep(0.02)
        assert "step failed on purpose" in srv.stats()["error"]
        assert srv._stop.is_set()
    finally:
        srv.stop()
