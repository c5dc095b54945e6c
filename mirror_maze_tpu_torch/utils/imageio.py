"""Image IO: PNG, JPEG and GIF writers, terminal frames, PNG reading (a
copy of the JAX package's ``utils/imageio.py`` on NumPy arrays, with a
built-in PNG decoder beside its encoders).

The display path is the only place frames cross device->host (the reference
likewise never reads the image back — it flows screen texture -> drawable).
Uses PIL when present, else the built-in zlib PNG codec and GIF89a encoder,
so the engine has no hard imaging dependency. ``ansi_frame`` is the JAX
package's byte-identical Python form of its native half-block presenter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 (or float in [0,1]) array as PNG."""
    img = _to_u8(img)
    try:
        from PIL import Image

        Image.fromarray(img, mode="RGB").save(path)
        return
    except ImportError:
        pass
    with open(path, "wb") as f:
        f.write(png_bytes(img, level=6))


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return np.ascontiguousarray(img)


def png_bytes(img: np.ndarray, level: int = 1) -> bytes:
    """Encode an [H, W, 3] frame as PNG bytes (builtin codec, no deps).

    ``level`` is the zlib effort: the HTTP stream encoder uses 1 (encode
    time beats size on a live stream); file writes use 6.
    """
    img = _to_u8(img)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def jpeg_bytes(img: np.ndarray, quality: int = 85) -> bytes | None:
    """Encode as JPEG via PIL (None when PIL is absent) — ~10x smaller
    than PNG for path-traced frames, the right default for streaming."""
    try:
        from PIL import Image
    except ImportError:
        return None
    import io

    buf = io.BytesIO()
    Image.fromarray(_to_u8(img), mode="RGB").save(
        buf, format="JPEG", quality=quality
    )
    return buf.getvalue()


def ansi_frame(img: np.ndarray, max_cols: int = 100) -> str:
    """Render an RGB uint8 image as 24-bit ANSI half-block art.

    Each character cell shows two vertically-stacked pixels (upper-half
    block with independent fg/bg colors), the closest a plain terminal
    gets to the reference's window (`utils.rs:104-168`). Downsamples by
    integer striding to fit max_cols.
    """
    h, w = img.shape[:2]
    step = max(1, -(-w // max_cols))
    small = img[::step, ::step]
    if small.shape[0] % 2:
        small = small[:-1]
    top, bot = small[0::2], small[1::2]
    rows = []
    for tr, br in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(tr, br)
        ]
        rows.append("".join(cells) + "\x1b[0m")
    return "\n".join(rows)


def kitty_frame(img: np.ndarray) -> str:
    """Encode an RGB uint8 image as a kitty graphics-protocol escape
    sequence (APC G, f=24 raw RGB, chunked base64) — full-resolution
    in-terminal display for terminals that speak it (kitty, ghostty,
    wezterm). The half-block `ansi_frame` is the portable fallback."""
    import base64

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    payload = base64.standard_b64encode(img.tobytes()).decode("ascii")
    chunks = [payload[i:i + 4096] for i in range(0, len(payload), 4096)]
    out = []
    for i, chunk in enumerate(chunks):
        ctrl = f"a=T,f=24,s={w},v={h}," if i == 0 else ""
        m = 1 if i + 1 < len(chunks) else 0
        out.append(f"\x1b_G{ctrl}m={m};{chunk}\x1b\\")
    return "".join(out)


def write_gif(path: str, frames: np.ndarray, fps: int = 20,
              loop: int = 0) -> None:
    """Write [N, H, W, 3] uint8 (or float in [0,1]) frames as a looping
    GIF (the `animate` CLI's output). PIL when present, else the built-in
    GIF89a encoder below (median-cut global palette + LZW), mirroring
    write_png's zero-hard-dep policy."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.round(np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)
    assert frames.ndim == 4 and frames.shape[-1] == 3, frames.shape
    duration_ms = max(1, round(1000.0 / fps))
    try:
        from PIL import Image

        ims = [Image.fromarray(f, mode="RGB") for f in frames]
        ims[0].save(path, save_all=True, append_images=ims[1:],
                    duration=duration_ms, loop=loop)
        return
    except ImportError:
        pass
    _write_gif_builtin(path, frames, duration_ms, loop)


def _median_cut_palette(frames: np.ndarray, n_colors: int = 256) -> np.ndarray:
    """Global palette via median cut over a pixel sample: [n_colors, 3]."""
    px = frames.reshape(-1, 3)
    if px.shape[0] > 1 << 16:
        stride = px.shape[0] // (1 << 16) + 1
        px = px[::stride]
    boxes = [px.astype(np.int32)]
    while len(boxes) < n_colors:
        # Split the box with the largest single-channel range; stop when
        # every box is a single color.
        spans = [b.max(0) - b.min(0) if len(b) else np.zeros(3, np.int32)
                 for b in boxes]
        widest = max(range(len(boxes)), key=lambda i: spans[i].max())
        if spans[widest].max() == 0:
            break
        b = boxes.pop(widest)
        ch = int(spans[widest].argmax())
        order = b[:, ch].argsort(kind="stable")
        half = len(b) // 2
        boxes += [b[order[:half]], b[order[half:]]]
    pal = np.zeros((n_colors, 3), np.uint8)
    for i, b in enumerate(boxes):
        pal[i] = b.mean(0).round().astype(np.uint8)
    return pal


def _lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF-flavor LZW (LSB-first bit packing, clear/EOI codes, 12-bit cap)."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = n_bits = 0

    def emit(code: int, width: int):
        nonlocal acc, n_bits
        acc |= code << n_bits
        n_bits += width
        while n_bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_bits -= 8

    table: dict[int, int] = {}
    next_code = eoi + 1
    width = min_code_size + 1
    emit(clear, width)
    data = indices.ravel().tolist()
    prev = data[0]
    for sym in data[1:]:
        key = (prev << 8) | sym
        code = table.get(key)
        if code is not None:
            prev = code
            continue
        emit(prev, width)
        if next_code == (1 << 12):
            # Table full at the 12-bit GIF maximum: a new entry would
            # take code 4096 (13 bits, unrepresentable). Emit the clear
            # code and restart WITHOUT inserting the over-wide entry.
            emit(clear, width)
            table.clear()
            next_code = eoi + 1
            width = min_code_size + 1
        else:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        prev = sym
    emit(prev, width)
    emit(eoi, width)
    if n_bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _write_gif_builtin(path: str, frames: np.ndarray, duration_ms: int,
                       loop: int) -> None:
    import struct

    n, h, w, _ = frames.shape
    pal = _median_cut_palette(frames)
    # 5-bit RGB cube -> nearest palette index (one 32k x 256 distance
    # solve), then frames map through the cube by integer indexing.
    g = np.arange(32, dtype=np.int32) * 8 + 4
    cube = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    d = ((cube[:, None, :] - pal[None].astype(np.int32)) ** 2).sum(-1)
    lut = d.argmin(1).astype(np.uint8).reshape(32, 32, 32)
    delay_cs = max(1, duration_ms // 10)
    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))
        f.write(pal.tobytes())
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
                + struct.pack("<H", loop) + b"\x00")
        for frame in frames:
            idx = lut[frame[..., 0] >> 3, frame[..., 1] >> 3,
                      frame[..., 2] >> 3]
            f.write(b"\x21\xf9\x04" + struct.pack("<BHBB", 0x04, delay_cs,
                                                  0, 0))
            f.write(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            f.write(b"\x08")
            payload = _lzw_encode(idx)
            for i in range(0, len(payload), 255):
                block = payload[i:i + 255]
                f.write(bytes([len(block)]) + block)
            f.write(b"\x00")
        f.write(b"\x3b")


def read_png(path: str) -> np.ndarray:
    """Read a PNG to an [H, W, C] uint8 array: PIL when present, else the
    built-in decoder (8-bit greyscale, RGB or RGBA, not interlaced)."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as f:
            return decode_png(f.read())
    return np.asarray(Image.open(path))


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes of 8-bit greyscale (with or without alpha), RGB or
    RGBA, not interlaced, every row filter undone: [H, W, C] uint8 (C
    squeezed for greyscale)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * ch)
    out = np.zeros((h, w * ch), np.uint8)
    prev = np.zeros(w * ch, np.int32)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 1:       # Sub: each byte plus the one ch bytes left of it
            row = np.cumsum(row.reshape(w, ch), axis=0).reshape(-1)
        elif kind == 2:     # Up
            row = row + prev
        elif kind in (3, 4):    # Average, Paeth: left to right
            row = row.copy()
            for x in range(w * ch):
                a = row[x - ch] if x >= ch else 0
                b = prev[x]
                if kind == 3:
                    row[x] = (row[x] + (a + b) // 2) & 0xFF
                else:
                    c = prev[x - ch] if x >= ch else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    row[x] = (row[x] + pred) & 0xFF
        elif kind != 0:
            raise ValueError(f"bad PNG row filter {kind}")
        prev = row & 0xFF
        out[y] = prev
    img = out.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img
