"""Decoders for the stb_image format tail: HDR, PSD, GIF, PIC.

The reference loads textures through stb_image (hello_vulkan.cpp:321-331),
which accepts PNG/JPG/BMP/TGA/PNM (covered in io/textures.py + io/jpeg.py)
plus Radiance HDR, Photoshop PSD, GIF, and Softimage PIC — this module
covers those four so a reference user's asset directory decodes the same
set of containers.  Like the rest of io/, pure Python + numpy.

Behavior notes (matched to stb semantics, not to each format's full
feature matrix):

  * HDR decodes to float RGB then converts to 8-bit exactly like
    stb's hdr-to-ldr default (scale 1, gamma 2.2): the reference calls
    stbi_load (the LDR entry point), so .hdr textures arrive
    gamma-encoded like every other texture and the loader's
    sRGB->linear step applies uniformly.
  * PSD: composited image data only (like stb) — version 1, RGB color
    mode, 8/16-bit, raw or PackBits RLE; 16-bit takes the high byte.
  * GIF: first frame only (stbi_load's behavior), global/local color
    tables, interlacing, transparency -> alpha 0.
  * PIC: uncompressed and mixed-RLE packets (the encodings Softimage
    writers produce); pure-RLE (type 1) raises -> magenta fallback.

Failures raise ValueError; load_texture turns any raise into the
reference's magenta fallback (hello_vulkan.cpp:323-331).

Copied from voxelray_tpu/io/formats.py (numpy only, so the port
imports no JAX).
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_hdr", "read_psd", "read_gif", "read_pic"]


# ---------------------------------------------------------------------------
# Radiance HDR (RGBE)
# ---------------------------------------------------------------------------

def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 (stb: ldexp(1, e-136))."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.exp2(e - 136, dtype=np.float64), 0.0)
    return (rgbe[..., :3].astype(np.float64)
            * scale[..., None]).astype(np.float32)


def read_hdr(path: str) -> np.ndarray:
    """Radiance .hdr/.pic RGBE -> (H, W, 3) uint8 via stb's hdr-to-ldr
    (scale 1, gamma 2.2).  New-style per-component RLE scanlines and
    flat/old-RLE streams both decode; only the -Y +X orientation stb
    accepts is supported."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    # header: lines to the first empty line, then the resolution line
    pos = 0
    fmt_ok = False
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
        if line.strip() == b"FORMAT=32-bit_rle_rgbe":
            fmt_ok = True
    if not fmt_ok:
        raise ValueError("HDR: unsupported FORMAT")
    eol = data.index(b"\n", pos)
    m = data[pos:eol].split()
    pos = eol + 1
    if len(m) != 4 or m[0] != b"-Y" or m[2] != b"+X":
        raise ValueError("HDR: unsupported orientation")
    h, w = int(m[1]), int(m[3])

    rows = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        if pos + 4 > len(data):
            raise ValueError("HDR: truncated")
        if (w >= 8 and w < 32768 and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            # new-style: 4 components, each RLE over the scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:                     # run
                        rows[y, x:x + cnt - 128, c] = data[pos]
                        x += cnt - 128
                        pos += 1
                    else:                             # literal
                        rows[y, x:x + cnt, c] = np.frombuffer(
                            data, np.uint8, cnt, pos)
                        x += cnt
                        pos += cnt
                if x != w:
                    raise ValueError("HDR: scanline overrun")
        else:
            # flat RGBE with old-style (1,1,1,count) run markers
            x = 0
            shift = 0
            while x < w:
                px = data[pos:pos + 4]
                pos += 4
                if px[0] == 1 and px[1] == 1 and px[2] == 1 and x > 0:
                    n = px[3] << shift
                    rows[y, x:x + n] = rows[y, x - 1]
                    x += n
                    shift += 8
                else:
                    rows[y, x] = np.frombuffer(px, np.uint8)
                    x += 1
                    shift = 0
    rgb = _rgbe_to_float(rows)
    ldr = np.power(np.clip(rgb, 0.0, None), 1.0 / 2.2) * 255.0 + 0.5
    return np.clip(ldr, 0.0, 255.0).astype(np.uint8)


# ---------------------------------------------------------------------------
# Photoshop PSD
# ---------------------------------------------------------------------------

def _unpackbits(data: bytes, pos: int, out: np.ndarray) -> int:
    """PackBits into out (1-D uint8); returns the new stream position."""
    x, n = 0, out.shape[0]
    while x < n:
        b = data[pos]
        pos += 1
        if b > 128:                       # repeat next byte 257-b times
            cnt = 257 - b
            out[x:x + cnt] = data[pos]
            pos += 1
            x += cnt
        elif b < 128:                     # b+1 literals
            cnt = b + 1
            out[x:x + cnt] = np.frombuffer(data, np.uint8, cnt, pos)
            pos += cnt
            x += cnt
        # b == 128: no-op
    if x != n:
        raise ValueError("PSD: PackBits overrun")
    return pos


def read_psd(path: str) -> np.ndarray:
    """PSD composited image -> (H, W, 3|4) uint8 (stb subset: version 1,
    RGB mode, 8/16-bit, compression 0 raw / 1 RLE, planar channels)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"8BPS":
        raise ValueError("not a PSD file")
    ver, = struct.unpack_from(">H", data, 4)
    if ver != 1:
        raise ValueError("PSD: unsupported version")
    channels, h, w, depth, mode = struct.unpack_from(">HIIHH", data, 12)
    if channels < 1 or channels > 16:
        raise ValueError("PSD: bad channel count")
    if depth not in (8, 16):
        raise ValueError("PSD: unsupported bit depth")
    if mode != 3:
        raise ValueError("PSD: only RGB color mode supported")
    pos = 26
    for _ in range(3):  # color mode data, image resources, layer info
        ln, = struct.unpack_from(">I", data, pos)
        pos += 4 + ln
    comp, = struct.unpack_from(">H", data, pos)
    pos += 2
    out_ch = min(channels, 4)
    planes = np.empty((out_ch, h * w), np.uint8)
    if comp == 0:
        step = 2 if depth == 16 else 1
        for c in range(channels):
            if c < out_ch:
                plane = np.frombuffer(data, np.uint8, h * w * step, pos)
                # 16-bit: take the high byte (big-endian), like stb's
                # 8-bit reduction
                planes[c] = plane[::step] if step == 2 else plane
            pos += h * w * step
    elif comp == 1:
        if depth != 8:
            raise ValueError("PSD: RLE requires 8-bit")
        counts = np.frombuffer(data, ">u2", channels * h, pos)
        pos += 2 * channels * h
        row = np.empty(w, np.uint8)
        for c in range(channels):
            for y in range(h):
                if c < out_ch:
                    end = _unpackbits(data, pos, row)
                    planes[c, y * w:(y + 1) * w] = row
                    pos = end
                else:
                    pos += int(counts[c * h + y])
    else:
        raise ValueError("PSD: unsupported compression")
    return planes.reshape(out_ch, h, w).transpose(1, 2, 0).copy()


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def _lzw_decode(data: bytes, min_code_size: int, n_pixels: int) -> bytes:
    """GIF LZW (variable 3..12-bit codes) -> index stream."""
    clear = 1 << min_code_size
    end = clear + 1
    # dictionary as immutable byte strings; reset on clear
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    code_size = min_code_size + 1
    out = bytearray()
    prev = None
    acc = 0
    nbits = 0
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= code_size:
            code = acc & ((1 << code_size) - 1)
            acc >>= code_size
            nbits -= code_size
            if code == clear:
                table = list(base)
                code_size = min_code_size + 1
                prev = None
                continue
            if code == end:
                return bytes(out[:n_pixels])
            if prev is None:
                if code >= len(table):
                    raise ValueError("GIF: bad LZW code")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError("GIF: bad LZW code")
            out += entry
            prev = entry
            if len(table) >= (1 << code_size) and code_size < 12:
                code_size += 1
            if len(out) >= n_pixels:
                return bytes(out[:n_pixels])
    return bytes(out[:n_pixels])


def read_gif(path: str) -> np.ndarray:
    """First GIF frame -> (H, W, 4) uint8 (stbi_load's behavior);
    transparent pixels get alpha 0."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    sw, sh, flags, _bg, _ar = struct.unpack_from("<HHBBB", data, 6)
    pos = 13
    gct = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        gct = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3
    transparent = -1
    while True:
        block = data[pos]
        pos += 1
        if block == 0x3B:                               # trailer
            raise ValueError("GIF: no image data")
        if block == 0x21:                               # extension
            label = data[pos]
            pos += 1
            if label == 0xF9:                           # graphic control
                sz = data[pos]
                gflags = data[pos + 1]
                if gflags & 1:
                    transparent = data[pos + 4]
                pos += 1 + sz
            while data[pos]:                            # sub-blocks
                pos += 1 + data[pos]
            pos += 1
            continue
        if block != 0x2C:                               # image descriptor
            raise ValueError("GIF: unexpected block")
        ix, iy, iw, ih, iflags = struct.unpack_from("<HHHHB", data, pos)
        pos += 9
        table = gct
        if iflags & 0x80:
            n = 2 << (iflags & 7)
            table = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
            pos += n * 3
        if table is None:
            raise ValueError("GIF: no color table")
        min_code = data[pos]
        pos += 1
        stream = bytearray()
        while data[pos]:
            sz = data[pos]
            stream += data[pos + 1:pos + 1 + sz]
            pos += 1 + sz
        pos += 1
        idx = np.frombuffer(
            _lzw_decode(bytes(stream), min_code, iw * ih), np.uint8)
        if idx.shape[0] < iw * ih:
            raise ValueError("GIF: truncated image")
        idx = idx.reshape(ih, iw)
        if iflags & 0x40:                               # interlaced
            de = np.empty_like(idx)
            rows = np.concatenate([np.arange(0, ih, 8),
                                   np.arange(4, ih, 8),
                                   np.arange(2, ih, 4),
                                   np.arange(1, ih, 2)])
            de[rows] = idx
            idx = de
        rgba = np.zeros((sh, sw, 4), np.uint8)
        sub = np.empty((ih, iw, 4), np.uint8)
        sub[..., :3] = table[np.minimum(idx, table.shape[0] - 1)]
        sub[..., 3] = np.where(idx == transparent, 0, 255)
        rgba[iy:iy + ih, ix:ix + iw] = sub
        return rgba


# ---------------------------------------------------------------------------
# Softimage PIC
# ---------------------------------------------------------------------------

_PIC_MASKS = (0x80, 0x40, 0x20, 0x10)   # R, G, B, A channel bits


def read_pic(path: str) -> np.ndarray:
    """Softimage PIC -> (H, W, 3|4) uint8.

    Packet types 0 (uncompressed) and 2 (mixed RLE: count<128 ->
    count+1 literal pixels; count==128 -> u16 run; count>128 ->
    count-127 run) are decoded; type 1 (pure RLE) raises.
    """
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"\x53\x80\xf6\x34" or data[88:92] != b"PICT":
        raise ValueError("not a PIC file")
    w, h = struct.unpack_from(">HH", data, 92)
    pos = 92 + 2 + 2 + 4 + 2 + 2        # + ratio f32, fields u16, pad u16
    packets = []
    while True:
        chained, size, ptype, chan = struct.unpack_from("BBBB", data, pos)
        pos += 4
        if size != 8:
            raise ValueError("PIC: only 8-bit channels supported")
        packets.append((ptype, [i for i, m in enumerate(_PIC_MASKS)
                                if chan & m]))
        if not chained:
            break
    has_alpha = any(3 in chans for _, chans in packets)
    out = np.zeros((h, w, 4), np.uint8)
    out[..., 3] = 255
    for y in range(h):
        for ptype, chans in packets:
            nc = len(chans)
            if ptype == 0:
                px = np.frombuffer(data, np.uint8, w * nc, pos) \
                    .reshape(w, nc)
                pos += w * nc
                out[y, :, chans] = px.T
            elif ptype == 2:
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt == 128:
                        run, = struct.unpack_from(">H", data, pos)
                        pos += 2
                        out[y, x:x + run, chans] = np.frombuffer(
                            data, np.uint8, nc, pos)[:, None]
                        pos += nc
                        x += run
                    elif cnt > 128:
                        run = cnt - 127
                        out[y, x:x + run, chans] = np.frombuffer(
                            data, np.uint8, nc, pos)[:, None]
                        pos += nc
                        x += run
                    else:
                        lit = cnt + 1
                        px = np.frombuffer(data, np.uint8, lit * nc, pos) \
                            .reshape(lit, nc)
                        pos += lit * nc
                        out[y, x:x + lit, chans] = px.T
                        x += lit
                if x != w:
                    raise ValueError("PIC: scanline overrun")
            else:
                raise ValueError("PIC: unsupported packet type")
    return out if has_alpha else out[..., :3].copy()
