"""Texture I/O: image read/write without external deps + mip generation.

Replaces the reference's stb_image upload path (hello_vulkan.cpp:286-349):
  * missing texture list -> 1x1 white dummy (hello_vulkan.cpp:297-312)
  * failed load -> 1x1 magenta fallback (hello_vulkan.cpp:323-331)
  * sRGB -> linear conversion on load (the reference samples VK_FORMAT_
    R8G8B8A8_SRGB, so shaders see linear values)
  * full mip chain generation (the reference's generateMipmaps /
    vkCmdBlitImage-linear loop, hello_vulkan.cpp:335-340) via 2x2 box
    filtering with edge clamp — build_mip_chain.

Formats (stb_image reads PNG/JPG/BMP/TGA/PSD/GIF/HDR/PIC/PNM): this
decoder covers PNG (8-bit RGB/RGBA/gray, no interlacing), BMP
(uncompressed 24/32-bit bottom-up or top-down), TGA (types 2/3/10/11:
uncompressed + RLE truecolor/gray, 24/32/8-bit), PNM (P2/P3/P5/P6),
JPEG (baseline + progressive, io/jpeg.py), and — via io/formats.py —
Radiance HDR, PSD, GIF (first frame), and Softimage PIC: the full
stb_image container set.  Anything else falls back to magenta like a
failed stb load.

Copied from voxelray_tpu/io/textures.py (numpy only, so the port
imports no JAX).
"""
from __future__ import annotations

import re
import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png", "read_bmp", "read_tga", "read_pnm",
           "read_image", "build_mip_chain", "load_texture", "white_dummy",
           "magenta_fallback"]


def white_dummy() -> np.ndarray:
    return np.ones((1, 1, 3), np.float32)


def magenta_fallback() -> np.ndarray:
    return np.asarray([[[1.0, 0.0, 1.0]]], np.float32)


def write_png(path: str, image) -> None:
    """Write (H, W, 3|4) float [0,1] or uint8 as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, ch = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", ihdr))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        ftype = data[pos]
        pos += 1
        row = data[pos: pos + stride].astype(np.int32)
        pos += stride
        if ftype == 0:
            cur = row
        elif ftype == 1:  # Sub
            cur = row.copy()
            for i in range(ch, stride):
                cur[i] = (cur[i] + cur[i - ch]) & 0xFF
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = row.copy()
            for i in range(stride):
                left = cur[i - ch] if i >= ch else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = row.copy()
            for i in range(stride):
                a = cur[i - ch] if i >= ch else 0
                b = prev[i]
                c = prev[i - ch] if i >= ch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else \
                    (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[r] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """-> (H, W, C) uint8.  Raises ValueError on unsupported files."""
    with open(path, "rb") as fh:
        sig = fh.read(8)
        if sig != b"\x89PNG\r\n\x1a\n":
            raise ValueError("not a PNG")
        idat = b""
        meta = None
        while True:
            head = fh.read(8)
            if len(head) < 8:
                break
            ln, tag = struct.unpack(">I4s", head)
            data = fh.read(ln)
            fh.read(4)  # crc
            if tag == b"IHDR":
                meta = struct.unpack(">IIBBBBB", data)
            elif tag == b"IDAT":
                idat += data
            elif tag == b"IEND":
                break
    if meta is None:
        raise ValueError("no IHDR")
    w, h, depth, ctype, comp, filt, interlace = meta
    if depth != 8 or interlace != 0 or ctype not in (0, 2, 6):
        raise ValueError(f"unsupported PNG (depth={depth} type={ctype})")
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return _unfilter(raw, h, w, ch)


def read_bmp(path: str) -> np.ndarray:
    """Uncompressed 24/32-bit BMP -> (H, W, 3|4) uint8 (top-down rows)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    pix_off = struct.unpack_from("<I", data, 10)[0]
    hdr_size = struct.unpack_from("<I", data, 14)[0]
    if hdr_size < 40:
        raise ValueError("unsupported BMP header")
    w, h = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    comp = struct.unpack_from("<I", data, 30)[0]
    if planes != 1 or bpp not in (24, 32) or comp not in (0, 3):
        raise ValueError(f"unsupported BMP (bpp={bpp} comp={comp})")
    flip = h > 0          # positive height = bottom-up storage
    h = abs(h)
    ch = bpp // 8
    stride = (w * ch + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=h * stride, offset=pix_off)
    img = rows.reshape(h, stride)[:, : w * ch].reshape(h, w, ch)
    if flip:
        img = img[::-1]
    # BGR(A) -> RGB(A)
    out = img.copy()
    out[..., 0], out[..., 2] = img[..., 2], img[..., 0]
    return out


def read_tga(path: str) -> np.ndarray:
    """TGA types 2/3 (uncompressed) and 10/11 (RLE), 8/24/32-bit."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 18:
        raise ValueError("not a TGA")
    id_len, cmap_type, img_type = data[0], data[1], data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    bpp, desc = data[16], data[17]
    if cmap_type != 0 or img_type not in (2, 3, 10, 11) \
            or bpp not in (8, 24, 32):
        raise ValueError(f"unsupported TGA (type={img_type} bpp={bpp})")
    ch = bpp // 8
    pos = 18 + id_len
    n = w * h
    if img_type in (2, 3):
        pix = np.frombuffer(data, np.uint8, count=n * ch, offset=pos) \
            .reshape(n, ch)
    else:  # RLE
        pix = np.empty((n, ch), np.uint8)
        out = 0
        while out < n:
            hdr = data[pos]
            pos += 1
            count = (hdr & 0x7F) + 1
            if hdr & 0x80:  # run packet
                pix[out: out + count] = np.frombuffer(
                    data, np.uint8, count=ch, offset=pos)
                pos += ch
            else:           # raw packet
                pix[out: out + count] = np.frombuffer(
                    data, np.uint8, count=count * ch, offset=pos) \
                    .reshape(count, ch)
                pos += count * ch
            out += count
    img = pix.reshape(h, w, ch)
    if not (desc & 0x20):   # bit 5 clear = bottom-up origin
        img = img[::-1]
    if ch >= 3:             # BGR(A) -> RGB(A)
        out = img.copy()
        out[..., 0], out[..., 2] = img[..., 2], img[..., 0]
        img = out
    return img


def read_pnm(path: str) -> np.ndarray:
    """PNM P2/P3 (ascii) and P5/P6 (binary) gray/RGB, maxval <= 255."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError("not a PNM")
    # strip comments, then tokenize the header
    pos = 2
    fields = []
    while len(fields) < 3:
        m = re.match(rb"\s*(#[^\n]*\n)*\s*(\d+)", data[pos:])
        if m is None:
            raise ValueError("bad PNM header")
        fields.append(int(m.group(2)))
        pos += m.end()
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError("16-bit PNM unsupported")
    ch = 3 if magic in (b"P3", b"P6") else 1
    if magic in (b"P5", b"P6"):
        pos += 1  # single whitespace after maxval
        pix = np.frombuffer(data, np.uint8, count=w * h * ch, offset=pos)
    else:
        toks = data[pos:].split()[: w * h * ch]
        pix = np.asarray([int(t) for t in toks], np.uint8)
    img = pix.reshape(h, w, ch)
    if maxval != 255:
        img = (img.astype(np.uint16) * 255 // maxval).astype(np.uint8)
    return img


def read_image(path: str) -> np.ndarray:
    """Sniff the container and decode -> (H, W, C) uint8."""
    with open(path, "rb") as fh:
        head = fh.read(10)
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return read_png(path)
    if head[:2] == b"\xff\xd8":
        from .jpeg import read_jpeg
        return read_jpeg(path)
    if head[:2] == b"BM":
        return read_bmp(path)
    if head[:2] in (b"P2", b"P3", b"P5", b"P6"):
        return read_pnm(path)
    if head[:10] == b"#?RADIANCE" or head[:6] == b"#?RGBE":
        from .formats import read_hdr
        return read_hdr(path)
    if head[:4] == b"8BPS":
        from .formats import read_psd
        return read_psd(path)
    if head[:4] == b"GIF8":
        from .formats import read_gif
        return read_gif(path)
    if head[:4] == b"\x53\x80\xf6\x34":
        from .formats import read_pic
        return read_pic(path)
    if path.lower().endswith(".tga"):
        return read_tga(path)
    raise ValueError(f"unrecognized image format: {path}")


def build_mip_chain(rgb: np.ndarray) -> list[np.ndarray]:
    """Full mip pyramid [level0, level1, ...] down to 1x1.

    Mirrors the reference's generateMipmaps loop (vkCmdBlitImage with
    VK_FILTER_LINEAR halving each dim to max(1, d/2),
    hello_vulkan.cpp:335-340): 2x2 box average; odd source dims drop the
    trailing row/column (the blit's fractional tail) so level L+1 is
    exactly max(1, dim_L // 2).
    """
    levels = [np.asarray(rgb, np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        h, w = cur.shape[:2]
        nh, nw = max(1, h // 2), max(1, w // 2)
        if h > 1:
            cur = cur[: nh * 2]
        if w > 1:
            cur = cur[:, : nw * 2]
        if h == 1:
            nxt = (cur[:, 0::2] + cur[:, 1::2]) * 0.5
        elif w == 1:
            nxt = (cur[0::2] + cur[1::2]) * 0.5
        else:
            nxt = (cur[0::2, 0::2] + cur[0::2, 1::2]
                   + cur[1::2, 0::2] + cur[1::2, 1::2]) * 0.25
        levels.append(nxt.reshape(nh, nw, cur.shape[2]))
    return levels


def load_texture(path: str, srgb_to_linear: bool = True) -> np.ndarray:
    """(H, W, 3) float32 linear; magenta fallback on any failure."""
    try:
        img = read_image(path)
    except Exception:
        return magenta_fallback()
    rgb = img[..., :3].astype(np.float32) / 255.0
    if rgb.shape[-1] == 1:
        rgb = rgb.repeat(3, axis=-1)
    if srgb_to_linear:
        rgb = np.power(rgb, np.float32(2.2))
    return rgb
