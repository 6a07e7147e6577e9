"""JPEG decoder (pure Python + numpy, no external deps).

Covers the stb_image subset that matters for textures
(hello_vulkan.cpp:321-331 loads textures through
stb_image): baseline sequential DCT (SOF0), extended sequential (SOF1),
and **progressive** (SOF2) with spectral selection + successive
approximation; 8-bit, grayscale or YCbCr 4:4:4 / 4:2:2 / 4:2:0, restart
markers.  Arithmetic coding, hierarchical, and 12-bit precision raise
ValueError (callers fall back to magenta like a failed stb load,
hello_vulkan.cpp:323-331).

The entropy decode is a Python bit-reader (fine for texture-sized
images); dequant + IDCT + upsampling + color convert are vectorized
numpy over all blocks at once.  Progressive scans accumulate into the
same per-component coefficient planes until EOI, then reconstruct once
(ITU T.81 Annex G decoding procedures).

Copied from voxelray_tpu/io/jpeg.py (numpy only, so the port imports
no JAX).
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_jpeg"]

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# 8x8 type-III DCT basis, precomputed: idct2(B) = C.T @ B @ C
_k = np.arange(8)
_C = np.cos((2 * _k[:, None] + 1) * _k[None, :] * np.pi / 16) * 0.5
_C[:, 0] *= 1.0 / np.sqrt(2.0)


class _Huff:
    """Canonical Huffman table with a flat (code, length) -> value map."""

    def __init__(self, counts, symbols):
        self.lookup = {}
        code = 0
        k = 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                self.lookup[(length, code)] = symbols[k]
                code += 1
                k += 1
            code <<= 1


class _BitReader:
    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bits = 0
        self.nbits = 0

    def _fill(self):
        b = self.data[self.pos]
        self.pos += 1
        if b == 0xFF:
            nxt = self.data[self.pos]
            if nxt == 0x00:
                self.pos += 1          # byte-stuffing
            elif 0xD0 <= nxt <= 0xD7:
                raise _RestartMarker()  # caller handles RSTn
            else:
                b = 0xFF               # treat as padding at stream end
        self.bits = (self.bits << 8) | b
        self.nbits += 8

    def read_bit(self):
        if self.nbits == 0:
            self._fill()
        self.nbits -= 1
        return (self.bits >> self.nbits) & 1

    def read_bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def decode(self, table: _Huff):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.read_bit()
            sym = table.lookup.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("bad Huffman code")

    def align_restart(self):
        """Consume an RSTn marker and realign to a byte boundary."""
        self.nbits = 0
        while self.data[self.pos] != 0xFF:
            self.pos += 1
        self.pos += 2  # FF Dn

    def end_of_segment(self):
        """Skip to the next marker (end of this scan's entropy data)."""
        self.nbits = 0
        p = self.pos
        while p + 1 < len(self.data):
            if self.data[p] == 0xFF and self.data[p + 1] != 0x00:
                return p
            p += 1
        return len(self.data)


class _RestartMarker(Exception):
    pass


def _extend(v, n):
    """JPEG sign extension (ITU T.81 F.2.2.1)."""
    return v - (1 << n) + 1 if n and v < (1 << (n - 1)) else v


def read_jpeg(path: str) -> np.ndarray:
    """Decode a baseline/extended/progressive JPEG -> (H, W, 3|1) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")

    qt = {}
    huff_dc = {}
    huff_ac = {}
    frame = None
    restart_interval = 0
    pos = 2
    saw_scan = False
    while pos < len(data) - 1:
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        seg = data[pos + 2: pos + seglen]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                p += 1
                if pq:
                    raise ValueError("16-bit quant tables unsupported")
                qt[tq] = np.frombuffer(seg, np.uint8, 64, p) \
                    .astype(np.int32)
                p += 64
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                counts = list(seg[p + 1: p + 17])
                n = sum(counts)
                symbols = list(seg[p + 17: p + 17 + n])
                (huff_dc if tc == 0 else huff_ac)[th] = _Huff(counts,
                                                              symbols)
                p += 17 + n
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0/1 sequential, SOF2 prog
            prec, h, w, nc = seg[0], *struct.unpack_from(">HH", seg, 1), \
                seg[5]
            if prec != 8:
                raise ValueError("only 8-bit JPEG supported")
            comps = []
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c], seg[7 + 3 * c], \
                    seg[8 + 3 * c]
                comps.append(dict(id=cid, hs=hv >> 4, vs=hv & 15, tq=tq))
            frame = dict(h=h, w=w, comps=comps,
                         progressive=marker == 0xC2)
            _alloc_coef(frame)
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise ValueError("lossless/arithmetic/hierarchical JPEG "
                             "unsupported")
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack_from(">H", seg, 0)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = seg[0]
            scomps = []
            for c in range(ns):
                cid, tabs = seg[1 + 2 * c], seg[2 + 2 * c]
                scomps.append((cid, tabs >> 4, tabs & 15))
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            a = seg[3 + 2 * ns]
            ah, al = a >> 4, a & 15
            pos = _entropy_scan(data, pos + seglen, frame, scomps,
                                ss, se, ah, al, huff_dc, huff_ac,
                                restart_interval)
            saw_scan = True
            continue
        pos += seglen
    if not saw_scan:
        raise ValueError("no scan data")
    return _reconstruct(frame, qt)


def _alloc_coef(frame):
    comps = frame["comps"]
    h, w = frame["h"], frame["w"]
    hmax = max(c["hs"] for c in comps)
    vmax = max(c["vs"] for c in comps)
    frame["hmax"], frame["vmax"] = hmax, vmax
    frame["mcux"] = mcux = -(-w // (8 * hmax))
    frame["mcuy"] = mcuy = -(-h // (8 * vmax))
    for c in comps:
        c["bw"] = mcux * c["hs"]
        c["bh"] = mcuy * c["vs"]
        # non-interleaved scan block dims (T.81 A.1.1: the component's
        # own sampled size, NOT padded to whole MCUs)
        c["nbw"] = -(- (-(-w * c["hs"] // hmax)) // 8)
        c["nbh"] = -(- (-(-h * c["vs"] // vmax)) // 8)
        c["coef"] = np.zeros((c["bh"] * c["bw"], 64), np.int32)
        c["pred"] = 0
        c["eobrun"] = 0


def _entropy_scan(data, pos, frame, scomps, ss, se, ah, al,
                  huff_dc, huff_ac, restart_interval):
    """Decode one scan's entropy data into the coefficient planes.

    Sequential frames arrive as one full-spectrum scan (ss=0, se=63,
    ah=al=0) and take the same path as a progressive DC+AC first scan.
    Returns the stream position after the scan's entropy segment.
    """
    comps = frame["comps"]
    by_id = {c["id"]: c for c in comps}
    sel = [(by_id[cid], tdc, tac) for cid, tdc, tac in scomps]
    progressive = frame["progressive"]
    br = _BitReader(data, pos)

    for c, _, _ in sel:
        c["pred"] = 0
        c["eobrun"] = 0

    def reset_restart():
        br.align_restart()
        for c, _, _ in sel:
            c["pred"] = 0
            c["eobrun"] = 0

    try:
        if len(sel) == 1:
            # non-interleaved scan (T.81 A.2.2): block raster over the
            # component's OWN sampled dims (not padded to whole MCUs).
            # Progressive AC scans are always this shape; grayscale and
            # per-component sequential scans collapse to it too.
            c, tdc, tac = sel[0]
            n_blocks = c["nbw"] * c["nbh"]
            for b in range(n_blocks):
                if restart_interval and b and b % restart_interval == 0:
                    reset_restart()
                row = (b // c["nbw"]) * c["bw"] + b % c["nbw"]
                _decode_block(br, c, row, tdc, tac, ss, se, ah, al,
                              huff_dc, huff_ac, progressive)
        else:
            # interleaved MCU order (T.81 A.2.3)
            n_mcu = frame["mcux"] * frame["mcuy"]
            for m in range(n_mcu):
                if restart_interval and m and m % restart_interval == 0:
                    reset_restart()
                my, mx = divmod(m, frame["mcux"])
                for c, tdc, tac in sel:
                    for by in range(c["vs"]):
                        for bx in range(c["hs"]):
                            row = (my * c["vs"] + by) * c["bw"] \
                                + (mx * c["hs"] + bx)
                            _decode_block(br, c, row, tdc, tac,
                                          ss, se, ah, al,
                                          huff_dc, huff_ac, progressive)
    except _RestartMarker:
        raise ValueError("unexpected restart marker")
    except IndexError:
        pass  # truncated stream: keep what we decoded

    return br.end_of_segment()


def _decode_block(br, c, row, tdc, tac, ss, se, ah, al,
                  huff_dc, huff_ac, progressive):
    blk = c["coef"][row]
    if not progressive:
        # full-spectrum sequential block (T.81 F.2.2)
        s = br.decode(huff_dc[tdc])
        diff = _extend(br.read_bits(s), s) if s else 0
        c["pred"] += diff
        blk[0] = c["pred"]
        k = 1
        while k < 64:
            rs = br.decode(huff_ac[tac])
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r == 15:
                    k += 16
                    continue
                break  # EOB
            k += r
            if k > 63:
                break
            blk[k] = _extend(br.read_bits(s), s)
            k += 1
        return

    if ss == 0:
        # DC scan (T.81 G.2: Se must be 0 in a DC progressive scan)
        if ah == 0:  # first pass
            s = br.decode(huff_dc[tdc])
            diff = _extend(br.read_bits(s), s) if s else 0
            c["pred"] += diff
            blk[0] = c["pred"] << al
        else:        # refinement: one bit per block
            if br.read_bit():
                blk[0] |= 1 << al
        return

    # AC scans
    if ah == 0:
        # first pass (T.81 G.1.2.2): EOB runs + new coefficients at
        # magnitude 1<<al
        if c["eobrun"] > 0:
            c["eobrun"] -= 1
            return
        k = ss
        while k <= se:
            rs = br.decode(huff_ac[tac])
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r < 15:
                    c["eobrun"] = (1 << r) - 1
                    if r:
                        c["eobrun"] += br.read_bits(r)
                    break
                k += 16
            else:
                k += r
                if k > se:
                    break
                blk[k] = _extend(br.read_bits(s), s) << al
                k += 1
        return

    # AC refinement pass (T.81 G.1.2.3 / libjpeg decode_mcu_AC_refine):
    # every already-nonzero coefficient in the band consumes one
    # correction bit as the scan pointer passes it; zero coefficients
    # count against the run length r, and a new +-1<<al lands where the
    # run ends.
    bit = 1 << al

    def refine_nonzero(k):
        if br.read_bit():
            v = blk[k]
            if not (abs(v) & bit):
                blk[k] = v + bit if v >= 0 else v - bit

    if c["eobrun"] > 0:
        c["eobrun"] -= 1
        for k in range(ss, se + 1):
            if blk[k]:
                refine_nonzero(k)
        return

    k = ss
    while k <= se:
        rs = br.decode(huff_ac[tac])
        r, s = rs >> 4, rs & 15
        newval = 0
        if s == 0:
            if r < 15:
                # EOB run starts here: refine the rest of the band,
                # then the next eobrun-1 blocks refine-only
                c["eobrun"] = (1 << r) - 1
                if r:
                    c["eobrun"] += br.read_bits(r)
                for kk in range(k, se + 1):
                    if blk[kk]:
                        refine_nonzero(kk)
                return
            # r == 15: skip 16 ZERO coefficients (nonzeros refine in
            # passing, not counted)
        else:
            if s != 1:
                raise ValueError("bad AC refinement magnitude")
            newval = bit if br.read_bit() else -bit
        while k <= se:
            if blk[k]:
                refine_nonzero(k)
            else:
                if r == 0:
                    break
                r -= 1
            k += 1
        if newval and k <= se:
            blk[k] = newval
        k += 1


def _upsample2(plane: np.ndarray, axis: int) -> np.ndarray:
    """2x centered triangle-filter upsample along one axis."""
    if axis == 1:
        return _upsample2(plane.T, 0).T
    prev = np.concatenate([plane[:1], plane[:-1]], axis=0)
    nxt = np.concatenate([plane[1:], plane[-1:]], axis=0)
    out = np.empty((plane.shape[0] * 2,) + plane.shape[1:], plane.dtype)
    out[0::2] = (3.0 * plane + prev) * 0.25
    out[1::2] = (3.0 * plane + nxt) * 0.25
    return out


def _reconstruct(frame, qt):
    """Dequant + IDCT + upsample + color convert, vectorized per comp."""
    comps = frame["comps"]
    h, w = frame["h"], frame["w"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    planes = []
    for c in comps:
        # DQT tables and entropy-coded coefficients are both in zigzag
        # order: dequantize first, then de-zigzag into natural order
        dq = c["coef"] * qt[c["tq"]][None]
        coef = np.zeros_like(dq)
        coef[:, ZIGZAG] = dq
        blocks = coef.astype(np.float32).reshape(-1, 8, 8)
        # f = C @ F @ C.T with C[x,u] = a(u) cos((2x+1) u pi / 16)
        pix = np.einsum("ik,nkl,jl->nij", _C, blocks, _C) + 128.0
        plane = pix.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3) \
            .reshape(c["bh"] * 8, c["bw"] * 8)
        # upsample to full resolution with the centered triangle filter
        # (libjpeg/stb "fancy upsampling"): out[2i] = (3 c[i] + c[i-1])/4,
        # out[2i+1] = (3 c[i] + c[i+1])/4, edges clamped
        for axis, factor in ((0, vmax // c["vs"]), (1, hmax // c["hs"])):
            while factor > 1:
                plane = _upsample2(plane, axis)
                factor //= 2
        planes.append(plane[:h, :w])

    if len(planes) == 1:
        return np.clip(planes[0], 0, 255).astype(np.uint8)[..., None]
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)
