"""Image IO: EXR / PNG / TGA / PFM readers and writers, from scratch.

Replaces reference core/imageio.cpp (ReadImage/WriteImage dispatch by
extension, :84-200) and its vendored OpenEXR/stb/targa dependencies with
pure-Python+NumPy codecs:

- .exr  scanline OpenEXR 2.0: write FLOAT (ZIP-compressed), read
        NONE/ZIP/ZIPS in HALF or FLOAT (covers files pbrt writes/reads).
- .png  8-bit RGB(A) via zlib; write applies 1/2.2 gamma like the
        student addition (reference imageio.cpp:107-121), read applies
        2.2 gamma to linearize.
- .tga  uncompressed + RLE true-color read; uncompressed write.
- .pfm  portable float map, little-endian (reference imageio.cpp:419).

All read paths return linear float32 RGB [h, w, 3], top row first.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from pbrt_tpu_torch.core.error import PbrtError


def read_image(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    if ext == ".png":
        return read_png(path)
    if ext == ".tga":
        return read_tga(path)
    if ext == ".pfm":
        return read_pfm(path)
    raise PbrtError(f'unable to load image "{path}": unsupported extension')


def write_image(path: str, rgb: np.ndarray):
    """rgb: [h, w, 3] linear float. Extension picks the format
    (reference core/imageio.cpp:84 WriteImage)."""
    rgb = np.asarray(rgb, np.float32)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        write_exr(path, rgb)
    elif ext == ".png":
        write_png(path, rgb)
    elif ext == ".tga":
        write_tga(path, rgb)
    elif ext == ".pfm":
        write_pfm(path, rgb)
    else:
        raise PbrtError(f'unable to write image "{path}": unsupported extension')


# ---------------------------------------------------------------------------
# PFM

def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise PbrtError("not a PFM file")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        count = w * h * (3 if header == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4), dtype="<f4" if scale < 0 else ">f4")
        data = data.astype(np.float32) * abs(scale) if scale not in (-1.0, 1.0) else data.astype(np.float32)
    img = data.reshape(h, w, -1)[::-1]  # PFM stores bottom-up
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def write_pfm(path: str, rgb: np.ndarray):
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.000000\n" % (w, h))
        f.write(np.ascontiguousarray(rgb[::-1], dtype="<f4").tobytes())


# ---------------------------------------------------------------------------
# PNG

def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, rgb: np.ndarray, gamma: float = 1.0 / 2.2):
    """Linear float -> gamma-encoded 8-bit PNG (student imageio.cpp:107)."""
    h, w, _ = rgb.shape
    u8 = np.clip(np.power(np.clip(rgb, 0.0, 1.0), gamma) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def _png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = raw[pos]
        line = raw[pos + 1: pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft == 3:
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise PbrtError(f"PNG: unknown filter type {ft}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.read(8) != b"\x89PNG\r\n\x1a\n":
            raise PbrtError("not a PNG file")
        idat = b""
        w = h = depth = color = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            ln, tag = struct.unpack(">I4s", hdr)
            data = f.read(ln)
            f.read(4)  # crc
            if tag == b"IHDR":
                w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", data)
                if interlace:
                    raise PbrtError("PNG: interlaced images unsupported")
            elif tag == b"IDAT":
                idat += data
            elif tag == b"IEND":
                break
    nchan = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    if depth not in (8, 16):
        raise PbrtError(f"PNG: bit depth {depth} unsupported")
    bpp = nchan * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = _png_unfilter(raw, h, stride, bpp)
    if depth == 16:
        arr = rows.reshape(h, w, nchan, 2)
        vals = (arr[..., 0].astype(np.float32) * 256 + arr[..., 1]) / 65535.0
    else:
        vals = rows.reshape(h, w, nchan).astype(np.float32) / 255.0
    if nchan == 1:
        vals = np.repeat(vals[..., None] if vals.ndim == 2 else vals, 3, axis=-1)
    elif nchan == 2:
        vals = np.repeat(vals[..., :1], 3, axis=-1)
    elif nchan == 4:
        vals = vals[..., :3]
    return np.power(vals, 2.2).astype(np.float32)  # inverse of the write gamma


# ---------------------------------------------------------------------------
# TGA

def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    idlen, cmap_type, img_type = data[0], data[1], data[2]
    w = struct.unpack("<H", data[12:14])[0]
    h = struct.unpack("<H", data[14:16])[0]
    bpp = data[16]
    desc = data[17]
    off = 18 + idlen
    if cmap_type:
        raise PbrtError("TGA: colormapped images unsupported")
    nb = bpp // 8
    if img_type == 2:
        px = np.frombuffer(data[off: off + w * h * nb], np.uint8).reshape(h, w, nb)
    elif img_type == 3:
        g = np.frombuffer(data[off: off + w * h], np.uint8).reshape(h, w, 1)
        px = np.repeat(g, 3, axis=2)
        nb = 3
    elif img_type == 10:  # RLE true color
        out = np.zeros((w * h, nb), np.uint8)
        i, n = off, 0
        while n < w * h:
            hdrb = data[i]; i += 1
            cnt = (hdrb & 0x7F) + 1
            if hdrb & 0x80:
                out[n: n + cnt] = np.frombuffer(data[i: i + nb], np.uint8)
                i += nb
            else:
                out[n: n + cnt] = np.frombuffer(
                    data[i: i + cnt * nb], np.uint8
                ).reshape(cnt, nb)
                i += cnt * nb
            n += cnt
        px = out.reshape(h, w, nb)
    else:
        raise PbrtError(f"TGA: image type {img_type} unsupported")
    if nb >= 3:
        rgb = px[..., [2, 1, 0]].astype(np.float32) / 255.0  # BGR -> RGB
    else:
        rgb = np.repeat(px[..., :1], 3, axis=2).astype(np.float32) / 255.0
    if not (desc & 0x20):  # bottom-up origin
        rgb = rgb[::-1]
    return np.power(rgb, 2.2).astype(np.float32)


def write_tga(path: str, rgb: np.ndarray):
    h, w, _ = rgb.shape
    u8 = np.clip(np.power(np.clip(rgb, 0.0, 1.0), 1.0 / 2.2) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    bgr = u8[..., [2, 1, 0]]
    hdr = bytearray(18)
    hdr[2] = 2
    hdr[12:14] = struct.pack("<H", w)
    hdr[14:16] = struct.pack("<H", h)
    hdr[16] = 24
    hdr[17] = 0x20  # top-left origin
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.ascontiguousarray(bgr).tobytes())


# ---------------------------------------------------------------------------
# EXR (scanline, minimal but real)

_EXR_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2


def _exr_attr(name: bytes, atype: bytes, data: bytes) -> bytes:
    return name + b"\x00" + atype + b"\x00" + struct.pack("<I", len(data)) + data


def write_exr(path: str, rgb: np.ndarray):
    """Scanline FLOAT RGB, ZIP compression (16-line blocks)."""
    h, w, _ = rgb.shape
    chans = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, required by the format
        chans += name + b"\x00" + struct.pack("<iBBBBii", _PT_FLOAT, 0, 0, 0, 0, 1, 1)
    chans += b"\x00"
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += _exr_attr(b"channels", b"chlist", chans)
    header += _exr_attr(b"compression", b"compression", b"\x03")  # ZIP
    header += _exr_attr(b"dataWindow", b"box2i", dw)
    header += _exr_attr(b"displayWindow", b"box2i", dw)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    nblocks = (h + 15) // 16
    blocks = []
    for b in range(nblocks):
        y0 = b * 16
        ny = min(16, h - y0)
        # per scanline: B, G, R planes
        lines = []
        for y in range(y0, y0 + ny):
            row = np.stack([rgb[y, :, 2], rgb[y, :, 1], rgb[y, :, 0]])
            lines.append(row.astype("<f4").tobytes())
        raw = b"".join(lines)
        blocks.append((y0, _exr_zip_compress(raw)))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _EXR_MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, no flags
        f.write(header)
        offset_table_pos = f.tell()
        f.write(b"\x00" * 8 * nblocks)
        offsets = []
        for y0, comp in blocks:
            offsets.append(f.tell())
            f.write(struct.pack("<i", y0))
            f.write(struct.pack("<i", len(comp)))
            f.write(comp)
        f.seek(offset_table_pos)
        for off in offsets:
            f.write(struct.pack("<Q", off))


def _exr_reorder(data: bytes) -> bytes:
    """EXR ZIP predictor: split even/odd bytes into halves, then
    delta-encode the split buffer (OpenEXR ImfZip order)."""
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    split = np.empty_like(arr)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    d = split.astype(np.int32)
    out = np.empty_like(d)
    out[0] = d[0]
    out[1:] = d[1:] - d[:-1] + 128 + 256
    return (out & 0xFF).astype(np.uint8).tobytes()


def _exr_unreorder(data: bytes) -> bytes:
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    x = np.empty(len(d), np.int64)
    x[0] = d[0]
    x[1:] = d[0] + np.cumsum(d[1:] - 128 - 256)
    x = (x & 0xFF).astype(np.uint8)
    half = (len(x) + 1) // 2
    out = np.empty_like(x)
    out[0::2] = x[:half]
    out[1::2] = x[half:]
    return out.tobytes()


def _exr_zip_compress(raw: bytes) -> bytes:
    comp = zlib.compress(_exr_reorder(raw), 6)
    return comp if len(comp) < len(raw) else raw


def read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<Ii", data, 0)
    if magic != _EXR_MAGIC:
        raise PbrtError("not an EXR file")
    if version & 0x200:
        raise PbrtError("EXR: tiled images unsupported")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        atype = data[pos:e].decode()
        pos = e + 1
        (sz,) = struct.unpack_from("<I", data, pos)
        pos += 4
        attrs[name] = (atype, data[pos: pos + sz])
        pos += sz
    pos += 1

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    # parse channel list
    chdata = attrs["channels"][1]
    chans = []
    cpos = 0
    while chdata[cpos] != 0:
        e = chdata.index(b"\x00", cpos)
        cname = chdata[cpos:e].decode()
        ptype, _, _, _, _, sx, sy = struct.unpack_from("<iBBBBii", chdata, e + 1)
        chans.append((cname, ptype))
        cpos = e + 1 + 16
    if comp not in (0, 2, 3):
        raise PbrtError(f"EXR: compression {comp} unsupported (NONE/ZIPS/ZIP only)")
    lines_per_block = {0: 1, 2: 1, 3: 16}[comp]
    nblocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from("<%dQ" % nblocks, data, pos)

    chan_bytes = {_PT_HALF: 2, _PT_FLOAT: 4, _PT_UINT: 4}
    planes = {name: np.zeros((h, w), np.float32) for name, _ in chans}
    for off in offsets:
        by, ln = struct.unpack_from("<ii", data, off)
        blob = data[off + 8: off + 8 + ln]
        ny = min(lines_per_block, y1 - by + 1)
        raw_size = ny * sum(chan_bytes[pt] for _, pt in chans) * w
        if comp == 0 or ln == raw_size:
            raw = blob
        else:
            raw = _exr_unreorder(zlib.decompress(blob))
        rp = 0
        for yy in range(by - y0, by - y0 + ny):
            for cname, ptype in chans:  # channels stored alphabetically per line
                nb = chan_bytes[ptype] * w
                seg = raw[rp: rp + nb]
                rp += nb
                if ptype == _PT_HALF:
                    planes[cname][yy] = np.frombuffer(seg, "<f2").astype(np.float32)
                elif ptype == _PT_FLOAT:
                    planes[cname][yy] = np.frombuffer(seg, "<f4")
                else:
                    planes[cname][yy] = np.frombuffer(seg, "<u4").astype(np.float32)
    if all(c in planes for c in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    if "Y" in planes:
        return np.repeat(planes["Y"][..., None], 3, axis=-1)
    first = next(iter(planes.values()))
    return np.repeat(first[..., None], 3, axis=-1)
