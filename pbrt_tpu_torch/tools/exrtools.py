"""Image tools: exrdiff / exravg / exrtotiff / tifftoexr.

Port of pbrt_tpu/tools/exrtools.py (reference tools/exrdiff.cpp: pixel
diff with a -d tolerance in percent and an optional diff image;
tools/exravg.cpp: mean pixel value; the TIFF converters
tools/exrtotiff.cpp, tifftoexr.cpp) on this package's io/image.py, with
the same minimal uncompressed TIFF codec instead of libtiff. The file
tools touch no device.
"""
from __future__ import annotations

import struct
import sys

import numpy as np

from pbrt_tpu_torch.io.image import read_image, write_image


def exrdiff(argv=None) -> int:
    """usage: exrdiff [-o diff.exr] [-d tol_percent] img1 img2
    (reference tools/exrdiff.cpp)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    out = None
    tol = 0.0
    files = []
    i = 0
    while i < len(argv):
        if argv[i] == "-o":
            out = argv[i + 1]
            i += 2
        elif argv[i] == "-d":
            tol = float(argv[i + 1])
            i += 2
        else:
            files.append(argv[i])
            i += 1
    if len(files) != 2:
        print("usage: exrdiff [-o diff.exr] [-d diff_percent] img1 img2",
              file=sys.stderr)
        return 1
    a = read_image(files[0])
    b = read_image(files[1])
    if a.shape != b.shape:
        print(f"images have different resolutions: {a.shape} vs {b.shape}")
        return 1
    d = np.abs(a - b)
    denom = np.maximum(np.abs(a) + np.abs(b), 1e-9)
    rel = 2.0 * d / denom
    bigdiff = int(np.sum(np.any(rel > 2.0 * tol / 100.0, axis=-1) & np.any(d > 1e-6, -1)))
    smalldiff = int(np.sum(np.any(d > 1e-6, -1))) - bigdiff
    sum1, sum2 = float(a.sum()), float(b.sum())
    print(f"{files[0]}: {sum1:.6g} avg {a.mean():.6g}")
    print(f"{files[1]}: {sum2:.6g} avg {b.mean():.6g}")
    print(f"{bigdiff} big diffs, {smalldiff} small diffs "
          f"({100.0 * bigdiff / a[..., 0].size:.3f}%% of pixels differ)")
    if out:
        write_image(out, d)
    return 0 if bigdiff == 0 else 1


def exravg(argv=None) -> int:
    """usage: exravg img ... (reference tools/exravg.cpp)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: exravg <images...>", file=sys.stderr)
        return 1
    for fn in argv:
        img = read_image(fn)
        print(f"{fn}: avg = ({img[..., 0].mean():.6g}, {img[..., 1].mean():.6g}, "
              f"{img[..., 2].mean():.6g})")
    return 0


# -- minimal TIFF (uncompressed RGB 8-bit) ----------------------------------

def write_tiff(path: str, rgb: np.ndarray, gamma: float = 1.0 / 2.2):
    h, w, _ = rgb.shape
    u8 = np.clip(np.power(np.clip(rgb, 0, 1), gamma) * 255 + 0.5, 0, 255).astype(np.uint8)
    data = np.ascontiguousarray(u8).tobytes()
    # header + IFD with 10 entries
    n_entries = 10
    ifd_off = 8
    data_off = ifd_off + 2 + n_entries * 12 + 4
    bps_off = data_off
    pix_off = bps_off + 6
    ents = [
        (256, 3, 1, w), (257, 3, 1, h),           # width, height
        (258, 3, 3, bps_off),                      # bits per sample 8,8,8
        (259, 3, 1, 1),                            # no compression
        (262, 3, 1, 2),                            # RGB
        (273, 4, 1, pix_off),                      # strip offset
        (277, 3, 1, 3),                            # samples per pixel
        (278, 3, 1, h),                            # rows per strip
        (279, 4, 1, len(data)),                    # strip byte count
        (284, 3, 1, 1),                            # planar config chunky
    ]
    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", ifd_off))
        f.write(struct.pack("<H", n_entries))
        for tag, typ, cnt, val in ents:
            f.write(struct.pack("<HHI", tag, typ, cnt))
            if typ == 3 and cnt == 1:
                f.write(struct.pack("<HH", val, 0))
            else:
                f.write(struct.pack("<I", val))
        f.write(struct.pack("<I", 0))
        f.write(struct.pack("<HHH", 8, 8, 8))
        f.write(data)


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:2] == b"II":
        en = "<"
    elif blob[:2] == b"MM":
        en = ">"
    else:
        raise ValueError("not a TIFF")
    (ifd_off,) = struct.unpack_from(en + "I", blob, 4)
    (n,) = struct.unpack_from(en + "H", blob, ifd_off)
    tags = {}
    for i in range(n):
        tag, typ, cnt = struct.unpack_from(en + "HHI", blob, ifd_off + 2 + i * 12)
        voff = ifd_off + 2 + i * 12 + 8
        if typ == 3 and cnt == 1:
            (val,) = struct.unpack_from(en + "H", blob, voff)
        else:
            (val,) = struct.unpack_from(en + "I", blob, voff)
        tags[tag] = (typ, cnt, val)
    w = tags[256][2]
    h = tags[257][2]
    comp = tags.get(259, (3, 1, 1))[2]
    if comp != 1:
        raise ValueError(f"TIFF compression {comp} unsupported")
    spp = tags.get(277, (3, 1, 1))[2]
    off = tags[273][2]
    cnt = tags[279][2]
    # handle multiple strips (offset array)
    if tags[273][1] > 1:
        offs = struct.unpack_from(en + "%dI" % tags[273][1], blob, tags[273][2])
        cnts = struct.unpack_from(en + "%dI" % tags[279][1], blob, tags[279][2])
        raw = b"".join(blob[o: o + c] for o, c in zip(offs, cnts))
    else:
        raw = blob[off: off + cnt]
    px = np.frombuffer(raw, np.uint8)[: h * w * spp].reshape(h, w, spp)
    rgb = px[..., :3].astype(np.float32) / 255.0
    if spp == 1:
        rgb = np.repeat(rgb, 3, -1)
    return np.power(rgb, 2.2).astype(np.float32)


def exrtotiff(argv=None) -> int:
    """usage: exrtotiff [-scale s] [-gamma g] in.exr out.tiff
    (reference tools/exrtotiff.cpp)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    scale, gamma, tonemap = 1.0, 2.2, False
    files = []
    i = 0
    while i < len(argv):
        if argv[i] == "-scale":
            scale = float(argv[i + 1]); i += 2
        elif argv[i] == "-gamma":
            gamma = float(argv[i + 1]); i += 2
        elif argv[i] == "-tonemap":
            tonemap = True; i += 1
        else:
            files.append(argv[i]); i += 1
    if len(files) != 2:
        print("usage: exrtotiff [-scale s] [-gamma g] [-tonemap] in out.tiff",
              file=sys.stderr)
        return 1
    img = read_image(files[0]) * scale
    if tonemap:
        y = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        ymax = max(float(np.percentile(y, 99.9)), 1e-9)
        img = img / ymax
    write_tiff(files[1], img, 1.0 / gamma)
    return 0


def tifftoexr(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("usage: tifftoexr in.tiff out.exr", file=sys.stderr)
        return 1
    write_image(argv[1], read_tiff(argv[0]))
    return 0
