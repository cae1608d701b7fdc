"""Geometry converters: obj2pbrt / ply2pbrt.

Port of pbrt_tpu/tools/converters.py (reference tools/obj2pbrt.cpp and
tools/ply2pbrt.c + ply.c): parse OBJ (v/vn/vt/f with polygon fan
triangulation, usemtl grouping) or PLY (ascii and binary little/big
endian vertex/face elements) into pbrt `Shape "trianglemesh"`
statements. The output text is the JAX package's, byte for byte (its
header line names the converter as the JAX package's does).
"""
from __future__ import annotations

import struct
import sys

import numpy as np


def _emit_mesh(out, P, N, UV, indices, material_line=None):
    if material_line:
        out.write(material_line + "\n")
    out.write('Shape "trianglemesh"\n')
    out.write('  "integer indices" [\n    ')
    out.write(" ".join(str(i) for i in indices))
    out.write(" ]\n")
    out.write('  "point P" [\n    ')
    out.write(" ".join(f"{v:.7g}" for v in np.asarray(P).ravel()))
    out.write(" ]\n")
    if N is not None and len(N):
        out.write('  "normal N" [\n    ')
        out.write(" ".join(f"{v:.7g}" for v in np.asarray(N).ravel()))
        out.write(" ]\n")
    if UV is not None and len(UV):
        out.write('  "float uv" [\n    ')
        out.write(" ".join(f"{v:.7g}" for v in np.asarray(UV).ravel()))
        out.write(" ]\n")


def obj2pbrt(argv=None) -> int:
    """usage: obj2pbrt in.obj out.pbrt (reference tools/obj2pbrt.cpp)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("usage: obj2pbrt <in.obj> <out.pbrt>", file=sys.stderr)
        return 1
    vs, vns, vts = [], [], []
    # per-material: vertex-tuple remap + faces
    groups: dict = {}
    cur = ""

    def group():
        return groups.setdefault(cur, {"map": {}, "P": [], "N": [], "UV": [],
                                       "idx": []})

    with open(argv[0]) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                vts.append([float(x) for x in parts[1:3]])
            elif parts[0] == "usemtl":
                cur = parts[1] if len(parts) > 1 else ""
            elif parts[0] == "f":
                g = group()
                corner_ids = []
                for vert in parts[1:]:
                    toks = vert.split("/")
                    vi = int(toks[0])
                    vi = vi - 1 if vi > 0 else len(vs) + vi
                    ti = ni = -1
                    if len(toks) > 1 and toks[1]:
                        t = int(toks[1])
                        ti = t - 1 if t > 0 else len(vts) + t
                    if len(toks) > 2 and toks[2]:
                        t = int(toks[2])
                        ni = t - 1 if t > 0 else len(vns) + t
                    key = (vi, ti, ni)
                    if key not in g["map"]:
                        g["map"][key] = len(g["P"])
                        g["P"].append(vs[vi])
                        g["N"].append(vns[ni] if ni >= 0 else None)
                        g["UV"].append(vts[ti] if ti >= 0 else None)
                    corner_ids.append(g["map"][key])
                for k in range(1, len(corner_ids) - 1):  # fan triangulation
                    g["idx"] += [corner_ids[0], corner_ids[k], corner_ids[k + 1]]

    with open(argv[1], "w") as out:
        out.write(f"# converted from {argv[0]} by pbrt_tpu obj2pbrt\n")
        for name, g in groups.items():
            has_n = all(n is not None for n in g["N"]) and g["N"]
            has_uv = all(t is not None for t in g["UV"]) and g["UV"]
            if name:
                out.write(f'# material group "{name}"\n')
            _emit_mesh(out, g["P"], g["N"] if has_n else None,
                       g["UV"] if has_uv else None, g["idx"])
    n_tris = sum(len(g["idx"]) // 3 for g in groups.values())
    print(f"obj2pbrt: wrote {n_tris} triangles in {len(groups)} groups")
    return 0


def _read_ply(path: str):
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(b"ply"):
        raise ValueError("not a PLY file")
    hdr_end = blob.index(b"end_header") + len(b"end_header")
    hdr = blob[:hdr_end].decode("ascii", "replace").splitlines()
    body = blob[blob.index(b"\n", hdr_end) + 1:]
    fmt = "ascii"
    elements = []  # (name, count, [(prop_type, prop_name) | ("list", ct, it, name)])
    for line in hdr:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append((t[1], int(t[2]), []))
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append(("list", t[2], t[3], t[4]))
            else:
                elements[-1][2].append((t[1], t[2]))

    TYPES = {"char": "b", "uchar": "B", "int8": "b", "uint8": "B",
             "short": "h", "ushort": "H", "int16": "h", "uint16": "H",
             "int": "i", "uint": "I", "int32": "i", "uint32": "I",
             "float": "f", "float32": "f", "double": "d", "float64": "d"}
    verts, faces = [], []
    if fmt == "ascii":
        toks = body.split()
        pos = 0
        for name, count, props in elements:
            for _ in range(count):
                row = {}
                for p in props:
                    if p[0] == "list":
                        n = int(float(toks[pos])); pos += 1
                        row[p[3]] = [int(float(toks[pos + i])) for i in range(n)]
                        pos += n
                    else:
                        row[p[1]] = float(toks[pos]); pos += 1
                if name == "vertex":
                    verts.append(row)
                elif name == "face":
                    faces.append(row)
    else:
        en = "<" if "little" in fmt else ">"
        pos = 0
        for name, count, props in elements:
            for _ in range(count):
                row = {}
                for p in props:
                    if p[0] == "list":
                        cf = TYPES[p[1]]
                        (n,) = struct.unpack_from(en + cf, body, pos)
                        pos += struct.calcsize(cf)
                        itf = TYPES[p[2]]
                        vals = struct.unpack_from(en + str(n) + itf, body, pos)
                        pos += struct.calcsize(itf) * n
                        row[p[3]] = list(vals)
                    else:
                        cf = TYPES[p[0]]
                        (v,) = struct.unpack_from(en + cf, body, pos)
                        pos += struct.calcsize(cf)
                        row[p[1]] = v
                if name == "vertex":
                    verts.append(row)
                elif name == "face":
                    faces.append(row)
    return verts, faces


def ply2pbrt(argv=None) -> int:
    """usage: ply2pbrt in.ply out.pbrt (reference tools/ply2pbrt.c)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("usage: ply2pbrt <in.ply> <out.pbrt>", file=sys.stderr)
        return 1
    verts, faces = _read_ply(argv[0])
    P = [[v.get("x", 0), v.get("y", 0), v.get("z", 0)] for v in verts]
    has_n = verts and all(("nx" in v) for v in verts)
    N = [[v["nx"], v["ny"], v["nz"]] for v in verts] if has_n else None
    has_uv = verts and all(("u" in v or "s" in v) for v in verts)
    UV = ([[v.get("u", v.get("s", 0.0)), v.get("v", v.get("t", 0.0))]
           for v in verts] if has_uv else None)
    idx = []
    for f in faces:
        vi = (f.get("vertex_indices") or f.get("vertex_index") or [])
        for k in range(1, len(vi) - 1):
            idx += [vi[0], vi[k], vi[k + 1]]
    with open(argv[1], "w") as out:
        out.write(f"# converted from {argv[0]} by pbrt_tpu ply2pbrt\n")
        _emit_mesh(out, P, N, UV, idx)
    print(f"ply2pbrt: wrote {len(idx) // 3} triangles, {len(P)} vertices")
    return 0
