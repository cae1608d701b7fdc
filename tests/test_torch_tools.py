"""The port's tools (python -m pbrt_tpu_torch.tools) against the JAX
package's and tests/test_tools.py.

Image, TIFF round trips and exrdiff's exit codes as tests/test_tools.py
asks of the JAX package's tools; obj2pbrt and ply2pbrt write the JAX
package's text byte for byte on the same inputs; samplepat writes the
same table; bsdftest on the CPU exits 0 and its 42 estimates are the
JAX package's within 1e-5 (float32 means summed in another order); the
dispatcher reaches all eight tools.
"""
import os
import struct
import subprocess
import sys

import numpy as np
import torch

from pbrt_tpu.tools import converters as j_conv
from pbrt_tpu.tools import exrtools as j_exr
from pbrt_tpu_torch.io.image import (
    read_exr,
    read_pfm,
    read_png,
    read_tga,
    write_exr,
    write_pfm,
    write_png,
    write_tga,
)
from pbrt_tpu_torch.tools import __main__ as tools
from pbrt_tpu_torch.tools import converters, exrtools

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_image_roundtrips(tmp_path):
    img = np.random.RandomState(0).rand(23, 41, 3).astype(np.float32) * 3
    write_exr(str(tmp_path / "t.exr"), img)
    np.testing.assert_array_equal(read_exr(str(tmp_path / "t.exr")), img)
    write_pfm(str(tmp_path / "t.pfm"), img)
    np.testing.assert_array_equal(read_pfm(str(tmp_path / "t.pfm")), img)
    c = np.clip(img / 3, 0, 1)
    write_png(str(tmp_path / "t.png"), c)
    np.testing.assert_allclose(read_png(str(tmp_path / "t.png")), c, atol=0.006)
    write_tga(str(tmp_path / "t.tga"), c)
    np.testing.assert_allclose(read_tga(str(tmp_path / "t.tga")), c, atol=0.006)


def test_tiff_roundtrip_and_converters(tmp_path):
    """The TIFF codec round-trips, writes the JAX package's bytes, and
    exrtotiff / tifftoexr / exravg run through the dispatcher."""
    img = np.random.RandomState(1).rand(17, 29, 3).astype(np.float32)
    exrtools.write_tiff(str(tmp_path / "t.tiff"), img)
    np.testing.assert_allclose(exrtools.read_tiff(str(tmp_path / "t.tiff")), img, atol=0.006)
    j_exr.write_tiff(str(tmp_path / "j.tiff"), img)
    assert (tmp_path / "t.tiff").read_bytes() == (tmp_path / "j.tiff").read_bytes()
    write_exr(str(tmp_path / "a.exr"), img)
    assert tools.main(["exrtotiff", "-scale", "0.5", str(tmp_path / "a.exr"),
                       str(tmp_path / "b.tiff")]) == 0
    j_exr.exrtotiff(["-scale", "0.5", str(tmp_path / "a.exr"), str(tmp_path / "jb.tiff")])
    assert (tmp_path / "b.tiff").read_bytes() == (tmp_path / "jb.tiff").read_bytes()
    assert tools.main(["tifftoexr", str(tmp_path / "b.tiff"), str(tmp_path / "c.exr")]) == 0
    np.testing.assert_allclose(read_exr(str(tmp_path / "c.exr")), 0.5 * img, atol=0.01)
    assert tools.main(["exravg", str(tmp_path / "a.exr")]) == 0


def test_exrdiff_cli(tmp_path, capsys):
    """Exit 0 on equal images, 1 on different ones (and on a size
    mismatch), as the JAX tool; the same report; through the module's
    command line too."""
    a = np.random.RandomState(2).rand(8, 8, 3).astype(np.float32)
    A, B, C = (str(tmp_path / f"{n}.exr") for n in "abc")
    write_exr(A, a)
    write_exr(B, a * 1.5)
    write_exr(C, a[:4])
    for args, rc in (([A, A], 0), ([A, B], 1), (["-d", "60", A, B], 0), ([A, C], 1)):
        assert exrtools.exrdiff(args) == rc
        got = capsys.readouterr().out
        assert j_exr.exrdiff(args) == rc
        assert capsys.readouterr().out == got
    env = dict(os.environ, PYTHONPATH=REPO)
    for args, rc in (([A, A], 0), ([A, B], 1)):
        proc = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch.tools", "exrdiff", *args],
                              cwd=str(tmp_path), env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == rc, proc.stderr


OBJ = """# a quad with normals and uvs, a triangle by negative indices in a
# second material group
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl blue
f -4 -3 -1
"""


def _binary_ply(path, endian):
    verts = [(0, 0, 0, 0, 0, 1), (1, 0, 0, 0, 0, 1), (1, 1, 0, 0, 0, 1), (0, 1, 0.5, 0, 0, 1)]
    head = (f"ply\nformat binary_{endian}_endian 1.0\nelement vertex 4\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "element face 1\nproperty list uchar int vertex_indices\nend_header\n")
    e = "<" if endian == "little" else ">"
    body = b"".join(struct.pack(e + "6f", *v) for v in verts)
    body += struct.pack(e + "B4i", 4, 0, 1, 2, 3)
    path.write_bytes(head.encode() + body)


def test_obj_ply_converters_match_jax(tmp_path):
    """The JAX package's text on the same inputs: OBJ with normals, uvs,
    fans, material groups and negative indices; ASCII PLY; binary PLY
    both endians."""
    (tmp_path / "m.obj").write_text(OBJ)
    (tmp_path / "a.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    _binary_ply(tmp_path / "le.ply", "little")
    _binary_ply(tmp_path / "be.ply", "big")
    cases = [("obj2pbrt", "m.obj")] + [("ply2pbrt", f) for f in ("a.ply", "le.ply", "be.ply")]
    for tool, src in cases:
        src = str(tmp_path / src)
        got, ref = str(tmp_path / "got.pbrt"), str(tmp_path / "ref.pbrt")
        assert tools.main([tool, src, got]) == 0
        assert getattr(j_conv, tool)([src, ref]) == 0
        text = open(got).read()
        assert text == open(ref).read()
        assert "trianglemesh" in text and '"integer indices"' in text
    assert open(str(tmp_path / "got.pbrt")).read().count('"normal N"') == 1
    assert getattr(converters, "obj2pbrt")([str(tmp_path / "m.obj")]) == 1   # usage


def test_samplepat_matches_jax(tmp_path):
    from pbrt_tpu.tools.__main__ import samplepat as j_samplepat

    got, ref = str(tmp_path / "got.npy"), str(tmp_path / "ref.npy")
    assert tools.main(["samplepat", got, "96"]) == 0
    assert j_samplepat([ref, "96"]) == 0
    a = np.load(got)
    assert a.shape == (96, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a, np.load(ref))


def test_bsdftest_matches_jax(monkeypatch, capsys):
    """bsdftest 8192 on the CPU exits 0, and every estimate (BSDF,
    uniform and cosine sampling, for each BSDF and angle) is the JAX
    package's within 1e-5: the JAX tool's luminance calls on the
    strategies' means are recorded as it runs."""
    from pbrt_tpu.core import spectrum as j_spec
    from pbrt_tpu.tools.bsdftest import bsdftest as j_bsdftest
    from pbrt_tpu_torch.tools.bsdftest import bsdf_estimates, bsdftest

    assert bsdftest(["8192", "--device", "cpu"]) == 0
    table = capsys.readouterr().out
    ref = []
    real_y = j_spec.y

    def y(s):
        out = real_y(s)
        if np.ndim(out) == 0:
            ref.append(float(out))
        return out

    monkeypatch.setattr(j_spec, "y", y)
    assert j_bsdftest(["8192"]) == 0
    assert capsys.readouterr().out == table
    got = [v for row in bsdf_estimates(8192, torch.device("cpu")) for v in row[3:]
           if v is not None]
    assert len(got) == len(ref) == 42
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_dispatcher_reaches_every_tool(tmp_path, capsys):
    """Each of the eight tools answers a wrong call with its usage line
    and exit 1 (bsdftest: no card here); an unknown tool and no tool
    exit 1."""
    assert tools.TOOLS == ("exrdiff", "exravg", "exrtotiff", "tifftoexr", "obj2pbrt",
                           "ply2pbrt", "bsdftest", "samplepat")
    for tool in tools.TOOLS[:6]:
        assert tools.main([tool]) == 1, tool
        assert "usage" in capsys.readouterr().err, tool
    if not torch.cuda.is_available():
        assert tools.main(["bsdftest", "64"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert tools.main(["samplepat", str(tmp_path / "s.npy"), "8"]) == 0
    assert tools.main(["nonesuch"]) == 1 and tools.main([]) == 1
