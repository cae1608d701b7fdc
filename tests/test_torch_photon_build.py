"""The port's build_photon_maps against the JAX package's on `disp`
(tests/goldens), with `quick` (an eighth of the quotas): the same maps
and sizes, the same 1/nshot windows, one host sync per batch. Then a
scene whose caustic quota cannot fill: the shoot ends at the batch cap,
and the port names the short map.

Limits: map counts and path counts identical; each map's total power
within 2e-3 relative (the records agree as
tests/test_torch_photon_shooter.py states, not bit for bit).
"""
import os

import numpy as np
import pytest
import torch

from pbrt_tpu.photon import shooter as j_shoot
from pbrt_tpu_torch.core import error as t_error
from pbrt_tpu_torch.photon import shooter as t_shoot
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from test_reference_golden import GOLDEN_DIR
from test_torch_photon_shooter import compiled
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


@pytest.fixture(scope="module")
def disp(tmp_path_factory):
    with open(os.path.join(GOLDEN_DIR, "disp.pbrt")) as f:
        return compiled(tmp_path_factory, "disp", f.read())


def test_build_photon_maps_on_disp(disp):
    """The quotas (quick: an eighth), the 1/nshot windows and the maps'
    sizes agree; one host sync per batch."""
    js, ts, _, jro, tro = disp
    ref = j_shoot.build_photon_maps(js, jro.surf_integrator_params, jro.vol_integrator_params,
                                    {"quick": True})
    got = t_shoot.build_photon_maps(ts, tro.surf_integrator_params, tro.vol_integrator_params,
                                    {"quick": True})
    for f in ("n_caustic_paths", "n_indirect_paths", "n_volume_paths", "n_used", "max_dist2",
              "gather_samples", "final_gather"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("caustic", "indirect", "direct", "volume", "radiance"):
        jm, tm = getattr(ref, f), getattr(got, f)
        assert (jm is None) == (tm is None), f
        if jm is not None:
            assert tm.count == jm.count, f
            ja = float(np.asarray(jm.alpha_t).sum())
            assert abs(tm.alpha.sum().item() - ja) <= 2e-3 * ja, f
    assert got.caustic is not None and got.direct.count == 10000
    st = got.stats
    assert st["syncs"] == st["batches"] and st["shots"] == st["batches"] * 4096


# no specular surface: no photon is ever caustic
NO_CAUSTIC_SCENE = """Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 1 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
SurfaceIntegrator "photonmap" "integer causticphotons" [1000] "integer indirectphotons" [100]
WorldBegin
LightSource "point" "point from" [0 2 -1] "rgb I" [5 5 5]
Material "matte" "rgb Kd" [.5 .5 .5]
Shape "sphere" "float radius" [0.5]
Translate 0 -0.5 0
Rotate -90 1 0 0
Shape "disk" "float radius" [3]
WorldEnd
"""


def test_short_map_at_the_batch_cap_is_named(tmp_path, capsys, monkeypatch):
    """With quick, the cap is 32 batches of 4,096 (131,072 paths, under
    the 500k past which a quota is given up): the caustic map ends empty,
    and the warning and stats["short"] say so; the indirect map fills."""
    path = tmp_path / "scene.pbrt"
    path.write_text(NO_CAUSTIC_SCENE)
    tro = _parse(t_api, t_parser, path)
    ts = t_compile(tro, "cpu")
    monkeypatch.setattr(t_error, "quiet", False)   # the parse sets it from its options
    ctx = t_shoot.build_photon_maps(ts, tro.surf_integrator_params,
                                    tro.vol_integrator_params, {"quick": True})
    st = ctx.stats
    assert st["batches"] == 32 and not st["aborted"]
    assert st["short"] == {"caustic": [0, 125]}
    assert ctx.caustic is None and ctx.indirect.count >= 12
    assert "with maps short of their quotas: caustic 0 of 125" in capsys.readouterr().err
