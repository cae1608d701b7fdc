"""The port's photon maps (pbrt_tpu_torch/photon/map.py) against the JAX
package's (pbrt_tpu/photon/map.py).

One 20,000-photon map, made from a seed with NumPy: a uniform cloud, a
dense cluster (cells far over the per-cell cap, so lookups truncate and
reweight), duplicated positions (10 photons on each of 50 points) and
pairs placed symmetrically about a query (exact distance ties). The
queries: inside the cloud and the cluster, on the duplicates and the
symmetric pairs, in an empty pocket (no photon in their 27 cells) and
outside the grid (clamped to its edge cells). 1,000 queries, fewer than
one of the JAX package's query blocks at every k, so its per-block
rules apply to all of them alike.

Limits: the grid structure is identical; the selected photons are the
same set in the same order (n_found, the validity masks and the
directions of knn_dirs identical); flux, irradiance and the materialized
lookup within 1e-5 relative (float32 sums in another order); r2_norm
within 1e-6 relative; r2_found within 1e-6 relative where a photon was
found (photon/map.py says why not elsewhere); radiance lookups identical.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.photon import map as j_map
from pbrt_tpu_torch.photon import map as t_map

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

S = 30
P = 20000
N_Q = 1000


def photons(seed=0):
    rng = np.random.RandomState(seed)
    cloud = rng.uniform(-1, 1, (10500, 3))
    cluster = rng.normal(0.3, 0.03, (8000, 3))
    dup = np.repeat(rng.uniform(-0.8, 0.8, (50, 3)), 10, axis=0)
    # pairs symmetric about three query points, at offsets exact in float32
    centres = np.array([[-0.5, -0.25, 0.5], [0.25, 0.5, -0.5], [-0.75, 0.5, 0.25]])
    offs = np.array([[0.125, 0, 0], [-0.125, 0, 0], [0, 0.125, 0], [0, -0.125, 0],
                     [0, 0, 0.0625], [0, 0, -0.0625]])
    sym = (centres[:, None, :] + offs[None]).reshape(-1, 3)
    pos = np.concatenate([cloud, cluster, dup, sym])
    # an empty pocket: no photon within 0.6 of (-0.6, -0.6, -0.6)
    keep = np.linalg.norm(pos - [-0.6, -0.6, -0.6], axis=-1) > 0.6
    pos = pos[keep]
    pos = np.concatenate([pos, rng.uniform(-1, 1, (P - len(pos), 3))])
    pos = pos[np.linalg.norm(pos - [-0.6, -0.6, -0.6], axis=-1) > 0.6]
    pos = np.concatenate([pos, np.tile([[0.9, 0.9, 0.9]], (P - len(pos), 1))])
    alpha = rng.uniform(0, 1, (len(pos), S)) * rng.uniform(0.1, 2, (len(pos), 1))
    wi = rng.normal(size=(len(pos), 3))
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    return pos.astype(np.float32), alpha.astype(np.float32), wi.astype(np.float32), centres


def queries(pos, centres, seed=1):
    rng = np.random.RandomState(seed)
    q = np.concatenate([
        rng.uniform(-1, 1, (300, 3)),                     # the cloud
        rng.normal(0.3, 0.03, (200, 3)),                  # the dense cluster
        pos[10500 + 8000:10500 + 8000 + 500:5],           # on the duplicates
        np.repeat(centres, 10, axis=0),                   # amid the symmetric pairs
        rng.uniform(-0.7, -0.5, (150, 3)),                # the empty pocket
        rng.uniform(1.2, 3.0, (120, 3)) * rng.choice([-1, 1], (120, 3)),   # outside the grid
    ])
    q = np.concatenate([q, rng.uniform(-1, 1, (N_Q - len(q), 3))])
    n = rng.normal(size=(N_Q, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return q.astype(np.float32), n.astype(np.float32)


@pytest.fixture(scope="module")
def maps():
    pos, alpha, wi, centres = photons()
    q, n = queries(pos, centres)
    jm = j_map.build_photon_map(pos, alpha, wi, 0.05, target_k=60)
    tm = t_map.build_photon_map(pos, alpha, wi, 0.05, target_k=60, device="cpu")
    return pos, alpha, wi, q, n, jm, tm


def test_structure_identical(maps):
    pos = maps[0]
    for cell, k in ((0.05, 0), (0.05, 60), (0.2, 500), (1e-5, 0)):
        js = j_map.photon_map_structure(pos, cell, k)
        ts = t_map.photon_map_structure(pos, cell, k)
        for f in js._fields:
            np.testing.assert_array_equal(np.asarray(getattr(ts, f)), np.asarray(getattr(js, f)),
                                          err_msg=f)
    assert t_map.photon_map_structure(pos[:0], 0.1) is None
    jm, tm = maps[5], maps[6]
    np.testing.assert_array_equal(tm.pos.numpy(), np.asarray(jm.pxyz)[:, :3])
    np.testing.assert_array_equal(tm.alpha.numpy(), np.asarray(jm.alpha_t).T)
    np.testing.assert_array_equal(tm.occ.numpy(), np.asarray(jm.occ))
    assert tm.dims == jm.dims and tm.count == jm.count == P
    assert tm.occ.max() > 4 * t_map.default_cap(60)    # dense cells truncate


def _weight(stack, where):
    """Two channels (front and back hemisphere of nb) of 1 - d2 / r2."""
    def weight(wix, wiy, wiz, d2, valid, r2, nb):
        front = (wix * nb[:, 0:1] + wiy * nb[:, 1:2] + wiz * nb[:, 2:3]) > 0.0
        smooth = 1.0 - d2 / r2[:, None]
        return stack([where(front, smooth, 0.0 * smooth), where(front, 0.0 * smooth, smooth)], -1)
    return weight


@pytest.mark.parametrize("k", [8, 60, 500])
def test_knn_flux_and_dirs_match_jax(maps, k):
    import jax.numpy as jnp

    _, _, _, q, n, jm, tm = maps
    max_d2 = 0.04 if k < 500 else 0.25
    ref = j_map.knn_weighted_flux(jm, jnp.asarray(q), k, max_d2, _weight(jnp.stack, jnp.where),
                                  extras=(jnp.asarray(n),))
    got = t_map.knn_weighted_flux(tm, torch.as_tensor(q), k, max_d2,
                                  _weight(torch.stack, torch.where),
                                  extras=(torch.as_tensor(n),), n_channels=2)
    nf_j, nf_t = np.asarray(ref.n_found), got.n_found.numpy()
    np.testing.assert_array_equal(nf_t, nf_j)
    assert (nf_j == k).sum() > 200 and (nf_j == 0).sum() > 100 and ((nf_j > 0) & (nf_j < k)).any()
    fj = np.asarray(ref.flux)
    np.testing.assert_allclose(got.flux.numpy(), fj, rtol=1e-5, atol=1e-5 * np.abs(fj).max())
    np.testing.assert_allclose(got.r2_norm.numpy(), np.asarray(ref.r2_norm), rtol=1e-6)
    found = nf_j > 0
    np.testing.assert_allclose(got.r2_found.numpy()[found], np.asarray(ref.r2_found)[found],
                               rtol=1e-6)
    # the port's blocking does not change a query's result
    small = t_map.knn_weighted_flux(tm, torch.as_tensor(q), k, max_d2,
                                    _weight(torch.stack, torch.where),
                                    extras=(torch.as_tensor(n),), n_channels=2, block=97)
    for a, b in zip(small, got):
        assert torch.equal(a, b)

    jd = [np.asarray(x) for x in j_map.knn_dirs(jm, jnp.asarray(q), k, max_d2)]
    td = [x.numpy() for x in t_map.knn_dirs(tm, torch.as_tensor(q), k, max_d2)]
    np.testing.assert_array_equal(td[3], jd[3])
    for a, b in zip(td[:3], jd[:3]):
        np.testing.assert_array_equal(a[jd[3]], b[jd[3]])   # same photons, same order


def test_knn_lookup_and_ephoton_match_jax(maps):
    import jax.numpy as jnp

    _, _, _, q, n, jm, tm = maps
    ref = j_map.knn_lookup(jm, jnp.asarray(q), 60, 0.04)
    got = t_map.knn_lookup(tm, torch.as_tensor(q), 60, 0.04)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.dist2.numpy(), np.asarray(ref.dist2))
    np.testing.assert_array_equal(got.wi.numpy()[np.asarray(ref.valid)],
                                  np.asarray(ref.wi)[np.asarray(ref.valid)])
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha), rtol=1e-6)
    np.testing.assert_allclose(got.r2_max.numpy(), np.asarray(ref.r2_max), rtol=1e-6)

    ej = np.asarray(j_map.ephoton(jm, jnp.asarray(q), jnp.asarray(n), 60, 0.04))
    et = t_map.ephoton(tm, torch.as_tensor(q), torch.as_tensor(n), 60, 0.04).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-5 * np.abs(ej).max())
    assert (ej.sum(-1) > 0).mean() > 0.5
    # the mask: unwanted queries get the no-photon result, the rest are unchanged
    mask = torch.as_tensor(np.arange(N_Q) % 3 == 0)
    em = t_map.ephoton(tm, torch.as_tensor(q), torch.as_tensor(n), 60, 0.04, mask=mask).numpy()
    np.testing.assert_array_equal(em[mask.numpy()], et[mask.numpy()])
    assert (em[~mask.numpy()] == 0).all()


def test_radiance_lookup_matches_jax(maps):
    import jax.numpy as jnp

    pos, alpha, wi, q, n, _, _ = maps
    jr = j_map.build_radiance_map(pos, alpha, wi, 0.1)
    tr = t_map.build_radiance_map(pos, alpha, wi, 0.1, device="cpu")
    lo_j, f_j = (np.asarray(x) for x in j_map.radiance_lookup(jr, jnp.asarray(q), jnp.asarray(n)))
    lo_t, f_t = (x.numpy() for x in t_map.radiance_lookup(tr, torch.as_tensor(q),
                                                          torch.as_tensor(n)))
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(lo_t, lo_j)
    assert f_j.mean() > 0.5 and not f_j.all()


def test_maps_default_to_their_inputs_device(maps, monkeypatch):
    """Without a device, a tensor input's map stays on that tensor's
    device, and a NumPy input's map goes to the card (the port's
    default), for the photon and the radiance map alike."""
    pos, alpha, wi = maps[:3]
    tm = t_map.build_photon_map(torch.as_tensor(pos), torch.as_tensor(alpha),
                                torch.as_tensor(wi), 0.05, target_k=60)
    assert tm.pos.device == tm.alpha.device == tm.cell_start.device == torch.device("cpu")
    np.testing.assert_array_equal(tm.alpha.numpy(), maps[6].alpha.numpy())
    tr = t_map.build_radiance_map(torch.as_tensor(pos), torch.as_tensor(alpha),
                                  torch.as_tensor(wi), 0.1)
    assert tr.pos.device == tr.lo.device == torch.device("cpu")
    asked = []
    monkeypatch.setattr(t_map, "build_photon_map_from",
                        lambda st, p, a, w, device: asked.append(device))
    t_map.build_photon_map(pos, alpha, wi, 0.05)
    t_map.build_radiance_map(pos, alpha, wi, 0.1)
    t_map.build_photon_map(pos, alpha, wi, 0.05, device="cpu")
    assert asked == ["cuda", "cuda", "cpu"]
