"""The port's counter-based random streams against the JAX package's.

Both packages hash (pixel, sample, depth, dim, seed) counters with the
same uint32 arithmetic; the port carries it in int64 masked to 32 bits.
The streams must be bit-identical (tolerance 0): any difference would
turn port-vs-reference image diffs into Monte Carlo noise.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import sampling as jsampling
from pbrt_tpu.samplers import samplers as jsamplers
from pbrt_tpu.scene.paramset import ParamSet as JParamSet
from pbrt_tpu_torch.core import sampling as tsampling
from pbrt_tpu_torch.samplers import samplers as tsamplers
from pbrt_tpu_torch.scene.paramset import ParamSet as TParamSet

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

N = 1 << 20  # counters per stream


def _u32(seed):
    return np.random.RandomState(seed).randint(0, 2 ** 32, size=N, dtype=np.uint64)


def test_wang_hash_bit_exact():
    x = _u32(0)
    ref = np.asarray(jsamplers._wang_hash(jnp.asarray(x.astype(np.uint32))))
    got = tsamplers._wang_hash(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


def test_low_discrepancy_points_bit_exact():
    n = np.arange(N, dtype=np.uint64)
    scr = _u32(1)
    tn, ts = torch.as_tensor(n.astype(np.int64)), torch.as_tensor(scr.astype(np.int64))
    jn, js = jnp.asarray(n.astype(np.uint32)), jnp.asarray(scr.astype(np.uint32))
    np.testing.assert_array_equal(tsampling.van_der_corput(tn, ts).numpy(),
                                  np.asarray(jsampling.van_der_corput(jn, js)))
    np.testing.assert_array_equal(tsampling.sobol2(tn, ts).numpy(),
                                  np.asarray(jsampling.sobol2(jn, js)))


@pytest.mark.parametrize("depth,dim,seed", [(0, 0, 0), (3, 7, 5), (4, 9, 123456)])
def test_integrator_uniform_bit_exact(depth, dim, seed):
    pix = np.arange(N) % 65536
    sidx = np.arange(N) // 65536
    ref = jsamplers.integrator_uniform(jnp.asarray(pix, jnp.int32),
                                       jnp.asarray(sidx, jnp.int32), depth, dim, seed)
    got = tsamplers.integrator_uniform(torch.as_tensor(pix), torch.as_tensor(sidx),
                                       depth, dim, seed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["lowdiscrepancy", "random", "stratified"])
def test_camera_samples_bit_exact(kind):
    width, spp = 512, 4                      # 512 x 512 pixels x 4 = 1M samples
    ids = np.arange(width * width)
    px, py = ids % width, ids // width
    js = jsamplers.make_sampler(kind, JParamSet())
    ts = tsamplers.make_sampler(kind, TParamSet())
    assert js.spp == ts.spp == spp
    ref = jsamplers.camera_samples(js, jnp.asarray(px, jnp.int32),
                                   jnp.asarray(py, jnp.int32), width, 1)
    got = tsamplers.camera_samples(ts, torch.as_tensor(px), torch.as_tensor(py), width, 1)
    for name, r, g in zip(ref._fields, ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
