"""Multi-device rendering of the port (pbrt_tpu_torch/parallel/mesh.py)
on CPU gloo ranks.

- The collectives with two ranks, each its own process: shard_batch's
  contiguous slices, gather_replicated's rank-order all-gather (floats,
  bools, int64), reduce_sum, and the probes counters of each collective.
- tests/test_distributed.py's photonvolume scene at 16^2 through the real
  CLI: two processes joined by --distributed (the JAX package's
  PBRT_COORDINATOR variables, and torchrun's env:// ones), and
  --ncores 2, against a one-process render, with that test's limits:
  each image within rtol 1e-4 / atol 1e-5 of the one-process render, the
  two ranks' images within rtol 1e-5 / atol 1e-7 of each other;
  --ncores 2 with a checkpoint (written by rank 0 from the reduced film)
  and a run resumed from it, within the ranks' limits of the first.

Every subprocess has its own timeout and is killed when it expires, and
every rendezvous takes a free port, so a hung rank fails one test.
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import main as cli
from pbrt_tpu_torch.io.image import read_image

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
with open(os.path.join(REPO, "tests", "test_distributed.py")) as _f:
    SCENE = re.search(r'SCENE = """(.*?)"""', _f.read(), re.S).group(1)
# one tile of the image's 256 camera samples: no padding pixels traced
CLI_ARGS = ("--device", "cpu", "--tile-samples", "256")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_all(cmds_envs):
    """Start every (argv, env) at once; wait for each within TIMEOUT_S,
    killing the rest on expiry. -> [(returncode, output)]."""
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv, env in cmds_envs]
    out = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT_S)
            out.append((p.returncode, log))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a rank did not finish within {TIMEOUT_S} s")
    return out


RANK_SCRIPT = r"""
import sys
import datetime
import numpy as np
import torch
import torch.distributed as dist
from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.parallel import mesh as pmesh

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert pmesh.mesh_from_options({"device": "cpu"}) is None
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
m = pmesh.mesh_from_options({"device": "cpu"})
batch = torch.arange(24, dtype=torch.float32).reshape(8, 3)
mine = pmesh.shard_batch(m, batch)
g_f, g_b, g_i = pmesh.gather_replicated(m, [mine + 100 * rank, mine[:, 0] > 10,
                                            mine[:, 1].long() * 1000])
film = torch.full((4, 5, 3), float(rank + 1))
(red,) = pmesh.reduce_sum(m, [film])
np.savez(out, rank=m.rank, world=m.world, backend=m.backend, mine=mine.numpy(),
         g_f=g_f.numpy(), g_b=g_b.numpy(), g_b_dtype=str(g_b.dtype), g_i=g_i.numpy(),
         g_i_dtype=str(g_i.dtype), red=red.numpy(), film=film.numpy(),
         rounded=[pmesh.round_to_world(m, n) for n in (1, 7, 4096)],
         collectives=probes.counters()["mesh/collectives"])
dist.destroy_process_group()
"""


def test_collectives_on_two_gloo_ranks(tmp_path):
    port = free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    res = run_all([([sys.executable, "-c", RANK_SCRIPT, str(r), str(port), str(outs[r])],
                    child_env()) for r in range(2)])
    assert all(rc == 0 for rc, _ in res), "\n===\n".join(log for _, log in res)
    batch = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, path in enumerate(outs):
        z = np.load(path)
        assert (int(z["rank"]), int(z["world"]), str(z["backend"])) == (r, 2, "gloo")
        np.testing.assert_array_equal(z["mine"], batch[4 * r: 4 * r + 4])
        # every rank holds the whole batch, in rank order
        want = np.concatenate([batch[:4], batch[4:] + 100])
        np.testing.assert_array_equal(z["g_f"], want)
        np.testing.assert_array_equal(z["g_b"], batch[:, 0] > 10)
        assert str(z["g_b_dtype"]) == "torch.bool" and str(z["g_i_dtype"]) == "torch.int64"
        np.testing.assert_array_equal(z["g_i"], batch[:, 1].astype(np.int64) * 1000)
        np.testing.assert_array_equal(z["red"], np.full((4, 5, 3), 3.0, np.float32))
        # the input is left as it was
        np.testing.assert_array_equal(z["film"], np.full((4, 5, 3), r + 1.0, np.float32))
        assert list(z["rounded"]) == [2, 6, 4096]
        assert int(z["collectives"]) == 2


@pytest.fixture(scope="module")
def scene_and_single(tmp_path_factory):
    """The scene file and its one-process render."""
    tmp = tmp_path_factory.mktemp("parallel")
    scene = tmp / "dist.pbrt"
    scene.write_text(SCENE)
    out = tmp / "single.pfm"
    (rc, log), = run_all([([sys.executable, "-m", "pbrt_tpu_torch.main", *CLI_ARGS,
                            "--quiet", "--outfile", str(out), str(scene)], child_env())])
    assert rc == 0, log
    img = read_image(str(out))
    assert np.all(np.isfinite(img)) and img.max() > 0.0
    return scene, img


@pytest.mark.parametrize("rendezvous", ["pbrt_env", "torchrun_env"])
def test_two_process_distributed_render(tmp_path, scene_and_single, rendezvous):
    scene, single = scene_and_single
    port = free_port()
    runs, outs = [], []
    for pid in range(2):
        if rendezvous == "pbrt_env":
            env = child_env(PBRT_COORDINATOR=f"127.0.0.1:{port}", PBRT_NUM_PROCESSES=2,
                            PBRT_PROCESS_ID=pid)
        else:
            env = child_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=2, RANK=pid,
                            LOCAL_RANK=pid)
            env.pop("PBRT_COORDINATOR", None)
        outs.append(tmp_path / f"dist_{pid}.pfm")
        runs.append(([sys.executable, "-m", "pbrt_tpu_torch.main", "--distributed", *CLI_ARGS,
                      "--verbose", "--outfile", str(outs[-1]), str(scene)], env))
    res = run_all(runs)
    assert all(rc == 0 for rc, _ in res), "\n===\n".join(log for _, log in res)
    for _, log in res:
        assert "sharding render tiles over 2 ranks" in log
        assert "photon shooting sharded over 2 ranks" in log
        assert int(re.search(r"mesh/collectives\s+([\d,]+)", log).group(1).replace(",", "")) > 0
    imgs = [read_image(str(o)) for o in outs]
    # both processes hold the identical full film
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=1e-5, atol=1e-7)
    # and the distributed render equals the one-process render
    np.testing.assert_allclose(imgs[0], single, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def ncores_run(scene_and_single, tmp_path_factory):
    """--ncores 2 with a checkpoint: tiles of 2 pixels (one a rank), 128
    tiles, so the film is reduced and written by rank 0 at tile 64."""
    scene, _ = scene_and_single
    tmp = tmp_path_factory.mktemp("ncores")
    out, ckpt = tmp / "ncores.pfm", tmp / "film.npz"
    (rc, log), = run_all([([sys.executable, "-m", "pbrt_tpu_torch.main", "--ncores", "2",
                            "--device", "cpu", "--tile-samples", "2", "--checkpoint", str(ckpt),
                            "--verbose", "--outfile", str(out), str(scene)], child_env())])
    assert rc == 0, log
    return out, ckpt, log


def test_ncores_render(ncores_run, scene_and_single):
    out, _, log = ncores_run
    # two ranks rendered, rank 0 alone wrote the image
    assert log.count("sharding render tiles over 2 ranks") == 2
    assert log.count("Wrote image") == 1
    np.testing.assert_allclose(read_image(str(out)), scene_and_single[1], rtol=1e-4, atol=1e-5)


def test_ncores_checkpoint_resume(ncores_run, scene_and_single, tmp_path):
    """The checkpoint holds the reduced film of 64 tiles; a second run
    resumes there (rank 0 keeps the film, both ranks take its tile) and
    gives the first run's image."""
    scene, single = scene_and_single
    first, ckpt, _ = ncores_run
    z = np.load(ckpt)
    assert int(z["tile"]) == 64 and 0 < float(z["weight"].sum()) < 256
    out = tmp_path / "resumed.pfm"
    (rc, log), = run_all([([sys.executable, "-m", "pbrt_tpu_torch.main", "--ncores", "2",
                            "--device", "cpu", "--tile-samples", "2", "--checkpoint", str(ckpt),
                            "--verbose", "--outfile", str(out), str(scene)], child_env())])
    assert rc == 0, log
    assert log.count("resuming render from checkpoint tile 64/128") == 2
    resumed = read_image(str(out))
    np.testing.assert_allclose(resumed, read_image(str(first)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(resumed, single, rtol=1e-4, atol=1e-5)


def test_distributed_refuses_ncores(tmp_path, capsys):
    scene = tmp_path / "s.pbrt"
    scene.write_text(SCENE)
    assert cli.main(["--distributed", "--ncores", "2", *CLI_ARGS, str(scene)]) == 1
    assert "--ncores" in capsys.readouterr().err
