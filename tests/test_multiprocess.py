"""Multi-PROCESS distributed training: 2 CPU subprocesses run
``train.py --world_size 2 --process_id {0,1}`` through a short schedule with
per-process file shards (reference: dist.init_process_group + mp spawn,
/root/reference/train.py:272,280-304; file sharding dataloader.py:50-56).

Asserts: both ranks complete, their final params are IDENTICAL (the global
shard_map mesh psum is a real DDP all-reduce — unsynced ranks diverge
immediately on different shards), and checkpoints are written by rank 0
only.

Runs in real subprocesses (its own jax.distributed universe per process),
so the in-process virtual mesh of the other tests is not disturbed.
"""

import os
import socket
import subprocess
import sys

import h5py
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = """
import os, sys
import numpy as np
from absl import app, flags

sys.path.insert(0, {repo!r})
import train
from equivariant_nn_zoo.models import config_energy, register_config


def tiny(spec=None):
    from equivariant_nn_zoo.models.layer_configs import (
        addEnergyOutput, featureModel,
    )

    cfg = config_energy()
    mc = featureModel(
        n_dim=4, l_max=1, edge_spherical="1x0e+1x1o", node_attrs="4x0e",
        edge_radial="4x0e", num_types=10, num_layers=1, r_max=4.0,
    )
    cfg.model_config = addEnergyOutput(mc, shifts=[0.0] * 10)
    cfg.batch_size = 8
    cfg.max_epochs = 2
    cfg.data_config.path = list(os.environ["E3_TEST_SHARDS"].split(","))
    cfg.data_config.n_train = 24
    cfg.data_config.n_val = 8
    cfg.data_config.train_val_split = "sequential"
    cfg.data_config.shuffle = False
    cfg.data_config.key_map = {{
        "Z": ("species", "atom_types"), "R": "pos", "U0": "total_energy",
    }}
    return cfg


register_config("config_tiny_mp", tiny)


def main(argv):
    trainer = train.run(argv)
    leaves = __import__("jax").tree_util.tree_leaves(trainer.params)
    digest = float(sum(float(np.abs(np.asarray(l)).sum()) for l in leaves))
    print(f"PARAM_DIGEST {{digest:.10e}}", flush=True)


if __name__ == "__main__":
    flags.mark_flags_as_required(["config"])
    app.run(main)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_shard(path, seed, n_mols=32):
    rng = np.random.default_rng(seed)
    Rs, Zs, Us, n_nodes = [], [], [], []
    for _ in range(n_mols):
        n = int(rng.integers(4, 10))
        pos = rng.normal(size=(n, 3)) * 1.1
        Z = rng.choice([1, 6, 7, 8], size=(n, 1))
        U = float(rng.normal())
        Rs.append(pos)
        Zs.append(Z)
        Us.append([U])
        n_nodes.append([n])
    with h5py.File(path, "w") as f:
        f["R"] = np.concatenate(Rs).astype(np.float32)
        f["Z"] = np.concatenate(Zs).astype(np.int64)
        f["U0"] = np.asarray(Us, np.float32)
        f["_n_nodes"] = np.asarray(n_nodes, np.int64)
        f.attrs["R"] = ("node", "1x1o")
        f.attrs["Z"] = ("node", "1x0e")
        f.attrs["U0"] = ("graph", "1x0e")
        f.attrs["_n_nodes"] = ("graph", "1x0e")


def test_two_process_ddp_train(tmp_path):
    shard0 = tmp_path / "shard_0.hdf5"
    shard1 = tmp_path / "shard_1.hdf5"
    _write_shard(shard0, seed=0)
    _write_shard(shard1, seed=1)

    runner = tmp_path / "runner.py"
    runner.write_text(RUNNER.format(repo=REPO))

    port = _free_port()
    workdirs = [tmp_path / "wd0", tmp_path / "wd1"]
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
            E3_COMPUTE_DTYPE="float32",
            E3_TEST_SHARDS=f"{shard0},{shard1}",
        )
        env.pop("JAX_PLATFORMS", None)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, str(runner),
                    "--config", "config_tiny_mp",
                    "--platform", "cpu",
                    "--world_size", "2",
                    "--process_id", str(rank),
                    "--master_addr", "127.0.0.1",
                    "--master_port", str(port),
                    "--workdir", str(workdirs[rank]),
                    "--name", "mp",
                    "--seed", "0",
                ],
                env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"

    # the global mesh path must have been taken
    assert any("across 2 processes" in o for o in outs), outs[0][-2000:]

    # gradient sync: identical final params on both ranks
    digests = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("PARAM_DIGEST")]
        assert lines, out[-2000:]
        digests.append(float(lines[-1].split()[1]))
    np.testing.assert_allclose(digests[0], digests[1], rtol=1e-6)

    # rank-0-only checkpointing (reference train.py:52,87,183 discipline)
    rank0_files = os.listdir(workdirs[0] / "default_project" / "mp")
    assert "best.pt" in rank0_files and "trainer.pt" in rank0_files
    rank1_files = os.listdir(workdirs[1] / "default_project" / "mp")
    assert "best.pt" not in rank1_files and "trainer.pt" not in rank1_files
