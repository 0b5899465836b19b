"""Data-parallel training over a virtual 8-device CPU mesh: the Trainer's
shard_map path must train, and gradients must match single-device training on
the same total batch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from equivariant_nn_zoo.parallel import make_mesh
from equivariant_nn_zoo.parallel.data_parallel import (
    put_sharded,
    stack_shards,
)


def test_virtual_mesh_available():
    mesh = make_mesh(8)
    assert mesh.devices.size == 8


def test_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    g.dryrun_multichip(4)


def test_trainer_with_mesh(tmp_path):
    """End-to-end: Trainer + 4-device mesh trains on sharded batches."""
    from functools import partial

    import h5py

    from equivariant_nn_zoo.data.compute_edge import computeEdgeIndex
    from equivariant_nn_zoo.data.dataset import CondensedDataset
    from equivariant_nn_zoo.models.layer_configs import (
        addEnergyOutput,
        featureModel,
    )
    from equivariant_nn_zoo.run import Trainer
    from equivariant_nn_zoo.utils import build

    rng = np.random.default_rng(0)
    path = tmp_path / "ds.hdf5"
    Rs, Zs, Us, nn = [], [], [], []
    for _ in range(64):
        n = int(rng.integers(4, 9))
        Rs.append(rng.normal(size=(n, 3)).astype(np.float32))
        Zs.append(rng.choice([1, 6, 7, 8], size=(n, 1)))
        Us.append([float(rng.normal())])
        nn.append([n])
    with h5py.File(path, "w") as f:
        f["R"] = np.concatenate(Rs)
        f["Z"] = np.concatenate(Zs).astype(np.int64)
        f["U0"] = np.asarray(Us, np.float32)
        f["_n_nodes"] = np.asarray(nn, np.int64)
        f.attrs["R"] = ("node", "1x1o")
        f.attrs["Z"] = ("node", "1x0e")
        f.attrs["U0"] = ("graph", "1x0e")
        f.attrs["_n_nodes"] = ("graph", "1x0e")

    mc = featureModel(
        n_dim=4, l_max=1, edge_spherical="1x0e+1x1o", node_attrs="4x0e",
        edge_radial="4x0e", num_types=10, num_layers=1, r_max=4.0,
    )
    mc = addEnergyOutput(mc, shifts=[0.0] * 10)
    model = build(mc)
    ds = CondensedDataset(
        path=str(path),
        key_map={"Z": ("species", "atom_types"), "R": "pos",
                 "U0": "total_energy"},
        preprocess=[partial(computeEdgeIndex, r_max=4.0)],
    )
    mesh = make_mesh(4)
    tr = Trainer(
        model=model, workdir=str(tmp_path / "wd"), seed=0, mesh=mesh,
        data_config={"n_train": 32, "n_val": 16,
                     "train_val_split": "sequential", "shuffle": False},
        loss_coeffs={"total_energy": [1.0, "MSELoss"]},
        metrics_components={"total_energy": ["mae"]},
        metric_key="validation_loss", learning_rate=1e-3,
        optimizer_name="Adam", lr_scheduler_name="none",
        use_ema=True, ema_decay=0.99, max_epochs=2, batch_size=8,
        log_period=1000,
    )
    tr.set_dataset(ds)
    tr.init_metrics()
    tr.epoch_step()
    assert np.isfinite(tr.mae_dict["validation_loss"])
    assert np.isfinite(tr.mae_dict["validation_total_energy_mae"])


def test_dp_matches_single_device():
    """DP shard_map training must be numerically identical to single-device
    training on the same total batch (DDP all-reduce ≡ large-batch SGD):
    grads and updated params after K steps match to f32 tolerance."""
    import optax

    import __graft_entry__ as g
    from equivariant_nn_zoo.parallel.data_parallel import (
        make_dp_train_step,
    )
    from equivariant_nn_zoo.run.loss import Loss

    n_dev = 4
    mesh = make_mesh(n_dev)
    model = g._tiny_model()
    params0 = model.init(jax.random.PRNGKey(0))
    loss_obj = Loss({"total_energy": [1.0, "MSELoss"]})
    optimizer = optax.adam(1e-2)

    rng = np.random.default_rng(42)
    steps_shards = [
        [g._tiny_batch(rng) for _ in range(n_dev)] for _ in range(3)
    ]

    # --- DP path ---------------------------------------------------------
    dp_params = jax.tree_util.tree_map(jnp.copy, params0)
    dp_opt = optimizer.init(dp_params)
    step = make_dp_train_step(model, loss_obj, optimizer, mesh)
    dp_losses = []
    for shards in steps_shards:
        stacked = put_sharded(stack_shards(shards), mesh)
        dp_params, dp_opt, _, loss, _ = step(dp_params, dp_opt, None, stacked)
        dp_losses.append(float(loss))

    # --- single-device reference: mean of per-shard losses ----------------
    sd_params = jax.tree_util.tree_map(jnp.copy, params0)
    sd_opt = optimizer.init(sd_params)

    def total_loss(p, shards):
        losses = [loss_obj(model.apply(p, b).data, b.data)[0] for b in shards]
        return jnp.mean(jnp.stack(losses))

    sd_losses = []
    for shards in steps_shards:
        loss, grads = jax.value_and_grad(total_loss)(sd_params, shards)
        updates, sd_opt = optimizer.update(grads, sd_opt, sd_params)
        sd_params = optax.apply_updates(sd_params, updates)
        sd_losses.append(float(loss))

    np.testing.assert_allclose(dp_losses, sd_losses, rtol=1e-5, atol=1e-6)
    flat_dp = jax.tree_util.tree_leaves(dp_params)
    flat_sd = jax.tree_util.tree_leaves(sd_params)
    for a, b in zip(flat_dp, flat_sd):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
        )


def test_stack_and_put_sharded_roundtrip():
    from equivariant_nn_zoo.data import Batch, Data, GraphBatch

    rng = np.random.default_rng(0)

    def mol():
        n = int(rng.integers(3, 6))
        return Data(
            {"pos": ("node", "1x1o"), "y": ("graph", "1x0e")},
            pos=rng.normal(size=(n, 3)), y=rng.normal(size=(1, 1)),
        )

    shards = [
        GraphBatch.from_batch(Batch.from_data_list([mol(), mol()]), 16, 32, 2)
        for _ in range(4)
    ]
    stacked = stack_shards(shards)
    assert stacked["pos"].shape == (4, 16, 3)
    mesh = make_mesh(4)
    dev = put_sharded(stacked, mesh)
    np.testing.assert_allclose(
        np.asarray(dev["pos"]), np.asarray(stacked["pos"])
    )
