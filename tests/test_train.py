"""Vertical-slice test: HDF5 dataset -> trainer -> loss decreases ->
checkpoint -> resume -> inference collection.  The reference's de-facto
integration test (SURVEY.md §4) is accuracy parity; this is the fast CI
version on a synthetic separable dataset."""

import os
from functools import partial

import h5py
import numpy as np
import jax
import pytest

from equivariant_nn_zoo.data.compute_edge import computeEdgeIndex
from equivariant_nn_zoo.data.dataset import CondensedDataset
from equivariant_nn_zoo.models import get_config
from equivariant_nn_zoo.run import Trainer
from equivariant_nn_zoo.utils import build


E_SPECIES = {1: -16.4, 6: -1036.0, 7: -1489.0, 8: -2047.0}


@pytest.fixture(scope="module")
def qm9_file(tmp_path_factory):
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("data") / "qm9_tiny.hdf5"
    Rs, Zs, Us, n_nodes = [], [], [], []
    for _ in range(96):
        n = int(rng.integers(4, 12))
        pos = rng.normal(size=(n, 3)) * 1.1
        Z = rng.choice([1, 6, 7, 8], size=(n, 1), p=[0.5, 0.3, 0.1, 0.1])
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        pair = np.exp(-d[np.triu_indices(n, 1)]).sum()
        U = sum(E_SPECIES[int(z)] for z in Z[:, 0]) + 3.0 * pair
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
    return str(path)


def make_trainer(qm9_file, workdir, num_layers=1, n_dim=8, max_epochs=2,
                 **extra):
    cfg = get_config("config_energy")
    cfg.batch_size = 8
    cfg.data_config.n_train = 64
    cfg.data_config.n_val = 16
    cfg.data_config.key_map = {
        "Z": ("species", "atom_types"), "R": "pos", "U0": "total_energy",
    }
    from equivariant_nn_zoo.models.layer_configs import (
        addEnergyOutput, featureModel,
    )

    mc = featureModel(
        n_dim=n_dim, l_max=1, edge_spherical="1x0e+1x1o",
        node_attrs="4x0e", edge_radial="4x0e", num_types=10, num_layers=num_layers,
        r_max=4.0,
    )
    mc = addEnergyOutput(mc, shifts=[0.0, -16.4, 0, 0, 0, 0, -1036.0,
                                     -1489.0, -2047.0, 0])
    model = build(mc)
    ds = CondensedDataset(
        path=qm9_file, key_map=dict(cfg.data_config.key_map),
        preprocess=[partial(computeEdgeIndex, r_max=4.0)],
        type_names=cfg.data_config.type_names,
    )
    tr = Trainer(
        model=model, workdir=str(workdir), seed=0,
        data_config=dict(cfg.data_config),
        loss_coeffs={"total_energy": [1.0, "MSELoss"]},
        metrics_components={"total_energy": ["mae"]},
        metric_key="validation_loss",
        learning_rate=5e-3, optimizer_name="Adam",
        lr_scheduler_name="ReduceLROnPlateau", lr_scheduler_patience=1,
        lr_scheduler_factor=0.8, use_ema=True, ema_decay=0.99,
        max_epochs=max_epochs, batch_size=8,
        early_stopping_patiences={"validation_loss": 50},
        log_period=1000,
        **extra,
    )
    tr.set_dataset(ds)
    return tr


def test_train_loss_decreases(qm9_file, tmp_path):
    tr = make_trainer(qm9_file, tmp_path / "wd", max_epochs=3)
    tr.train()
    losses = tr.mae_dict
    assert "validation_loss" in losses
    assert np.isfinite(losses["validation_loss"])
    # energy variance of the raw data is huge; after per-species shifts the
    # model should reach far below it within 3 epochs
    assert losses["validation_loss"] < 1e4
    assert os.path.exists(tr.best_model_path)
    assert os.path.exists(tr.trainer_save_path)


def test_watch_histograms(qm9_file, tmp_path):
    """wandb.watch parity (reference trainer.py:905-907): with watch_freq
    set, every watch_freq-th training batch records parameter and gradient
    norms + histograms."""
    tr = make_trainer(qm9_file, tmp_path / "wd_watch", max_epochs=1,
                      watch_freq=2)
    tr.train()
    stats = tr.watch_dict
    p_hists = [k for k in stats if k.startswith("parameters/")
               and not k.endswith("_norm")]
    g_hists = [k for k in stats if k.startswith("gradients/")
               and not k.endswith("_norm")]
    assert p_hists and g_hists
    assert len(p_hists) == len(g_hists)  # one gradient leaf per param leaf
    counts, edges = stats[g_hists[0]]
    assert counts.sum() > 0 and len(edges) == len(counts) + 1
    norms = [v for k, v in stats.items() if k.endswith("_norm")]
    assert all(np.isfinite(v) for v in norms)
    # some gradient must be non-zero after a real step
    assert any(v > 0 for k, v in stats.items()
               if k.startswith("gradients/") and k.endswith("_norm"))


def test_grad_acc_matches_large_batch(qm9_file, tmp_path):
    """Regression-path gradient accumulation (reference README.md:154):
    K accumulated micro-batches must produce the same update (params AND
    EMA) as one K-times-larger batch, given equal real-graph counts."""
    from equivariant_nn_zoo.data import Batch, GraphBatch

    tr_a = make_trainer(qm9_file, tmp_path / "wa", grad_acc=2)
    tr_b = make_trainer(qm9_file, tmp_path / "wb")
    tr_a.init_metrics()
    tr_b.init_metrics()
    # same seed -> identical initial params in both trainers
    chex = np.testing.assert_allclose

    ds = CondensedDataset(
        path=qm9_file,
        key_map={"Z": ("species", "atom_types"), "R": "pos",
                 "U0": "total_energy"},
        preprocess=[partial(computeEdgeIndex, r_max=4.0)],
    )
    items = [ds[i] for i in range(16)]
    micro1 = GraphBatch.from_batch(Batch.from_data_list(items[:8]), 256, 2048, 8)
    micro2 = GraphBatch.from_batch(Batch.from_data_list(items[8:]), 256, 2048, 8)
    combined = GraphBatch.from_batch(Batch.from_data_list(items), 512, 4096, 16)
    assert micro1.dropped == micro2.dropped == combined.dropped == 0

    tr_a.batch_step(micro1)
    tr_a.batch_step(micro2)
    tr_b.batch_step(combined)

    flat_a = jax.tree_util.tree_leaves(tr_a.params)
    flat_b = jax.tree_util.tree_leaves(tr_b.params)
    for a, b in zip(flat_a, flat_b):
        chex(np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6)
    for a, b in zip(jax.tree_util.tree_leaves(tr_a.ema["params"]),
                    jax.tree_util.tree_leaves(tr_b.ema["params"])):
        chex(np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6)
    # mid-accumulation: one more micro-batch must NOT move the params
    before = jax.tree_util.tree_leaves(tr_a.params)
    tr_a.batch_step(micro1)
    after = jax.tree_util.tree_leaves(tr_a.params)
    for a, b in zip(before, after):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_resume_restores_state(qm9_file, tmp_path):
    # simulate preemption: run one epoch of a longer schedule, save, resume
    tr = make_trainer(qm9_file, tmp_path / "wd1", max_epochs=10)
    tr.init_metrics()
    tr.epoch_step()
    tr.save()
    from equivariant_nn_zoo.utils.saveload import finish_all_writes

    finish_all_writes()
    epoch_before = tr.iepoch
    best_before = tr.best_metrics
    params_before = jax.device_get(tr.params)

    tr2 = Trainer.from_file(
        tr.trainer_save_path, model=tr.model
    )
    assert tr2.iepoch == epoch_before
    assert tr2.best_metrics == pytest.approx(best_before)
    params_after = jax.device_get(tr2.params)
    flat1 = jax.tree_util.tree_leaves(params_before)
    flat2 = jax.tree_util.tree_leaves(params_after)
    for a, b in zip(flat1, flat2):
        np.testing.assert_array_equal(a, b)
    # optimizer state restored
    lr1 = tr.current_lr
    assert tr2.current_lr == pytest.approx(lr1)


def test_refuse_resume_after_stop(qm9_file, tmp_path):
    tr = make_trainer(qm9_file, tmp_path / "wd2", max_epochs=1)
    tr.train()
    assert tr.stop_arg == "max epochs"
    tr.save()
    from equivariant_nn_zoo.utils.saveload import finish_all_writes

    finish_all_writes()
    with pytest.raises(RuntimeError, match="properly stopped"):
        Trainer.from_file(tr.trainer_save_path, model=tr.model)


def test_equivariance_test_harness(qm9_file, tmp_path):
    ds = CondensedDataset(
        path=qm9_file,
        key_map={"Z": ("species", "atom_types"), "R": "pos",
                 "U0": "total_energy"},
        preprocess=[partial(computeEdgeIndex, r_max=4.0)],
    )
    ds.equivarianceTest(4)
    assert len(ds) == 4
    assert "_rotation_matrix" in ds.data
    # all four samples are rotations of sample 0: same species
    s0 = ds.get(0)
    s1 = ds.get(1)
    np.testing.assert_array_equal(s0["species"], s1["species"])
    # positions are rotated copies: distance matrices match
    d0 = np.linalg.norm(s0["pos"][:, None] - s0["pos"][None], axis=-1)
    d1 = np.linalg.norm(s1["pos"][:, None] - s1["pos"][None], axis=-1)
    np.testing.assert_allclose(d0, d1, atol=1e-4)


def test_statistics(qm9_file):
    ds = CondensedDataset(
        path=qm9_file,
        key_map={"Z": ("species", "atom_types"), "R": "pos",
                 "U0": "total_energy"},
        type_names=[str(i) for i in range(10)],
    )
    (uniq, counts), = ds.statistics(["atom_types-count"])
    assert set(uniq.tolist()) <= {1, 6, 7, 8}
    (rms,), = ds.statistics(["pos-rms"])
    assert rms > 0
    mean, std = ds.statistics(["total_energy-mean_std"])[0]
    assert np.isfinite(mean).all()
    # per-species GP solve recovers the species energies approximately
    shifts, _ = ds.statistics(["total_energy-per-atom_types-mean_std"])[0]
    shifts = np.asarray(shifts).reshape(-1)
    assert abs(shifts[6] - (-1036.0)) < 60
    assert abs(shifts[1] - (-16.4)) < 60


def test_lr_injection_does_not_retrace(qm9_file, tmp_path):
    """Plateau LR changes are injected into optax hyperparams without
    changing the leaf aval — the train step must not recompile."""
    tr = make_trainer(qm9_file, tmp_path / "wd3", max_epochs=5)
    tr.init_metrics()
    tr.epoch_step()
    assert tr._train_step._cache_size() == 1
    tr._set_lr(tr.current_lr * 0.5)
    tr.epoch_step()
    assert tr._train_step._cache_size() == 1


def test_train_cli_dp_mesh(qm9_file, tmp_path):
    """train.py's regression driver builds a DP mesh and trains end-to-end
    on the virtual CPU mesh (reference: mp.spawn+DDP, train.py:280-304)."""
    from types import SimpleNamespace

    import train as train_cli
    from equivariant_nn_zoo.models import get_config as get_cfg
    from equivariant_nn_zoo.models.layer_configs import (
        addEnergyOutput, featureModel,
    )

    cfg = get_cfg("config_energy")
    cfg.batch_size = 8
    cfg.max_epochs = 1
    cfg.data_config.path = qm9_file
    cfg.data_config.n_train = 32
    cfg.data_config.n_val = 16
    cfg.data_config.key_map = {
        "Z": ("species", "atom_types"), "R": "pos", "U0": "total_energy",
    }
    mc = featureModel(
        n_dim=4, l_max=1, edge_spherical="1x0e+1x1o", node_attrs="4x0e",
        edge_radial="4x0e", num_types=10, num_layers=1, r_max=4.0,
    )
    cfg.model_config = addEnergyOutput(mc, shifts=[0.0] * 10)

    flags_ns = SimpleNamespace(
        wandb=False, workdir=str(tmp_path / "cli_wd"), seed=0,
        equivariance_test=False, profiling=False, log_period=1000,
        save_period=2000, resume_from=None, dp=4,
    )
    train_cli.train_regression(cfg, flags_ns)
    assert os.path.exists(os.path.join(flags_ns.workdir, "best.pt"))


def test_make_dp_mesh_guards(tmp_path):
    from types import SimpleNamespace

    import train as train_cli

    # batch not divisible by explicit dp -> error
    with pytest.raises(ValueError, match="not divisible"):
        train_cli._make_dp_mesh(7, SimpleNamespace(dp=4))
    # auto mode falls back to single device quietly
    assert train_cli._make_dp_mesh(7, SimpleNamespace(dp=0)) is None
    # dp=1 -> no mesh
    assert train_cli._make_dp_mesh(8, SimpleNamespace(dp=1)) is None
    mesh = train_cli._make_dp_mesh(8, SimpleNamespace(dp=4))
    assert mesh is not None and mesh.devices.size == 4


def test_equivariance_test_skips_mixed_size_batch(qm9_file, tmp_path, caplog):
    """Natural batches (varying node counts) must be skipped loudly, not
    silently reshaped (VERDICT r1 weak #7)."""
    import logging as _logging

    tr = make_trainer(qm9_file, tmp_path / "wd_eq")
    loader = tr.dl_train
    batch = next(iter(loader))
    g = int(np.asarray(batch["_graph_mask"]).sum())
    counts = np.bincount(
        np.asarray(batch["_node_segment"]).reshape(-1), minlength=g
    )[:g]
    assert len(set(counts.tolist())) > 1, "fixture should have mixed sizes"
    batch.data["_rotation_matrix"] = np.tile(
        np.eye(3, dtype=np.float32).reshape(1, 9), (batch["pos"].shape[0], 1)
    )
    out = {"pos": np.asarray(batch["pos"])}
    with caplog.at_level(_logging.INFO):
        tr.equivarianceTest(out, batch)
    assert any("skipped" in r.message for r in caplog.records)


def test_train_cli_diffusion_driver(tmp_path):
    """train.py's diffusion driver end-to-end: lazy loss accumulation,
    eval, checkpointing (reference train.py diffusion branch)."""
    from types import SimpleNamespace

    import train as train_cli
    from equivariant_nn_zoo.data import Batch
    from equivariant_nn_zoo.models import get_config as get_cfg

    rng = np.random.default_rng(7)
    prot = tmp_path / "pdb_0.hdf5"
    items = []
    for _ in range(8):
        n = int(rng.integers(24, 40))
        t = np.cumsum(rng.normal(size=(n, 3)) * 2.0, axis=0)
        item = {
            "species": rng.integers(0, 20, size=(n, 1)),
            "chain_id": (np.arange(n) // 24).reshape(-1, 1),
            "mask": np.ones((n, 1), np.int64),
            "_n_nodes": n,
            "CA": t.astype(np.float32),
        }
        items.append(item)
    attrs = {
        "species": ("node", "1x0e"), "chain_id": ("node", "1x0e"),
        "mask": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e"),
        "CA": ("node", "1x1o"),
    }
    Batch.from_data_list(items, attrs).dumpHDF5(str(prot))

    sde_cfg = tmp_path / "sde_tiny.py"
    sde_cfg.write_text(
        "from equivariant_nn_zoo.models.sde_config import get_config as g\n"
        "def get_config():\n"
        "    c = g()\n"
        "    c.training.n_iters = 4\n"
        "    c.training.snapshot_sampling = False\n"
        "    c.model.num_scales = 10\n"
        "    return c\n"
    )

    cfg = get_cfg("config_diffusion_CA")
    cfg.batch_size = 2
    cfg.data_config.path = [str(prot)]
    cfg.data_config.n_train = 0.7
    cfg.data_config.n_val = 0.3
    cfg.data_config.edge_capacity = 2048

    flags_ns = SimpleNamespace(
        sde_config=str(sde_cfg), workdir=str(tmp_path / "dwd"), seed=0,
        resume_from=None, wandb=False, log_period=2, eval_period=2,
        save_period=4,
    )
    train_cli.train_diffusion(cfg, flags_ns)
    assert os.path.exists(
        os.path.join(flags_ns.workdir, "checkpoints", "4.pth")
    )
