"""Unit tests for losses, metrics, early stopping, LR schedulers, scalers,
saveload, and the config registry."""

import numpy as np
import jax.numpy as jnp
import pytest

from equivariant_nn_zoo.data import Batch
from equivariant_nn_zoo.models import CONFIG_REGISTRY, get_config
from equivariant_nn_zoo.run import (
    EarlyStopping,
    Loss,
    LossStat,
    Metrics,
    PerAtomLoss,
    ReduceLROnPlateau,
    SimpleLoss,
    find_loss_function,
)
from equivariant_nn_zoo.utils import build, getScaler, insertAfter, replace
from equivariant_nn_zoo.utils.saveload import (
    load_file,
    save_file,
    saveMol,
    saveProtein,
)
from equivariant_nn_zoo.utils.statistics import bincount, solver


def test_all_configs_build():
    for name in CONFIG_REGISTRY:
        cfg = get_config(name)
        model = build(cfg.model_config)
        layers = getattr(model, "layers", None) or model.func.layers
        assert len(layers) > 3, name


def test_simple_loss_masked():
    pred = {"y": jnp.asarray([[1.0], [2.0], [5.0]])}
    ref = {
        "y": jnp.asarray([[1.0], [4.0], [99.0]]),
        "_graph_mask": jnp.asarray([[1.0], [1.0], [0.0]]),
    }
    loss = SimpleLoss("MSELoss")(pred, ref, "y")
    assert float(loss) == pytest.approx(2.0)  # (0 + 4)/2, padded row ignored
    l1 = SimpleLoss("L1Loss")(pred, ref, "y")
    assert float(l1) == pytest.approx(1.0)


def test_ignore_nan():
    pred = {"y": jnp.asarray([[1.0], [2.0]])}
    ref = {"y": jnp.asarray([[jnp.nan], [4.0]])}
    loss = SimpleLoss("MSELoss", {"ignore_nan": True})(pred, ref, "y")
    assert float(loss) == pytest.approx(4.0)


def test_per_atom_loss():
    pred = {"y": jnp.asarray([[2.0], [4.0]])}
    ref = {
        "y": jnp.asarray([[0.0], [0.0]]),
        "_n_nodes": jnp.asarray([[2], [4]]),
        "_graph_mask": jnp.asarray([[1.0], [1.0]]),
    }
    # MSE: err^2 / N^2 -> (4/4 + 16/16)/2 = 1
    loss = PerAtomLoss("MSELoss")(pred, ref, "y")
    assert float(loss) == pytest.approx(1.0)


def test_loss_coeff_grammar():
    loss = Loss({
        "a": 1.0,
        "b": [2.0, "L1Loss"],
        "c": [3.0, "MSELoss", {"ignore_nan": True}],
        "d": "L1Loss",
    })
    assert loss.coeffs["b"] == 2.0
    assert loss.funcs["c"].ignore_nan
    pred = {k: jnp.ones((2, 1)) for k in "abcd"}
    ref = {k: jnp.zeros((2, 1)) for k in "abcd"}
    total, contrib = loss(pred, ref)
    assert float(total) == pytest.approx(1 + 2 + 3 + 1)
    assert set(contrib) == set("abcd")


def test_find_loss_prefix_dispatch():
    assert type(find_loss_function("PerAtomMSELoss", {})).__name__ == "PerAtomLoss"
    assert type(find_loss_function("PerSpeciesL1Loss", {})).__name__ == (
        "PerSpeciesLoss"
    )


def test_loss_stat():
    stat = LossStat()
    stat(jnp.asarray(2.0), {"a": jnp.asarray(1.0)})
    stat(jnp.asarray(4.0), {"a": jnp.asarray(3.0)})
    res = stat.current_result()
    assert res["loss"] == pytest.approx(3.0)
    assert res["loss_a"] == pytest.approx(2.0)


def test_metrics_accumulation():
    m = Metrics({"y": ["mae", "rmse"]})
    pred = {"y": jnp.asarray([[1.0], [3.0]])}
    ref = {"y": jnp.asarray([[0.0], [0.0]])}
    m(pred, ref)
    flat, _ = m.flatten_metrics(m.current_result())
    assert flat["y_mae"] == pytest.approx(2.0)
    assert flat["y_rmse"] == pytest.approx(np.sqrt(5.0))


def test_early_stopping_patience():
    es = EarlyStopping(patiences={"loss": 2})
    assert es({"loss": 1.0})[0] is False
    assert es({"loss": 1.1})[0] is False
    stop, args, _ = es({"loss": 1.2})
    assert stop
    sd = es.state_dict()
    es2 = EarlyStopping(patiences={"loss": 2})
    es2.load_state_dict(sd)
    assert es2.counters == es.counters


def test_early_stopping_bounds():
    es = EarlyStopping(lower_bounds={"LR": 1e-6})
    assert es({"LR": 1e-5})[0] is False
    assert es({"LR": 1e-7})[0] is True


def test_reduce_lr_on_plateau():
    s = ReduceLROnPlateau(lr=1.0, factor=0.5, patience=1)
    assert s.step(1.0) == 1.0
    assert s.step(1.0) == 1.0  # bad 1
    assert s.step(1.0) == 0.5  # bad 2 > patience -> decay
    sd = s.state_dict()
    s2 = ReduceLROnPlateau(lr=1.0)
    s2.load_state_dict(sd)
    assert s2.lr == 0.5


def test_get_scaler_roundtrip():
    attrs = {"CA": ("node", "1x1o"), "_n_nodes": ("graph", "1x0e")}
    batch = Batch(attrs, CA=np.arange(12.0).reshape(4, 3),
                  _n_nodes=np.array([[2], [2]]))
    scaler = getScaler([("CA", ("shift", "mean")), ("CA", ("scale", 0.5))])
    inverse = getScaler([("CA", ("scale", 2.0))])
    out = inverse(scaler(batch))
    # mean-centered per graph
    np.testing.assert_allclose(out["CA"][:2].mean(axis=0), 0.0, atol=1e-6)


def test_config_surgery():
    layers = [("a", 1), ("b", 2)]
    assert insertAfter(layers, "a", ("x", 9))[1] == ("x", 9)
    assert replace(layers, "b", ("y", 8))[1] == ("y", 8)
    with pytest.raises(ValueError):
        insertAfter(layers, "zz", ("x", 9))


def test_save_load_roundtrip(tmp_path):
    item = {"a": np.arange(3), "b": {"c": 1.5}}
    p = save_file(item, str(tmp_path / "x.pkl"), enforced_format="pickle")
    from equivariant_nn_zoo.utils.saveload import finish_all_writes

    finish_all_writes()
    back = load_file(p)
    np.testing.assert_array_equal(back["a"], item["a"])
    assert back["b"]["c"] == 1.5
    p2 = save_file({"k": [1, 2]}, str(tmp_path / "y.yaml"))
    finish_all_writes()
    assert load_file(p2)["k"] == [1, 2]


def test_molecule_writers(tmp_path):
    attrs = {
        "pos": ("node", "1x1o"), "species": ("node", "1x0e"),
        "_n_nodes": ("graph", "1x0e"),
    }
    batch = Batch(attrs, pos=np.random.randn(3, 3),
                  species=np.array([[8], [1], [1]]),
                  _n_nodes=np.array([[3]]))
    f = saveMol(batch, workdir=str(tmp_path), filename="mol")
    assert f.endswith(".gro")
    lines = open(f).read().splitlines()
    assert lines[1] == "3"

    attrs = {
        "CA": ("node", "1x1o"), "species": ("node", "1x0e"),
        "chain_id": ("node", "1x0e"), "_n_nodes": ("graph", "1x0e"),
    }
    batch = Batch(attrs, CA=np.random.randn(4, 3),
                  species=np.array([[0], [1], [2], [3]]),
                  chain_id=np.zeros((4, 1), np.int64),
                  _n_nodes=np.array([[4]]))
    f = saveProtein(batch, str(tmp_path), filename="prot")
    content = open(f).read()
    assert "ATOM" in content and content.strip().endswith("END")


def test_gp_solver_recovers_linear_model():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 5, size=(200, 4)).astype(np.float64)
    true = np.array([[-10.0], [5.0], [2.0], [-3.0]])
    y = X @ true + rng.normal(scale=0.01, size=(200, 1))
    mean, std = solver(X, y)
    np.testing.assert_allclose(mean, true, atol=0.5)


def test_bincount_per_graph():
    types = np.array([0, 1, 1, 2, 0])
    batch = np.array([0, 0, 1, 1, 1])
    out = bincount(types, batch, minlength=3)
    np.testing.assert_array_equal(out, [[1, 1, 0], [1, 1, 1]])


def test_device_scaler_matches_host():
    from equivariant_nn_zoo.data import Batch, Data, GraphBatch

    rng = np.random.default_rng(0)
    mols = []
    for _ in range(3):
        n = int(rng.integers(3, 6))
        mols.append(Data(
            {"CA": ("node", "1x1o"), "C": ("node", "1x1o"),
             "y": ("graph", "1x0e")},
            CA=rng.normal(size=(n, 3)), C=rng.normal(size=(n, 3)),
            y=rng.normal(size=(1, 1)),
        ))
    host = Batch.from_data_list(mols)
    gb = GraphBatch.from_batch(Batch.from_data_list([m.clone() for m in mols]),
                               24, 32, 3)
    ops = [("C", ("shift", "CA", -1)), ("CA", ("shift", "mean")),
           (["CA", "C"], ("scale", 0.25))]
    scaler = getScaler(ops)
    out_host = scaler(host)
    out_dev = scaler(gb).to_batch()
    np.testing.assert_allclose(np.asarray(out_dev["CA"]),
                               np.asarray(out_host["CA"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_dev["C"]),
                               np.asarray(out_host["C"]), rtol=1e-5,
                               atol=1e-6)
