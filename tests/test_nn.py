"""Layer-zoo and full-model tests: equivariance, padding independence,
force-head correctness."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from equivariant_nn_zoo.data import (
    Batch,
    Data,
    GraphBatch,
    computeEdgeIndex,
)
from equivariant_nn_zoo.models import get_config
from equivariant_nn_zoo.models.layer_configs import addForceOutput
from equivariant_nn_zoo.nn import (
    Broadcast,
    OneHotEncoding,
    PointwiseLinear,
    Pooling,
    RadialBasisEncoding,
    SphericalEncoding,
)
from equivariant_nn_zoo.ops import Irreps, irreps_d, rand_matrix
from equivariant_nn_zoo.utils import build


RNG = np.random.default_rng(7)


def make_mol(n, rng=RNG):
    pos = rng.normal(size=(n, 3)) * 1.2
    d = {
        "pos": pos,
        "species": rng.integers(1, 9, size=(n, 1)),
        "total_energy": rng.normal(size=(1, 1)),
        "forces": rng.normal(size=(n, 3)),
    }
    d["atom_types"] = d["species"]
    attrs = {
        "pos": ("node", "1x1o"),
        "species": ("node", "1x0e"),
        "atom_types": ("node", "1x0e"),
        "total_energy": ("graph", "1x0e"),
        "forces": ("node", "1x1o"),
    }
    out, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
    d.update(out)
    return Data(attrs, **d)


@pytest.fixture(scope="module")
def small_batch():
    mols = [make_mol(int(n)) for n in RNG.integers(5, 11, size=4)]
    batch = Batch.from_data_list(mols)
    return GraphBatch.from_batch(batch, node_capacity=64, edge_capacity=512,
                                 n_graphs=4)


@pytest.fixture(scope="module")
def energy_model():
    cfg = get_config("config_energy")
    cfg.model_config.num_layers = 2  # keep tests fast
    model = build(cfg.model_config)
    params = model.init(jax.random.PRNGKey(0))
    return model, params


def test_simple_layers_roundtrip(small_batch):
    gb = small_batch
    onehot = OneHotEncoding(num_types=10, irreps_out=("10x0e", "onehot"),
                            irreps_in=("1x0e", "species"))
    p = onehot.init(jax.random.PRNGKey(1))
    d, a = onehot.apply(p, onehot.inputKeyMap(dict(gb.data)),
                        onehot.inputKeyMap(dict(gb.attrs)))
    assert d["one_hot"].shape == (64, 10)

    lin = PointwiseLinear(("10x0e", "onehot"), ("8x0e", "feat"))
    p = lin.init(jax.random.PRNGKey(2))
    out, _ = lin.apply(p, {"input": d["one_hot"]}, {"input": ("node", "10x0e")})
    assert out["output"].shape == (64, 8)


def test_pooling_drops_padding_segment(small_batch):
    gb = small_batch
    pool = Pooling("1x0e", "1x0e", reduce="sum")
    x = jnp.asarray(np.ones((64, 1), np.float32))
    d = {"input": x * gb["_node_mask"], "_node_segment": gb["_node_segment"],
         "_graph_mask": gb["_graph_mask"]}
    out, attrs = pool.apply({}, d, {"input": ("node", "1x0e")})
    n_per_graph = np.asarray(gb["_n_nodes"])[:, 0]
    np.testing.assert_allclose(np.asarray(out["output"])[:, 0], n_per_graph)
    assert attrs["output"][0] == "graph"


def test_broadcast(small_batch):
    gb = small_batch
    bc = Broadcast("1x0e", "1x0e", to="node")
    g = jnp.arange(4.0).reshape(4, 1)
    out, _ = bc.apply({}, {"input": g, "_node_segment": gb["_node_segment"]},
                      {"input": ("graph", "1x0e")})
    seg = np.asarray(gb["_node_segment"])
    mask = np.asarray(gb["_node_mask"])[:, 0] > 0
    np.testing.assert_allclose(
        np.asarray(out["output"])[mask, 0], seg[mask].astype(np.float32)
    )


def test_radial_encoding_finite_on_padded_edges(small_batch):
    gb = small_batch
    enc = RadialBasisEncoding(r_max=4.0, trainable=True,
                              irreps_out=("8x0e", "edge_radial"),
                              irreps_in=("1x0e", "edge_length"))
    p = enc.init(jax.random.PRNGKey(0))
    length = jnp.full((512, 1), 1e-6)  # epsilon-clamped padded edges
    out, _ = enc.apply(p, {"input": length}, {"input": ("edge", "1x0e")})
    assert bool(jnp.all(jnp.isfinite(out["radial_embedding"])))


def test_full_model_energy_invariance(energy_model, small_batch):
    model, params = energy_model
    gb = small_batch
    fwd = jax.jit(lambda p, b: model.apply(p, b))
    out = fwd(params, gb)
    R = rand_matrix(RNG).astype(np.float32)
    out_rot = fwd(params, gb.replace(pos=gb["pos"] @ jnp.asarray(R.T)))
    e, e_rot = out["total_energy"], out_rot["total_energy"]
    scale = float(jnp.abs(e).max())
    assert float(jnp.abs(e - e_rot).max()) <= 1e-5 * max(scale, 1.0)


def test_full_model_feature_equivariance(energy_model, small_batch):
    model, params = energy_model
    gb = small_batch
    out = model.apply(params, gb)
    R = rand_matrix(RNG).astype(np.float32)
    out_rot = model.apply(params, gb.replace(pos=gb["pos"] @ jnp.asarray(R.T)))
    irreps = Irreps(out.attrs["node_features"][1])
    D = jnp.asarray(irreps_d(irreps, R), jnp.float32)
    lhs = out_rot["node_features"]
    rhs = out["node_features"] @ D.T
    denom = max(float(jnp.abs(rhs).max()), 1e-6)
    assert float(jnp.abs(lhs - rhs).max()) / denom < 1e-4


def test_padding_independence(energy_model, small_batch):
    model, params = energy_model
    gb = small_batch
    out = model.apply(params, gb)
    pos2 = np.asarray(gb["pos"]).copy()
    n_real = int(np.asarray(gb["_node_mask"]).sum())
    pos2[n_real:] += 50.0
    out2 = model.apply(params, gb.replace(pos=jnp.asarray(pos2)))
    np.testing.assert_allclose(
        np.asarray(out["total_energy"]), np.asarray(out2["total_energy"])
    )


def test_capacity_independence(energy_model):
    """The same graphs padded to different capacities give the same energy."""
    model, params = energy_model
    mols = [make_mol(6), make_mol(9)]
    batch = Batch.from_data_list(mols)
    gb1 = GraphBatch.from_batch(batch, 32, 256, 2)
    batch2 = Batch.from_data_list(mols)
    gb2 = GraphBatch.from_batch(batch2, 64, 512, 2)
    e1 = model.apply(params, gb1)["total_energy"]
    e2 = model.apply(params, gb2)["total_energy"]
    np.testing.assert_allclose(np.asarray(e1), np.asarray(e2), rtol=1e-5)


def test_force_head(small_batch):
    """GradientOutput: forces = -dE/dpos, equivariant, and padded slots 0."""
    cfg = get_config("config_energy")
    cfg.model_config.num_layers = 1
    force_cfg = addForceOutput(cfg.model_config)
    model = build(force_cfg)
    params = model.init(jax.random.PRNGKey(0))
    gb = small_batch
    out = model.apply(params, gb)
    assert "forces" in out.data
    f = out["forces"]
    assert f.shape == (64, 3)
    # equivariance: F(Rx) = R F(x)
    R = rand_matrix(RNG).astype(np.float32)
    out_rot = model.apply(params, gb.replace(pos=gb["pos"] @ jnp.asarray(R.T)))
    lhs = out_rot["forces"]
    rhs = f @ jnp.asarray(R.T)
    denom = max(float(jnp.abs(f).max()), 1e-9)
    assert float(jnp.abs(lhs - rhs).max()) / denom < 1e-3
    # finite-difference check on one coordinate
    eps = 1e-3
    pos = np.asarray(gb["pos"]).copy()
    pos_p, pos_m = pos.copy(), pos.copy()
    pos_p[0, 0] += eps
    pos_m[0, 0] -= eps
    ep = model.apply(params, gb.replace(pos=jnp.asarray(pos_p)))["total_energy"]
    em = model.apply(params, gb.replace(pos=jnp.asarray(pos_m)))["total_energy"]
    fd = -(float(ep.sum()) - float(em.sum())) / (2 * eps)
    assert abs(fd - float(f[0, 0])) < 5e-2 * max(abs(fd), 1.0)


def test_batch_roundtrip():
    mols = [make_mol(5), make_mol(8)]
    batch = Batch.from_data_list(mols)
    assert len(batch) == 2
    d0 = batch.get(0)
    np.testing.assert_allclose(d0["pos"], mols[0]["pos"].astype(np.float32),
                               rtol=1e-6)
    sub = batch.index_select([1])
    assert len(sub) == 1
    np.testing.assert_allclose(sub["pos"], mols[1]["pos"].astype(np.float32),
                               rtol=1e-6)
    gb = GraphBatch.from_batch(batch, 32, 256, 2)
    back = gb.to_batch()
    assert len(back) == 2
    np.testing.assert_allclose(back.get(1)["pos"], sub.get(0)["pos"], rtol=1e-6)
    # edge_index rebased identically
    np.testing.assert_array_equal(back.get(1)["edge_index"],
                                  sub.get(0)["edge_index"])


def test_force_training_double_grad(small_batch):
    """Training on forces differentiates through jax.grad (double backprop)
    — must work through the fused conv path and stay finite."""
    import optax

    cfg = get_config("config_energy")
    cfg.model_config.num_layers = 1
    force_cfg = addForceOutput(cfg.model_config)
    model = build(force_cfg)
    params = model.init(jax.random.PRNGKey(0))
    gb = small_batch
    target_f = jnp.zeros((64, 3))
    target_e = jnp.zeros((4, 1))

    def loss_fn(p):
        out = model.apply(p, gb)
        mask = gb["_node_mask"]
        lf = jnp.sum(((out["forces"] - target_f) ** 2) * mask)
        le = jnp.sum((out["total_energy"] - target_e) ** 2 * gb["_graph_mask"])
        return lf + 1e-6 * le

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    assert np.isfinite(float(loss))
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(bool(jnp.all(jnp.isfinite(g))) for g in leaves)
    # at least some force-gradient signal reaches the conv weights
    total = sum(float(jnp.abs(g).sum()) for g in leaves)
    assert total > 0


def test_tpe_mid_fused_expand_matches_tp_then_linear():
    """Internal-weight uvu expansions skip the materialized mid tensor:
    the fused per-path mix must equal tp-then-linear in values and grads."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from equivariant_nn_zoo.nn.pointwise import TensorProductExpansion

    ir = "8x0e+8x0o+8x1e+8x1o+8x2e"
    tpe = TensorProductExpansion(ir, ir, ir, "uvu")
    assert tpe._fuse_plan is not None
    params = tpe.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    dim = tpe.tp.irreps_in1.dim
    L = jnp.asarray(rng.normal(size=(5, dim)).astype(np.float32))
    R = jnp.asarray(rng.normal(size=(5, dim)).astype(np.float32))

    def slow(p):
        mid = tpe.tp.apply(p["tp"], L, R)
        return tpe.linear.apply(p["linear"], mid)

    np.testing.assert_allclose(
        np.asarray(tpe._expand_fused(params, L, R)), np.asarray(slow(params)),
        rtol=2e-5, atol=2e-5,
    )
    g1 = jax.grad(lambda p: jnp.sum(jnp.sin(tpe._expand_fused(p, L, R))))(
        params
    )
    g2 = jax.grad(lambda p: jnp.sum(jnp.sin(slow(p))))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)

    # external-weight expansions (the conv path) must NOT take the plan
    conv_like = TensorProductExpansion(
        "8x0e+8x1o", "1x0e+1x1o", "8x0e+8x1o", "uvu", internal_weight=False
    )
    assert conv_like._fuse_plan is None
