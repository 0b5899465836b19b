"""Fused conv path vs the reference per-path einsum implementation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from equivariant_nn_zoo.nn.message_passing import FactorizedConvolution


KW = dict(
    input_features="8x0e+8x0o+8x1e+8x1o+8x2e+8x2o",
    output_features="8x0e+8x0o+8x1e+8x1o+8x2e+8x2o",
    node_attrs="4x0e",
    edge_radial="8x0e",
    edge_spherical="1x0e+1x1o+1x2e",
    invariant_layers=2,
    invariant_neurons=8,
    avg_num_neighbors=5.0,
    use_sc=True,
)


def make_data(conv, N=32, E=128, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "input_features": jnp.asarray(
            rng.normal(size=(N, conv.tp.tp.irreps_in1.dim)), jnp.float32
        ),
        "node_attrs": jnp.asarray(rng.normal(size=(N, 4)), jnp.float32),
        "edge_radial": jnp.asarray(rng.normal(size=(E, 8)), jnp.float32),
        "edge_spherical": jnp.asarray(rng.normal(size=(E, 9)), jnp.float32),
        "edge_index": jnp.asarray(rng.integers(0, N, size=(2, E)), jnp.int32),
        "_edge_mask": jnp.asarray(
            (rng.random((E, 1)) < 0.8).astype(np.float32)
        ),
    }


def test_fused_matches_unfused():
    conv_f = FactorizedConvolution(**KW, fused=True, compute_dtype="float32")
    conv_u = FactorizedConvolution(**KW, fused=False)
    params = conv_f.init(jax.random.PRNGKey(0))
    data = make_data(conv_f)
    attrs = {"input_features": ("node", KW["input_features"])}
    o1, _ = conv_f.apply(params, data, attrs)
    o2, _ = conv_u.apply(params, data, attrs)
    a, b = o1["output_features"], o2["output_features"]
    rel = float(jnp.abs(a - b).max() / jnp.abs(b).max())
    assert rel < 1e-5, rel


def test_fused_bf16_close():
    conv_f = FactorizedConvolution(**KW, fused=True, compute_dtype="bfloat16")
    conv_u = FactorizedConvolution(**KW, fused=False)
    params = conv_f.init(jax.random.PRNGKey(0))
    data = make_data(conv_f)
    attrs = {"input_features": ("node", KW["input_features"])}
    o1, _ = conv_f.apply(params, data, attrs)
    o2, _ = conv_u.apply(params, data, attrs)
    a, b = o1["output_features"], o2["output_features"]
    rel = float(jnp.abs(a - b).max() / jnp.abs(b).max())
    assert rel < 0.05, rel


def test_fused_gradients_match():
    conv_f = FactorizedConvolution(**KW, fused=True, compute_dtype="float32")
    conv_u = FactorizedConvolution(**KW, fused=False)
    params = conv_f.init(jax.random.PRNGKey(0))
    data = make_data(conv_f)
    attrs = {"input_features": ("node", KW["input_features"])}

    def loss(conv, p):
        out, _ = conv.apply(p, data, attrs)
        return jnp.sum(out["output_features"] ** 2)

    g1 = jax.grad(lambda p: loss(conv_f, p))(params)
    g2 = jax.grad(lambda p: loss(conv_u, p))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        denom = max(float(jnp.abs(b).max()), 1e-6)
        assert float(jnp.abs(a - b).max()) / denom < 1e-4


def test_fused_reduce_false_matches_unfused():
    """The Pairwise head's per-edge conv (reduce=False) now rides the fused
    path; it must match the per-path einsum path on the edge output."""
    kw = dict(KW, use_sc=False, node_attrs=None, avg_num_neighbors=1,
              reduce=False)
    conv_f = FactorizedConvolution(**kw, fused=True, compute_dtype="float32")
    conv_u = FactorizedConvolution(**kw, fused=False)
    assert conv_f.fused_conv is not None
    params = conv_f.init(jax.random.PRNGKey(0))
    data = make_data(conv_f)
    data.pop("node_attrs")
    attrs = {"input_features": ("node", kw["input_features"])}
    out_f, af = conv_f.apply(params, dict(data), dict(attrs))
    out_u, au = conv_u.apply(params, dict(data), dict(attrs))
    assert out_f["output_features"].shape[0] == data["edge_radial"].shape[0]
    assert af == au
    np.testing.assert_allclose(
        np.asarray(out_f["output_features"]),
        np.asarray(out_u["output_features"]),
        rtol=2e-4, atol=2e-4,
    )


def test_m_cache_keys_by_structure_and_survives_concurrent_traces():
    """_M_CACHE (ops/fused_tp.py) memoizes M = sh @ C per (sh object,
    structure key).  Two different conv structures sharing ONE sh tracer
    inside a jit must each get their own operator (no cross-structure
    aliasing), including when the traces run on concurrent threads."""
    import threading

    from equivariant_nn_zoo.nn.message_passing import FactorizedConvolution
    from equivariant_nn_zoo.ops.fused_tp import FusedUVUConv

    def make_conv(out_spec):
        kw = dict(KW)
        kw["output_features"] = out_spec
        conv = FactorizedConvolution(**kw, fused=True, compute_dtype="float32")
        params = conv.init(jax.random.PRNGKey(0))
        return FusedUVUConv(conv.tp, compute_dtype=jnp.float32), params

    fused_a, pa = make_conv("8x0e+8x1o+8x2e")
    fused_b, pb = make_conv("8x0e+8x0o+8x1e+8x1o")
    rng = np.random.default_rng(7)
    N, E = 16, 64
    x_a = jnp.asarray(rng.normal(size=(N, fused_a.irreps_in.dim)), jnp.float32)
    sh = jnp.asarray(rng.normal(size=(E, 9)), jnp.float32)
    w_a = jnp.asarray(rng.normal(size=(E, fused_a.weight_numel)), jnp.float32)
    w_b = jnp.asarray(rng.normal(size=(E, fused_b.weight_numel)), jnp.float32)
    src = jnp.asarray(rng.integers(0, N, size=(E,)), jnp.int32)
    dst = jnp.asarray(rng.integers(0, N, size=(E,)), jnp.int32)

    def both(sh_):
        # one sh tracer feeds two structures -> two distinct cache entries
        oa = fused_a(pa["tp"]["linear"], x_a, src, dst, sh_, w_a, N)
        ob = fused_b(pb["tp"]["linear"], x_a, src, dst, sh_, w_b, N)
        return oa, ob

    ref_a, ref_b = both(sh)                      # eager (array-keyed cache)
    jit_a, jit_b = jax.jit(both)(sh)             # traced (tracer-keyed)
    np.testing.assert_allclose(np.asarray(jit_a), np.asarray(ref_a),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jit_b), np.asarray(ref_b),
                               rtol=1e-5, atol=1e-5)

    # concurrent traces: each thread jits its own composite; results must
    # stay structure-correct (no cache cross-talk between live traces)
    results, errs = {}, []

    def run(tag, fused, p, w):
        try:
            f = jax.jit(lambda s: fused(p["tp"]["linear"], x_a, src, dst,
                                        s, w, N))
            for _ in range(3):
                results[tag] = np.asarray(f(sh))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [
        threading.Thread(target=run, args=("a", fused_a, pa, w_a)),
        threading.Thread(target=run, args=("b", fused_b, pb, w_b)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    np.testing.assert_allclose(results["a"], np.asarray(ref_a),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(results["b"], np.asarray(ref_b),
                               rtol=1e-5, atol=1e-5)
