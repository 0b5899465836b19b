"""Unit + equivariance property tests for the irreps algebra core.

Mirrors the reference's built-in equivariance-testing strategy
(SURVEY.md §4): rotate the input => output must rotate by the Wigner matrix.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from equivariant_nn_zoo.ops import (
    Irrep,
    Irreps,
    Linear,
    TensorProduct,
    Gate,
    NormActivation,
    fully_connected_tp,
    irreps_d,
    rand_matrix,
    spherical_harmonics,
    tp_path_exists,
    wigner_3j,
    wigner_d,
    segment_sum,
)
from equivariant_nn_zoo.ops.wigner import so3_generators


RNG = np.random.default_rng(42)


def init_params(op, seed=0):
    p = {}
    key = jax.random.PRNGKey(seed)
    for name, (shape, init) in sorted(op.param_specs().items()):
        key, k = jax.random.split(key)
        p[name] = (
            jax.random.normal(k, shape) if init == "normal" else jnp.zeros(shape)
        )
    return p


def D(irreps, R):
    return jnp.asarray(irreps_d(Irreps(irreps), R), dtype=jnp.float32)


# ---------------------------------------------------------------- irreps ----


def test_irreps_parsing():
    ir = Irreps("64x0e+64x1o+64x2e")
    assert ir.dim == 64 * (1 + 3 + 5)
    assert ir.num_irreps == 192
    assert ir.lmax == 2
    assert str(ir) == "64x0e+64x1o+64x2e"
    assert Irrep("2e") in ir
    assert Irrep("1e") not in ir
    assert ir.count("1o") == 64
    assert (Irreps("1x0e") + Irreps("1x1o")).dim == 4


def test_irreps_sort_simplify():
    ir = Irreps("1x1o+2x0e+1x0e")
    s = ir.sort()
    assert str(s.irreps) == "2x0e+1x0e+1x1o"
    assert str(s.irreps.simplify()) == "3x0e+1x1o"
    assert len(s.p) == 3


def test_irrep_product_selection_rule():
    out = list(Irrep("1o") * Irrep("1o"))
    assert out == [Irrep("0e"), Irrep("1e"), Irrep("2e")]
    assert tp_path_exists("1x1o", "1x1o", "2e")
    assert not tp_path_exists("1x0e", "1x0e", "1o")


def test_spherical_harmonics_irreps():
    assert str(Irreps.spherical_harmonics(2)) == "1x0e+1x1o+1x2e"


# ---------------------------------------------------------------- wigner ----


def test_generators_commutation():
    for l in range(4):
        g = so3_generators(l)
        comm = g[0] @ g[1] - g[1] @ g[0]
        np.testing.assert_allclose(comm, g[2], atol=1e-8)


def test_wigner_d_representation():
    R1, R2 = rand_matrix(RNG), rand_matrix(RNG)
    for l in range(4):
        np.testing.assert_allclose(
            wigner_d(l, R1 @ R2), wigner_d(l, R1) @ wigner_d(l, R2), atol=1e-9
        )


def test_wigner_d_l1_is_rotation():
    R = rand_matrix(RNG)
    np.testing.assert_allclose(wigner_d(1, R), R, atol=1e-10)


def test_wigner_3j_invariance_and_symmetry():
    R = rand_matrix(RNG)
    for l1, l2, l3 in [(1, 1, 0), (1, 1, 2), (2, 2, 2), (3, 2, 1)]:
        C = wigner_3j(l1, l2, l3)
        C2 = np.einsum(
            "ijk,xi,yj,zk->xyz", C, wigner_d(l1, R), wigner_d(l2, R), wigner_d(l3, R)
        )
        np.testing.assert_allclose(C, C2, atol=1e-9)
        assert abs(np.linalg.norm(C) - 1) < 1e-9


def test_wigner_3j_triangle_violation_is_zero():
    assert np.abs(wigner_3j(0, 1, 3)).max() == 0


# -------------------------------------------------- spherical harmonics ----


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_sh_equivariance(l):
    R = rand_matrix(RNG)
    x = jnp.asarray(RNG.normal(size=(6, 3)), dtype=jnp.float32)
    y_rot = spherical_harmonics(l, x @ jnp.asarray(R.T, jnp.float32))
    y = spherical_harmonics(l, x) @ jnp.asarray(wigner_d(l, R).T, jnp.float32)
    np.testing.assert_allclose(y_rot, y, atol=1e-5)


def test_sh_component_normalization():
    x = jnp.asarray(RNG.normal(size=(4, 3)), dtype=jnp.float32)
    for l in range(4):
        y = spherical_harmonics(l, x, normalize=True, normalization="component")
        np.testing.assert_allclose(
            jnp.linalg.norm(y, axis=-1), np.sqrt(2 * l + 1), rtol=1e-5
        )


def test_sh_zero_vector_is_safe():
    y = spherical_harmonics([0, 1, 2], jnp.zeros((2, 3)))
    assert bool(jnp.all(jnp.isfinite(y)))
    np.testing.assert_allclose(y[:, 1:], 0.0)


def test_sh_l1_identity():
    x = jnp.asarray(RNG.normal(size=(5, 3)), dtype=jnp.float32)
    y = spherical_harmonics(1, x, normalize=False, normalization="component")
    np.testing.assert_allclose(y, np.sqrt(3) * x, rtol=1e-6)


# ----------------------------------------------------------------- ops -----


def test_linear_equivariance_and_bias():
    R = rand_matrix(RNG)
    ir_in, ir_out = Irreps("4x0e+3x1o+2x2e"), Irreps("5x0e+2x1o+1x3o")
    lin = Linear(ir_in, ir_out, biases=True)
    p = init_params(lin)
    p["b0"] = jnp.ones_like(p["b0"])  # nonzero scalar bias stays equivariant
    x = jnp.asarray(RNG.normal(size=(7, ir_in.dim)), jnp.float32)
    np.testing.assert_allclose(
        lin.apply(p, x @ D(ir_in, R).T),
        lin.apply(p, x) @ D(ir_out, R).T,
        atol=1e-5,
    )


def test_fctp_equivariance():
    R = rand_matrix(RNG)
    ir1, ir2, iro = Irreps("4x0e+4x1o"), Irreps("3x0e+3x1e"), Irreps("4x0e+4x1o+4x2e")
    tp = fully_connected_tp(ir1, ir2, iro)
    p = init_params(tp)
    x1 = jnp.asarray(RNG.normal(size=(9, ir1.dim)), jnp.float32)
    x2 = jnp.asarray(RNG.normal(size=(9, ir2.dim)), jnp.float32)
    np.testing.assert_allclose(
        tp.apply(p, x1 @ D(ir1, R).T, x2 @ D(ir2, R).T),
        tp.apply(p, x1, x2) @ D(iro, R).T,
        atol=1e-5,
    )


def test_uvu_tp_external_weights_equivariance():
    R = rand_matrix(RNG)
    ir1, ir2 = Irreps("8x0e+8x1o"), Irreps("1x0e+1x1o+1x2e")
    instructions, out = [], []
    for i, mi1 in enumerate(ir1):
        for j, mi2 in enumerate(ir2):
            for ir_o in mi1.ir * mi2.ir:
                out.append((mi1.mul, ir_o))
                instructions.append((i, j, len(out) - 1, "uvu", True))
    iro = Irreps(out)
    tp = TensorProduct(ir1, ir2, iro, instructions, shared_weights=False,
                       internal_weights=False)
    E = 11
    w = jnp.asarray(RNG.normal(size=(E, tp.weight_numel)), jnp.float32)
    x1 = jnp.asarray(RNG.normal(size=(E, ir1.dim)), jnp.float32)
    x2 = jnp.asarray(RNG.normal(size=(E, ir2.dim)), jnp.float32)
    np.testing.assert_allclose(
        tp.apply({}, x1 @ D(ir1, R).T, x2 @ D(ir2, R).T, w),
        tp.apply({}, x1, x2, w) @ D(iro, R).T,
        atol=1e-4,
    )


def test_tp_variance_near_unity():
    ir1, ir2 = Irreps("64x0e+64x1o"), Irreps("1x0e+1x1o+1x2e")
    instructions, out = [], []
    for i, mi1 in enumerate(ir1):
        for j, mi2 in enumerate(ir2):
            for ir_o in mi1.ir * mi2.ir:
                out.append((mi1.mul, ir_o))
                instructions.append((i, j, len(out) - 1, "uvu", True))
    tp = TensorProduct(ir1, ir2, Irreps(out), instructions, shared_weights=False,
                       internal_weights=False)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    x1 = jax.random.normal(k1, (4096, ir1.dim))
    x2 = jax.random.normal(k2, (4096, ir2.dim))
    w = jax.random.normal(k3, (4096, tp.weight_numel))
    v = float(jnp.var(tp.apply({}, x1, x2, w)))
    assert 0.5 < v < 2.0, v


def test_gate_equivariance():
    R = rand_matrix(RNG)
    g = Gate("4x0e", ["silu"], "3x0e", ["silu"], "2x1o+1x2e")
    x = jnp.asarray(RNG.normal(size=(10, g.irreps_in.dim)), jnp.float32)
    np.testing.assert_allclose(
        g(x @ D(g.irreps_in, R).T), g(x) @ D(g.irreps_out, R).T, atol=1e-5
    )


def test_norm_activation_equivariance():
    R = rand_matrix(RNG)
    na = NormActivation("3x1o+2x2e", "silu")
    x = jnp.asarray(RNG.normal(size=(10, na.irreps_in.dim)), jnp.float32)
    np.testing.assert_allclose(
        na(x @ D(na.irreps_in, R).T), na(x) @ D(na.irreps_in, R).T, atol=1e-5
    )


def test_segment_sum_static():
    x = jnp.arange(12.0).reshape(6, 2)
    seg = jnp.array([0, 0, 1, 1, 2, 2])
    out = segment_sum(x, seg, 4)
    assert out.shape == (4, 2)
    np.testing.assert_allclose(out[3], 0.0)


def test_linear_grouped_lowering_matches_loop():
    """The batched-by-degree Linear fast path is numerically identical to
    the per-path loop (and actually engages on the standard layouts)."""
    from equivariant_nn_zoo.ops.tensor_product import Linear

    rng = np.random.default_rng(0)
    cases = [
        ("64x0e+64x0o+64x1e+64x1o+64x2e", "64x0e+64x0o+64x1e+64x1o+64x2e",
         True),
        # different muls per degree + dropped/zero slots
        ("8x0e+8x0o+4x1o", "6x0e+6x0o+4x1o+2x2e", True),
    ]
    for ir_in, ir_out, biased in cases:
        lin = Linear(ir_in, ir_out, biases=biased)
        assert lin._lgroups is not None
        params = {
            k: jnp.asarray(rng.normal(size=shape).astype(np.float32))
            for k, (shape, _) in lin.param_specs().items()
        }
        x = jnp.asarray(
            rng.normal(size=(5, Linear(ir_in, ir_in).irreps_in.dim))
            .astype(np.float32)
        )
        fast = lin._apply_grouped(params, x)
        lin._lgroups = None
        slow = lin.apply(params, x)
        np.testing.assert_allclose(np.asarray(fast), np.asarray(slow),
                                   rtol=1e-6, atol=1e-6)

    # repeated irreps (Concat-style input) are not a slot bijection:
    # the plan must disable itself and the loop path take over
    lin = Linear("4x0e+4x0e", "4x0e")
    assert lin._lgroups is None


def test_norm_activation_run_merging_matches_per_slot():
    from equivariant_nn_zoo.ops.gate import NormActivation
    from equivariant_nn_zoo.ops.irreps import Irreps

    rng = np.random.default_rng(1)
    ir = Irreps("16x0e+16x0o+8x1e+8x1o+4x2e")
    na = NormActivation(ir, jax.nn.silu)
    assert len(na._runs) == 3  # 0e+0o, 1e+1o, 2e merged by degree
    x = jnp.asarray(rng.normal(size=(7, ir.dim)).astype(np.float32))
    got = na(x)
    # reference: slot-at-a-time
    outs = []
    ofs = 0
    for mi in ir:
        chunk = x[..., ofs: ofs + mi.dim].reshape(-1, mi.mul, mi.ir.dim)
        norm = jnp.sqrt(jnp.sum(chunk * chunk, -1, keepdims=True) + 1e-24)
        scale = na.act(norm) / norm
        outs.append((chunk * scale).reshape(-1, mi.dim))
        ofs += mi.dim
    want = jnp.concatenate(outs, -1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_gate_fused_lowering_matches_loop():
    """Gate's fused lowering (merged scalar runs + one-hot gate-expansion
    matmul) must match the per-slot reference loop exactly."""
    from equivariant_nn_zoo.ops.gate import Gate, activations

    rng = np.random.default_rng(3)
    g = Gate(
        "8x0e+8x0o", [activations["ssp"], activations["tanh"]],
        "12x0e", [activations["silu"]], "4x1o+4x1e+4x2e",
    )
    assert g._gates_fused and len(g._scalar_runs) == 2
    x = jnp.asarray(rng.normal(size=(7, g.irreps_in.dim)), jnp.float32)
    out = g(x)
    g._gates_fused = False  # force the reference loop
    ref = g(x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=0, atol=1e-6)
    g._gates_fused = True
    ga = jax.grad(lambda x_: jnp.sum(jnp.cos(g(x_))))(x)
    g._gates_fused = False
    gb = jax.grad(lambda x_: jnp.sum(jnp.cos(g(x_))))(x)
    np.testing.assert_allclose(np.asarray(ga), np.asarray(gb),
                               rtol=1e-5, atol=1e-5)
