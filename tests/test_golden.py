"""Golden-value regression tests for the equivariant op conventions.

The reference's de-facto integration test is accuracy parity against its
published MAEs (SURVEY.md §6); reaching those requires the real datasets,
but the *numerical conventions* of the op stack (CG normalization, basis
order, path weights, initialization scaling) can be frozen offline.  These
tests pin them two ways:

1. closed-form checks — real spherical harmonics and l=1 Wigner-3j values
   have textbook forms, verified here independently of our own derivation
   (``ops/wigner.py``'s null-space CG + largest-entry-positive sign rule);
2. stored goldens — fixed-seed outputs of Linear / uvu-TP / FCTP / SH
   recorded in ``tests/golden/ops_golden.npz``.  Any convention drift
   (basis order, normalization, sign) breaks saved checkpoints, so a
   failure here means "you changed the math, not just the code".

Note on e3nn: this rebuild does NOT share e3nn's basis conventions (our
l=1 basis is (x, y, z); e3nn's is (y, z, x)) and e3nn is deliberately not
a dependency, so parity with the reference is at the *capability* level
(same MAEs when trained), not bitwise weight compatibility.

Regenerate the goldens (only after an INTENTIONAL convention change) with:
    python tests/test_golden.py --regen
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from equivariant_nn_zoo.ops.irreps import Irreps
from equivariant_nn_zoo.ops.spherical_harmonics import spherical_harmonics
from equivariant_nn_zoo.ops.tensor_product import (
    Linear,
    fully_connected_tp,
)
from equivariant_nn_zoo.ops.wigner import wigner_3j

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ops_golden.npz")


# ------------------------------------------------------- closed-form checks

def test_sh_l1_closed_form():
    """Our l=1 spherical harmonics are sqrt(3) * (x, y, z) / |v| in
    component normalization, in (x, y, z) order (CLAUDE.md convention)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(16, 3))
    out = np.asarray(spherical_harmonics(1, jnp.asarray(v), normalize=True))
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_allclose(out, np.sqrt(3.0) * unit, atol=1e-5)
    out0 = np.asarray(spherical_harmonics(0, jnp.asarray(v)))
    np.testing.assert_allclose(out0, 1.0, atol=1e-6)


def test_sh_l2_closed_form():
    """l=2 components span the traceless quadratic monomials; check the
    full l=2 block against the analytic real quadrupole basis built from
    outer products (basis-order agnostic: compare Gram matrices and the
    subspace projection, then pin our exact component order via the
    stored golden below)."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(64, 3))
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    y2 = np.asarray(spherical_harmonics(2, jnp.asarray(v), normalize=True))
    # analytic traceless symmetric quadratics
    x, y, z = unit[:, 0], unit[:, 1], unit[:, 2]
    quad = np.stack(
        [x * y, y * z, 2 * z * z - x * x - y * y, x * z, x * x - y * y],
        axis=1,
    )
    # y2 must lie in the span of quad: residual of least squares ~ 0
    coef, res, *_ = np.linalg.lstsq(quad, y2, rcond=None)
    pred = quad @ coef
    assert np.abs(pred - y2).max() < 1e-5
    # component normalization: sum_m Y_lm^2 = 2l+1
    np.testing.assert_allclose((y2 ** 2).sum(1), 5.0, atol=1e-4)


def test_wigner_3j_l1_l1_closed_form():
    """1 x 1 -> 0 and 1 x 1 -> 1 couplings have closed forms in ANY real
    orthonormal l=1 basis: the invariant is delta_ij/sqrt(3), the l=1
    output is the Levi-Civita tensor (up to overall sign) / sqrt(6)."""
    w0 = np.asarray(wigner_3j(1, 1, 0))[:, :, 0]      # [3, 3]
    np.testing.assert_allclose(w0, np.eye(3) / np.sqrt(3.0), atol=1e-6)
    w1 = np.asarray(wigner_3j(1, 1, 1))               # [3, 3, 3]
    eps = np.zeros((3, 3, 3))
    for i, j, k in [(0, 1, 2), (1, 2, 0), (2, 0, 1)]:
        eps[i, j, k] = 1.0
        eps[j, i, k] = -1.0
    ratio = w1 / np.where(eps == 0, 1.0, eps)
    vals = ratio[eps != 0]
    np.testing.assert_allclose(np.abs(vals), 1 / np.sqrt(6.0), atol=1e-6)
    assert np.allclose(vals, vals[0]), "not proportional to Levi-Civita"
    np.testing.assert_allclose(w1[eps == 0], 0.0, atol=1e-6)


def test_wigner_3j_orthogonality():
    """sum_{m1,m2} C^{l3,m3}_{m1,m2} C^{l3',m3'}_{m1,m2} =
    delta_{l3 l3'} delta_{m3 m3'} / (2l3+1) in the normalized convention."""
    for l1, l2 in [(1, 1), (1, 2), (2, 2)]:
        for l3 in range(abs(l1 - l2), l1 + l2 + 1):
            w = np.asarray(wigner_3j(l1, l2, l3))
            g = np.einsum("abm,abn->mn", w, w)
            np.testing.assert_allclose(
                g, np.eye(2 * l3 + 1) * g[0, 0], atol=1e-6
            )


# ----------------------------------------------------------- stored goldens

def _compute_goldens():
    key = jax.random.PRNGKey(1234)
    rng = np.random.default_rng(1234)
    out = {}

    v = rng.normal(size=(4, 3)).astype(np.float32)
    out["sh_in"] = v
    out["sh_l3"] = np.asarray(
        spherical_harmonics([0, 1, 2, 3], jnp.asarray(v), normalize=True)
    )

    irreps = Irreps("2x0e+2x1o+1x2e")
    lin = Linear(irreps, irreps)
    lp = {}
    for name, (shape, init) in sorted(lin.param_specs().items()):
        key, k = jax.random.split(key)
        lp[name] = (jax.random.normal(k, shape) if init == "normal"
                    else jnp.zeros(shape))
    x = rng.normal(size=(3, irreps.dim)).astype(np.float32)
    out["lin_in"] = x
    out["lin_w"] = np.concatenate(
        [np.asarray(v).ravel() for v in jax.tree_util.tree_leaves(lp)]
    )
    out["lin_out"] = np.asarray(lin.apply(lp, jnp.asarray(x)))

    fctp = fully_connected_tp(Irreps("2x0e+1x1o"), Irreps("2x0e"),
                              Irreps("2x0e+1x1o"))
    n_w = sum(int(np.prod(fctp._weight_shape(i))) for i in fctp.instructions)
    w = rng.normal(size=(n_w,)).astype(np.float32)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(3, 2)).astype(np.float32)
    out["fctp_w"], out["fctp_a"], out["fctp_b"] = w, a, b
    out["fctp_out"] = np.asarray(
        fctp.apply({"weight": jnp.asarray(w)}, jnp.asarray(a),
                   jnp.asarray(b))
    )

    for l1, l2, l3 in [(1, 2, 1), (2, 2, 2), (1, 1, 2), (3, 2, 1)]:
        out[f"w3j_{l1}{l2}{l3}"] = np.asarray(wigner_3j(l1, l2, l3))
    return out


def test_stored_goldens():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden file missing; run tests/test_golden.py --regen")
    stored = dict(np.load(GOLDEN))
    fresh = _compute_goldens()
    assert set(stored) == set(fresh), (
        set(stored) ^ set(fresh)
    )
    for k in stored:
        np.testing.assert_allclose(
            stored[k], fresh[k], atol=2e-5, rtol=2e-5,
            err_msg=f"golden drift in {k}: op conventions changed — this "
            "breaks saved checkpoints",
        )


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez(GOLDEN, **_compute_goldens())
        print(f"wrote {GOLDEN}")
