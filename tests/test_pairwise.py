"""The Hamiltonian head's pairwise expansion on its XLA path (the batched
per-group lowering ``TensorProductExpansion._expand_fused``) against the
per-path einsum reference (``tp.apply`` then the mix linear)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from equivariant_nn_zoo.nn.output import Pairwise
from equivariant_nn_zoo.nn.pointwise import TensorProductExpansion

HEAD_IRREPS = [
    # the config_hamiltonian node features (l_max 4), at a small width
    "4x0e+4x0o+4x1e+4x1o+4x2e+4x2o+4x3e+4x3o+4x4e+4x4o",
    "3x0e+3x1o+3x2e",
    "2x0e+2x0o+2x1e+2x1o",
]
# gradients compile far longer; l_max 3 stands in for the l_max 4 head
GRAD_IRREPS = ["2x0e+2x0o+2x1e+2x1o+2x2e+2x2o+2x3e+2x3o"] + HEAD_IRREPS[1:]


def _per_path(tpe, params, left, right):
    mid = tpe.tp.apply(params["tp"], left, right)
    return tpe.linear.apply(params["linear"], mid)


def _inputs(tpe, n, seed=0):
    rng = np.random.default_rng(seed)
    dim = tpe.tp.irreps_in1.dim
    left = jnp.asarray(rng.normal(size=(n, dim)), jnp.float32)
    right = jnp.asarray(rng.normal(size=(n, dim)), jnp.float32)
    return left, right


@pytest.mark.parametrize("irreps", HEAD_IRREPS)
def test_pairwise_expansion_forward_matches_per_path(irreps):
    tpe = TensorProductExpansion(irreps, irreps, irreps, "uvu")
    assert tpe._fuse_plan is not None
    params = tpe.init(jax.random.PRNGKey(0))
    left, right = _inputs(tpe, 7)
    np.testing.assert_allclose(
        np.asarray(tpe.expand(params, left, right)),
        np.asarray(_per_path(tpe, params, left, right)),
        rtol=2e-5, atol=2e-5,
    )


@pytest.mark.parametrize("irreps", GRAD_IRREPS)
def test_pairwise_expansion_gradients_match_per_path(irreps):
    tpe = TensorProductExpansion(irreps, irreps, irreps, "uvu")
    params = tpe.init(jax.random.PRNGKey(1))
    left, right = _inputs(tpe, 5, seed=1)

    def loss(expand):
        return lambda p, a, b: jnp.sum(jnp.sin(expand(p, a, b)))

    g_fast = jax.grad(loss(tpe.expand), argnums=(0, 1, 2))(params, left, right)
    g_ref = jax.grad(loss(lambda p, a, b: _per_path(tpe, p, a, b)),
                     argnums=(0, 1, 2))(params, left, right)
    for a, b in zip(jax.tree_util.tree_leaves(g_fast),
                    jax.tree_util.tree_leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)


def test_pairwise_head_matches_per_path_reference():
    """The whole Pairwise head (neighbor conv, diagonal and off-diagonal
    expansions, residual blocks) with and without the batched lowering."""
    irreps = HEAD_IRREPS[1]
    head = Pairwise(
        node_features=irreps, edge_radial="8x0e",
        edge_spherical="1x0e+1x1o+1x2e", diagonal=irreps,
        off_diagonal=irreps, conv="auto",
    )
    reference = copy.copy(head)
    for name in ("tp", "tp_off"):
        tpe = copy.copy(getattr(head, name))
        tpe._fuse_plan = None
        setattr(reference, name, tpe)
    rng = np.random.default_rng(2)
    n, e = 9, 20
    data = {
        "node_features": jnp.asarray(
            rng.normal(size=(n, head.tp.tp.irreps_in1.dim)), jnp.float32),
        "edge_radial": jnp.asarray(rng.normal(size=(e, 8)), jnp.float32),
        "edge_spherical": jnp.asarray(rng.normal(size=(e, 9)), jnp.float32),
        "edge_index": jnp.asarray(rng.integers(0, n, size=(2, e)), jnp.int32),
    }
    attrs = {"node_features": ("node", irreps)}
    params = head.init(jax.random.PRNGKey(2))
    out, _ = head.apply(params, dict(data), dict(attrs))
    ref, _ = reference.apply(params, dict(data), dict(attrs))
    for key in ("diagonal", "off_diagonal"):
        np.testing.assert_allclose(np.asarray(out[key]), np.asarray(ref[key]),
                                   rtol=2e-5, atol=2e-5)
