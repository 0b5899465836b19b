"""Hamiltonian head: the full pairwise -> TP-contraction -> contractBasis
pipeline must produce a 24x24 H2O matrix that transforms as
H(Rx) = D(R) H(x) D(R)^T in the ORCA-mapped basis."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from equivariant_nn_zoo.data import Batch, Data, GraphBatch, computeEdgeIndex
from equivariant_nn_zoo.models import get_config
from equivariant_nn_zoo.models.config_hamiltonian import (
    orca_transform_matrix,
)
from equivariant_nn_zoo.ops import Irreps, irreps_d, rand_matrix
from equivariant_nn_zoo.utils import build


RNG = np.random.default_rng(11)


def make_h2o(rng=RNG):
    pos = np.array([[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    pos = pos + rng.normal(scale=0.03, size=(3, 3))
    d = {
        "pos": pos,
        "species": np.array([[8], [1], [1]]),
        "hamiltonian": rng.normal(size=(1, 576)),
    }
    d["atom_types"] = d["species"]
    attrs = {
        "pos": ("node", "1x1o"),
        "species": ("node", "1x0e"),
        "atom_types": ("node", "1x0e"),
        "hamiltonian": ("graph", 576),
    }
    out, attrs = computeEdgeIndex(d, attrs, r_max=4.0)
    d.update(out)
    return Data(attrs, **d), pos


@pytest.fixture(scope="module")
def ham_model():
    cfg = get_config("config_hamiltonian")
    # shrink for test speed but keep l_max=4 and the full head
    model = build(cfg.model_config)
    params = model.init(jax.random.PRNGKey(0))
    return model, params


def test_hamiltonian_covariance(ham_model):
    model, params = ham_model
    mol, pos = make_h2o()
    gb = GraphBatch.from_batch(Batch.from_data_list([mol]), 8, 16, 1)
    out = model.apply(params, gb)
    H = np.asarray(out["hamiltonian"]).reshape(24, 24)

    R = rand_matrix(RNG)
    mol2 = mol.clone()
    mol2["pos"] = (np.asarray(mol["pos"]) @ R.T).astype(np.float32)
    gb2 = GraphBatch.from_batch(Batch.from_data_list([mol2]), 8, 16, 1)
    H_rot = np.asarray(model.apply(params, gb2)["hamiltonian"]).reshape(24, 24)

    # basis irreps in the internal convention before the ORCA transform:
    # O(3s 2p 1d) + H(2s 1p) + H(2s 1p)
    basis = Irreps("3x0e+2x1o+1x2e+2x0e+1x1o+2x0e+1x1o")
    D_int = irreps_d(basis, R)
    M = orca_transform_matrix()
    D = M.T @ D_int @ M  # Wigner matrix in the ORCA-mapped basis
    H_expect = D @ H @ D.T
    scale = np.abs(H).max()
    assert scale > 1e-6, "degenerate test"
    assert np.abs(H_rot - H_expect).max() / scale < 2e-3


def test_hamiltonian_symmetric(ham_model):
    model, params = ham_model
    mol, _ = make_h2o()
    gb = GraphBatch.from_batch(Batch.from_data_list([mol]), 8, 16, 1)
    H = np.asarray(model.apply(params, gb)["hamiltonian"]).reshape(24, 24)
    np.testing.assert_allclose(H, H.T, atol=1e-5)


def test_orca_transform_orthogonal():
    M = orca_transform_matrix()
    np.testing.assert_allclose(M.T @ M, np.eye(24), atol=1e-6)
