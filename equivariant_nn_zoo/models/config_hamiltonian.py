"""Hamiltonian-matrix prediction for H2O (ORCA convention).

Reference parity: e3_layers/configs/config_hamiltonian.py — pairwise irreps
features, tensor-product matrix contraction, the e3nn->ORCA basis transform,
and the ``contractBasis`` padding-removal reshape.
"""

from functools import partial

import numpy as np
from ..utils.config_dict import ConfigDict

from ..data.compute_edge import computeEdgeIndex
from ..utils.utils import default_type_names
from .layer_configs import addMatrixOutput, featureModel


def _direct_sum(*blocks):
    n = sum(b.shape[0] for b in blocks)
    out = np.zeros((n, n), dtype=np.float32)
    i = 0
    for b in blocks:
        k = b.shape[0]
        out[i : i + k, i : i + k] = b
        i += k
    return out


def orca_transform_matrix():
    """Change of basis from this framework's real-irrep convention to ORCA's
    orbital ordering for the H2O basis (3s2p1d on O, 2s1p on each H).

    Reference parity: config_hamiltonian.py:10-28.  The P/D blocks express
    ORCA's (z, x, y)-style ordering in terms of the real irrep components;
    with the l=1 basis being (x, y, z) here (vs e3nn's (y, z, x)) the
    permutations are adjusted so the composite mapping is identical.
    """
    S = np.ones((1, 1), np.float32)
    # ORCA p order (pz, px, py) from our (x, y, z): rows select components
    P = np.array([[0, 0, 1.0], [1, 0, 0], [0, 1, 0]], np.float32)
    # ORCA d order from our real l=2 components (m = -2..2 in the internal
    # basis); same linear combinations as the reference expressed for the
    # internal ordering
    D = np.array(
        [
            [0, 1, 0, 0, 0.0],
            [0, 0, 0, 0, 1],
            [-0.5, 0, 0, -((3 / 4) ** 0.5), 0],
            [0, 0, 1, 0, 0],
            [((3 / 4) ** 0.5), 0, 0, -0.5, 0],
        ],
        np.float32,
    )
    return _direct_sum(S, S, S, P, P, D, S, S, P, S, S, P)


def transform(result):
    """Transform the hamiltonian from the internal irrep basis to ORCA."""
    import jax.numpy as jnp

    M = jnp.asarray(orca_transform_matrix())
    return M.T @ result @ M


def contractBasis(data, attrs):
    """Fill the molecular hamiltonian from atom(-pair) blocks, removing the
    padding basis.  H2O-specific like the reference.

    Reference parity: config_hamiltonian.py:31-92.  Works on the padded
    GraphBatch: the first 3*G node rows / 6*G edge rows are the real atoms /
    pairs in graph order (H2O graphs are uniform), padded graphs produce
    garbage rows that the graph mask removes from the loss.
    """
    import jax.numpy as jnp

    g = data["_graph_mask"].shape[0]
    diagonal = data["hamiltonian_diagonal"]
    off = data["hamiltonian_off"]

    result = jnp.zeros((g, 24, 24), jnp.float32)
    orbitals = [
        (0, 0, 3), (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 1, 1), (2, 0, 2),
        (2, 1, 1),
    ]
    dic = {(0, 1): 0, (0, 2): 1, (1, 0): 2, (1, 2): 3, (2, 0): 4, (2, 1): 5}
    full = [3, 2, 1]  # padded basis multiplicities per degree
    i_cnt = 0
    for i, degree_i, mul_i in orbitals:
        j_cnt = 0
        p_l = "e" if degree_i % 2 == 0 else "o"
        dim_l = mul_i * (2 * degree_i + 1)
        full_dim_l = full[degree_i] * (2 * degree_i + 1)
        for j, degree_j, mul_j in orbitals:
            p_r = "e" if degree_j % 2 == 0 else "o"
            dim_r = mul_j * (2 * degree_j + 1)
            full_dim_r = full[degree_j] * (2 * degree_j + 1)
            key = (
                f"{full[degree_i]}x{degree_i}{p_l}*"
                f"{full[degree_j]}x{degree_j}{p_r}"
            )
            if i == j:
                H = diagonal[key][: 3 * g].reshape(
                    g, 3, full_dim_l, full_dim_r
                )
                H = H[:, i, :dim_l, :dim_r]
            else:
                H = off[key][: 6 * g].reshape(g, 6, full_dim_l, full_dim_r)
                H = H[:, dic[(i, j)], :dim_l, :dim_r]
            result = result.at[
                :, i_cnt : i_cnt + dim_l, j_cnt : j_cnt + dim_r
            ].set(H)
            j_cnt += dim_r
        assert j_cnt == 24
        i_cnt += dim_l
    assert i_cnt == 24
    result = (result + jnp.swapaxes(result, 2, 1)) / 2
    result = transform(result)
    result = result.reshape(g, -1)
    attrs = dict(attrs)
    attrs["hamiltonian"] = ("graph", 576)
    return {"hamiltonian": result}, attrs


def get_config(spec=None):
    config = ConfigDict()
    data, model = ConfigDict(), ConfigDict()
    config.data_config = data
    config.model_config = model

    config.epoch_subdivision = 1
    config.learning_rate = 1e-2
    config.batch_size = 16

    config.use_ema = True
    config.ema_decay = 0.99
    config.ema_use_num_updates = True
    config.metric_key = "validation_loss"

    config.max_epochs = int(1e6)
    config.early_stopping_patiences = {"validation_loss": 20}
    config.early_stopping_lower_bounds = {"LR": 1e-6}

    config.loss_coeffs = {"hamiltonian": [1e5, "MSELoss"]}
    config.metrics_components = {"hamiltonian": ["mae"]}
    config.optimizer_name = "Adam"
    config.lr_scheduler_name = "ReduceLROnPlateau"
    config.lr_scheduler_patience = 8
    config.lr_scheduler_factor = 0.8

    model.n_dim = 64
    model.l_max = 4
    model.r_max = 4.0
    model.num_layers = 5
    model.node_attrs = "8x0e"
    num_types = 9

    data.n_train = 500
    data.n_val = 500
    data.train_val_split = "random"
    data.shuffle = True
    data.path = "h2o.hdf5"
    data.type_names = default_type_names(num_types)
    data.preprocess = [partial(computeEdgeIndex, r_max=model.r_max)]
    # deterministic preprocess -> memoize items (epoch >= 2 is host-free)
    data.cache_preprocessed = True
    data.num_workers = 4

    edge_spherical = "1x0e+1x1o+1x2e+1x3o"
    layer_configs = featureModel(
        n_dim=model.n_dim,
        l_max=model.l_max,
        edge_spherical=edge_spherical,
        node_attrs=model.node_attrs,
        edge_radial="8x0e",
        num_types=num_types,
        num_layers=model.num_layers,
        r_max=model.r_max,
    )
    layer_configs = addMatrixOutput(
        layer_configs, "3x0e+2x1o+1x2e", "3x0e+2x1o+1x2e"
    )
    layer_configs.layers.append(("hamiltonian", contractBasis))
    model.update(layer_configs)
    return config
