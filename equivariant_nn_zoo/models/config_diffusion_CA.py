"""Protein C-alpha diffusion (VP-SDE over CA positions).

Reference parity: e3_layers/configs/config_diffusion_CA.py — masked→indexed
compaction, spatial crop to <=384 nodes, sparse edges (radius 8Å ∪ chain
neighbors ∪ 2% random long-range), chain-aware relative-position encoding,
time embedding, per-key score heads.  The radius graph is the model's FIRST
layer — here the device-side static-capacity version, so the sampler's
1000-step reverse loop rebuilds edges inside one jitted fori_loop.
"""

from functools import partial

from ..utils.config_dict import ConfigDict

from ..data.compute_edge import (
    chain_criteria_device,
    computeEdgeIndexDevice,
    computeEdgeVector,
)
from ..nn import (
    Broadcast,
    Concat,
    PointwiseLinear,
    RadialBasisEncoding,
    RelativePositionEncoding,
    symmetric_cutoff,
)
from ..utils.saveload import saveProtein
from ..utils.utils import getScaler, insertAfter, replace
from .protein_utils import crop, masked2indexed


def get_config(spec=""):
    spec = spec or ""
    config = ConfigDict()
    data, model = ConfigDict(), ConfigDict()
    config.data_config = data
    config.model_config = model

    config.learning_rate = 1e-2
    config.batch_size = 4
    config.grad_acc = 4

    config.use_ema = True
    config.ema_decay = 0.99
    config.config_spec = spec
    config.ema_use_num_updates = True

    config.optimizer_name = "Adam"
    config.lr_scheduler_name = "ReduceLROnPlateau"
    config.lr_scheduler_patience = 1
    config.lr_scheduler_factor = 0.8
    config.grad_clid_norm = 1.0
    config.saveMol = saveProtein
    config.diffusion_keys = {"CA": 3}

    model.n_dim = 64
    model.l_max = 2
    model.r_max = 5.0  # does not control the number of edges
    model.num_layers = 8
    model.edge_radial = "32x0e"
    model.node_attrs = "32x0e"
    model.jit = True
    num_types = 21

    data.n_train = 0.9
    data.n_val = 0.1
    data.std = 25.83
    data.scaler = getScaler(
        [("CA", ("shift", "mean")), ("CA", ("scale", 1 / data.std))]
    )
    data.inverse_scaler = getScaler([("CA", ("scale", data.std))])
    data.train_val_split = "random"
    data.shuffle = True
    data.path = [f"/mnt/vepfs/hb/protein_new/{i}" for i in range(8)]
    data.preprocess = [masked2indexed, partial(crop, max_nodes=384)]
    data.key_map = {}
    # static buffer for device-side edges: ~(avg 100 radius neighbors +
    # 2% random long-range) per node at 384 nodes * batch
    data.edge_capacity = 262144

    features = "+".join(
        [f"{model.n_dim}x{n}e+{model.n_dim}x{n}o" for n in range(model.l_max + 1)]
    )
    edge_spherical = "1x0e+1x1o+1x2e"
    from .layer_configs import featureModel

    layer_configs = featureModel(
        n_dim=model.n_dim,
        l_max=model.l_max,
        edge_spherical=edge_spherical,
        node_attrs=model.node_attrs,
        edge_radial=model.edge_radial,
        num_types=num_types,
        num_layers=model.num_layers,
        r_max=model.r_max,
        avg_num_neighbors=100,
        normalize=True,
    )
    layer_configs.layers = replace(
        layer_configs.layers, "edge_vector",
        ("edge_vector", partial(computeEdgeVector, key="CA")),
    )

    relative_position = {
        "module": RadialBasisEncoding,
        "r_max": 150,
        "cutoff": symmetric_cutoff,
        "trainable": True,
        "one_over_r": False,
    }
    relative_position = ("relative_position", {
        "module": RelativePositionEncoding,
        "segment": ("1x0e", "chain_id"),
        "id": ("1x0e", "id"),
        "irreps_out": (model.edge_radial, "rel_pos_embed"),
        "radial_encoding": relative_position,
    })
    concat = ("concat1", {
        "module": Concat,
        "rel_pos": (model.edge_radial, "rel_pos_embed"),
        "edge_radial": (model.edge_radial, "edge_radial"),
        "irreps_out": (model.edge_radial, "edge_radial"),
    })
    layer_configs.layers = [relative_position] + layer_configs.layers
    layer_configs.layers = insertAfter(layer_configs.layers, "radial_basis",
                                       concat)

    time_encoding = ("time_encoding", {
        "module": RadialBasisEncoding,
        "r_max": 1.0,
        "trainable": True,
        "irreps_in": ("1x0e", "t"),
        "one_over_r": False,
        "irreps_out": (f"{model.n_dim}x0e", "time_encoding"),
    })
    layer_configs.layers = insertAfter(layer_configs.layers, "embedding",
                                       time_encoding)
    graph2node = ("graph2node", {
        "module": Broadcast,
        "irreps_in": (f"{model.n_dim}x0e", "time_encoding"),
        "irreps_out": (f"{model.n_dim}x0e", "time_encoding"),
        "to": "node",
    })
    layer_configs.layers = insertAfter(layer_configs.layers, "time_encoding",
                                       graph2node)
    concat = ("concat2", {
        "module": Concat,
        "node_attrs": (model.node_attrs, "node_attrs"),
        "time_encoding": (f"{model.n_dim}x0e", "time_encoding"),
        "irreps_out": (model.node_attrs, "node_attrs"),
    })
    layer_configs.layers = insertAfter(layer_configs.layers, "graph2node",
                                       concat)

    for key in config.diffusion_keys:
        layer_configs.layers.append(
            (
                f"score_{key}",
                {
                    "module": PointwiseLinear,
                    "irreps_in": (features, "node_features"),
                    "irreps_out": ("1x1o", f"score_{key}"),
                },
            )
        )
    layer_configs.layers = [
        ("edge_index", partial(
            computeEdgeIndexDevice, r_max=8.0 / data.std, key="CA",
            criteria=chain_criteria_device,
        ))
    ] + layer_configs.layers
    model.update(layer_configs)
    return config
