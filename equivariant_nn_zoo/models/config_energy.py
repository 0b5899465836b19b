"""QM9 total-energy regression config.

Reference parity: e3_layers/configs/config_energy.py — same hyperparameters
(n_dim 64, l_max 3, r_max 4.0, 5 layers, batch 128, lr 1e-2,
ReduceLROnPlateau 0.8/patience 1, EMA 0.99, per-species energy shifts).
"""

from functools import partial

from ..utils.config_dict import ConfigDict

from ..data.compute_edge import computeEdgeIndex
from ..utils.utils import default_type_names
from .layer_configs import addEnergyOutput, featureModel


def get_config(spec=None):
    config = ConfigDict()
    data, model = ConfigDict(), ConfigDict()
    config.data_config = data
    config.model_config = model

    config.epoch_subdivision = 1
    config.learning_rate = 1e-2
    config.batch_size = 128

    config.use_ema = True
    config.ema_decay = 0.99
    config.ema_use_num_updates = True
    config.metric_key = "validation_loss"

    config.max_epochs = int(1e6)
    config.early_stopping_patiences = {"validation_loss": 20}
    config.early_stopping_lower_bounds = {"LR": 1e-6}

    config.loss_coeffs = {"total_energy": [1e3, "MSELoss"]}
    config.metrics_components = {"total_energy": ["mae"]}
    config.optimizer_name = "Adam"
    config.lr_scheduler_name = "ReduceLROnPlateau"
    config.lr_scheduler_patience = 1
    config.lr_scheduler_factor = 0.8

    model.n_dim = 64
    model.l_max = 3
    model.r_max = 4.0
    model.num_layers = 5
    model.node_attrs = "20x0e"
    model.jit = True
    num_types = 10

    data.n_train = 120000
    data.n_val = 10831
    data.train_val_split = "random"
    data.shuffle = True
    data.path = "/opt/shared-data/qm9.hdf5"
    data.type_names = default_type_names(num_types)
    data.key_map = {"Z": "species", "R": "pos", "U0": "total_energy"}
    data.preprocess = [partial(computeEdgeIndex, r_max=model.r_max)]
    # deterministic preprocess -> memoize items (epoch >= 2 is host-free)
    data.cache_preprocessed = True
    data.num_workers = 4

    if isinstance(spec, str) and "profiling" in spec:
        data.n_train = 1280
        data.n_val = 128
    if isinstance(spec, str) and spec.startswith("{"):
        # reference parity (config_energy_force.py:53-55): the spec string
        # may eval to an override dict; dotted keys address nested fields.
        # Applied before the layers are built, so model widths take effect.
        config.update_from_flattened_dict(eval(spec))

    edge_spherical = "1x0e+1x1o+1x2e"
    layer_configs = featureModel(
        n_dim=model.n_dim,
        l_max=model.l_max,
        edge_spherical=edge_spherical,
        node_attrs=model.node_attrs,
        edge_radial="8x0e",
        num_types=num_types,
        num_layers=model.num_layers,
        r_max=model.r_max,
        normalize=False,
    )
    # per-species energy shifts (dataset.statistics
    # ['total_energy-per-atom_types-mean_std']); reference config_energy.py:65-76
    shifts = [
        -620.4502,
        -16.4435,
        -620.4502,
        -620.4502,
        -620.4502,
        -620.4502,
        -1036.0271,
        -1489.8005,
        -2046.9702,
        -2717.4263,
    ]
    layer_configs = addEnergyOutput(layer_configs, shifts)
    model.update(layer_configs)

    return config
