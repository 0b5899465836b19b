"""Default SDE (diffusion) training configuration.

The reference consumes a score_sde_pytorch-style config file via
``--sde_config`` (train.py:25-26); this provides the same field layout
self-contained (the reference leans on external score_sde imports,
SURVEY.md §7.1).
"""

from ..utils.config_dict import ConfigDict


def get_config():
    config = ConfigDict()

    config.training = training = ConfigDict()
    training.continuous = True
    training.snapshot_sampling = True
    training.n_iters = 1000000
    training.reduce_mean = True
    training.likelihood_weighting = False

    config.sampling = sampling = ConfigDict()
    sampling.method = "pc"
    sampling.predictor = "euler_maruyama"
    sampling.corrector = "langevin"
    sampling.snr = 0.16
    sampling.n_steps_each = 1
    sampling.noise_removal = True

    config.model = model = ConfigDict()
    model.beta_min = 0.1
    model.beta_max = 20.0
    model.num_scales = 1000
    model.ema_rate = 0.9999

    config.optim = optim = ConfigDict()
    optim.optimizer = "Adam"
    optim.lr = 2e-4
    optim.beta1 = 0.9
    optim.eps = 1e-8
    optim.weight_decay = 0.0

    config.seed = 42
    return config
