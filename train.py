"""Training CLI — same flag surface as the reference train.py.

Reference parity: the reference train.py (C27 in SURVEY.md §2).  Process
orchestration: instead of mp.spawn + NCCL process groups, multi-host runs
call ``jax.distributed.initialize`` (coordinator = master_addr:master_port)
and each process drives its local devices; in-process multi-device data
parallelism uses the shard_map mesh (parallel/).
"""

import logging
import os
import sys
from pathlib import Path

import numpy as np
from absl import app, flags

flags.DEFINE_string("sde_config", None,
                    "Python file (or module path) with get_config() for SDE "
                    "training; defaults to the built-in sde config.")
flags.DEFINE_string("workdir", "results", "Work directory.")
flags.DEFINE_string("config", None, "The name of the config.")
flags.DEFINE_string("config_spec", "", "Config specification.")
flags.DEFINE_string("name", "default", "Name of the experiment.")
flags.DEFINE_integer("seed", 0, "The RNG seed.")
flags.DEFINE_integer("dataloader_num_workers", 4,
                     "Host-side prefetch depth (advisory).")
flags.DEFINE_string("resume_from", None,
                    "Trainer/model checkpoint to resume from.")
flags.DEFINE_boolean("profiling", False, "If profiling.")
flags.DEFINE_boolean("equivariance_test", False,
                     "If performs equivariance test.")
flags.DEFINE_boolean("wandb", False, "If logging with wandb.")
flags.DEFINE_string("project", "default_project", "The name of the project.")
flags.DEFINE_string("verbose", "INFO", "Logging verbosity.")
flags.DEFINE_integer("log_period", 100, "Number of training batches.")
flags.DEFINE_integer("eval_period", 20, "")
flags.DEFINE_integer("save_period", 2000, "")
flags.DEFINE_string("platform", None,
                    "Force a jax platform (e.g. 'cpu' to exercise the DP "
                    "mesh on virtual host devices).")
flags.DEFINE_integer("dp", 0,
                     "In-process data-parallel width (device-mesh shards). "
                     "0 = auto: use every local device when the batch size "
                     "divides evenly; 1 = force single-device.")
flags.DEFINE_integer("world_size", 1, "Number of processes (multi-host).")
flags.DEFINE_string("master_addr", "127.0.0.1", "Coordinator address.")
flags.DEFINE_string("master_port", "10000", "Coordinator port.")
flags.DEFINE_integer("process_id", 0, "This process's index (multi-host).")

FLAGS = flags.FLAGS


def setSeed(seed):
    np.random.seed(seed)


def _make_dp_mesh(batch_size: int, FLAGS):
    """Mesh over this process's local devices for in-process DP.

    The analogue of the reference's mp.spawn + DDP wrap (train.py:280-304,
    trainer.py:138-139): one process drives all local devices; the Trainer
    shards each batch over the mesh via shard_map.
    """
    import jax

    n = FLAGS.dp if FLAGS.dp > 0 else len(jax.local_devices())
    if jax.process_count() > 1:
        # multi-host DP: a GLOBAL mesh over every process's devices; each
        # process's loader feeds its local sub-shards and the step's psum
        # rides the cross-host collective (DDP all-reduce analogue,
        # reference train.py:272)
        if batch_size % n != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the {n} local "
                "devices of this process"
            )
        from equivariant_nn_zoo.parallel.mesh import make_mesh

        mesh = make_mesh(devices=jax.devices())
        logging.info(
            "data-parallel mesh over %d devices across %d processes",
            mesh.devices.size, jax.process_count(),
        )
        return mesh
    if n <= 1:
        return None
    if len(jax.local_devices()) < n:
        raise ValueError(
            f"--dp={n} but only {len(jax.local_devices())} local devices"
        )
    if batch_size % n != 0:
        if FLAGS.dp > 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by --dp={n}"
            )
        logging.warning(
            "auto-DP disabled: batch_size %d %% %d devices != 0",
            batch_size, n,
        )
        return None
    from equivariant_nn_zoo.parallel.mesh import make_mesh

    mesh = make_mesh(n, devices=jax.local_devices()[:n])
    logging.info("data-parallel mesh over %d local devices", n)
    return mesh


def train_regression(config, FLAGS):
    import jax

    from equivariant_nn_zoo.data.dataloader import shard_paths
    from equivariant_nn_zoo.data.dataset import CondensedDataset
    from equivariant_nn_zoo.utils import build, pruneArgs

    if FLAGS.wandb and jax.process_index() == 0:
        from equivariant_nn_zoo.run.trainer import TrainerWandB as Trainer
    else:
        from equivariant_nn_zoo.run.trainer import Trainer

    trainer_kwargs = dict(config)
    trainer_kwargs.pop("model_config", None)
    trainer_kwargs.update(
        workdir=FLAGS.workdir, seed=FLAGS.seed,
        equivariance_test=FLAGS.equivariance_test, profiling=FLAGS.profiling,
        log_period=FLAGS.log_period,
        save_period=FLAGS.save_period,
        mesh=_make_dp_mesh(int(config.batch_size), FLAGS),
    )
    if not FLAGS.resume_from:
        model = build(config.model_config)
        setSeed(FLAGS.seed)
        trainer = Trainer(model=model, **trainer_kwargs)
    else:
        model = build(config.model_config)
        trainer = Trainer.from_file(FLAGS.resume_from, model=model,
                                    **trainer_kwargs)
    logging.info("Successfully built the network...")
    data_config = dict(config.data_config)
    data_config["path"] = shard_paths(
        data_config.get("path"), jax.process_index(), jax.process_count()
    )
    dataset = CondensedDataset(**pruneArgs(CondensedDataset, **data_config))
    if FLAGS.equivariance_test:
        # the dataset becomes batch_size*2 rotated copies of one sample
        # (reference mechanism, dataset.py:123-137); resize the split to fit
        dataset.equivarianceTest(config.batch_size * 2)
        trainer.data_config = dict(trainer.data_config)
        trainer.data_config.update(
            n_train=config.batch_size, n_val=config.batch_size,
            train_val_split="sequential",
        )
    trainer.set_dataset(dataset, validation_dataset=None)
    if jax.process_index() == 0:
        trainer.save()
    trainer.train()
    return trainer


def train_diffusion(e3_config, FLAGS):
    import jax
    import optax

    from equivariant_nn_zoo.data.batch import Batch
    from equivariant_nn_zoo.data.dataloader import getDataIters
    from equivariant_nn_zoo.run import sde_sampling as sampling
    from equivariant_nn_zoo.run import sde_utils
    from equivariant_nn_zoo.run.lr_scheduler import ReduceLROnPlateau
    from equivariant_nn_zoo.utils import build, pruneArgs
    from equivariant_nn_zoo.utils.saveload import (
        restore_checkpoint,
        save_checkpoint,
    )

    if FLAGS.sde_config:
        import importlib.util

        spec = importlib.util.spec_from_file_location("sde_cfg",
                                                      FLAGS.sde_config)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sde_config = mod.get_config()
    else:
        from equivariant_nn_zoo.models.sde_config import get_config

        sde_config = get_config()

    workdir = FLAGS.workdir
    saveMol = e3_config.saveMol
    rank = jax.process_index()

    checkpoint_dir = os.path.join(workdir, "checkpoints")
    checkpoint_meta_dir = os.path.join(workdir, "checkpoints-meta",
                                       "checkpoint.pth")
    if rank == 0:
        Path(checkpoint_dir).mkdir(parents=True, exist_ok=True)
        Path(os.path.dirname(checkpoint_meta_dir)).mkdir(parents=True,
                                                         exist_ok=True)

    score_model = build(e3_config.model_config)
    params = score_model.init(jax.random.PRNGKey(FLAGS.seed))
    from equivariant_nn_zoo.utils import countParameters

    logging.info(f"Number of parameters {countParameters(params)}.")

    opt_kwargs = pruneArgs(prefix="optimizer", **dict(e3_config))
    opt_kwargs.pop("name", None)
    optimizer = {
        "Adam": optax.adam, "AdamW": optax.adamw, "SGD": optax.sgd,
    }[e3_config.optimizer_name](e3_config.learning_rate, **opt_kwargs)
    state = sde_utils.init_sde_state(
        params, optimizer, jax.random.PRNGKey(FLAGS.seed + 1)
    )
    if FLAGS.resume_from is not None:
        restored = restore_checkpoint(FLAGS.resume_from, state)
        if restored is not state:
            state = jax.device_put(restored)
        logging.info(f"Resumed from checkpoint {FLAGS.resume_from}.")
    initial_step = int(state["step"])

    sde = sde_utils.VPSDE(
        diffusion_keys=dict(e3_config.diffusion_keys),
        beta_min=sde_config.model.beta_min,
        beta_max=sde_config.model.beta_max,
        N=sde_config.model.num_scales,
    )
    sampling_eps = 1e-3
    continuous = sde_config.training.continuous

    train_step_fn = sde_utils.get_step_fn(
        sde, True, model=score_model, optimizer=optimizer,
        reduce_mean=sde_config.training.reduce_mean, continuous=continuous,
        grad_clid_norm=e3_config.get("grad_clid_norm"),
        grad_acc=e3_config.get("grad_acc", 1),
        ema_decay=sde_config.model.ema_rate,
    )
    eval_step_fn = sde_utils.get_step_fn(
        sde, False, model=score_model,
        reduce_mean=sde_config.training.reduce_mean, continuous=continuous,
    )

    scaler = e3_config.data_config.get("scaler", lambda x: x)
    inverse_scaler = e3_config.data_config.get("inverse_scaler", lambda x: x)
    train_iter, eval_iter = getDataIters(
        e3_config, seed=FLAGS.seed, process_index=rank,
        process_count=jax.process_count(),
    )
    sampling_fn = sampling.get_sampling_fn(
        sde_config, sde, inverse_scaler, sampling_eps
    )
    lr_sched = ReduceLROnPlateau(
        e3_config.learning_rate,
        factor=e3_config.get("lr_scheduler_factor", 0.8),
        patience=e3_config.get("lr_scheduler_patience", 1),
    )
    num_train_steps = sde_config.training.n_iters

    logging.info("Starting training loop at step %d." % (initial_step,))
    loss_lst, eval_loss_lst = [], []
    use_wandb = FLAGS.wandb and rank == 0
    wandb_mod = None
    if use_wandb:
        try:
            import wandb as wandb_mod
        except ImportError:
            use_wandb = False
    import jax.numpy as jnp

    def _host_means(lst):
        """One host sync for a whole window of device-scalar dicts."""
        means = {
            key: jnp.mean(jnp.stack([item[key] for item in lst]))
            for key in lst[0]
        }
        return {k: float(v) for k, v in jax.device_get(means).items()}

    for step in range(initial_step, num_train_steps + 1):
        gb = scaler(next(train_iter))  # device-side scaling (GraphBatch path)
        state, loss, losses = train_step_fn(state, gb)
        # keep device scalars; aggregating them here with float() would stall
        # the dispatch queue every step (the Trainer's lazy-accumulation fix)
        loss_lst.append(losses)

        if step % FLAGS.log_period == 0 and step > 0:
            loss_dict = _host_means(loss_lst)
            logging.info(
                "step: %d, training_loss: %.5e" % (step, loss_dict["total"])
            )
            if use_wandb:
                loss_dict["optim_step"] = step
                wandb_mod.log(loss_dict)
            loss_lst = []

        if step % FLAGS.eval_period == 0:
            egb = scaler(next(eval_iter))
            state, _, eval_losses = eval_step_fn(state, egb)
            eval_loss_lst.append(eval_losses)

        if (
            step != 0 and step % FLAGS.save_period == 0
            or step == num_train_steps
        ) and rank == 0:
            save_checkpoint(
                os.path.join(checkpoint_dir, f"{step}.pth"), state
            )
            save_checkpoint(checkpoint_meta_dir, state)
            if eval_loss_lst:
                loss_dict = {
                    f"{k}_val": v for k, v in _host_means(eval_loss_lst).items()
                }
                eval_loss_mean = loss_dict["total_val"]
                logging.info(
                    "step: %d, eval_loss: %.5e" % (step, eval_loss_mean)
                )
                lr_sched.step(eval_loss_mean)
                eval_loss_lst = []
                if use_wandb:
                    loss_dict.update(dict(lr=lr_sched.lr, optim_step=step))
                    wandb_mod.log(loss_dict)

            if sde_config.training.snapshot_sampling:
                sample_dir = os.path.join(workdir, "samples",
                                          f"iter_{step}")
                Path(sample_dir).mkdir(parents=True, exist_ok=True)
                gt_name = saveMol(inverse_scaler(gb.to_batch()),
                                  workdir=workdir, filename="ground_truth")
                samples_batch, _ = sampling_fn(
                    score_model, state["ema"]["params"], gb,
                    jax.random.PRNGKey(FLAGS.seed + step),
                )
                fname = saveMol(samples_batch, idx=0, workdir=workdir,
                                filename=f"{step}")
                if use_wandb:
                    wandb_mod.log({
                        "sample": wandb_mod.Molecule(fname),
                        "ground_truth": wandb_mod.Molecule(gt_name),
                        "optim_step": step,
                    })


def main(argv):
    # absl's app.run sys.exits on a non-None return; the trainer/state value
    # of run() is for programmatic callers (tests, notebooks)
    run(argv)


def run(argv):
    import jax

    from equivariant_nn_zoo.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    if FLAGS.platform:
        jax.config.update("jax_platforms", FLAGS.platform)
    if FLAGS.world_size > 1:
        # CPU processes need the gloo collectives; GPU processes use NCCL
        # and ignore this setting
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=f"{FLAGS.master_addr}:{FLAGS.master_port}",
            num_processes=FLAGS.world_size,
            process_id=FLAGS.process_id,
        )
    if FLAGS.platform:
        # the first device query initializes the backend: after
        # jax.distributed.initialize, which must come before it
        platform = jax.devices()[0].platform
        if platform != {"cuda": "gpu", "rocm": "gpu"}.get(FLAGS.platform,
                                                          FLAGS.platform):
            raise RuntimeError(
                f"--platform={FLAGS.platform} could not be applied: the "
                f"backend already runs on {platform}"
            )

    FLAGS.workdir = os.path.join(FLAGS.workdir, FLAGS.project, FLAGS.name)
    os.makedirs(FLAGS.workdir, exist_ok=True)
    logging.basicConfig(
        level=getattr(logging, FLAGS.verbose.upper(), logging.INFO),
        format="%(levelname)s - %(filename)s - %(asctime)s - %(message)s",
    )
    if jax.process_index() == 0:
        handler = logging.FileHandler(os.path.join(FLAGS.workdir,
                                                   "stdout.txt"))
        logging.getLogger().addHandler(handler)

    from equivariant_nn_zoo import models as configs

    config = configs.get_config(FLAGS.config, FLAGS.config_spec or None)

    if FLAGS.wandb and jax.process_index() == 0:
        import wandb

        wandb.init(project=FLAGS.project, name=FLAGS.name,
                   config=config.to_dict() if hasattr(config, "to_dict")
                   else dict(config))

    setSeed(FLAGS.seed)
    if "diffusion_keys" in config:
        return train_diffusion(config, FLAGS)
    else:
        return train_regression(config, FLAGS)


if __name__ == "__main__":
    flags.mark_flags_as_required(["config"])
    app.run(main)
