"""Trainer — the supervised training engine.

Reference parity: e3_layers/run/trainer.py (C20 in SURVEY.md §2): owns
model/optimizer/scheduler/EMA/loss/metrics/early-stopping, epoch loop with
subdivision, equivariance-test hook, profiling hook, best/last checkpointing
through atomic async writes, full-state resume including RNG streams.

Design: parameters are a pytree; one ``jax.jit``-compiled train
step does forward + loss + grad + optax update + EMA in a single XLA
program (buffer-donated, so params update in place on device).  The LR
schedule runs on host and is injected via ``optax.inject_hyperparams`` —
LR changes never trigger recompilation.  Metrics/loss statistics accumulate
as device scalars pulled lazily at epoch end.  Multi-chip data parallelism
shards each batch over a mesh (see parallel/) with XLA inserting the
gradient all-reduce — the DDP/NCCL analogue with zero backend code.
"""

from __future__ import annotations

import logging
import os
from copy import deepcopy
from time import perf_counter
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .early_stopping import EarlyStopping
from .loss import Loss, LossStat
from .lr_scheduler import SCHEDULERS
from .metrics import Metrics
from ..data.dataloader import DataLoader, estimate_capacities
from ..data.dataset import CondensedDataset
from ..ops.irreps import Irreps
from ..ops.wigner import irreps_d
from ..utils.saveload import (
    atomic_write_group,
    finish_all_writes,
    load_file,
    save_file,
)
from ..utils.utils import countParameters, pruneArgs


OPTIMIZERS = {
    "Adam": optax.adam,
    "AdamW": optax.adamw,
    "SGD": optax.sgd,
    "RMSprop": optax.rmsprop,
}


def make_ema_update(decay: float, use_num_updates: bool):
    def update(ema, params):
        num = ema["num_updates"] + 1
        d = decay
        if use_num_updates:
            d = jnp.minimum(decay, (1.0 + num) / (10.0 + num))
        new = jax.tree_util.tree_map(
            lambda e, p: e * d + p * (1.0 - d), ema["params"], params
        )
        return {"params": new, "num_updates": num}

    return update


class Trainer:
    stop_keys = ["max_epochs", "early_stopping", "early_stopping_kwargs"]
    object_keys = ["lr_sched", "optim", "ema", "early_stopping_conds"]

    def __init__(
        self,
        model,
        data_config,
        workdir: str = "/tmp/e3_workdir",
        seed: int = 0,
        loss_coeffs: Union[dict, str] = None,
        train_on_keys: Optional[List[str]] = None,
        metrics_components=None,
        metric_key="validation_loss",
        early_stopping_conds: Optional[EarlyStopping] = None,
        max_epochs: int = 1000000,
        learning_rate: float = 1e-2,
        lr_scheduler_name: str = "none",
        optimizer_name: str = "Adam",
        max_gradient_norm: float = float("inf"),
        use_ema: bool = False,
        ema_decay: float = 0.999,
        ema_use_num_updates=True,
        batch_size: int = 5,
        grad_acc: int = 1,
        train_idcs: Optional[list] = None,
        val_idcs: Optional[list] = None,
        epoch_subdivision: int = 1,
        equivariance_test: bool = False,
        profiling: bool = False,
        log_period: int = 50,
        save_period: int = 1,
        watch_freq: int = 0,
        mesh=None,
        **kwargs,
    ):
        self._initialized = False
        logging.debug("* Initialize Trainer")
        for key in (
            "data_config workdir seed loss_coeffs train_on_keys "
            "metrics_components metric_key max_epochs learning_rate "
            "lr_scheduler_name optimizer_name max_gradient_norm use_ema "
            "ema_decay ema_use_num_updates batch_size grad_acc train_idcs "
            "val_idcs epoch_subdivision equivariance_test profiling "
            "log_period save_period watch_freq"
        ).split():
            setattr(self, key, locals()[key])

        self.model = model
        self.mesh = mesh
        os.makedirs(workdir, exist_ok=True)
        self.last_model_path = os.path.join(workdir, "last.pt")
        self.best_model_path = os.path.join(workdir, "best.pt")
        self.trainer_save_path = os.path.join(workdir, "trainer.pt")
        self.rank = jax.process_index()
        self.logger = logging.getLogger()
        if self.rank == 0 and workdir:
            handler = logging.FileHandler(os.path.join(workdir, "log.txt"))
            handler.setFormatter(
                logging.Formatter(
                    "%(levelname)s - %(filename)s - %(asctime)s - %(message)s"
                )
            )
            self.logger.addHandler(handler)

        # RNG streams (all checkpointed for exact resume)
        self.split_rng = np.random.default_rng(seed)
        self.loader_rng_seed = seed + self.rank
        self.init_key = jax.random.PRNGKey(seed)

        self.kwargs = deepcopy(kwargs)
        self.best_metrics = float("inf")
        self.best_epoch = 0
        self.iepoch = 0

        self.loss = Loss(self.loss_coeffs)
        self.loss_stat = LossStat(self.loss)
        self.train_on_keys = self.loss.keys

        self.init_objects()

    # ------------------------------------------------------------- objects

    def init_objects(self):
        self.params = self.model.init(self.init_key)
        self.num_weights = countParameters(self.params)
        self.logger.info(f"Number of weights: {self.num_weights}")

        opt_fn = OPTIMIZERS[self.optimizer_name]
        opt_kwargs = pruneArgs(prefix="optimizer", **self.kwargs)
        opt_kwargs.pop("name", None)
        base = optax.inject_hyperparams(opt_fn)(
            learning_rate=self.learning_rate, **opt_kwargs
        )
        self.max_gradient_norm = (
            float(self.max_gradient_norm)
            if self.max_gradient_norm is not None
            else float("inf")
        )
        if self.max_gradient_norm < float("inf"):
            self.optimizer = optax.chain(
                optax.clip_by_global_norm(self.max_gradient_norm), base
            )
            self._hyper_path = lambda s: s[1].hyperparams
        else:
            self.optimizer = base
            self._hyper_path = lambda s: s.hyperparams
        self.opt_state = self.optimizer.init(self.params)

        assert self.lr_scheduler_name in SCHEDULERS, self.lr_scheduler_name
        self.lr_sched = None
        if SCHEDULERS.get(self.lr_scheduler_name) is not None:
            sched_kwargs = pruneArgs(prefix="lr_scheduler", **self.kwargs)
            sched_kwargs.pop("name", None)
            self.lr_sched = SCHEDULERS[self.lr_scheduler_name](
                lr=self.learning_rate, **sched_kwargs
            )

        es_kwargs = pruneArgs(prefix="early_stopping", **self.kwargs)
        n_args = 0
        for key, item in list(es_kwargs.items()):
            if hasattr(item, "items"):
                new_dict = {}
                for k, v in item.items():
                    if (
                        k.lower().startswith("validation")
                        or k.lower().startswith("training")
                        or k.lower() in ["lr", "wall"]
                    ):
                        new_dict[k] = v
                    else:
                        new_dict[f"validation_{k}"] = v
                es_kwargs[key] = new_dict
                n_args += len(new_dict)
        self.early_stopping_conds = (
            EarlyStopping(**es_kwargs) if n_args > 0 else None
        )

        self.ema = None
        if self.use_ema:
            # copy so params/EMA never alias (both are donated to the step)
            self.ema = {
                "params": jax.tree_util.tree_map(jnp.copy, self.params),
                "num_updates": jnp.zeros((), jnp.int32),
            }
        self._ema_update = make_ema_update(
            self.ema_decay, self.ema_use_num_updates
        )
        self._train_step = None
        self._eval_step = None
        self._initialized = True

    def init_metrics(self):
        if self.metrics_components is None:
            self.metrics_components = []
            for key, func in self.loss.funcs.items():
                params = {
                    "PerSpecies": type(func).__name__.lower().startswith(
                        "perspecies"
                    ),
                }
                self.metrics_components.append((key, "mae", params))
                self.metrics_components.append((key, "rmse", params))
        self.metrics = Metrics(
            components=self.metrics_components,
            **pruneArgs(prefix="metrics", **self.kwargs),
        )
        # the step jits close over metrics.batch_stats — rebuild them
        # against the new Metrics object
        self._train_step = None
        if not (
            self.metric_key.lower().startswith("validation")
            or self.metric_key.lower().startswith("training")
        ):
            raise RuntimeError(
                "metric_key should start with either validation or training"
            )
        # only these outputs are fetched from the jitted step (everything
        # else is dead-code-eliminated by XLA)
        self._out_keys = set(self.loss.keys) | set(self.metrics.funcs.keys())
        self._out_keys |= {"atom_types"}

    # ------------------------------------------------------------ stepping

    def _build_steps(self):
        model, loss_obj = self.model, self.loss
        out_keys = self._out_keys
        optimizer = self.optimizer
        use_ema = self.use_ema
        ema_update = self._ema_update

        equivariance_test = self.equivariance_test

        def select(out_data, batch):
            if equivariance_test:
                # the equivariance check needs every annotated output
                return {
                    k: v for k, v in out_data.items()
                    if k in out_keys or not k.startswith("_")
                }
            return {k: v for k, v in out_data.items() if k in out_keys}

        if self.mesh is not None:
            # data-parallel: per-device sub-batches via shard_map; gradients
            # of the replicated params are psum'd by shard_map's transpose —
            # the DDP all-reduce, compiled into the step.
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            from ..parallel.data_parallel import _local_batch

            mesh, axis = self.mesh, "dp"

            def local_forward(params, stacked):
                batch = _local_batch(stacked)
                out = model.apply(params, batch)
                loss, contrib = loss_obj(out.data, batch.data)
                loss = jax.lax.pmean(loss, axis)
                contrib = {
                    k: jax.lax.pmean(v, axis) for k, v in contrib.items()
                }
                sel = {k: v[None] for k, v in select(out.data, batch).items()}
                return loss, contrib, sel

            def forward(params, stacked):
                return shard_map(
                    local_forward, mesh=mesh,
                    in_specs=(P(), P(axis)),
                    out_specs=(P(), P(), P(axis)),
                    
                )(params, stacked)
        else:

            def forward(params, batch):
                out = model.apply(params, batch)
                loss, contrib = loss_obj(out.data, batch.data)
                return loss, contrib, select(out.data, batch)

        watch = bool(self.watch_freq)
        # metric partial sums computed INSIDE the step jit: one device
        # dispatch per batch instead of two.
        # batch_stats is pure, so closing over the bound method is safe;
        # init_metrics invalidates the steps so a new Metrics object rebuilds
        # them.
        metric_stats = getattr(self, "metrics", None)
        metric_stats = metric_stats.batch_stats if metric_stats else None

        def stats_of(out, batch):
            return metric_stats(out, batch.data) if metric_stats else {}

        def train_step(params, opt_state, ema, batch):
            batch = batch.from_wire()

            def loss_fn(p):
                loss, contrib, out = forward(p, batch)
                return loss, (out, contrib)

            (loss, (out, contrib)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            if use_ema:
                ema = ema_update(ema, params)
            # wandb.watch parity: keep the raw gradients as a step output so
            # the watch hook can histogram them (reference: trainer.py:905-907)
            aux = grads if watch else ()
            return (params, opt_state, ema, loss, contrib, out,
                    stats_of(out, batch), aux)

        def eval_step(params, batch):
            batch = batch.from_wire()
            loss, contrib, out = forward(params, batch)
            return loss, contrib, out, stats_of(out, batch)

        # gradient accumulation (regression path): K micro-batch grads are
        # summed on device, the optimizer consumes their mean every K-th
        # batch — identical update to one K-times-larger batch when micro
        # batches hold equally many real graphs.  Reference documents this
        # workflow for regression (README.md:154); the SDE step fn has its
        # own accumulator (sde_utils.py).
        def accum_step(params, acc, batch):
            batch = batch.from_wire()

            def loss_fn(p):
                loss, contrib, out = forward(p, batch)
                return loss, (out, contrib)

            (loss, (out, contrib)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            acc = jax.tree_util.tree_map(jnp.add, acc, grads)
            return acc, loss, contrib, out, stats_of(out, batch)

        k_acc = max(1, int(getattr(self, "grad_acc", 1) or 1))

        def apply_step(params, opt_state, ema, acc):
            grads = jax.tree_util.tree_map(lambda a: a / k_acc, acc)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            if use_ema:
                ema = ema_update(ema, params)
            return params, opt_state, ema

        self._train_step = jax.jit(train_step, donate_argnums=(0, 1, 2))
        self._eval_step = jax.jit(eval_step)
        self._accum_step = jax.jit(accum_step, donate_argnums=(1,))
        self._apply_step = jax.jit(apply_step, donate_argnums=(0, 1, 2, 3))
        self._acc = None
        self._acc_count = 0

    def lower_train_step(self, batch):
        """The jitted train step lowered for ``batch``, for compile-time and
        memory readings (``.compile().memory_analysis()``)."""
        if self._train_step is None:
            self._build_steps()
        return self._train_step.lower(self.params, self.opt_state, self.ema,
                                      batch)

    def batch_step(self, data, validation=False):
        """Reference parity: trainer.py:358-399."""
        if self._train_step is None:
            self._build_steps()
        if self.mesh is not None:
            from ..parallel.data_parallel import put_sharded, stack_shards
            from ..parallel.mesh import local_mesh_size

            if local_mesh_size(self.mesh) == 1:
                # multi-host with one local device: the loader yields an
                # unstacked batch (num_shards=1); give it the leading
                # device axis put_sharded splits over the mesh
                data = stack_shards([data])
            data = put_sharded(data, self.mesh)
        if validation:
            params = self.ema["params"] if self.use_ema else self.params
            loss, contrib, out, stats = self._eval_step(params, data)
        elif int(getattr(self, "grad_acc", 1) or 1) > 1:
            if self._acc is None:
                self._acc = jax.tree_util.tree_map(
                    jnp.zeros_like, self.params
                )
            self._acc, loss, contrib, out, stats = self._accum_step(
                self.params, self._acc, data
            )
            self._acc_count += 1
            if self._acc_count >= int(self.grad_acc):
                self.params, self.opt_state, self.ema = self._apply_step(
                    self.params, self.opt_state, self.ema, self._acc
                )
                self._acc = None
                self._acc_count = 0
        else:
            (
                self.params,
                self.opt_state,
                self.ema,
                loss,
                contrib,
                out,
                stats,
                grads,
            ) = self._train_step(self.params, self.opt_state, self.ema, data)
            if self.watch_freq:
                self._watch_count = getattr(self, "_watch_count", 0) + 1
                if self._watch_count % self.watch_freq == 0:
                    self.watch_log(grads)
        if self.equivariance_test:
            self.equivarianceTest(out, data)
        self.batch_losses = self.loss_stat(loss, contrib)
        # metric partial sums came out of the step jit itself (one dispatch
        # per batch); accumulation stays lazy on device
        self.batch_metrics = self.metrics.ingest(stats)

    # ------------------------------------------------------ wandb.watch hook

    def watch_stats(self, grads):
        """Per-leaf parameter/gradient norms and histograms — the
        `wandb.watch(model)` equivalent (reference: trainer.py:905-907).

        Returns a flat dict: `parameters/<path>` / `gradients/<path>` map to
        `(counts, bin_edges)` numpy histograms, `*_norm` to scalars.
        """
        stats = {}

        def add(prefix, tree):
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            for path, leaf in leaves:
                name = jax.tree_util.keystr(path).strip(".[]'\"").replace(
                    "']['", "."
                )
                arr = np.asarray(jax.device_get(leaf), np.float32).ravel()
                if arr.size == 0:
                    continue
                stats[f"{prefix}/{name}_norm"] = float(
                    np.linalg.norm(arr)
                )
                stats[f"{prefix}/{name}"] = np.histogram(arr, bins=64)
            return stats

        add("parameters", self.params)
        if grads is not None and grads != ():
            add("gradients", grads)
        return stats

    def watch_log(self, grads):
        """Hook called every `watch_freq` training batches; the base trainer
        just records the stats (TrainerWandB forwards them to wandb)."""
        self.watch_dict = self.watch_stats(grads)

    # ------------------------------------------------- equivariance testing

    def equivarianceTest(self, out, batch):
        """Check Wigner-rotated outputs have ~zero std across the batch of
        rotated copies.  Reference parity: trainer.py:334-356."""
        if "_rotation_matrix" not in batch.data:
            return
        mats = np.asarray(batch["_rotation_matrix"]).reshape(-1, 3, 3)
        g = int(np.asarray(batch["_graph_mask"]).sum())
        mats = mats[:g]
        for key, value in out.items():
            if key not in batch.attrs:
                continue
            is_per, transform = batch.attrs[key]
            if not isinstance(transform, (str, Irreps)) or (
                isinstance(transform, str) and str(transform).isdigit()
            ):
                continue
            irreps = Irreps(transform)
            value = np.asarray(value)
            if is_per == "graph":
                rows = value[:g].reshape(g, -1, irreps.dim)
            elif is_per == "node":
                # group rows by the node->graph segment: the cross-copy std
                # check is only meaningful when every graph is a (rotated)
                # copy with the same node count — skip loudly otherwise
                # instead of silently reshaping misaligned rows.
                seg = np.asarray(batch["_node_segment"]).reshape(-1)
                counts = np.bincount(seg, minlength=g + 1)[:g]
                if g == 0 or not np.all(counts == counts[0]):
                    self.logger.info(
                        f"equivariance test skipped for {key}: node counts "
                        f"differ across graphs (needs rotated copies)"
                    )
                    continue
                per_graph = [value[seg == i] for i in range(g)]
                rows = np.stack(per_graph).reshape(g, int(counts[0]),
                                                   irreps.dim)
            else:
                continue
            unrot = np.stack(
                [
                    rows[i] @ irreps_d(irreps, mats[i].T).T
                    for i in range(g)
                ]
            )
            old_std = rows.std(0).max()
            std = unrot.std(0).max()
            if old_std < 1e-3:
                self.logger.info(f"{key} too small to perform equivariance test")
            elif std < 1e-3:
                self.logger.info(f"equivariance test succeeded for {key}")
            else:
                self.logger.warning(
                    f"equivariance test failed for {key} (std {std:.2e})"
                )

    # ----------------------------------------------------------- datasets

    def set_dataset(self, dataset, validation_dataset=None):
        """Split + build loaders. Reference parity: trainer.py:229-307."""
        data_config = self.data_config
        n_train = data_config["n_train"]
        n_val = data_config["n_val"]
        if self.train_idcs is None or self.val_idcs is None:
            if validation_dataset is None:
                total_n = len(dataset)
                if isinstance(n_train, float):
                    n_train = int(n_train * total_n)
                if isinstance(n_val, float):
                    n_val = int(n_val * total_n)
                if (n_train + n_val) > total_n:
                    raise ValueError(
                        "too little data for training and validation. "
                        "please reduce n_train and n_val"
                    )
                split = data_config.get("train_val_split", "random")
                if split == "random":
                    idcs = self.split_rng.permutation(total_n)
                elif split == "sequential":
                    idcs = np.arange(total_n)
                else:
                    raise NotImplementedError(f"split mode {split}")
                self.train_idcs = idcs[:n_train]
                self.val_idcs = idcs[n_train : n_train + n_val]
            else:
                split = data_config.get("train_val_split", "random")
                if split == "random":
                    self.train_idcs = self.split_rng.permutation(
                        len(dataset)
                    )[:n_train]
                    self.val_idcs = self.split_rng.permutation(
                        len(validation_dataset)
                    )[:n_val]
                else:
                    self.train_idcs = np.arange(n_train)
                    self.val_idcs = np.arange(n_val)
        if validation_dataset is None:
            validation_dataset = dataset
        self.dataset_train = dataset.index_select(self.train_idcs)
        self.dataset_val = validation_dataset.index_select(self.val_idcs)

        # this process's loader produces one sub-batch per LOCAL mesh device;
        # other processes feed their own mesh shards (multi-host DP)
        if self.mesh is None:
            num_shards = 1
        else:
            from ..parallel.mesh import local_mesh_size

            num_shards = local_mesh_size(self.mesh)
        node_cap, edge_cap = estimate_capacities(
            self.dataset_train, self.batch_size // num_shards,
        )
        node_cap = data_config.get("node_capacity") or node_cap
        edge_cap = data_config.get("edge_capacity") or edge_cap
        if self.mesh is not None and jax.process_count() > 1:
            # static shapes must agree across processes (SPMD): take the max
            # of every process's bootstrapped capacities
            from jax.experimental import multihost_utils

            caps = multihost_utils.process_allgather(
                np.asarray([node_cap, edge_cap], np.int64)
            )
            node_cap = int(caps[:, 0].max())
            edge_cap = int(caps[:, 1].max())
        dl_kwargs = dict(
            batch_size=self.batch_size,
            node_capacity=node_cap,
            edge_capacity=edge_cap,
            drop_last=True,
            seed=self.loader_rng_seed,
            num_shards=num_shards,
            num_workers=data_config.get("num_workers", 0),
        )
        self.dl_train = DataLoader(
            self.dataset_train, shuffle=data_config.get("shuffle", True),
            **dl_kwargs,
        )
        self.dl_val = DataLoader(self.dataset_val, shuffle=False, **dl_kwargs)
        # restore the loader RNG stream on resume (reference restores all
        # four RNG streams, trainer.py:836-840)
        if getattr(self, "_loader_state", None) is not None:
            self.dl_train.load_state_dict(self._loader_state)
            self._loader_state = None

    # ------------------------------------------------------------- training

    def train(self):
        if getattr(self, "dl_train", None) is None:
            raise RuntimeError(
                "You must call `set_dataset()` before calling `train()`"
            )
        self.init_log()
        self.wall = perf_counter()
        if self.rank == 0 and self.iepoch == -1:
            with atomic_write_group():
                self.save()
        self.init_metrics()
        while not self.stop_cond:
            self.epoch_step()
            self.end_of_epoch_save()
        self.final_log()
        self.save()
        finish_all_writes()

    @property
    def stop_cond(self):
        if self.early_stopping_conds is not None and hasattr(self, "mae_dict"):
            early_stop, early_stop_args, debug_args = self.early_stopping_conds(
                self.mae_dict
            )
            if debug_args is not None:
                self.logger.debug(debug_args)
            if early_stop:
                self.stop_arg = early_stop_args
                return True
        if self.iepoch >= self.max_epochs:
            self.stop_arg = "max epochs"
            return True
        return False

    def reset_metrics(self):
        self.loss_stat.reset()
        self.metrics.reset()

    def _device_prefetch(self, it, lookahead: int = None):
        """Producer-thread batch pipeline: collate/pack + async host->device
        transfer run one step ahead of consumption.

        A daemon thread drains the loader and issues the (asynchronous)
        device_put, so packing and transfer overlap the previous step's
        device time; the bounded queue applies backpressure.

        Batches go to the device in GraphBatch.to_wire()'s two-blob form
        (one transfer per dtype instead of one per leaf); the step jits
        unpack via from_wire().  Skipped when the equivariance test is on
        — it reads batch fields host-side after the step."""
        import queue
        import threading

        if lookahead is None:
            # deeper lookahead smooths loader-time variance on the
            # single-host CPU at the cost of one extra resident batch
            # per slot (E3_PREFETCH, default 2)
            lookahead = int(os.environ.get("E3_PREFETCH", "2") or 2)
        q: queue.Queue = queue.Queue(maxsize=lookahead)
        sentinel = object()
        failure = []
        wire = (not self.equivariance_test
                and os.environ.get("E3_WIRE", "1") != "0")

        def producer():
            try:
                for item in it:
                    if wire and hasattr(item, "to_wire"):
                        item = item.to_wire()
                    q.put(jax.device_put(item))
            except BaseException as e:  # surfaced on the consumer side
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="e3-batch-prefetch")
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item

    def epoch_step(self):
        """Reference parity: trainer.py:426-503 (subdivision, profiling,
        per-category loops, LR plateau step, dataset reload)."""
        datasets = [self.dl_train, self.dl_val]
        categories = ["training", "validation"]
        if self.mesh is None:
            # single-chip: move batches to the device one step ahead (the
            # mesh path does its own sharded placement in batch_step)
            iterables = [
                self._device_prefetch(iter(self.dl_train)),
                self._device_prefetch(iter(self.dl_val)),
            ]
        else:
            iterables = [iter(self.dl_train), iter(self.dl_val)]

        for idivision in range(self.epoch_subdivision):
            self.metrics_dict = {}
            self.loss_dict = {}
            for category, dataset, iterable in zip(
                categories, datasets, iterables
            ):
                split_size = max(len(dataset) // self.epoch_subdivision, 1)
                profiling = category == "training" and self.profiling
                if profiling:
                    jax.profiler.start_trace(
                        os.path.join(self.workdir, "profile")
                    )
                self.reset_metrics()
                self.n_batches = len(dataset)
                start = idivision * split_size
                stop = min((idivision + 1) * split_size, len(dataset))
                batch_range = range(start, stop)
                if self.rank == 0:
                    try:
                        from tqdm import tqdm

                        batch_range = tqdm(batch_range)
                        batch_range.set_description(
                            f"{category} epoch{self.iepoch}-{idivision}"
                        )
                    except ImportError:
                        pass
                for self.ibatch in batch_range:
                    try:
                        batch = next(iterable)
                    except StopIteration:
                        break
                    self.batch_step(
                        data=batch, validation=(category == "validation")
                    )
                    if self.rank == 0 and (
                        (self.ibatch + 1) % self.log_period == 0
                        or (self.ibatch + 1) == self.n_batches
                    ):
                        self.end_of_batch_log(batch_type=category)
                self.metrics_dict[category] = self.metrics.current_result()
                self.loss_dict[category] = self.loss_stat.current_result()
                if profiling:
                    jax.profiler.stop_trace()
                    self._write_profiling_summary()
            self.end_of_epoch_log()
            if self.lr_sched is not None:
                new_lr = self.lr_sched.step(self.mae_dict[self.metric_key])
                self._set_lr(new_lr)
        self.iepoch += 1

        data_config = self.data_config
        if data_config.get("reload", False):
            dataset = CondensedDataset(
                **pruneArgs(CondensedDataset, **dict(data_config))
            )
            self.set_dataset(dataset, validation_dataset=None)

    def _write_profiling_summary(self):
        """Write the device time of the profiled epoch and its top kernels
        to profiling.txt (reference parity: trainer.py:486-491 writes torch
        profiler tables).  The raw trace under workdir/profile opens in
        TensorBoard/Perfetto."""
        from ..utils.profiling import device_events, summarize

        summary = summarize(
            device_events(os.path.join(self.workdir, "profile")),
            n_steps=max(1, self.n_batches), top=20,
        )
        lines = [f"# {summary['device']}: device time per step (ms)"]
        for key in ("device_ms_per_step", "kernel_ms_per_step",
                    "window_ms_per_step"):
            lines.append(f"{summary[key]:10.3f}  {key}")
        lines.append(f"{summary['idle_share']:10.3f}  idle_share")
        lines.append("# top kernels (ms per step)")
        for name, ms in summary["top_kernels_ms_per_step"]:
            lines.append(f"{ms:10.3f}  {name}")
        with open(os.path.join(self.workdir, "profiling.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def _set_lr(self, lr: float):
        try:
            # keep the exact aval (weak-typed f32 array) of the original
            # hyperparam — writing a python float would change the pytree
            # leaf type and force a recompile of the whole train step
            hp = self._hyper_path(self.opt_state)
            # match the stored leaf's aval exactly (strong f32 scalar) —
            # any aval change here would retrace the whole train step
            old = hp["learning_rate"]
            hp["learning_rate"] = jnp.full_like(old, lr)
        except (TypeError, KeyError, IndexError):  # pragma: no cover
            self.logger.warning("could not inject LR into optimizer state")

    @property
    def current_lr(self) -> float:
        if self.lr_sched is not None:
            return self.lr_sched.get_last_lr()[0]
        return self.learning_rate

    # -------------------------------------------------------------- logging

    def init_log(self):
        if self.iepoch > 0:
            self.logger.info("! Restarting training ...")
        else:
            self.logger.info("! Starting training ...")

    def final_log(self):
        self.logger.info(f"! Stop training: {self.stop_arg}")
        wall = perf_counter() - self.wall
        self.logger.info(f"Wall time: {wall}")

    def end_of_batch_log(self, batch_type: str):
        log_str = f"  {self.iepoch+1:5d} {self.ibatch+1:5d}"
        for name, value in self.batch_losses.items():
            log_str += f" {float(value):12.3g}"
        self.logger.info(f"{batch_type} {log_str}")

    def end_of_epoch_log(self):
        """Reference parity: trainer.py:555-626."""
        lr = self.current_lr
        if not hasattr(self, "wall"):
            self.wall = perf_counter()
        wall = perf_counter() - self.wall
        self.mae_dict = dict(LR=lr, epoch=self.iepoch, wall=wall)
        categories = ["training", "validation"]
        log_str = {}
        for category in categories:
            met, skip_keys = self.metrics.flatten_metrics(
                metrics=self.metrics_dict[category],
                type_names=getattr(self.dataset_train, "type_names", None),
            )
            log_str[category] = f"{self.iepoch:10d} {wall:8.3f} {lr:8.3g}"
            for key, value in self.loss_dict[category].items():
                log_str[category] += f" {value:12.3g}"
                self.mae_dict[f"{category}_{key}"] = value
            for key, value in met.items():
                if key not in skip_keys:
                    log_str[category] += f" {value:12.3g}"
                self.mae_dict[f"{category}_{key}"] = value
        if self.rank > 0:
            return
        if self.iepoch > 0:
            self.logger.info("! Train      " + log_str["training"])
            self.logger.info("! Validation " + log_str["validation"])
        else:
            self.logger.info("! Initial Validation " + log_str["validation"])
        self.logger.info(f"Wall time: {perf_counter() - self.wall}")

    # ------------------------------------------------------------ save/load

    @property
    def init_keys(self):
        return [
            "data_config", "workdir", "seed", "loss_coeffs", "train_on_keys",
            "metrics_components", "metric_key", "max_epochs", "learning_rate",
            "lr_scheduler_name", "optimizer_name", "max_gradient_norm",
            "use_ema", "ema_decay", "ema_use_num_updates", "batch_size",
            "grad_acc", "train_idcs", "val_idcs", "epoch_subdivision",
        ]

    @property
    def params_dict(self):
        return self.as_dict(state_dict=False, training_progress=False,
                            kwargs=False)

    def as_dict(self, state_dict: bool = False, training_progress: bool = False,
                kwargs: bool = True):
        """Reference parity: trainer.py:632-682."""
        dictionary = {}
        for key in self.init_keys:
            item = getattr(self, key, None)
            if hasattr(item, "to_dict"):
                item = item.to_dict()
            dictionary[key] = item
        if kwargs:
            dictionary.update(
                {
                    k: v
                    for k, v in getattr(self, "kwargs", {}).items()
                    if not callable(v)
                }
            )
        if state_dict:
            sd = {}
            sd["opt_state"] = jax.device_get(self.opt_state)
            if self.lr_sched is not None:
                sd["lr_sched"] = self.lr_sched.state_dict()
            if self.ema is not None:
                sd["ema"] = jax.device_get(self.ema)
            if self.early_stopping_conds is not None:
                sd["early_stopping_conds"] = (
                    self.early_stopping_conds.state_dict()
                )
            sd["split_rng_state"] = self.split_rng.bit_generator.state
            if getattr(self, "dl_train", None) is not None:
                sd["loader_state"] = self.dl_train.state_dict()
            sd["init_key"] = np.asarray(self.init_key)
            dictionary["state_dict"] = sd
        if training_progress:
            progress = {}
            for key in ["iepoch", "best_epoch"]:
                progress[key] = self.__dict__.get(key, -1)
            progress["best_metrics"] = self.__dict__.get(
                "best_metrics", float("inf")
            )
            progress["stop_arg"] = self.__dict__.get("stop_arg", None)
            progress["best_model_path"] = self.best_model_path
            progress["last_model_path"] = self.last_model_path
            progress["trainer_save_path"] = self.trainer_save_path
            dictionary["progress"] = progress
        return dictionary

    def end_of_epoch_save(self):
        """Reference parity: trainer.py:684-705."""
        if self.rank > 0:
            return
        with atomic_write_group():
            current_metrics = self.mae_dict[self.metric_key]
            if current_metrics < self.best_metrics:
                self.best_metrics = current_metrics
                self.best_epoch = self.iepoch
                self.save_ema_model(self.best_model_path, blocking=False)
                self.logger.info(
                    f"! Best model {self.best_epoch:8d} {self.best_metrics:8.3f}"
                )
            if self.save_period > 0 and (self.iepoch + 1) % self.save_period == 0:
                self.save(blocking=False)
                self.save_model(self.last_model_path, blocking=False)

    def save_model(self, path, blocking: bool = True):
        save_file(jax.device_get(self.params), path,
                  enforced_format="pickle", blocking=blocking)

    def save_ema_model(self, path, blocking: bool = True):
        params = (
            self.ema["params"] if self.ema is not None else self.params
        )
        save_file(jax.device_get(params), path, enforced_format="pickle",
                  blocking=blocking)

    def save(self, path=None, blocking: bool = True):
        if self.rank > 0:
            # rank-0-only checkpoint discipline (reference train.py:52,87,
            # 183); params are replica-identical so nothing is lost
            return None
        path = path or self.trainer_save_path
        state = self.as_dict(state_dict=True, training_progress=True)
        state["model_params"] = jax.device_get(self.params)
        save_file(state, path, enforced_format="pickle", blocking=blocking)
        return path

    # -------------------------------------------------------------- resume

    @classmethod
    def from_file(cls, path: str, model=None, **kwargs):
        """Reference parity: trainer.py:765-787."""
        dictionary = load_file(path, enforced_format="pickle")
        if "progress" in dictionary:
            return cls.from_dict(dictionary, model=model, **kwargs)
        # bare params pickle -> fresh trainer with loaded weights
        trainer = cls(model=model, **kwargs)
        trainer.params = jax.device_put(dictionary)
        return trainer

    @classmethod
    def from_dict(cls, dictionary: dict, model=None, **overrides):
        """Reference parity: trainer.py:789-863 (restores optimizer, EMA,
        early stopping, RNG streams, progress; refuses resume if the stop
        condition was already met)."""
        dictionary = deepcopy(dictionary)
        state_dict = dictionary.pop("state_dict", None)
        progress = dictionary.pop("progress", {})
        params = dictionary.pop("model_params", None)
        init_kwargs = {
            k: v
            for k, v in dictionary.items()
            if k not in ("state_dict", "progress")
        }
        init_kwargs.update(overrides)
        trainer = cls(model=model, **init_kwargs)
        if params is not None:
            trainer.params = jax.device_put(params)
        if state_dict:
            if "opt_state" in state_dict:
                ref = jax.tree_util.tree_structure(trainer.opt_state)
                leaves = jax.tree_util.tree_leaves(state_dict["opt_state"])
                trainer.opt_state = jax.tree_util.tree_unflatten(ref, leaves)
            if "lr_sched" in state_dict and trainer.lr_sched is not None:
                trainer.lr_sched.load_state_dict(state_dict["lr_sched"])
                trainer._set_lr(trainer.lr_sched.get_last_lr()[0])
            if "ema" in state_dict and trainer.ema is not None:
                trainer.ema = jax.device_put(state_dict["ema"])
            if (
                "early_stopping_conds" in state_dict
                and trainer.early_stopping_conds is not None
            ):
                trainer.early_stopping_conds.load_state_dict(
                    state_dict["early_stopping_conds"]
                )
            if "split_rng_state" in state_dict:
                trainer.split_rng.bit_generator.state = state_dict[
                    "split_rng_state"
                ]
            if "init_key" in state_dict:
                trainer.init_key = jnp.asarray(state_dict["init_key"])
            trainer._loader_state = state_dict.get("loader_state")
        if progress:
            trainer.iepoch = progress.get("iepoch", 0)
            trainer.best_epoch = progress.get("best_epoch", 0)
            trainer.best_metrics = progress.get("best_metrics", float("inf"))
            stop_arg = progress.get("stop_arg", None)
            if stop_arg is not None:
                raise RuntimeError(
                    f"The previous run has properly stopped with {stop_arg}. "
                    "Refusing to resume."
                )
        return trainer

    @staticmethod
    def load_model_from_training_session(workdir, which="best.pt"):
        """Reference parity: trainer.py:865-884."""
        return load_file(os.path.join(workdir, which),
                         enforced_format="pickle")


class TrainerWandB(Trainer):
    """Adds per-epoch wandb logging.

    Reference parity: e3_layers/run/trainer.py:887-907 (C21).
    """

    def end_of_epoch_log(self):
        super().end_of_epoch_log()
        if self.rank == 0:
            try:
                import wandb

                if wandb.run is not None:
                    wandb.log(self.mae_dict)
            except ImportError:
                pass

    def init_objects(self):
        super().init_objects()
        if self.rank == 0:
            try:
                import wandb

                if wandb.run is not None:
                    wandb.log({"num_weights": self.num_weights})
            except ImportError:
                pass

    def watch_log(self, grads):
        """wandb.watch parity (reference: trainer.py:905-907): gradient and
        parameter histograms + norms every `watch_freq` training batches."""
        super().watch_log(grads)
        if self.rank != 0:
            return
        try:
            import wandb
        except ImportError:
            return
        if wandb.run is None:
            return
        logd = {}
        for k, v in self.watch_dict.items():
            if isinstance(v, tuple):
                logd[k] = wandb.Histogram(np_histogram=v)
            else:
                logd[k] = v
        wandb.log(logd)
