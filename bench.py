#!/usr/bin/env python
"""Training-throughput benchmarks on one GPU: one JSON line per workload.

`python bench.py [mode] [batch_size]`, mode one of:
  energy        config_energy training step (the default)
  energy_force  config_energy_force force training: a double backward
                through GradientOutput
  diffusion     VP-SDE score-model training (config_diffusion)
  dipole        config_dipole per-atom dipole training
  hamiltonian   H2O Hamiltonian-matrix training (config_hamiltonian)
  e2e           config_energy through Trainer and the production DataLoader
  all           every mode above

Every line names the device it ran on and the card's name and power limit;
the benchmark refuses to run without a GPU.  The workloads (synthetic
molecules made from a seed, jitted train steps) are shared with
chip_smoke.py.
"""

import json
import sys
import time
from functools import partial

import numpy as np

# ------------------------------------------------------------ data makers


def _molecule(attrs, d, r_max):
    from equivariant_nn_zoo.data import Data, computeEdgeIndex

    out, attrs = computeEdgeIndex(d, attrs, r_max=r_max)
    d.update(out)
    return Data(attrs, **d)


def synthetic_qm9(n_mol, rng, r_max=4.0):
    """QM9-like molecules: 8-23 atoms of H/C/N/O, ~1.4 A spread blobs."""
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {
            "pos": rng.normal(size=(n, 3)) * 1.4,
            "species": rng.choice([1, 6, 7, 8], size=(n, 1)),
            "total_energy": rng.normal(size=(1, 1)),
        }
        d["atom_types"] = d["species"]
        attrs = {
            "pos": ("node", "1x1o"),
            "species": ("node", "1x0e"),
            "atom_types": ("node", "1x0e"),
            "total_energy": ("graph", "1x0e"),
        }
        mols.append(_molecule(attrs, d, r_max))
    return mols


def synthetic_fragments(n_mol, rng, r_max=5.0, num_types=20):
    """Protein-fragment-like molecules with energy+force targets."""
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {
            "pos": rng.normal(size=(n, 3)) * 1.6,
            "species": rng.integers(0, num_types, size=(n, 1)),
            "energy": rng.normal(size=(1, 1)),
            "forces": rng.normal(size=(n, 3)).astype(np.float32),
        }
        d["atom_types"] = d["species"]
        attrs = {
            "pos": ("node", "1x1o"),
            "species": ("node", "1x0e"),
            "atom_types": ("node", "1x0e"),
            "energy": ("graph", "1x0e"),
            "forces": ("node", "1x1o"),
        }
        mols.append(_molecule(attrs, d, r_max))
    return mols


def synthetic_diffusion_mols(n_mol, rng, r_max=9999.0, num_types=18):
    """Molecules for the score model: fully-connected edges (r_max=9999,
    reference config_diffusion preprocess), normalized positions."""
    from equivariant_nn_zoo.data import Data, computeEdgeIndex

    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 20))
        d = {
            "pos": (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
            "species": rng.integers(0, num_types, size=(n, 1)),
        }
        d["atom_types"] = d["species"]
        attrs = {
            "pos": ("node", "1x1o"),
            "species": ("node", "1x0e"),
            "atom_types": ("node", "1x0e"),
        }
        out, attrs = computeEdgeIndex(d, attrs, r_max=r_max)
        d.update(out)
        ne = int(np.asarray(d["edge_index"]).shape[-1])
        d["bond_type"] = rng.integers(0, 4, size=(ne, 1))
        attrs["bond_type"] = ("edge", "1x0e")
        mols.append(Data(attrs, **d))
    return mols


def synthetic_dipole_mols(n_mol, rng, r_max=5.0, num_types=18):
    """Molecules with per-atom l=1 targets (JCTC atomic multipoles; the
    reference config_dipole head is a PointwiseLinear, no pooling)."""
    mols = []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        d = {
            "pos": rng.normal(size=(n, 3)) * 1.4,
            "species": rng.integers(0, num_types, size=(n, 1)),
            "dipole": rng.normal(size=(n, 3)).astype(np.float32),
        }
        d["atom_types"] = d["species"]
        attrs = {
            "pos": ("node", "1x1o"),
            "species": ("node", "1x0e"),
            "atom_types": ("node", "1x0e"),
            "dipole": ("node", "1x1o"),
        }
        mols.append(_molecule(attrs, d, r_max))
    return mols


def synthetic_h2o(n_mol, rng, r_max=4.0):
    """Jittered water molecules with a 24x24 Hamiltonian target."""
    mols = []
    base = np.array([[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]])
    for _ in range(n_mol):
        d = {
            "pos": base + rng.normal(scale=0.03, size=(3, 3)),
            "species": np.array([[8], [1], [1]]),
            "hamiltonian": rng.normal(size=(1, 576)).astype(np.float32),
        }
        d["atom_types"] = d["species"]
        attrs = {
            "pos": ("node", "1x1o"),
            "species": ("node", "1x0e"),
            "atom_types": ("node", "1x0e"),
            "hamiltonian": ("graph", 576),
        }
        mols.append(_molecule(attrs, d, r_max))
    return mols


def qm9_condensed(n_mol, rng):
    """QM9-format condensed arrays (what a QM9 HDF5 file holds, after the
    config_energy key map) with a smooth synthetic energy target."""
    e_atom = {1: -16.4, 6: -1036.0, 7: -1489.0, 8: -2047.0}
    pos, z, u0, n_nodes = [], [], [], []
    for _ in range(n_mol):
        n = int(rng.integers(8, 24))
        p = rng.normal(size=(n, 3)) * 1.4
        s = rng.choice([1, 6, 7, 8], size=(n, 1), p=[0.5, 0.3, 0.1, 0.1])
        dm = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        pair = np.exp(-dm[np.triu_indices(n, 1)]).sum()
        pos.append(p)
        z.append(s)
        u0.append([sum(e_atom[int(t)] for t in s[:, 0]) + 3.0 * pair])
        n_nodes.append([n])
    species = np.concatenate(z).astype(np.int64)
    data = {
        "pos": np.concatenate(pos).astype(np.float32),
        "species": species,
        "atom_types": species.copy(),
        "total_energy": np.asarray(u0, np.float32),
        "_n_nodes": np.asarray(n_nodes, np.int64),
    }
    attrs = {
        "pos": ("node", "1x1o"),
        "species": ("node", "1x0e"),
        "atom_types": ("node", "1x0e"),
        "total_energy": ("graph", "1x0e"),
        "_n_nodes": ("graph", "1x0e"),
    }
    return data, attrs


# -------------------------------------------------------------- workloads


def make_batches(mols, batch_size, n_batches=4):
    """Device batches at production-estimated capacities, bumped until no
    graph is dropped (the real loader defers overflow instead)."""
    import jax

    from equivariant_nn_zoo.data import Batch, GraphBatch
    from equivariant_nn_zoo.data.dataloader import estimate_capacities

    node_cap, edge_cap = estimate_capacities(mols, batch_size)
    while True:
        batches = []
        for b in range(n_batches):
            host = Batch.from_data_list(
                mols[b * batch_size:(b + 1) * batch_size]
            )
            gb = GraphBatch.from_batch(host, node_cap, edge_cap, batch_size)
            if gb.dropped:
                break
            batches.append(gb)
        if len(batches) == n_batches:
            break
        node_cap += 128
        edge_cap += 128
    return [jax.device_put(gb) for gb in batches]


class Workload:
    """A jitted train step over a few device batches.  ``step(i)`` runs one
    optimizer step on batch ``i % len(batches)`` and returns its loss (a
    device scalar); ``lower()`` lowers the jitted step for compile-time and
    memory readings; after ``compile()`` the steps call that executable."""

    def __init__(self, name, batch_size, jitted, state, batches,
                 unpack=None):
        self.name = name
        self.batch_size = batch_size
        self.jitted = jitted
        self.state = state
        self.batches = batches
        # jitted(state, batch) -> whatever unpack maps to (state, loss)
        self._unpack = unpack or (lambda out: out)
        self._compiled = None

    def step(self, i):
        fn = self._compiled or self.jitted
        self.state, loss = self._unpack(
            fn(self.state, self.batches[i % len(self.batches)])
        )
        return loss

    def lower(self):
        return self.jitted.lower(self.state, self.batches[0])

    def compile(self):
        """Compile the step ahead of time (all batches share one shape)."""
        self._compiled = self.lower().compile()
        return self._compiled


REGRESSION = {
    # mode: (config, data maker, batch size; None = the config's)
    "energy": ("config_energy", synthetic_qm9, 128),
    "energy_force": ("config_energy_force", synthetic_fragments, 64),
    "dipole": ("config_dipole", synthetic_dipole_mols, None),
    "hamiltonian": ("config_hamiltonian", synthetic_h2o, None),
}


def regression_workload(mode, batch_size=None, seed=0):
    import jax
    import optax

    from equivariant_nn_zoo.models import get_config
    from equivariant_nn_zoo.run.loss import Loss
    from equivariant_nn_zoo.utils import build

    config_name, make_mols, default_bs = REGRESSION[mode]
    cfg = get_config(config_name)
    batch_size = int(batch_size or default_bs or cfg.batch_size)
    model = build(cfg.model_config)
    loss_obj = Loss(dict(cfg.loss_coeffs))
    rng = np.random.default_rng(seed)
    mols = make_mols(batch_size * 4, rng, r_max=cfg.model_config.r_max)
    batches = make_batches(mols, batch_size)
    params = model.init(jax.random.PRNGKey(seed))
    optimizer = optax.adam(cfg.learning_rate)

    @partial(jax.jit, donate_argnums=(0,))
    def train_step(state, batch):
        params, opt_state = state

        def loss_fn(p):
            out = model.apply(p, batch)
            return loss_obj(out.data, batch.data)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state), loss

    return Workload(mode, batch_size, train_step,
                    (params, optimizer.init(params)), batches)


def diffusion_workload(batch_size=128, seed=0):
    """config_diffusion score training; ``.model`` and ``.sde`` are kept
    for sampling with the trained state."""
    import jax
    import optax

    from equivariant_nn_zoo.models import get_config
    from equivariant_nn_zoo.models.sde_config import (
        get_config as sde_get_config,
    )
    from equivariant_nn_zoo.run import sde_utils
    from equivariant_nn_zoo.utils import build

    cfg = get_config("config_diffusion")
    sde_cfg = sde_get_config()
    model = build(cfg.model_config)
    rng = np.random.default_rng(seed)
    batches = make_batches(synthetic_diffusion_mols(batch_size * 4, rng),
                           batch_size)
    params = model.init(jax.random.PRNGKey(seed))
    optimizer = optax.adam(cfg.learning_rate)
    state = sde_utils.init_sde_state(params, optimizer,
                                     jax.random.PRNGKey(seed + 1))
    sde = sde_utils.VPSDE(
        diffusion_keys=dict(cfg.diffusion_keys),
        beta_min=sde_cfg.model.beta_min, beta_max=sde_cfg.model.beta_max,
        N=sde_cfg.model.num_scales,
    )
    sde_step = sde_utils.get_step_fn(
        sde, True, model=model, optimizer=optimizer,
        reduce_mean=sde_cfg.training.reduce_mean, continuous=True,
        grad_clid_norm=cfg.get("grad_clid_norm"),
        ema_decay=sde_cfg.model.ema_rate,
    )
    wl = Workload("diffusion", batch_size, sde_step, jax.device_put(state),
                  batches, unpack=lambda out: (out[0], out[1]))
    wl.model, wl.sde = model, sde
    return wl


def build_workload(mode, batch_size=None, seed=0):
    if mode == "diffusion":
        return diffusion_workload(batch_size or 128, seed)
    return regression_workload(mode, batch_size, seed)


# ---------------------------------------------------------------- harness


def trace_steps(step, n_steps, top=10):
    """Run ``step(i)`` ``n_steps`` times under the profiler and summarize
    the first GPU's events (a trace without device events is an error)."""
    import tempfile

    import jax

    from equivariant_nn_zoo.utils.profiling import device_events, summarize

    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            out = None
            for i in range(n_steps):
                out = step(i)
            jax.block_until_ready(out)
        return summarize(device_events(td), n_steps, top=top)


def measure_steps(step, n_steps=200, n_traced=20):
    """Steady-state step time: ``n_steps`` timed on the host clock after a
    warm-up, ended by ``block_until_ready``; then ``n_traced`` traced
    for device busy time and idle share."""
    import jax

    out = None
    for i in range(8):  # warm-up beyond compile
        out = step(i)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(n_steps):
        out = step(i)
    jax.block_until_ready(out)
    rec = {"ms_per_step": (time.perf_counter() - t0) / n_steps * 1e3}
    if n_traced:
        summary = trace_steps(step, n_traced)
        rec["device_ms_per_step"] = summary["device_ms_per_step"]
        rec["idle_share"] = summary["idle_share"]
    return rec


def emit(metric, graphs_per_sec, extra=None):
    from equivariant_nn_zoo.utils.device_info import device_record, gpu_label

    rec = {"metric": metric, "value": graphs_per_sec,
           "unit": "graphs/sec/chip"}
    rec.update(extra or {})
    rec["device"] = device_record()
    rec["gpu"] = gpu_label()
    print(json.dumps(rec), flush=True)


def bench_workload(mode, batch_size=None, n_steps=200):
    import jax

    wl = build_workload(mode, batch_size)
    t0 = time.perf_counter()
    jax.block_until_ready(wl.step(0))
    compile_s = time.perf_counter() - t0
    rec = measure_steps(wl.step, n_steps=n_steps)
    rec["first_step_s"] = compile_s
    rec["batch_size"] = wl.batch_size
    emit(f"{mode}_train_throughput",
         wl.batch_size / rec["ms_per_step"] * 1e3, rec)


def bench_e2e(n_mol=8192, epochs=3, batch_size=128):
    """config_energy through the production path: in-memory QM9-format
    CondensedDataset -> DataLoader (capacities, deferral, item cache,
    thread workers) -> Trainer.batch_step.  The number the user gets."""
    import tempfile

    import jax

    from equivariant_nn_zoo.data.dataset import CondensedDataset
    from equivariant_nn_zoo.models import get_config
    from equivariant_nn_zoo.run import Trainer
    from equivariant_nn_zoo.utils import build

    cfg = get_config("config_energy")
    data, attrs = qm9_condensed(n_mol, np.random.default_rng(0))
    ds = CondensedDataset(
        data=data, attrs=attrs, preprocess=cfg.data_config.preprocess,
        type_names=cfg.data_config.type_names, cache_preprocessed=True,
    )
    n_val = 512
    with tempfile.TemporaryDirectory() as workdir:
        tr = Trainer(
            model=build(cfg.model_config), workdir=workdir, seed=0,
            data_config={"n_train": n_mol - n_val, "n_val": n_val,
                         "shuffle": True, "num_workers": 4},
            loss_coeffs={"total_energy": [1.0, "MSELoss"]},
            metrics_components={"total_energy": ["mae"]},
            metric_key="validation_loss", learning_rate=1e-2,
            optimizer_name="Adam", lr_scheduler_name="none",
            use_ema=True, max_epochs=epochs, batch_size=batch_size,
            log_period=10000, save_period=0,
        )
        tr.set_dataset(ds)
        tr.init_metrics()
        best, best_split = 0.0, {}
        for epoch in range(epochs):
            n = 0
            t_next = t_step = 0.0
            t0 = time.perf_counter()
            it = tr._device_prefetch(iter(tr.dl_train))
            while True:
                ta = time.perf_counter()
                batch = next(it, None)
                tb = time.perf_counter()
                if batch is None:
                    break
                tr.batch_step(batch)
                t_next += tb - ta
                t_step += time.perf_counter() - tb
                n += 1
            jax.block_until_ready(tr.params)
            dt = time.perf_counter() - t0
            if epoch > 0 and n * batch_size / dt > best:
                # host-side split: waiting on the prefetch iterator (loader
                # pack + H2D) vs dispatch+bookkeeping in batch_step
                best = n * batch_size / dt
                best_split = {
                    "ms_loader_wait": t_next / n * 1e3,
                    "ms_dispatch": t_step / n * 1e3,
                    "ms_per_batch": dt / n * 1e3,
                }
    emit("config_energy_e2e_trainer_throughput", best,
         {"dropped_graphs": int(tr.dl_train.dropped_graphs), **best_split})


MODES = ("energy", "energy_force", "diffusion", "dipole", "hamiltonian")


def main():
    from equivariant_nn_zoo.utils.compile_cache import setup_compile_cache
    from equivariant_nn_zoo.utils.device_info import require_gpu

    mode = sys.argv[1] if len(sys.argv) > 1 else "energy"
    batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else None
    if mode not in MODES + ("e2e", "all"):
        raise SystemExit(f"unknown bench mode {mode!r}")
    require_gpu()
    setup_compile_cache()
    if mode == "e2e":
        bench_e2e()
    elif mode == "all":
        for m in MODES:
            bench_workload(m)
        bench_e2e()
    else:
        bench_workload(mode, batch_size)


if __name__ == "__main__":
    sys.exit(main())
