#!/usr/bin/env python
"""Smoke run of the training path on a GPU.

    python chip_smoke.py [--seed N]       # one card: phases 0-3
    python chip_smoke.py --chips 4        # four cards: phases 0 and 4 only

Every phase must pass; a failure exits non-zero and prints no result.

0. Device.  JAX's first device must be a GPU (there is no CPU path).  Prints
   the device kind and count, and the cards' name and power limit as
   nvidia-smi gives them; every later line carries that label.
1. Main path.  config_energy at full width (n_dim 64, l_max 3, 5 layers,
   batch 128) built as train.py builds it: get_config -> build -> Trainer ->
   set_dataset, on an in-memory QM9-sized dataset made from --seed.  20
   timed optimizer steps with EMA, then one Trainer epoch (training and
   validation).  The loss stays finite and the parameters change.
2. The other workloads, as bench.py builds them: one compiled train step
   plus a few more of energy_force (batch 64, a double backward),
   dipole, hamiltonian (batch 16) and diffusion (batch 128); then
   predictor-corrector sampling steps with the diffusion model, and the
   on-device radius graph checked against a host one.  Their steps
   compile in two threads from the end of phase 1's timed steps, beside
   the rest of phase 1 and phase 3 (the hamiltonian step alone takes
   minutes to compile), so the phases run in the order 0, 1, 3, 2.
3. Parity at config_energy widths (~2k nodes, ~28k edges): the fused conv
   against the unfused per-path reference run in float32 at "highest"
   matmul precision -- forward output, parameter and feature gradients --
   and the force path of a config_energy_force layer: forces and the
   parameter gradient of a force loss (a double backward).
4. (--chips 4) The config_energy data-parallel step on a 4-card mesh at
   per-card batch 128 against the single-device step on the same four
   shards, in float32; then a few Trainer(mesh=...) steps.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# Parity tolerances on the relative L-infinity error, max|a - b| / max|b|,
# at real widths (reasons in PERF.md): fused conv compute mode -> tolerance.
TOLERANCES = {
    "f32_highest": 1e-4,  # float32 sums over ~2e4 edges in another order;
                          # TF32 or bf16 leaking in would show >= 5e-4
    "f32_default": 5e-3,  # the card runs float32 dots in TF32
    "bf16": 3e-2,         # bfloat16 operands, float32 accumulation
}


class Log:
    """Prints each line after the cards' ``name, power limit`` label."""

    def __init__(self):
        self.label = None

    def __call__(self, msg):
        print(f"[{self.label}] {msg}" if self.label else msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _block(tree):
    import jax

    return jax.block_until_ready(tree)


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ------------------------------------------------------------ phase 0


def phase_device(log, n_chips=1):
    """Require ``n_chips`` GPUs; label the log with nvidia-smi's reading."""
    from equivariant_nn_zoo.utils.device_info import (
        device_record,
        format_label,
        nvidia_smi,
        parse_nvidia_smi,
        require_gpu,
    )

    devices = require_gpu()
    check(len(devices) >= n_chips,
          f"phase 0: {n_chips} GPUs asked for, JAX sees {len(devices)}")
    text = nvidia_smi()
    for line in text.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}", flush=True)
    log.label = format_label(parse_nvidia_smi(text))
    rec = device_record()
    log(f"phase 0 device: platform {rec['platform']}, kind {rec['kind']}, "
        f"count {rec['count']}")
    return devices[:n_chips]


# ------------------------------------------------------------ phase 1


def _qm9_dataset(cfg, n_mol, seed):
    import bench
    from equivariant_nn_zoo.data.dataset import CondensedDataset

    data, attrs = bench.qm9_condensed(n_mol, np.random.default_rng(seed))
    return CondensedDataset(
        data=data, attrs=attrs, preprocess=cfg.data_config.preprocess,
        type_names=cfg.data_config.type_names, cache_preprocessed=True,
    )


def _trainer(cfg, workdir, seed, n_train, n_val, batch_size, mesh=None):
    """A Trainer built from a config as train.py builds it."""
    from equivariant_nn_zoo.run.trainer import Trainer
    from equivariant_nn_zoo.utils import build

    kwargs = dict(cfg)
    kwargs.pop("model_config")
    data_config = dict(cfg.data_config)
    data_config.update(n_train=n_train, n_val=n_val)
    kwargs.update(data_config=data_config, batch_size=batch_size,
                  workdir=workdir, seed=seed, log_period=10 ** 9, mesh=mesh)
    return Trainer(model=build(cfg.model_config), **kwargs)


def phase_main_path(log, device, seed, spec=None, batch_size=None,
                    n_steps=20, n_val=256, after_timing=None):
    """``after_timing()`` runs once the timed steps are done (main() starts
    the phase 2 compiles there, so they overlap the rest of phase 1 and
    phase 3 but not the timed steps)."""
    import jax

    from equivariant_nn_zoo.models import get_config

    cfg = get_config("config_energy", spec)
    bs = int(batch_size or cfg.batch_size)
    n_train = (n_steps + 4) * bs
    m = cfg.model_config
    log(f"phase 1 main path: config_energy n_dim {m.n_dim}, l_max {m.l_max},"
        f" {m.num_layers} layers, batch {bs}, EMA {cfg.use_ema}")
    t0 = time.perf_counter()
    ds = _qm9_dataset(cfg, n_train + n_val, seed)
    with tempfile.TemporaryDirectory() as workdir:
        trainer = _trainer(cfg, workdir, seed, n_train, n_val, bs)
        trainer.set_dataset(ds)
        trainer.init_metrics()
        log(f"phase 1 set-up (data, model, loaders): "
            f"{time.perf_counter() - t0:.3f} s; capacities nodes "
            f"{trainer.dl_train.node_capacity}, edges "
            f"{trainer.dl_train.edge_capacity}")
        p0 = jax.device_get(trainer.params)
        it = trainer._device_prefetch(iter(trainer.dl_train))
        batch = next(it)
        t0 = time.perf_counter()
        trainer.batch_step(batch)
        _block(trainer.params)
        log(f"phase 1 first step (trace + compile + run): "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        compiled = trainer.lower_train_step(batch).compile()
        log(f"phase 1 lower + compile again (persistent cache): "
            f"{time.perf_counter() - t0:.3f} s")
        log(f"phase 1 train step memory_analysis: "
            f"{compiled.memory_analysis()}")
        losses = [trainer.batch_losses["loss"]]
        t0 = time.perf_counter()
        for _ in range(n_steps):
            trainer.batch_step(next(it))
            losses.append(trainer.batch_losses["loss"])
        _block(trainer.params)
        dt = time.perf_counter() - t0
        log(f"phase 1 steady: {dt / n_steps * 1e3:.3f} ms/step over "
            f"{n_steps} steps (smoke reading, not a benchmark)")
        if after_timing is not None:
            after_timing()
        losses = np.asarray(jax.device_get(losses), np.float64)
        check(np.all(np.isfinite(losses)), f"phase 1: loss not finite "
              f"{losses}")
        log(f"phase 1 loss first {losses[0]:.6g}, last {losses[-1]:.6g}")
        trainer.epoch_step()
        train_loss = trainer.loss_dict["training"]["loss"]
        val_loss = trainer.loss_dict["validation"]["loss"]
        check(np.isfinite(train_loss) and np.isfinite(val_loss),
              f"phase 1 epoch: loss {train_loss}, validation {val_loss}")
        log(f"phase 1 epoch of {len(trainer.dl_train)} batches: training "
            f"loss {train_loss:.6g}, validation loss {val_loss:.6g}")
        moved = max(
            float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
            for a, b in zip(jax.tree_util.tree_leaves(p0),
                            jax.tree_util.tree_leaves(trainer.params))
        )
        check(moved > 0, "phase 1: parameters did not change")
        n_ema = int(trainer.ema["num_updates"])
        check(n_ema >= n_steps, f"phase 1: EMA took {n_ema} updates")
        log(f"phase 1 EMA updates {n_ema}; largest parameter change "
            f"{moved:.6g}")
        trainer.dl_train.close()
        trainer.dl_val.close()
    log(f"phase 1 peak_bytes_in_use: {_peak_bytes(device)}")


# ------------------------------------------------------------ phase 2

WORKLOADS = (
    # bench.py mode, batch size (None: the bench default); the longest
    # compile first, so it starts at once on its own worker
    ("hamiltonian", 16),
    ("energy_force", 64),
    ("dipole", None),
    ("diffusion", 128),
)


def prepare_workload(mode, batch_size, seed):
    """Build a bench.py workload and compile its step ahead of time; its
    steps then run that executable.  Returns (workload, set-up s, compile
    s)."""
    import bench

    t0 = time.perf_counter()
    wl = bench.build_workload(mode, batch_size, seed)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wl.compile()
    return wl, setup_s, time.perf_counter() - t0


def start_workload_compiles(pool, seed, batch_size=None):
    """Submit every phase 2 workload's build and compile to ``pool``: the
    hamiltonian step alone takes minutes to compile on an H100, so the
    compiles run in threads (XLA compiles without the GIL) beside phases 1
    and 3.  Returns {future: mode}."""
    return {pool.submit(prepare_workload, mode, batch_size or bs, seed): mode
            for mode, bs in WORKLOADS}


def phase_workloads(log, device, seed, prepared, n_steps=4,
                    sample_steps=100):
    """Run each prepared workload (``start_workload_compiles``) as its
    compile finishes: one first step, then ``n_steps`` timed steps."""
    from concurrent.futures import as_completed

    import jax

    for fut in as_completed(prepared):
        mode = prepared[fut]
        wl, setup_s, compile_s = fut.result()
        t0 = time.perf_counter()
        losses = [_block(wl.step(0))]
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(1, n_steps + 1):
            losses.append(wl.step(i))
        _block(losses)
        dt = time.perf_counter() - t0
        losses = np.asarray(jax.device_get(losses), np.float64)
        check(np.all(np.isfinite(losses)),
              f"phase 2 {mode}: loss not finite {losses}")
        log(f"phase 2 {mode} batch {wl.batch_size}: set-up {setup_s:.3f} s, "
            f"lower + compile {compile_s:.3f} s (in a thread beside other "
            f"work), first step {first_s:.3f} s, then "
            f"{dt / n_steps * 1e3:.3f} ms/step over {n_steps} steps; loss "
            f"{losses[0]:.6g} -> {losses[-1]:.6g}; peak_bytes_in_use "
            f"{_peak_bytes(device)}")
        if mode == "diffusion":
            sample_and_rebuild_graph(log, wl, seed, sample_steps)


def sample_and_rebuild_graph(log, wl, seed, n_steps, r_max=1.0):
    """Predictor-corrector sampling with the trained score model, then the
    on-device radius graph of the samples against a host one.  The VP-SDE
    discretization needs beta_max / n_steps well below 1 (at 10 steps the
    update takes the square root of a negative number)."""
    import jax

    from equivariant_nn_zoo.data.compute_edge import radius_graph_fixed
    from equivariant_nn_zoo.models import get_config
    from equivariant_nn_zoo.run.sde_sampling import (
        get_corrector,
        get_pc_sampler,
        get_predictor,
    )
    from equivariant_nn_zoo.run.sde_utils import VPSDE

    keys = dict(get_config("config_diffusion").diffusion_keys)
    sde = VPSDE(keys, N=n_steps)
    pc = get_pc_sampler(sde, get_predictor("euler_maruyama"),
                        get_corrector("langevin"), None, snr=0.16,
                        n_steps=1, continuous=True)
    batch = wl.batches[0]
    params = wl.state["ema"]["params"]
    t0 = time.perf_counter()
    out, nfe = jax.jit(lambda p, b, k: pc(wl.model, p, b, k))(
        params, batch, jax.random.PRNGKey(seed))
    pos = np.asarray(_block(out["pos"]))
    dt = time.perf_counter() - t0
    real = np.asarray(batch["_node_mask"])[:, 0] > 0
    check(np.all(np.isfinite(pos[real])), "phase 2 sampler: non-finite pos")
    log(f"phase 2 sampler: {n_steps} predictor-corrector steps ({nfe} score "
        f"evaluations) on {int(real.sum())} atoms, {dt:.3f} s including "
        f"compile")

    seg = np.asarray(batch["_node_segment"])
    cap = batch.edge_capacity
    ei, _, _, n_cand = jax.jit(
        lambda p: radius_graph_fixed(p, batch["_node_segment"],
                                     batch["_node_mask"], cap, r_max,
                                     batch.dummy_node)
    )(out["pos"])
    n_cand = int(n_cand)
    check(n_cand <= cap, f"phase 2 radius graph: {n_cand} edges > {cap}")
    ei = np.asarray(ei)[:, :n_cand]
    device_edges = set(zip(ei[0].tolist(), ei[1].tolist()))
    d2 = np.sum((pos[:, None] - pos[None, :]) ** 2, axis=-1)
    host = (seg[:, None] == seg[None, :]) & real[:, None] & real[None, :]
    host &= ~np.eye(len(pos), dtype=bool) & (d2 < r_max * r_max)
    host_edges = set(zip(*[a.tolist() for a in np.nonzero(host)]))
    # pairs within float rounding of r_max may fall either way
    border = np.abs(np.sqrt(d2) - r_max) < 1e-5
    differ = {e for e in device_edges ^ host_edges if not border[e]}
    check(not differ, f"phase 2 radius graph: {len(differ)} edges differ "
          "from the host radius graph")
    log(f"phase 2 on-device radius graph (r_max {r_max}): {n_cand} edges, "
        f"same as the host radius graph")


# ------------------------------------------------------------ phase 3


def find_conv(model, layer="layer1"):
    """The FactorizedConvolution of a trunk layer (inside the force head's
    wrapped network, if any)."""
    net = getattr(model, "func", model)
    return dict(net.layers)[layer].conv


def conv_variant(conv, fused, compute_dtype):
    """A parameter-compatible copy of ``conv`` with another lowering."""
    from equivariant_nn_zoo.nn.message_passing import FactorizedConvolution

    dims = conv.fc.dims
    return FactorizedConvolution(
        input_features=conv.irreps_in["input_features"],
        output_features=conv.irreps_out["output_features"],
        node_attrs=conv.irreps_in.get("node_attrs"),
        edge_radial=conv.irreps_in["edge_radial"],
        edge_spherical=conv.irreps_in["edge_spherical"],
        invariant_layers=len(dims) - 2,
        invariant_neurons=dims[1],
        avg_num_neighbors=conv.avg_num_neighbors,
        use_sc=conv.use_sc,
        reduce=conv.reduce,
        fused=fused,
        compute_dtype=compute_dtype,
    )


def parity_graph(make_mols, n_mol, seed, r_max):
    """Positions and edges of ``n_mol`` molecules as one unpadded graph."""
    from equivariant_nn_zoo.data import Batch

    host = Batch.from_data_list(
        make_mols(n_mol, np.random.default_rng(seed), r_max=r_max))
    return (np.asarray(host["pos"], np.float32),
            np.asarray(host["edge_index"], np.int32))


def edge_geometry(conv, pos, edge_index, r_max):
    """Spherical harmonics and radial basis of the edges, as the trunk's
    SphericalEncoding and RadialBasisEncoding compute them (fixed Bessel
    frequencies); differentiable in ``pos``."""
    import jax.numpy as jnp

    from equivariant_nn_zoo.nn.embedding import BesselBasis, PolynomialCutoff
    from equivariant_nn_zoo.ops.irreps import Irreps
    from equivariant_nn_zoo.ops.spherical_harmonics import spherical_harmonics

    vec = pos[edge_index[1]] - pos[edge_index[0]]
    length = jnp.sqrt(jnp.sum(vec * vec, axis=-1) + 1e-12)
    ls = [mi.ir.l for mi in Irreps(conv.irreps_in["edge_spherical"])]
    sh = spherical_harmonics(ls, vec, normalize=True,
                             normalization="component")
    n_basis = Irreps(conv.irreps_in["edge_radial"]).num_irreps
    basis = BesselBasis(r_max, num_basis=n_basis, trainable=False)
    radial = basis.apply({}, length) * PolynomialCutoff(r_max)(length)[:, None]
    return sh, radial


def node_inputs(conv, n_nodes, rng):
    import jax.numpy as jnp

    from equivariant_nn_zoo.ops.irreps import Irreps

    x = jnp.asarray(rng.normal(size=(n_nodes, Irreps(
        conv.irreps_in["input_features"]).dim)), jnp.float32)
    attrs = None
    if "node_attrs" in conv.irreps_in:
        attrs = jnp.asarray(rng.normal(size=(n_nodes, Irreps(
            conv.irreps_in["node_attrs"]).dim)), jnp.float32)
    return x, attrs


def _apply(conv, params, x, attrs, sh, radial, edge_index):
    data = {"input_features": x, "edge_spherical": sh,
            "edge_radial": radial, "edge_index": edge_index}
    if attrs is not None:
        data["node_attrs"] = attrs
    out, _ = conv.apply(
        params, data,
        {"input_features": ("node", conv.irreps_in["input_features"])})
    return out["output_features"]


def rel_linf(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def tree_rel_linf(a, b):
    """Largest per-leaf relative L-infinity error over two pytrees."""
    import jax

    return max(rel_linf(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                             jax.tree_util.tree_leaves(b)))


def _run(fn, precision, *args):
    import jax

    with jax.default_matmul_precision(precision):
        return jax.device_get(jax.jit(fn)(*args))


def _candidates(conv, modes):
    """(mode, conv lowering, matmul precision) for each compared mode."""
    variants = {
        "f32_highest": (lambda: conv_variant(conv, True, "float32"),
                        "highest"),
        "f32_default": (lambda: conv_variant(conv, True, "float32"),
                        "default"),
        "bf16": (lambda: conv_variant(conv, True, "bfloat16"), "default"),
    }
    return [(m, variants[m][0](), variants[m][1]) for m in modes]


def conv_parity(conv, pos, edge_index, r_max, seed, modes=tuple(TOLERANCES)):
    """Fused conv vs the unfused float32 reference at "highest" precision:
    {mode: {"forward", "grad_params", "grad_features": rel L-inf error}}."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    sh, radial = edge_geometry(conv, jnp.asarray(pos), edge_index, r_max)
    x, attrs = node_inputs(conv, pos.shape[0], rng)
    params = conv.init(jax.random.PRNGKey(seed))
    n_out = edge_index.shape[1] if not conv.reduce else pos.shape[0]
    from equivariant_nn_zoo.ops.irreps import Irreps

    cot = jnp.asarray(rng.normal(size=(n_out, Irreps(
        conv.irreps_out["output_features"]).dim)), jnp.float32)

    def make(c):
        def f(p, x):
            out = _apply(c, p, x, attrs, sh, radial, edge_index)
            return jnp.sum(out * cot), out
        return jax.value_and_grad(f, argnums=(0, 1), has_aux=True)

    (_, ref_out), (ref_gp, ref_gx) = _run(
        make(conv_variant(conv, False, "float32")), "highest", params, x)
    result = {}
    for mode, c, precision in _candidates(conv, modes):
        (_, out), (gp, gx) = _run(make(c), precision, params, x)
        result[mode] = {"forward": rel_linf(out, ref_out),
                        "grad_params": tree_rel_linf(gp, ref_gp),
                        "grad_features": rel_linf(gx, ref_gx)}
    return result


def force_parity(conv, pos, edge_index, r_max, seed, modes=tuple(TOLERANCES)):
    """The force path through one conv layer: E = w . scalar outputs,
    F = -dE/dpos, and the parameter gradient of a force loss F . c (a
    double backward), fused vs the float32 "highest" reference:
    {mode: {"forces", "grad_params": rel L-inf error}}."""
    import jax
    import jax.numpy as jnp

    from equivariant_nn_zoo.ops.irreps import Irreps

    rng = np.random.default_rng(seed)
    x, attrs = node_inputs(conv, pos.shape[0], rng)
    params = conv.init(jax.random.PRNGKey(seed))
    first = Irreps(conv.irreps_out["output_features"])[0]
    assert first.ir.l == 0, first
    w = jnp.asarray(rng.normal(size=(first.mul,)), jnp.float32)
    c = jnp.asarray(rng.normal(size=pos.shape), jnp.float32)

    def make(cv):
        def energy(p, r):
            sh, radial = edge_geometry(cv, r, edge_index, r_max)
            out = _apply(cv, p, x, attrs, sh, radial, edge_index)
            return jnp.sum(out[:, :first.mul] * w)

        def force_loss(p, r):
            forces = -jax.grad(energy, argnums=1)(p, r)
            return jnp.sum(forces * c), forces

        return jax.grad(force_loss, has_aux=True)

    r = jnp.asarray(pos)
    ref_gp, ref_f = _run(make(conv_variant(conv, False, "float32")),
                         "highest", params, r)
    result = {}
    for mode, cv, precision in _candidates(conv, modes):
        gp, f = _run(make(cv), precision, params, r)
        result[mode] = {"forces": rel_linf(f, ref_f),
                        "grad_params": tree_rel_linf(gp, ref_gp)}
    return result


def _report_parity(log, what, result):
    failed = []
    for mode, errs in result.items():
        tol = TOLERANCES[mode]
        for name, err in errs.items():
            ok = err <= tol
            log(f"phase 3 {what} {mode} {name}: rel L-inf {err:.3e} "
                f"(tolerance {tol:.0e}) {'ok' if ok else 'FAILED'}")
            if not ok:
                failed.append(f"{what} {mode} {name}")
    return failed


def phase_parity(log, seed, n_mol=128):
    import bench
    from equivariant_nn_zoo.models import get_config
    from equivariant_nn_zoo.utils import build

    failed = []
    for config_name, make_mols, path in (
        ("config_energy", bench.synthetic_qm9, conv_parity),
        ("config_energy_force", bench.synthetic_fragments, force_parity),
    ):
        cfg = get_config(config_name)
        r_max = float(cfg.model_config.r_max)
        conv = find_conv(build(cfg.model_config))
        pos, edge_index = parity_graph(make_mols, n_mol, seed, r_max)
        what = f"{config_name} layer1 conv"
        log(f"phase 3 {what}: {pos.shape[0]} nodes, {edge_index.shape[1]} "
            f"edges, input {conv.irreps_in['input_features']}")
        t0 = time.perf_counter()
        result = path(conv, pos, edge_index, r_max, seed)
        failed += _report_parity(log, what, result)
        log(f"phase 3 {what}: {time.perf_counter() - t0:.3f} s including "
            "compiles")
    check(not failed, f"phase 3: outside tolerance: {failed}")


# ------------------------------------------------------------ phase 4


def _compile_in_threads(lowerings):
    """Compile ``{name: () -> jax.stages.Lowered}`` concurrently; each
    later jit call of the same function finds its executable in JAX's
    compilation cache.  Returns {name: compile seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    def compile_one(lower):
        t0 = time.perf_counter()
        lower().compile()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(lowerings)) as pool:
        futures = {k: pool.submit(compile_one, f) for k, f in lowerings.items()}
        return {k: f.result() for k, f in futures.items()}


def phase_data_parallel(log, devices, seed, spec=None, per_card=128,
                        trainer_steps=4):
    """The DP step on a mesh over ``devices`` against the single-device
    step on the same shards (float32, "highest" matmul precision), then a
    few Trainer(mesh=...) steps."""
    import jax
    import jax.numpy as jnp
    import optax

    import bench
    from equivariant_nn_zoo.models import get_config
    from equivariant_nn_zoo.parallel.data_parallel import (
        make_dp_train_step,
        put_sharded,
        stack_shards,
    )
    from equivariant_nn_zoo.parallel.mesh import make_mesh
    from equivariant_nn_zoo.run.loss import Loss
    from equivariant_nn_zoo.run.trainer import make_ema_update
    from equivariant_nn_zoo.utils import build

    n = len(devices)
    prev = os.environ.get("E3_COMPUTE_DTYPE")
    os.environ["E3_COMPUTE_DTYPE"] = "float32"
    workdir = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        cfg = get_config("config_energy", spec)
        model = build(cfg.model_config)
        mesh = make_mesh(devices=devices)
        log(f"phase 4 data parallel: config_energy on a {n}-card dp mesh, "
            f"per-card batch {per_card}, float32")
        rng = np.random.default_rng(seed)
        shards = bench.make_batches(
            bench.synthetic_qm9(per_card * n, rng,
                                r_max=cfg.model_config.r_max),
            per_card, n_batches=n)
        stacked = put_sharded(stack_shards(shards), mesh)
        # __graft_entry__.dryrun_multichip's set-up, with SGD at learning
        # rate 1 so the step's parameter update IS the negative gradient
        loss_obj = Loss({"total_energy": [1.0, "MSELoss"]})
        optimizer = optax.sgd(1.0)
        params = model.init(jax.random.PRNGKey(seed))
        ema = {"params": jax.tree_util.tree_map(jnp.copy, params),
               "num_updates": jnp.zeros((), jnp.int32)}
        opt_state = optimizer.init(params)
        step = make_dp_train_step(model, loss_obj, optimizer, mesh,
                                  ema_update=make_ema_update(0.99, True))
        shard_grad = jax.jit(jax.value_and_grad(
            lambda p, b: loss_obj(model.apply(p, b).data, b.data)[0]))

        bs = per_card * n
        n_train = (trainer_steps + 2) * bs
        trainer = _trainer(cfg, workdir, seed, n_train, bs, bs, mesh=mesh)
        trainer.set_dataset(_qm9_dataset(cfg, n_train + bs, seed))
        trainer.init_metrics()
        batches = iter(trainer.dl_train)
        first = next(batches)
        log(f"phase 4 set-up: {time.perf_counter() - t0:.3f} s")

        def highest(lower):
            def f():
                with jax.default_matmul_precision("highest"):
                    return lower()
            return f

        compile_s = _compile_in_threads({
            "DP step": highest(lambda: step.lower(params, opt_state, ema,
                                                  stacked)),
            "single-device gradient": highest(
                lambda: shard_grad.lower(params, shards[0])),
            "Trainer(mesh) step": lambda: trainer.lower_train_step(
                put_sharded(first, mesh)),
        })
        log("phase 4 lower + compile, concurrently: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in compile_s.items()))

        with jax.default_matmul_precision("highest"):
            new_params, _, _, loss, _ = step(
                jax.tree_util.tree_map(jnp.copy, params), opt_state, ema,
                stacked)
            loss = float(_block(loss))
            ref = [shard_grad(params, b) for b in shards]
        ref_loss = float(np.mean([float(l) for l, _ in ref]))
        ref_grads = jax.tree_util.tree_map(
            lambda *g: sum(g) / len(g), *[g for _, g in ref])
        ref_params = optax.apply_updates(
            params, optimizer.update(ref_grads, opt_state, params)[0])
        # the assertions of __graft_entry__.dryrun_multichip: the loss, and
        # the updated parameters within rtol 1e-4, atol 1e-5 (an update
        # smaller than the parameter's float32 spacing is judged by atol)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5, atol=1e-6)
        worst = max(
            float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                         / (1e-5 + 1e-4 * np.abs(np.asarray(b)))))
            for a, b in zip(jax.tree_util.tree_leaves(new_params),
                            jax.tree_util.tree_leaves(ref_params)))
        log(f"phase 4 DP step vs single device: loss {loss:.6g} vs "
            f"{ref_loss:.6g}; updated parameters |a - b| / (1e-5 + "
            f"1e-4 |b|) at most {worst:.3e} (must be <= 1)")
        check(worst <= 1.0, "phase 4: the DP step's update differs from "
              "the single-device update")

        p0 = jax.device_get(trainer.params)
        t0 = time.perf_counter()
        trainer.batch_step(first)
        _block(trainer.params)
        first_s = time.perf_counter() - t0
        losses = [trainer.batch_losses["loss"]]
        t0 = time.perf_counter()
        for _, batch in zip(range(trainer_steps - 1), batches):
            trainer.batch_step(batch)
            losses.append(trainer.batch_losses["loss"])
        _block(trainer.params)
        dt = (time.perf_counter() - t0) / max(1, trainer_steps - 1)
        losses = np.asarray(jax.device_get(losses), np.float64)
        check(np.all(np.isfinite(losses)),
              f"phase 4 Trainer(mesh): loss {losses}")
        moved = tree_rel_linf(trainer.params, p0)
        check(moved > 0, "phase 4 Trainer(mesh): parameters unchanged")
        log(f"phase 4 Trainer(mesh) batch {bs}: first step {first_s:.3f} s,"
            f" then {dt * 1e3:.3f} ms/step (host loader included; smoke "
            f"reading); loss {losses[0]:.6g} -> {losses[-1]:.6g}")
        trainer.dl_train.close()
        trainer.dl_val.close()
        log(f"phase 4 peak_bytes_in_use per card: "
            f"{[_peak_bytes(d) for d in devices]}")
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
        if prev is None:
            os.environ.pop("E3_COMPUTE_DTYPE", None)
        else:
            os.environ["E3_COMPUTE_DTYPE"] = prev


# ---------------------------------------------------------------- main


def phases_for(chips: int):
    if chips == 1:
        return ("device", "main_path", "parity", "workloads")
    if chips == 4:
        return ("device", "data_parallel")
    raise ValueError(f"--chips takes 1 or 4, not {chips}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the data-parallel phase on 4 cards")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from concurrent.futures import ThreadPoolExecutor

    args = parse_args(argv)
    log = Log()
    phases = phases_for(args.chips)
    pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="compile")
    prepared = {}
    try:
        devices = phase_device(log, args.chips)
        from equivariant_nn_zoo.utils.compile_cache import setup_compile_cache
        from equivariant_nn_zoo.utils.device_info import device_record

        log(f"compile cache: {setup_compile_cache()}")
        t_start = time.perf_counter()
        if "main_path" in phases:
            phase_main_path(log, devices[0], args.seed, after_timing=lambda:
                            prepared.update(start_workload_compiles(
                                pool, args.seed)))
        if "parity" in phases:
            phase_parity(log, args.seed)
        if "workloads" in phases:
            phase_workloads(log, devices[0], args.seed, prepared)
        if "data_parallel" in phases:
            phase_data_parallel(log, devices, args.seed)
        log(f"all phases passed in {time.perf_counter() - t_start:.3f} s")
        record = device_record()
    except Exception as e:  # report the failed phase, exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    print(json.dumps({"ok": True, "device": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
