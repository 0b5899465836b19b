#!/usr/bin/env python
"""MD integration demo — script parity for the reference's ``torchMD.ipynb``
(C30 in SURVEY.md §2): drive velocity-Verlet NVE dynamics with a trained
(or random-init) energy model as the force provider, via
``examples/calculator.py``'s E3Calculator.

The reference notebook wires its model into torchmd's Integrator as an
external force term and steps Langevin dynamics; here the WHOLE Verlet step
(radius graph + model + force grad + position/velocity update) is one jitted
device call, and ``steps_per_block`` inner steps run under ``lax.fori_loop``
so a block is a single dispatch (no per-step host round trip).

Usage:
    python examples/md_dynamics.py [--config config_energy]
        [--model_path ckpt.pickle] [--steps 300] [--dt_fs 0.2] [--T 300]

NVE conservation: with a smooth potential and a small dt the total energy
drift over the run should be a small fraction of the kinetic-energy scale —
the script prints the drift ratio and exits nonzero if it exceeds 20%.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples.calculator import E3Calculator  # noqa: E402

# eV/(amu.Angstrom) -> Angstrom/fs^2 (ASE units convention)
EV_AMU_A = 0.009648533
# Boltzmann constant in eV/K
KB_EV = 8.617333262e-5

MASSES = {1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999}


def maxwell_boltzmann(rng, masses, T):
    """Velocities [n, 3] in Angstrom/fs at temperature T (Kelvin)."""
    # sigma_v = sqrt(kB T / m); kB T in eV, m in amu -> v in A/fs via the
    # same unit factor as the acceleration
    sigma = np.sqrt(KB_EV * T * EV_AMU_A / masses)[:, None]
    v = rng.normal(size=(len(masses), 3)) * sigma
    return v - v.mean(axis=0, keepdims=True)  # zero net momentum


def run_md(calc, species, pos0, dt_fs=0.2, n_steps=300, T=300.0, seed=0,
           steps_per_block=10, log=print):
    """Velocity-Verlet NVE; returns (positions, total-energy trajectory)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    masses = np.array([MASSES[int(z)] for z in species])
    n = len(species)
    N = calc.node_capacity

    # padded device state
    def pad(x, fill=0.0):
        out = np.full((N,) + x.shape[1:], fill, x.dtype)
        out[:n] = x
        return jnp.asarray(out)

    pos = pad(pos0.astype(np.float32))
    vel = pad(maxwell_boltzmann(rng, masses, T).astype(np.float32))
    m = pad(masses.astype(np.float32)[:, None], fill=1.0)  # [N, 1]
    spec = np.zeros((N, 1), np.int32)
    spec[:n, 0] = species
    spec = jnp.asarray(spec)
    node_mask = np.zeros((N, 1), np.float32)
    node_mask[:n] = 1.0
    node_mask = jnp.asarray(node_mask)
    node_segment = np.full((N,), 1, np.int32)
    node_segment[:n] = 0
    node_segment = jnp.asarray(node_segment)
    dt = jnp.float32(dt_fs)

    def force(p):
        e, f = calc._potential.__wrapped__(
            calc.params, p, spec, node_mask, node_segment
        )
        return e, f * node_mask

    def verlet_block(state, _):
        def one_step(i, st):
            p, v, f = st
            # kick-drift-kick with a single force eval per step
            v_half = v + 0.5 * dt * (f / m) * EV_AMU_A
            p_new = p + dt * v_half * node_mask
            _, f_new = force(p_new)
            v_new = v_half + 0.5 * dt * (f_new / m) * EV_AMU_A
            return p_new, v_new * node_mask, f_new

        import jax.lax as lax

        p, v, f = lax.fori_loop(0, steps_per_block, one_step, state)
        e_pot, _ = force(p)
        ke = 0.5 * jnp.sum(m * v * v) / EV_AMU_A
        return (p, v, f), (e_pot, ke)

    import jax

    blocked = jax.jit(lambda st: verlet_block(st, None))

    e0, f0 = jax.jit(force)(pos)
    state = (pos, vel, f0)
    e_traj = []
    ke0 = 0.5 * float(jnp.sum(m * vel * vel)) / EV_AMU_A
    e_traj.append((float(e0), ke0))
    n_blocks = max(1, n_steps // steps_per_block)
    for b in range(n_blocks):
        state, (e_pot, ke) = blocked(state)
        e_traj.append((float(e_pot), float(ke)))
        if log and (b % max(1, n_blocks // 10) == 0):
            log(f"block {b:4d}: E_pot={e_traj[-1][0]:+.4f} eV  "
                f"KE={e_traj[-1][1]:.4f} eV  "
                f"E_tot={sum(e_traj[-1]):+.4f} eV")
    return np.asarray(state[0])[:n], np.asarray(e_traj)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="config_energy")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dt_fs", type=float, default=0.2)
    ap.add_argument("--T", type=float, default=300.0)
    ap.add_argument("--n_atoms", type=int, default=12)
    args = ap.parse_args()

    calc = E3Calculator.from_config(
        args.config, model_path=args.model_path,
        node_capacity=64, edge_capacity=1024,
    )
    rng = np.random.default_rng(0)
    Z = rng.choice([1, 6, 8], size=args.n_atoms, p=[0.5, 0.3, 0.2])
    # loose random cluster, pre-relaxed spacing so forces start moderate
    pos = rng.normal(size=(args.n_atoms, 3)) * 2.0

    pos_f, e_traj = run_md(calc, Z, pos, dt_fs=args.dt_fs,
                           n_steps=args.steps, T=args.T)
    e_tot = e_traj.sum(axis=1)
    ke_scale = max(float(np.abs(e_traj[:, 1]).mean()), 1e-6)
    drift = abs(e_tot[-1] - e_tot[0])
    print(f"total-energy drift over {args.steps} steps: {drift:.5f} eV "
          f"({drift / ke_scale:.1%} of mean KE)")
    ok = drift / ke_scale < 0.2
    print("NVE conservation:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
