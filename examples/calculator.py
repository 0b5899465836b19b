#!/usr/bin/env python
"""MD force-provider adapter — script parity for the reference's
``torchMD.ipynb`` (C30 in SURVEY.md §2): wrap a trained energy(+force) model
as a calculator usable from an MD loop (ASE-compatible interface shape).

The jitted potential compiles once for a fixed atom count; each MD step is a
single device call returning (energy, forces).
"""

import os
import sys
from functools import partial

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


class E3Calculator:
    """ASE-style calculator backed by an equivariant_nn_zoo model.

    Example:
        calc = E3Calculator.from_config('config_energy', params)
        e, f = calc.compute(species_Z, positions)
    """

    implemented_properties = ["energy", "forces"]

    def __init__(self, model, params, r_max: float, edge_capacity: int = 4096,
                 node_capacity: int = 256):
        import jax

        self.model = model
        self.params = params
        self.r_max = float(r_max)
        self.node_capacity = node_capacity
        self.edge_capacity = edge_capacity

        from equivariant_nn_zoo.data.compute_edge import radius_graph_fixed

        def potential(params, pos, species, node_mask, node_segment):
            import jax.numpy as jnp

            dummy = pos.shape[0] - 1
            ei, emask, eseg, _ = radius_graph_fixed(
                pos, node_segment, node_mask, self.edge_capacity, self.r_max,
                dummy,
            )
            data = {
                "pos": pos,
                "species": species,
                "atom_types": species,
                "edge_index": ei,
                "_edge_mask": emask,
                "_edge_segment": eseg,
                "_node_mask": node_mask,
                "_node_segment": node_segment,
                "_graph_mask": jnp.ones((1, 1), jnp.float32),
                "_n_nodes": jnp.sum(node_mask).astype(jnp.int32).reshape(1, 1),
            }
            attrs = {
                "pos": ("node", "1x1o"),
                "species": ("node", "1x0e"),
                "atom_types": ("node", "1x0e"),
            }

            def energy_of(p):
                out, _ = self.model.apply(params, {**data, "pos": p}, attrs)
                key = "total_energy" if "total_energy" in out else "energy"
                return jnp.sum(out[key]), out

            (e, out), grad = jax.value_and_grad(energy_of, has_aux=True)(pos)
            return e, -grad

        self._potential = jax.jit(potential)

    @classmethod
    def from_config(cls, config_name, params=None, model_path=None, **kwargs):
        import jax

        from equivariant_nn_zoo.models import get_config
        from equivariant_nn_zoo.utils import build

        cfg = get_config(config_name)
        model = build(cfg.model_config)
        # unwrap a force-head model: the calculator differentiates itself
        if hasattr(model, "func"):
            model = model.func
        if params is None and model_path:
            from equivariant_nn_zoo.utils.saveload import load_file

            params = load_file(model_path, enforced_format="pickle")
            if "func" in params and hasattr(model, "layers"):
                params = params["func"]
            params = jax.device_put(params)
        elif params is None:
            params = model.init(jax.random.PRNGKey(0))
        elif "func" in params:
            params = params["func"]
        return cls(model, params, r_max=float(cfg.model_config.r_max),
                   **kwargs)

    def compute(self, species, positions):
        """species [n], positions [n, 3] -> (energy float, forces [n, 3])."""
        import jax.numpy as jnp

        n = len(species)
        N = self.node_capacity
        assert n < N, "raise node_capacity"
        pos = np.zeros((N, 3), np.float32)
        pos[:n] = positions
        spec = np.zeros((N, 1), np.int32)
        spec[:n, 0] = species
        node_mask = np.zeros((N, 1), np.float32)
        node_mask[:n] = 1.0
        node_segment = np.full((N,), 1, np.int32)
        node_segment[:n] = 0
        e, f = self._potential(
            self.params, jnp.asarray(pos), jnp.asarray(spec),
            jnp.asarray(node_mask), jnp.asarray(node_segment),
        )
        return float(e), np.asarray(f)[:n]

    # ASE Calculator protocol ------------------------------------------------

    def calculate(self, atoms=None, properties=("energy",),
                  system_changes=()):
        e, f = self.compute(atoms.get_atomic_numbers(), atoms.get_positions())
        self.results = {"energy": e, "forces": f}


if __name__ == "__main__":
    calc = E3Calculator.from_config("config_energy",
                                    node_capacity=64, edge_capacity=1024)
    rng = np.random.default_rng(0)
    Z = rng.choice([1, 6, 7, 8], size=12)
    pos = rng.normal(size=(12, 3)) * 1.5
    e, f = calc.compute(Z, pos)
    print("energy:", e)
    print("forces shape:", f.shape, "finite:", np.isfinite(f).all())
    # finite-difference sanity: forces match -dE/dx
    eps = 1e-2
    pos_p = pos.copy()
    pos_p[0, 0] += eps
    e_p, _ = calc.compute(Z, pos_p)
    pos_m = pos.copy()
    pos_m[0, 0] -= eps
    e_m, _ = calc.compute(Z, pos_m)
    fd = -(e_p - e_m) / (2 * eps)
    print(f"force[0,0]={f[0,0]:.4f} vs finite-diff {fd:.4f}")
