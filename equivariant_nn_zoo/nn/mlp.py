"""Scalar MLP with normalized parameterization (replaces
``e3nn.nn.FullyConnectedNet``, used for the radial weight network at
e3_layers/nn/message_passing.py:74-79)."""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from ..ops.gate import normalize2mom


class FullyConnectedNet:
    """ops-style component: param_specs() + apply(params, x).

    Weights are stored N(0,1) and scaled by 1/sqrt(fan_in) at apply time;
    the activation (normalized to unit second moment, as e3nn does) runs
    between layers (not after the last).
    """

    def __init__(self, dims: List[int], activation="ssp"):
        assert len(dims) >= 2
        self.dims = list(dims)
        self.act = normalize2mom(activation)

    def param_specs(self):
        return {
            f"w{i}": ((self.dims[i], self.dims[i + 1]), "normal")
            for i in range(len(self.dims) - 1)
        }

    def apply(self, params, x: jnp.ndarray, compute_dtype=None) -> jnp.ndarray:
        import os

        if compute_dtype is None:
            compute_dtype = os.environ.get("E3_COMPUTE_DTYPE", "bfloat16")
        cd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[str(compute_dtype)]
        n = len(self.dims) - 1
        x = x.astype(cd)
        for i in range(n):
            w = params[f"w{i}"] / (float(self.dims[i]) ** 0.5)
            x = jax.lax.dot_general(
                x, w.astype(cd),
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            if i < n - 1:
                x = self.act(x).astype(cd)
        return x
