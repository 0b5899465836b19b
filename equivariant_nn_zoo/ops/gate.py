"""Equivariant nonlinearities: activations registry, Gate, NormActivation.

Reference parity: activation registry at e3_layers/utils/utils.py:69-84,
``e3nn.nn.Gate`` / ``e3nn.nn.NormActivation`` as used by MessagePassing
(e3_layers/nn/message_passing.py:191-219) and ResBlock
(e3_layers/nn/pointwise.py:112).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import jax
import jax.numpy as jnp

from .irreps import Irreps


def shifted_softplus(x):
    return jax.nn.softplus(x) - math.log(2.0)


def tanhlu(x):
    return jnp.tanh(x) * jnp.abs(x)


activations: Dict[str, Callable] = {
    "abs": jnp.abs,
    "tanh": jnp.tanh,
    "ssp": shifted_softplus,
    "silu": jax.nn.silu,
    "tanhlu": tanhlu,
}


def resolve_activation(act) -> Callable:
    return activations[act] if isinstance(act, str) else act


def _second_moment(fn) -> float:
    """E_{x~N(0,1)}[fn(x)^2] via Gauss-Hermite quadrature (host-side)."""
    import numpy as np

    x, w = np.polynomial.hermite_e.hermegauss(128)
    y = np.asarray(fn(jnp.asarray(x, jnp.float32)))
    return float((w * y * y).sum() / w.sum())


_NORM_CACHE: Dict[int, float] = {}


def normalize2mom(fn) -> Callable:
    """Rescale an activation to unit second moment under N(0,1) input —
    the variance-preserving trick e3nn applies inside Gate / Activation /
    FullyConnectedNet; without it deep equivariant stacks shrink (or blow
    up) multiplicatively per layer."""
    fn = resolve_activation(fn)
    key = id(fn)
    if key not in _NORM_CACHE:
        _NORM_CACHE[key] = _second_moment(fn)
    cst = _NORM_CACHE[key] ** -0.5
    if abs(cst - 1.0) < 1e-4:
        return fn
    return lambda x: fn(x) * cst


class Gate:
    """Gated nonlinearity: ``irreps_in = scalars + gates + gated``.

    Scalars get their own activation; gates are activated scalars that
    multiply the gated (l>0) irreps channel-wise.  Output irreps are
    ``scalars + gated`` (gates are consumed).
    """

    def __init__(self, irreps_scalars, act_scalars, irreps_gates, act_gates, irreps_gated):
        self.irreps_scalars = Irreps(irreps_scalars)
        self.irreps_gates = Irreps(irreps_gates)
        self.irreps_gated = Irreps(irreps_gated)
        self.act_scalars = [normalize2mom(a) for a in act_scalars]
        self.act_gates = [normalize2mom(a) for a in act_gates]
        assert self.irreps_gates.num_irreps == sum(
            mi.mul for mi in self.irreps_gated
        ), "need one gate per gated channel"
        for mi in self.irreps_scalars + self.irreps_gates:
            assert mi.ir.l == 0, "scalars/gates must be l=0"
        self.irreps_in = self.irreps_scalars + self.irreps_gates + self.irreps_gated
        self.irreps_out = self.irreps_scalars + self.irreps_gated

        # fused lowering plan: merge consecutive scalar slots sharing one
        # activation (acts vary only by parity in practice), and expand the
        # gates over the gated channels with ONE 0/1 matmul instead of
        # per-slot [*, mul, d] reshapes with 1/3/5/7-wide minor axes
        self._scalar_runs = []  # (ofs, dim, act)
        ofs = 0
        for mi, raw, act in zip(self.irreps_scalars, act_scalars,
                                self.act_scalars):
            if self._scalar_runs and self._scalar_runs[-1][3] is raw:
                self._scalar_runs[-1][1] += mi.dim
            else:
                self._scalar_runs.append([ofs, mi.dim, act, raw])
            ofs += mi.dim
        self._gates_fused = (
            len({id(a) for a in act_gates}) <= 1 and len(act_gates) > 0
        )
        if self.irreps_gated.dim:
            import numpy as np

            gated_dim = self.irreps_gated.dim
            dg = self.irreps_gates.dim
            Eg = np.zeros((dg, gated_dim), np.float32)
            col = 0
            gch = 0
            for mi in self.irreps_gated:
                for u in range(mi.mul):
                    Eg[gch, col: col + mi.ir.dim] = 1.0
                    gch += 1
                    col += mi.ir.dim
            self._Eg = Eg
        else:
            self._Eg = None

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        ds = self.irreps_scalars.dim
        dg = self.irreps_gates.dim
        scalars = x[..., :ds]
        gates = x[..., ds : ds + dg]
        gated = x[..., ds + dg :]
        outs: List[jnp.ndarray] = []
        for ofs, dim, act, _raw in self._scalar_runs:
            outs.append(act(scalars[..., ofs : ofs + dim]))
        if dg and self._gates_fused and self._Eg is not None:
            g = self.act_gates[0](gates)
            gexp = jax.lax.dot_general(
                g, jnp.asarray(self._Eg, x.dtype),
                dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).astype(x.dtype)
            outs.append(gated * gexp)
        elif dg:
            ofs = 0
            acted_gates = []
            for mi, act in zip(self.irreps_gates, self.act_gates):
                acted_gates.append(act(gates[..., ofs : ofs + mi.dim]))
                ofs += mi.dim
            g = jnp.concatenate(acted_gates, axis=-1)
            ofs = 0
            gofs = 0
            for mi in self.irreps_gated:
                chunk = gated[..., ofs : ofs + mi.dim].reshape(
                    gated.shape[:-1] + (mi.mul, mi.ir.dim)
                )
                gate = g[..., gofs : gofs + mi.mul, None]
                outs.append(
                    (chunk * gate).reshape(gated.shape[:-1] + (mi.dim,))
                )
                ofs += mi.dim
                gofs += mi.mul
        return (
            jnp.concatenate(outs, axis=-1)
            if outs
            else jnp.zeros(x.shape[:-1] + (0,), dtype=x.dtype)
        )

class NormActivation:
    """Norm-based nonlinearity: x -> x/|x| * f(|x|) per irrep channel.

    ``normalize=True`` matches e3nn's default as used in ResBlock
    (e3_layers/nn/pointwise.py:112) and MessagePassing's "norm" mode
    (e3_layers/nn/message_passing.py:212-219).
    """

    def __init__(
        self,
        irreps_in,
        scalar_nonlinearity,
        normalize: bool = True,
        epsilon: float = None,
        bias: bool = False,
    ):
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = self.irreps_in
        self.act = normalize2mom(scalar_nonlinearity)
        self.normalize = normalize
        self.epsilon = epsilon
        assert not bias, "bias not supported"
        # batched-by-degree plan: consecutive slots of equal ir.dim merge
        # their (mul) channel axes into ONE [.., sum_mul, d] chunk — the
        # norm/scale math is per (channel) and degree-uniform, so the
        # e/o-paired standard layout runs in 5 chunks instead of 10 (and
        # 10+ fewer minor-axis relayouts per call).
        self._runs = []  # (col0, col1, total_mul, d)
        ofs = 0
        for mi in self.irreps_in:
            d = mi.ir.dim
            if self._runs and self._runs[-1][3] == d:
                c0, _, m, _ = self._runs[-1]
                self._runs[-1] = (c0, ofs + mi.dim, m + mi.mul, d)
            else:
                self._runs.append((ofs, ofs + mi.dim, mi.mul, d))
            ofs += mi.dim

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        outs = []
        eps = self.epsilon if self.epsilon is not None else 1e-24
        for c0, c1, m, d in self._runs:
            chunk = x[..., c0:c1].reshape(x.shape[:-1] + (m, d))
            norm2 = jnp.sum(chunk * chunk, axis=-1, keepdims=True)
            norm = jnp.sqrt(norm2 + eps)
            scale = self.act(norm)
            if self.normalize:
                scale = scale / norm
            outs.append((chunk * scale).reshape(x.shape[:-1] + (c1 - c0,)))
        return jnp.concatenate(outs, axis=-1)
