"""Real spherical harmonics, evaluated as dense einsum contractions.

Replaces ``e3nn.o3.SphericalHarmonics`` (reference usage:
e3_layers/nn/embedding.py:130-178).  For each degree ``l`` we precompute a
coefficient tensor ``A_l`` with ``Y_l(x) = A_l · x^(⊗l)`` via the
Clebsch-Gordan recursion ``Y_l ∝ CG(l-1, 1, l) · (Y_{l-1} ⊗ x)``, which makes
the harmonics exactly equivariant w.r.t. the same Wigner matrices as every
other op in this framework.  Evaluation is a handful of tiny einsums that XLA
fuses into the surrounding computation; no torch-script codegen needed.

Normalizations (matching e3nn's options):
- "component": |Y_l(x)| = sqrt(2l+1) on the unit sphere (reference default,
  e3_layers/nn/embedding.py:148).
- "norm":      |Y_l(x)| = 1.
- "integral":  component / sqrt(4 pi).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp

from .irreps import Irreps
from .wigner import wigner_3j


@lru_cache(maxsize=None)
def _sh_coeff(l: int) -> np.ndarray:
    """Coefficient tensor of shape (3,)*l + (2l+1,), component-normalized."""
    if l == 0:
        return np.ones((1,))
    if l == 1:
        return np.sqrt(3.0) * np.eye(3)
    prev = _sh_coeff(l - 1)  # (3,)*(l-1) + (2l-1,)
    c = wigner_3j(l - 1, 1, l)  # (2l-1, 3, 2l+1)
    a = np.tensordot(prev, c, axes=[[-1], [0]])  # (3,)*(l-1) + (3, 2l+1)
    # fix the normalization numerically: |Y_l| must be sqrt(2l+1) on the sphere
    v = np.array([0.2, -0.5, 0.8437])
    v = v / np.linalg.norm(v)
    y = a
    for _ in range(l):
        y = np.tensordot(v, y, axes=[[0], [0]])
    a = a * np.sqrt(2 * l + 1) / np.linalg.norm(y)
    return a


def spherical_harmonics(
    ls,
    x: jnp.ndarray,
    normalize: bool = True,
    normalization: str = "component",
    eps: float = 1e-12,
) -> jnp.ndarray:
    """Evaluate real spherical harmonics of degrees ``ls`` at points ``x``.

    Args:
        ls: int, list of ints, or an Irreps (degrees taken in order).
        x: [..., 3] array (the l=1 convention is the identity on x).
        normalize: normalize input vectors first (safe at x=0: returns 0
            for l >= 1, so padded zero-edges produce inert features).
        normalization: "component" | "norm" | "integral".

    Returns [..., sum(2l+1)].
    """
    if isinstance(ls, int):
        ls = [ls]
    elif isinstance(ls, (str, Irreps)):
        ls = [mi.ir.l for mi in Irreps(ls) for _ in range(mi.mul)]
    if normalize:
        # smooth safe norm: gradient is exactly 0 (not NaN) at x = 0, so
        # padded zero-edges stay inert under force backprop
        n = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True) + eps * eps)
        x = x / n
    outs = []
    # share powers of x across degrees
    max_l = max(ls)
    ys = {}
    y = None
    for l in range(0, max_l + 1):
        if l == 0:
            ys[0] = jnp.ones(x.shape[:-1] + (1,), dtype=x.dtype)
            continue
        a = jnp.asarray(_sh_coeff(l), dtype=x.dtype)
        if l == 1:
            y = jnp.einsum("...i,ij->...j", x, a)
        else:
            # contract previous (component-normalized) y with one more x via
            # the recursion tensor, renormalized to component scale
            c = jnp.asarray(_recursion_coeff(l), dtype=x.dtype)
            y = jnp.einsum("...i,...j,ijk->...k", ys[l - 1], x, c)
        ys[l] = y
    for l in ls:
        scale = 1.0
        if normalization == "norm":
            scale = 1.0 / np.sqrt(2 * l + 1)
        elif normalization == "integral":
            scale = 1.0 / np.sqrt(4 * np.pi)
        outs.append(ys[l] * scale if scale != 1.0 else ys[l])
    return jnp.concatenate(outs, axis=-1)


@lru_cache(maxsize=None)
def _recursion_coeff(l: int) -> np.ndarray:
    """Tensor R with Y_l = R · (Y_{l-1} ⊗ x̂), component normalization."""
    c = wigner_3j(l - 1, 1, l)
    # normalization: evaluate both sides at a fixed unit vector
    v = np.array([0.2, -0.5, 0.8437])
    v = v / np.linalg.norm(v)
    y_prev = _eval_np(l - 1, v)
    y = np.einsum("i,j,ijk->k", y_prev, v, c)
    return c * np.sqrt(2 * l + 1) / np.linalg.norm(y)


def _eval_np(l: int, v: np.ndarray) -> np.ndarray:
    a = _sh_coeff(l)
    y = a
    for _ in range(l):
        y = np.tensordot(v, y, axes=[[0], [0]])
    return y
