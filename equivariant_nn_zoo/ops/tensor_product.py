"""Irreps-aware tensor products and linear maps as pure-JAX einsum programs.

Replaces ``e3nn.o3.TensorProduct`` / ``Linear`` / ``FullyConnectedTensorProduct``
(used throughout the reference nn layers, e.g. e3_layers/nn/pointwise.py:54-100
and e3_layers/nn/message_passing.py:58-87).  Instead of TorchScript codegen we
compile each instruction list into a small set of einsums that XLA fuses; the
CG tables are closed-over constants.

Normalization follows e3nn's defaults (irrep_normalization="component",
path_normalization="element"): weights are stored N(0,1) and each path is
scaled at apply time by ``sqrt(dim(ir_out) / fan_total)`` where fan_total sums
the contracted fan-in of every instruction writing to the same output slot.
This keeps activation variances ~1 through deep stacks, matching the training
dynamics of the reference models.

These op classes are *static* (hashable config + constant tables).  Parameters
live in external pytrees: every op exposes ``param_specs()`` and
``apply(params, ...)`` so optax/EMA/checkpointing work on plain dicts.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .irreps import Irrep, Irreps
from .wigner import wigner_3j


class Instruction(NamedTuple):
    i_in1: int
    i_in2: int
    i_out: int
    mode: str  # "uvw" | "uvu"
    has_weight: bool
    path_weight: float = 1.0


def _normalize_instructions(
    irreps_in1: Irreps,
    irreps_in2: Irreps,
    irreps_out: Irreps,
    instructions: List[Tuple],
) -> List[Instruction]:
    """Attach e3nn-style path weights: sqrt(d_out / fan_total_per_output)."""
    raw = [Instruction(*ins[:5]) for ins in instructions]

    def fan(ins: Instruction) -> float:
        mul1 = irreps_in1[ins.i_in1].mul
        mul2 = irreps_in2[ins.i_in2].mul
        if ins.mode == "uvw":
            return mul1 * mul2
        if ins.mode == "uvu":
            return mul2
        raise ValueError(f"unsupported mode {ins.mode}")

    fan_total: Dict[int, float] = {}
    for ins in raw:
        fan_total[ins.i_out] = fan_total.get(ins.i_out, 0.0) + fan(ins)
    out = []
    for ins in raw:
        d_out = irreps_out[ins.i_out].ir.dim
        alpha = (d_out / fan_total[ins.i_out]) ** 0.5
        out.append(ins._replace(path_weight=alpha))
    return out


class TensorProduct:
    """Instruction-list tensor product over irreps (modes uvw, uvu).

    Weight layout is one flat vector; ``shared_weights=False`` means the
    caller passes per-element weights of shape [..., weight_numel]
    (the per-edge weights of the factorized convolution,
    e3_layers/nn/message_passing.py:93-106).
    """

    def __init__(
        self,
        irreps_in1,
        irreps_in2,
        irreps_out,
        instructions: List[Tuple],
        shared_weights: bool = True,
        internal_weights: Optional[bool] = None,
    ):
        self.irreps_in1 = Irreps(irreps_in1)
        self.irreps_in2 = Irreps(irreps_in2)
        self.irreps_out = Irreps(irreps_out)
        self.instructions = _normalize_instructions(
            self.irreps_in1, self.irreps_in2, self.irreps_out, instructions
        )
        self.shared_weights = shared_weights
        self.internal_weights = (
            shared_weights if internal_weights is None else internal_weights
        )
        for ins in self.instructions:
            ir1 = self.irreps_in1[ins.i_in1].ir
            ir2 = self.irreps_in2[ins.i_in2].ir
            ir3 = self.irreps_out[ins.i_out].ir
            assert ir3 in ir1 * ir2, f"forbidden path {ir1}*{ir2}->{ir3}"
            if ins.mode == "uvu":
                assert (
                    self.irreps_out[ins.i_out].mul == self.irreps_in1[ins.i_in1].mul
                ), "uvu requires mul_out == mul_in1"

        self.weight_numel = sum(
            int(np.prod(self._weight_shape(ins)))
            for ins in self.instructions
            if ins.has_weight
        )

    def _apply_uvu_grouped(self, weight, x1, x2):
        """Grouped lowering for shared-weight all-uvu products.

        Per (i_in1, i_in2) pair with L paths: ONE matmul contracts the
        stacked weights into x2 (``bw[..., L, u, j] = sum_v W[L,u,v]
        b[..., v, j]``), then each path is a small per-(l1,l2,l3) CG
        contraction elementwise in (batch, u).  Identical math to the
        per-instruction einsums (same weight offsets), fewer and better-
        shaped ops."""
        slices1 = self.irreps_in1.slices()
        slices2 = self.irreps_in2.slices()
        # instruction -> flat-weight offset, in declaration order
        offs = []
        w_ofs = 0
        for ins in self.instructions:
            n = int(np.prod(self._weight_shape(ins)))
            offs.append(w_ofs)
            w_ofs += n
        groups: Dict[Tuple[int, int], list] = {}
        for ins, o in zip(self.instructions, offs):
            groups.setdefault((ins.i_in1, ins.i_in2), []).append((ins, o))

        out_chunks: Dict[int, jnp.ndarray] = {}
        for (i1, i2), items in groups.items():
            mi1 = self.irreps_in1[i1]
            mi2 = self.irreps_in2[i2]
            mul1, d1 = mi1.mul, mi1.ir.dim
            mul2, d2 = mi2.mul, mi2.ir.dim
            a = x1[..., slices1[i1]].reshape(x1.shape[:-1] + (mul1, d1))
            b = x2[..., slices2[i2]].reshape(x2.shape[:-1] + (mul2, d2))
            W = jnp.stack(
                [
                    weight[o: o + mul1 * mul2].reshape(mul1, mul2)
                    for _, o in items
                ]
            )  # [L, u, v]
            bw = jnp.einsum("...vj,Luv->...Luj", b, W)
            for idx, (ins, _) in enumerate(items):
                mi3 = self.irreps_out[ins.i_out]
                c = jnp.asarray(
                    wigner_3j(mi1.ir.l, mi2.ir.l, mi3.ir.l), dtype=x1.dtype
                ) * ins.path_weight
                chunk = jnp.einsum(
                    "...ui,...uj,ijk->...uk", a, bw[..., idx, :, :], c
                )
                chunk = chunk.reshape(chunk.shape[:-2] + (mi3.dim,))
                if ins.i_out in out_chunks:
                    out_chunks[ins.i_out] = out_chunks[ins.i_out] + chunk
                else:
                    out_chunks[ins.i_out] = chunk
        batch_shape = jnp.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        outs = []
        for i, mi in enumerate(self.irreps_out):
            if i in out_chunks:
                outs.append(
                    jnp.broadcast_to(out_chunks[i], batch_shape + (mi.dim,))
                )
            else:
                outs.append(
                    jnp.zeros(batch_shape + (mi.dim,), dtype=x1.dtype)
                )
        return jnp.concatenate(outs, axis=-1)

    def _weight_shape(self, ins: Instruction) -> Tuple[int, ...]:
        mul1 = self.irreps_in1[ins.i_in1].mul
        mul2 = self.irreps_in2[ins.i_in2].mul
        if ins.mode == "uvw":
            return (mul1, mul2, self.irreps_out[ins.i_out].mul)
        return (mul1, mul2)  # uvu

    def param_specs(self):
        if not self.internal_weights or self.weight_numel == 0:
            return {}
        return {"weight": ((self.weight_numel,), "normal")}

    def apply(self, params, x1: jnp.ndarray, x2: jnp.ndarray, weight=None):
        """x1 [..., dim1], x2 [..., dim2] -> [..., dim_out].

        ``weight``: flat [weight_numel] (shared) or [..., weight_numel].
        """
        if self.internal_weights:
            weight = params["weight"]
        if (
            weight is not None
            and weight.ndim == 1
            and all(
                ins.mode == "uvu" and ins.has_weight
                for ins in self.instructions
            )
            and len(self.instructions) > 4
        ):
            # shared-weight all-uvu products (the Pairwise/hamiltonian head)
            # take the grouped weight-first path: contracting W into x2 per
            # (i_in1, i_in2) pair before the CG keeps every intermediate at
            # [..., mul, d] instead of the [..., mul, mul, ...] outers the
            # generic einsum order can materialize
            return self._apply_uvu_grouped(weight, x1, x2)
        slices1 = self.irreps_in1.slices()
        slices2 = self.irreps_in2.slices()
        out_chunks: Dict[int, jnp.ndarray] = {}
        w_ofs = 0
        for ins in self.instructions:
            mi1 = self.irreps_in1[ins.i_in1]
            mi2 = self.irreps_in2[ins.i_in2]
            mi3 = self.irreps_out[ins.i_out]
            a = x1[..., slices1[ins.i_in1]].reshape(
                x1.shape[:-1] + (mi1.mul, mi1.ir.dim)
            )
            b = x2[..., slices2[ins.i_in2]].reshape(
                x2.shape[:-1] + (mi2.mul, mi2.ir.dim)
            )
            c = jnp.asarray(
                wigner_3j(mi1.ir.l, mi2.ir.l, mi3.ir.l), dtype=x1.dtype
            ) * ins.path_weight
            if ins.has_weight:
                shape = self._weight_shape(ins)
                n = int(np.prod(shape))
                if weight.ndim == 1:
                    w = weight[w_ofs : w_ofs + n].reshape(shape)
                else:
                    w = weight[..., w_ofs : w_ofs + n].reshape(
                        weight.shape[:-1] + shape
                    )
                w_ofs += n
                if ins.mode == "uvw":
                    if w.ndim == 3:
                        chunk = jnp.einsum("...ui,...vj,ijk,uvw->...wk", a, b, c, w)
                    else:
                        chunk = jnp.einsum(
                            "...ui,...vj,ijk,...uvw->...wk", a, b, c, w
                        )
                else:  # uvu
                    if w.ndim == 2:
                        chunk = jnp.einsum("...ui,...vj,ijk,uv->...uk", a, b, c, w)
                    else:
                        chunk = jnp.einsum(
                            "...ui,...vj,ijk,...uv->...uk", a, b, c, w
                        )
            else:
                if ins.mode == "uvw":
                    raise ValueError("uvw requires weights")
                chunk = jnp.einsum("...ui,...vj,ijk->...uk", a, b, c)
            chunk = chunk.reshape(chunk.shape[:-2] + (mi3.dim,))
            if ins.i_out in out_chunks:
                out_chunks[ins.i_out] = out_chunks[ins.i_out] + chunk
            else:
                out_chunks[ins.i_out] = chunk
        batch_shape = jnp.broadcast_shapes(x1.shape[:-1], x2.shape[:-1])
        outs = []
        for i, mi in enumerate(self.irreps_out):
            if i in out_chunks:
                outs.append(
                    jnp.broadcast_to(out_chunks[i], batch_shape + (mi.dim,))
                )
            else:
                outs.append(jnp.zeros(batch_shape + (mi.dim,), dtype=x1.dtype))
        return jnp.concatenate(outs, axis=-1) if outs else jnp.zeros(
            batch_shape + (0,), dtype=x1.dtype
        )


def fully_connected_tp(irreps_in1, irreps_in2, irreps_out) -> TensorProduct:
    """All-paths uvw tensor product with internal weights.

    Reference parity: ``e3nn.o3.FullyConnectedTensorProduct``
    (self-connection at e3_layers/nn/message_passing.py:83-87).
    """
    irreps_in1, irreps_in2, irreps_out = (
        Irreps(irreps_in1),
        Irreps(irreps_in2),
        Irreps(irreps_out),
    )
    instructions = []
    for i1, mi1 in enumerate(irreps_in1):
        for i2, mi2 in enumerate(irreps_in2):
            for io, mio in enumerate(irreps_out):
                if mio.ir in mi1.ir * mi2.ir:
                    instructions.append((i1, i2, io, "uvw", True))
    return TensorProduct(
        irreps_in1, irreps_in2, irreps_out, instructions, shared_weights=True
    )


class Linear:
    """Equivariant linear map: mixes multiplicities within equal irreps.

    Reference parity: ``e3nn.o3.Linear`` with optional biases on scalar (0e)
    outputs (e3_layers/nn/pointwise.py:14-30).  Weights are stored N(0,1) and
    scaled by 1/sqrt(fan_in) at apply time (normalized parameterization).
    """

    def __init__(self, irreps_in, irreps_out, biases: bool = False):
        self.irreps_in = Irreps(irreps_in)
        self.irreps_out = Irreps(irreps_out)
        self.paths: List[Tuple[int, int]] = []
        for io, mio in enumerate(self.irreps_out):
            for ii, mii in enumerate(self.irreps_in):
                if mii.ir == mio.ir:
                    self.paths.append((ii, io))
        fan: Dict[int, int] = {}
        for ii, io in self.paths:
            fan[io] = fan.get(io, 0) + self.irreps_in[ii].mul
        self.alphas = {io: (1.0 / fan[io]) ** 0.5 for io in fan}
        self.biases = biases
        self.bias_slots = (
            [io for io, mio in enumerate(self.irreps_out) if mio.ir == Irrep("0e")]
            if biases
            else []
        )
        self._build_lgroups()
        # Widest input column any path actually reads.  Configs routinely
        # declare irreps_in wider than the producing layer's true output
        # (e.g. an energy head declared on the full node_features string
        # atop a shallow trunk whose tp_path_exists narrowing dropped the
        # tail slots) — legal as long as every slot with a live path is
        # present.  Reading PAST the input silently clamps the slice and
        # garbles the reshape, so validate against this bound at apply.
        in_slices = self.irreps_in.slices()
        self._max_read = max(
            (in_slices[ii].stop for ii, _ in self.paths), default=0
        )

    def _build_lgroups(self):
        """Batched-by-degree lowering plan.

        The per-path ``apply`` loop costs one minor-axis reshape + one small
        dot + one concat slot per irrep — 10+ ops and several full-tensor
        relayouts for a typical l_max=4 feature.  When every path pairs a
        unique input slot with a unique output slot (true for any
        simplified->simplified map, i.e. all the hot Linears), consecutive
        output slots of equal (dim, mul) whose input slots are also
        consecutive and of equal (dim, mul) collapse into ONE batched
        einsum ``...sud,suw->...swd`` over the contiguous column range —
        e.g. 5 dots instead of 10 for the standard e/o-paired layout.
        ``self._lgroups`` is None when the structure is not eligible
        (fall back to the per-path loop)."""
        self._lgroups = None
        ins_of_out: Dict[int, int] = {}
        outs_of_in: Dict[int, int] = {}
        for ii, io in self.paths:
            if io in ins_of_out or ii in outs_of_in:
                return  # not a slot bijection
            ins_of_out[io] = ii
            outs_of_in[ii] = io
        in_slices = self.irreps_in.slices()
        out_slices = self.irreps_out.slices()
        groups = []
        io = 0
        n_out = len(self.irreps_out)
        while io < n_out:
            mio = self.irreps_out[io]
            if io not in ins_of_out:
                groups.append(dict(kind="zero", io=io, dim=mio.dim))
                io += 1
                continue
            # grow a run of out slots with equal (d, mul_out) whose in
            # slots are consecutive columns with equal (d, mul_in)
            run = [io]
            ii0 = ins_of_out[io]
            d = mio.ir.dim
            mul_out = mio.mul
            mul_in = self.irreps_in[ii0].mul
            q = io + 1
            while q < n_out and q in ins_of_out:
                mq = self.irreps_out[q]
                iq = ins_of_out[q]
                if (
                    mq.ir.dim != d
                    or mq.mul != mul_out
                    or self.irreps_in[iq].mul != mul_in
                    or iq != ins_of_out[run[-1]] + 1
                    or in_slices[iq].start
                    != in_slices[ins_of_out[run[-1]]].stop
                ):
                    break
                run.append(q)
                q += 1
            groups.append(dict(
                kind="dot",
                ios=run,
                iis=[ins_of_out[t] for t in run],
                c0=in_slices[ii0].start,
                c1=in_slices[ins_of_out[run[-1]]].stop,
                d=d,
                mul_in=mul_in,
                mul_out=mul_out,
            ))
            io = q
        # eligible only if it actually batches something (or drops the
        # formatting): always usable, but keep the plan only when legal
        self._lgroups = groups

    def _apply_grouped(self, params, x: jnp.ndarray) -> jnp.ndarray:
        if x.shape[-1] < self._max_read:
            raise ValueError(
                f"Linear on {self.irreps_in} reads input cols up to "
                f"{self._max_read}, got input with {x.shape[-1]} cols"
            )
        outs = []
        for g in self._lgroups:
            if g["kind"] == "zero":
                io = g["io"]
                chunk = jnp.zeros(x.shape[:-1] + (g["dim"],), dtype=x.dtype)
                if io in self.bias_slots:
                    chunk = chunk + params[f"b{io}"][
                        tuple([None] * (x.ndim - 1)) + (slice(None),)
                    ]
                outs.append(chunk)
                continue
            S, d = len(g["ios"]), g["d"]
            a = x[..., g["c0"]: g["c1"]].reshape(
                x.shape[:-1] + (S, g["mul_in"], d)
            )
            w = jnp.stack([
                params[f"w{ii}_{io}"] * self.alphas[io]
                for ii, io in zip(g["iis"], g["ios"])
            ])                                       # [S, mul_in, mul_out]
            chunk = jnp.einsum("...sud,suw->...swd", a, w)
            if self.biases and any(io in self.bias_slots for io in g["ios"]):
                bio = next(io for io in g["ios"] if io in self.bias_slots)
                b = jnp.stack([
                    params[f"b{io}"] if io in self.bias_slots
                    else jnp.zeros_like(params[f"b{bio}"])
                    for io in g["ios"]
                ])                                   # [S, mul_out]
                chunk = chunk + b[..., None]
            outs.append(chunk.reshape(x.shape[:-1] + (S * g["mul_out"] * d,)))
        return jnp.concatenate(outs, axis=-1)

    def param_specs(self):
        specs = {}
        for ii, io in self.paths:
            shape = (self.irreps_in[ii].mul, self.irreps_out[io].mul)
            specs[f"w{ii}_{io}"] = (shape, "normal")
        for io in self.bias_slots:
            specs[f"b{io}"] = ((self.irreps_out[io].mul,), "zeros")
        return specs

    def apply(self, params, x: jnp.ndarray) -> jnp.ndarray:
        if self._lgroups is not None:
            return self._apply_grouped(params, x)
        if x.shape[-1] < self._max_read:
            raise ValueError(
                f"Linear on {self.irreps_in} reads input cols up to "
                f"{self._max_read}, got input with {x.shape[-1]} cols"
            )
        slices_in = self.irreps_in.slices()
        chunks: Dict[int, jnp.ndarray] = {}
        for ii, io in self.paths:
            mii = self.irreps_in[ii]
            mio = self.irreps_out[io]
            a = x[..., slices_in[ii]].reshape(x.shape[:-1] + (mii.mul, mii.ir.dim))
            w = params[f"w{ii}_{io}"] * self.alphas[io]
            chunk = jnp.einsum("...ui,uw->...wi", a, w)
            chunks[io] = chunks.get(io, 0) + chunk
        outs = []
        for io, mio in enumerate(self.irreps_out):
            if io in chunks:
                chunk = chunks[io]
            else:
                chunk = jnp.zeros(x.shape[:-1] + (mio.mul, mio.ir.dim), dtype=x.dtype)
            if io in self.bias_slots:
                chunk = chunk + params[f"b{io}"][..., :, None]
            outs.append(chunk.reshape(chunk.shape[:-2] + (mio.dim,)))
        return (
            jnp.concatenate(outs, axis=-1)
            if outs
            else jnp.zeros(x.shape[:-1] + (0,), dtype=x.dtype)
        )
