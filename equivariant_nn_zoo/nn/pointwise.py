"""Pointwise equivariant layers: linear, layer norm, tensor-product
expansion, residual block, concat/split.

Reference parity: e3_layers/nn/pointwise.py (C9 in SURVEY.md §2).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import jax.numpy as jnp

from .module import Module
from ..ops.gate import NormActivation, resolve_activation
from ..ops.irreps import Irreps
from ..ops.tensor_product import Linear, TensorProduct
from ..ops.wigner import wigner_3j


class PointwiseLinear(Module):
    """Irreps-aware linear with biases on scalar outputs.

    Reference parity: pointwise.py:14-30.
    """

    def __init__(self, irreps_in, irreps_out, biases=True, **kwargs):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out, output_keys=["output"])
        self.linear = self.declare_op(
            "linear",
            Linear(self.irreps_in["input"], self.irreps_out["output"], biases=biases),
        )

    def apply(self, params, data: Dict, attrs: Dict):
        out = self.linear.apply(params["linear"], data["input"])
        out_attrs = {"output": (attrs["input"][0], self.irreps_out["output"])}
        return {"output": out}, out_attrs


class LayerNormalization(Module):
    """Per-irrep RMS normalization with a learned scale.

    Reference parity: pointwise.py:32-51 (norm averaged over multiplicity,
    eps 1e-6, one trainable std per irrep slice).
    """

    def __init__(self, irreps_in, irreps_out, **kwargs):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out, output_keys=["output"])
        assert Irreps(self.irreps_in["input"]) == Irreps(self.irreps_out["output"])
        irreps = Irreps(self.irreps_in["input"])
        self.muls = [mi.mul for mi in irreps]
        self.irreps = irreps
        self.declare("std", (len(self.muls),), "ones")

    def apply(self, params, data: Dict, attrs: Dict):
        x = data["input"]
        outs = []
        # consecutive slots of equal (mul, dim) batch into one chunk —
        # the norm is per (node, slot), so equal widths suffice
        runs = []
        ofs = 0
        for i, mi in enumerate(self.irreps):
            if runs and runs[-1][2] == mi.dim and runs[-1][3] == mi.mul:
                runs[-1][1] += 1
            else:
                runs.append([i, 1, mi.dim, mi.mul, ofs])
            ofs += mi.dim
        for i0, S, dim, mul, c0 in runs:
            tmp = x[:, c0: c0 + S * dim].reshape(x.shape[0], S, dim)
            norm = jnp.sum(tmp * tmp, axis=-1, keepdims=True)
            norm = jnp.sqrt(norm / mul + 1e-6)
            out = tmp / norm * params["std"][i0: i0 + S][None, :, None]
            outs.append(out.reshape(x.shape[0], S * dim))
        return {"output": jnp.concatenate(outs, axis=-1)}, dict(attrs)


class TensorProductExpansion(Module):
    """uvu/uvw tensor product into all reachable intermediate irreps,
    followed by an equivariant linear mix into the requested output.

    Reference parity: pointwise.py:54-100.  ``internal_weight=False`` takes
    per-element weights (the factorized convolution's radial MLP output).
    The TP and the mix-linear are exposed separately (``tp`` / ``linear``)
    so callers can reorder the linear past a segment reduction (they
    commute) — the conv uses that to run the mix per-node instead of
    per-edge.
    """

    def __init__(self, left, right, output, instruction="uvu",
                 internal_weight=True, **kwargs):
        super().__init__()
        self.init_irreps(left=left, right=right, output=output,
                         output_keys=["output"])
        irreps_left = Irreps(self.irreps_in["left"])
        irreps_right = Irreps(self.irreps_in["right"])
        irreps_out = Irreps(self.irreps_out["output"])

        irreps_mid = []
        instructions = []
        for i, mi_l in enumerate(irreps_left):
            for j, mi_r in enumerate(irreps_right):
                for ir_out in mi_l.ir * mi_r.ir:
                    if ir_out in irreps_out:
                        k = len(irreps_mid)
                        irreps_mid.append((mi_l.mul, ir_out))
                        instructions.append((i, j, k, instruction, True))
        irreps_mid = Irreps(irreps_mid)
        sorted_mid = irreps_mid.sort()
        instructions = [
            (i1, i2, sorted_mid.p[k], mode, train)
            for i1, i2, k, mode, train in instructions
        ]
        self.irreps_mid = sorted_mid.irreps
        self.internal_weight = internal_weight
        self.tp = self.declare_op(
            "tp",
            TensorProduct(
                irreps_left, irreps_right, self.irreps_mid, instructions,
                shared_weights=internal_weight,
                internal_weights=internal_weight,
            ),
        )
        self.linear = self.declare_op(
            "linear",
            Linear(self.irreps_mid.simplify(), irreps_out, biases=False),
        )
        self._fuse_plan = self._build_fuse_plan()

    def _build_fuse_plan(self):
        """Mid-fused lowering plan for internal-weight all-uvu expansions.

        ``expand`` = TP then mix-linear materializes the full mid tensor
        ([N, sum_paths mul*d] — 83k columns for the l_max=4 hamiltonian
        head) in HBM twice per differentiation level.  When the mix is a
        slot bijection (simplified mid / unique output irreps), the linear
        row-block of each TP path is known statically, so the mix can be
        applied per path right after its CG contraction and accumulated
        into the output — the mid never exists wider than one path."""
        tp, lin = self.tp, self.linear
        if not self.internal_weight:
            return None
        if not all(
            ins.mode == "uvu" and ins.has_weight for ins in tp.instructions
        ) or len(tp.instructions) <= 4:
            return None
        simplified = self.irreps_mid.simplify()
        if len({mi.ir for mi in simplified}) != len(simplified):
            return None
        if len({mo.ir for mo in lin.irreps_out}) != len(lin.irreps_out):
            return None
        if lin.bias_slots:
            return None
        ii_of_ir = {mi.ir: i for i, mi in enumerate(simplified)}
        io_of_ir = {mo.ir: i for i, mo in enumerate(lin.irreps_out)}
        # rank: row offset of each tp mid slot inside its simplified block
        rank, counter = {}, {}
        for slot, mi in enumerate(tp.irreps_out):
            rank[slot] = counter.get(mi.ir, 0)
            counter[mi.ir] = rank[slot] + mi.mul
        offs, ofs = [], 0
        for ins in tp.instructions:
            offs.append(ofs)
            ofs += int(np.prod(tp._weight_shape(ins)))
        groups: Dict = {}
        for ins, o in zip(tp.instructions, offs):
            ir3 = tp.irreps_out[ins.i_out].ir
            groups.setdefault((ins.i_in1, ins.i_in2), []).append((
                ins, o, rank[ins.i_out],
                ii_of_ir[ir3], io_of_ir.get(ir3),
            ))
        return groups

    def _expand_fused(self, params, left, right):
        tp, lin = self.tp, self.linear
        weight = params["tp"]["weight"]
        lp = params["linear"]
        slices1, slices2 = tp.irreps_in1.slices(), tp.irreps_in2.slices()
        # Batched lowering (traced-size taming): the l_max=4 hamiltonian
        # head has 100 (i1,i2) groups x 260 paths; per-path einsums make the
        # step's HLO too large to compile in reasonable time.
        # Per group, ONE K-padded stacked-CG einsum covers all
        # its paths; the mix then runs as ONE einsum per output irrep over
        # the stacked per-path chunks.  ~620 -> ~210 einsums per expansion.
        mix_bins: Dict[int, list] = {}  # io -> [(chunk, wrow, mul1)]
        for (i1, i2), items in self._fuse_plan.items():
            mi1, mi2 = tp.irreps_in1[i1], tp.irreps_in2[i2]
            mul1, d1 = mi1.mul, mi1.ir.dim
            mul2, d2 = mi2.mul, mi2.ir.dim
            live = [it for it in items if it[4] is not None]
            if not live:
                continue  # no mid irrep of this group is used by the mix
            a = left[..., slices1[i1]].reshape(left.shape[:-1] + (mul1, d1))
            b = right[..., slices2[i2]].reshape(right.shape[:-1] + (mul2, d2))
            W = jnp.stack([
                weight[o: o + mul1 * mul2].reshape(mul1, mul2)
                for _, o, _, _, _ in live
            ])                                              # [L, u, v]
            bw = jnp.einsum("...vj,Luv->...Luj", b, W)
            dims3 = [tp.irreps_out[ins.i_out].ir.dim for ins, *_ in live]
            kmax = max(dims3)
            C = np.zeros((len(live), d1, d2, kmax))
            for p, (ins, _, _, _, _) in enumerate(live):
                mi3 = tp.irreps_out[ins.i_out]
                C[p, :, :, : mi3.ir.dim] = (
                    wigner_3j(mi1.ir.l, mi2.ir.l, mi3.ir.l) * ins.path_weight
                )
            chunk = jnp.einsum(
                "...ui,...Luj,LijK->...LuK", a, bw,
                jnp.asarray(C, dtype=left.dtype),
            )
            for p, (ins, _, rk, ii, io) in enumerate(live):
                wrow = lp[f"w{ii}_{io}"][rk: rk + mul1] * lin.alphas[io]
                mix_bins.setdefault(io, []).append(
                    (chunk[..., p, :, : dims3[p]], wrow, mul1)
                )
        out_chunks: Dict[int, jnp.ndarray] = {}
        for io, entries in mix_bins.items():
            if len(entries) > 1 and len({u for *_, u in entries}) == 1:
                ch = jnp.stack([c for c, _, _ in entries], axis=-3)
                ws = jnp.stack([w for _, w, _ in entries])  # [P, u, w]
                out_chunks[io] = jnp.einsum("...Puk,Puw->...wk", ch, ws)
            else:  # mixed path muls: accumulate per path
                acc = None
                for c, w, _ in entries:
                    o_ = jnp.einsum("...uk,uw->...wk", c, w)
                    acc = o_ if acc is None else acc + o_
                out_chunks[io] = acc
        batch_shape = jnp.broadcast_shapes(left.shape[:-1], right.shape[:-1])
        outs = []
        for io, mo in enumerate(lin.irreps_out):
            if io in out_chunks:
                ch = out_chunks[io]
                outs.append(jnp.broadcast_to(
                    ch.reshape(ch.shape[:-2] + (mo.mul * mo.ir.dim,)),
                    batch_shape + (mo.mul * mo.ir.dim,),
                ))
            else:
                outs.append(jnp.zeros(
                    batch_shape + (mo.mul * mo.ir.dim,), dtype=left.dtype
                ))
        return jnp.concatenate(outs, axis=-1)

    def expand(self, params, left, right, weight=None):
        """tp (+ external weights) then linear mix — the reference forward."""
        if weight is None and self._fuse_plan is not None:
            return self._expand_fused(params, left, right)
        mid = self.tp.apply(params["tp"], left, right, weight)
        return self.linear.apply(params["linear"], mid)

    def apply(self, params, data: Dict, attrs: Dict):
        out = self.expand(params, data["left"], data["right"],
                          data.get("weight"))
        is_per = attrs["left"][0]
        out_attrs = {"output": (is_per, self.irreps_out["output"])}
        return {"output": out}, out_attrs


class ResBlock(Module):
    """Equivariant residual block: x + linear(norm_act(x)), with a second
    linear if the output irreps differ.

    Reference parity: pointwise.py:103-132.  Also callable directly on a
    tensor via ``block(params, x)`` like the reference's tensor path.
    """

    def __init__(self, irreps_in, irreps_out, activation="silu", biases=True,
                 **kwargs):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out, output_keys=["output"])
        ir_in = Irreps(self.irreps_in["input"])
        ir_out = Irreps(self.irreps_out["output"])
        self.same = ir_in == ir_out
        self.linear_1 = self.declare_op("linear_1", Linear(ir_in, ir_in, biases=biases))
        if not self.same:
            self.linear_2 = self.declare_op(
                "linear_2", Linear(ir_in, ir_out, biases=biases)
            )
        self.act = NormActivation(ir_in, resolve_activation(activation))

    def block(self, params, x):
        out = x + self.linear_1.apply(params["linear_1"], self.act(x))
        if not self.same:
            out = self.linear_2.apply(params["linear_2"], out)
        return out

    def apply(self, params, data: Dict, attrs: Dict):
        out = self.block(params, data["input"])
        is_per = attrs["input"][0]
        return {"output": out}, {"output": (is_per, self.irreps_out["output"])}


class Concat(Module):
    """Concatenate several irreps features and mix linearly.

    Reference parity: pointwise.py:134-152.
    """

    def __init__(self, irreps_out, **irreps_in):
        super().__init__()
        self.init_irreps(**irreps_in, output=irreps_out, output_keys=["output"])
        cat = Irreps(None)
        for value in self.irreps_in.values():
            cat = cat + Irreps(value)
        self.linear = self.declare_op(
            "linear", Linear(cat, Irreps(self.irreps_out["output"]), biases=True)
        )

    def apply(self, params, data: Dict, attrs: Dict):
        x = jnp.concatenate([data[key] for key in self.irreps_in.keys()], axis=1)
        out = self.linear.apply(params["linear"], x)
        first = list(self.irreps_in.keys())[0]
        is_per = attrs[first][0]
        return {"output": out}, {"output": (is_per, self.irreps_out["output"])}


class Split(Module):
    """Linear then split into named outputs along irreps boundaries.

    Reference parity: pointwise.py:154-175 (with the slicing applied to the
    feature axis).
    """

    def __init__(self, irreps_in, **irreps_out):
        super().__init__()
        self.init_irreps(input=irreps_in, **irreps_out,
                         output_keys=[key for key in irreps_out])
        cat = Irreps(None)
        self.out_dims = {}
        for key, value in self.irreps_out.items():
            cat = cat + Irreps(value)
            self.out_dims[key] = Irreps(value).dim
        self.linear = self.declare_op(
            "linear", Linear(Irreps(self.irreps_in["input"]), cat, biases=True)
        )

    def apply(self, params, data: Dict, attrs: Dict):
        result = self.linear.apply(params["linear"], data["input"])
        out = {}
        cnt = 0
        for key, dim in self.out_dims.items():
            out[key] = result[..., cnt : cnt + dim]
            cnt += dim
        is_per = attrs["input"][0]
        out_attrs = {key: (is_per, value) for key, value in self.irreps_out.items()}
        return out, out_attrs
