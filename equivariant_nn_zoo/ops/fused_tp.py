"""Fused uvu tensor-product convolution path — the conv's hot loop.

The naive lowering of the NequIP convolution (reference hot loop,
e3_layers/nn/message_passing.py:104-109) is one small einsum per CG path:
30-50 ops over ``[E, mul, 2l+1]`` tensors with 1/3/5/7-wide minor axes,
followed by a scatter of the full ``[E, mul * n_paths_dim]`` intermediate.

This module restructures the same math into a few dense matmuls:

1.  ``M[e] = sh[e] @ C``           — one matmul against the precomputed
    block-sparse CG operator ``C[J, K, I]`` (all paths at once).
2.  ``mid[e] = M[e] @ x_T[e]``     — one batched matmul ``[E,K,I]x[E,I,mul]``.
3.  per-edge weights applied group-broadcast (paths grouped by output irrep).
4.  the expansion's mix-linear applied **per edge** (it commutes with the
    edge->node sum because it is a shared bias-free linear), shrinking the
    scatter operand from ``[E, mid_dim]`` to ``[E, out_dim]`` — a ~6x cut in
    scatter traffic on the reference architecture.
5.  one ``segment_sum`` into the node table.

Everything runs in a configurable ``compute_dtype`` (bfloat16 by default)
with f32 matmul accumulation.  Parameters are IDENTICAL to the unfused
``TensorProductExpansion`` (same pytree), so the two paths are
interchangeable per checkpoint; equality is covered by tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .irreps import Irreps
from .segment import segment_sum
from .wigner import wigner_3j

# Per-trace cache of the per-edge CG operator M = sh @ C: layers with the
# same (input irreps, sh irreps, mid irreps) share an identical C, so M is
# computed once per step and reused by every such layer (keyed weakly on the
# sh tracer/array so entries die with the trace).
import weakref

_M_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class FusedUVUConv:
    """Precomputed fused program for one TensorProductExpansion.

    Args:
        tpe: an ``nn.pointwise.TensorProductExpansion`` with uvu instructions
            and external (per-edge) weights whose left input has uniform
            multiplicity.
    """

    def __init__(self, tpe, compute_dtype=jnp.bfloat16):
        self.compute_dtype = compute_dtype
        irreps_in = Irreps(tpe.irreps_in["left"])
        irreps_sh = Irreps(tpe.irreps_in["right"])
        irreps_out = Irreps(tpe.irreps_out["output"])
        self.irreps_in = irreps_in
        self.irreps_sh = irreps_sh
        self.irreps_out = irreps_out

        muls = {mi.mul for mi in irreps_in}
        assert len(muls) == 1, "fused path requires uniform multiplicity"
        self.mul = muls.pop()
        for mi in irreps_sh:
            assert mi.mul == 1, "fused path requires mul-1 sh"

        instructions = tpe.tp.instructions
        mid_irreps = tpe.tp.irreps_out  # sorted TPE mid irreps
        assert all(ins.mode == "uvu" and ins.has_weight for ins in instructions)

        # ---- path bookkeeping in OUR order: sorted by output irrep --------
        # each path: (i1, i2, ir3, path_weight, tpe_weight_offset, tpe_mid_slot)
        w_offsets = {}
        ofs = 0
        for idx, ins in enumerate(instructions):
            w_offsets[idx] = ofs
            ofs += self.mul  # mul2 == 1 -> weight shape (mul, 1)
        self.weight_numel = ofs

        order = sorted(
            range(len(instructions)),
            key=lambda i: (
                mid_irreps[instructions[i].i_out].ir.l,
                -mid_irreps[instructions[i].i_out].ir.p,
                i,
            ),
        )
        self.paths = [instructions[i] for i in order]
        self.path_w_offset = [w_offsets[i] for i in order]

        # I index: position of each (slot1, m1) in the transposed x layout
        self.I_dim = sum(mi.ir.dim for mi in irreps_in)
        i_starts = np.cumsum([0] + [mi.ir.dim for mi in irreps_in])

        # K index: (path, m3) in our order; group paths by output irrep
        d3s = [mid_irreps[ins.i_out].ir.dim for ins in self.paths]
        k_starts = np.cumsum([0] + d3s)
        self.K_dim = int(k_starts[-1])

        # the big CG operator C[J, K, I]
        j_starts = np.cumsum([0] + [mi.ir.dim for mi in irreps_sh])
        J_dim = int(j_starts[-1])
        C = np.zeros((J_dim, self.K_dim, self.I_dim), np.float32)
        for p, ins in enumerate(self.paths):
            l1 = irreps_in[ins.i_in1].ir.l
            l2 = irreps_sh[ins.i_in2].ir.l
            l3 = mid_irreps[ins.i_out].ir.l
            cg = wigner_3j(l1, l2, l3) * ins.path_weight  # [d1, d2, d3]
            i0 = i_starts[ins.i_in1]
            j0 = j_starts[ins.i_in2]
            k0 = k_starts[p]
            C[j0 : j0 + 2 * l2 + 1, k0 : k0 + 2 * l3 + 1,
              i0 : i0 + 2 * l1 + 1] += np.transpose(cg, (1, 2, 0))
        self.C_flat = jnp.asarray(C.reshape(J_dim, self.K_dim * self.I_dim))

        # ---- output-irrep groups (contiguous in our K order) --------------
        groups = []  # (ir, k_start, n_paths, d, [path indices], p_start)
        p = 0
        while p < len(self.paths):
            ir = mid_irreps[self.paths[p].i_out].ir
            q = p
            while q < len(self.paths) and mid_irreps[self.paths[q].i_out].ir == ir:
                q += 1
            groups.append((ir, int(k_starts[p]), q - p, ir.dim, p))
            p = q
        self.groups = groups

        # ---- mix-linear mapping -------------------------------------------
        # TPE's linear maps mid_irreps.simplify() -> irreps_out with weights
        # w{ii}_{io} of shape [mul_in_total, mul_out].  Row index in the
        # simplified layout = (slot position within the irrep block, u).
        # Build, per group, the row order of our (m-th path, u) pairs.
        simplified = mid_irreps.simplify()
        self.linear = tpe.linear
        # position of each TPE mid slot within its irrep block
        slot_rank = {}
        counter = {}
        for slot, mi in enumerate(mid_irreps):
            r = counter.get(mi.ir, 0)
            slot_rank[slot] = r
            counter[mi.ir] = r + self.mul  # slots contribute `mul` rows
        self.group_row_perm = []
        for (ir, k0, n_paths, d, p0) in groups:
            # our m-th path corresponds to TPE slot paths[p0+m].i_out
            ranks = [slot_rank[self.paths[p0 + m].i_out] for m in range(n_paths)]
            # rows in the simplified linear input: rank + u
            perm = np.concatenate(
                [np.arange(r, r + self.mul) for r in ranks]
            )
            self.group_row_perm.append(jnp.asarray(perm))
        # linear input slot index per group irrep
        self.lin_in_index = {}
        for ii, mi in enumerate(simplified):
            self.lin_in_index[mi.ir] = ii
        self.lin_out = {}
        for io, mo in enumerate(self.linear.irreps_out):
            self.lin_out.setdefault(mo.ir, []).append(io)
        self._struct_key = (
            repr(irreps_in), repr(irreps_sh), repr(mid_irreps),
            self.mul, str(np.dtype(self.compute_dtype)),
        )

    def _get_M(self, sh):
        """Per-edge CG operator, cached per (sh object, structure)."""
        cd = self.compute_dtype
        E = sh.shape[0]

        def compute():
            return jax.lax.dot_general(
                sh.astype(cd), self.C_flat.astype(cd),
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).reshape(E, self.K_dim, self.I_dim).astype(cd)

        try:
            per_sh = _M_CACHE.get(sh)
            if per_sh is None:
                per_sh = {}
                _M_CACHE[sh] = per_sh
            if self._struct_key not in per_sh:
                per_sh[self._struct_key] = compute()
            return per_sh[self._struct_key]
        except TypeError:  # sh not weak-referenceable
            return compute()

    def __call__(self, linear_params, x, edge_src, edge_dst, sh, weight,
                 num_nodes: int, pre_scale: Optional[float] = None,
                 out_dtype=jnp.float32, reduce: bool = True):
        """x [N, in_dim] (node features, already linear_1'd), sh [E, J],
        weight [E, weight_numel] -> node-accumulated mix output [N, out_dim].

        ``reduce=False`` skips the edge->node segment sum and returns the
        per-edge mixed output [E, out_dim] (the Pairwise head's neighbor
        convolution, reference e3_layers/nn/output.py:77-164 via
        FactorizedConvolution(reduce=False)); ``edge_dst`` is unused then.
        """
        cd = self.compute_dtype
        E = sh.shape[0]
        mul = self.mul

        # transpose x to [N, I, mul] once per layer (cheap, node-sized)
        blocks = []
        ofs = 0
        for mi in self.irreps_in:
            d = mi.ir.dim
            b = x[:, ofs : ofs + mul * d].reshape(-1, mul, d)
            blocks.append(jnp.swapaxes(b, 1, 2))
            ofs += mul * d
        xT = jnp.concatenate(blocks, axis=1).astype(cd)  # [N, I, mul]
        xTg = xT[edge_src]  # [E, I, mul]

        # per-edge CG operator (cached across layers with the same structure)
        M = self._get_M(sh)

        # batched matmul: mid[e, K, mul]  (A/B showed per-group matmuls are
        # slower: many small batched dots lose more than slice-grads cost)
        mid = jax.lax.dot_general(
            M, xTg,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        ).astype(cd)

        # weights: TPE layout is per-instruction [mul] chunks; ours reordered
        w3 = weight.reshape(E, -1, mul).astype(cd)  # [E, P_tpe, mul]

        # per-group: weight-multiply + per-edge mix, accumulate output blocks
        out_blocks = {}
        for g, (ir, k0, n_paths, d, p0) in enumerate(self.groups):
            block = mid[:, k0 : k0 + n_paths * d, :].reshape(E, n_paths, d, mul)
            w_idx = [self.path_w_offset[p0 + m] // mul for m in range(n_paths)]
            wg = w3[:, jnp.asarray(w_idx), :]  # [E, n_paths, mul]
            block = block * wg[:, :, None, :]
            # mix: rows (path m, u) -> out mult, via TPE linear weights.
            # contract u (the minor dim of `block`) with the path index as a
            # dot_general batch dim — no [E, ...]-scale transpose needed.
            ii = self.lin_in_index[ir]
            for io in self.lin_out.get(ir, []):
                w_full = linear_params[f"w{ii}_{io}"] * self.linear.alphas[io]
                rows = self.group_row_perm[g]
                w_sel = w_full[rows].astype(cd).reshape(n_paths, mul, -1)
                o = jax.lax.dot_general(
                    block, w_sel,
                    dimension_numbers=(((3,), (1,)), ((1,), (0,))),
                    preferred_element_type=jnp.float32,
                )  # [n_paths, E, d, mul_out]
                o = jnp.sum(o, axis=0)  # [E, d, mul_out]
                out_blocks.setdefault(io, []).append(o)
        # assemble per-edge output [E, out_dim] in irreps_out order
        outs = []
        for io, mo in enumerate(self.linear.irreps_out):
            if io in out_blocks:
                o = sum(out_blocks[io])  # [E, d, mul_out]
                o = jnp.swapaxes(o, 1, 2).reshape(E, mo.mul * mo.ir.dim)
            else:
                o = jnp.zeros((E, mo.mul * mo.ir.dim), jnp.float32)
            outs.append(o)
        edge_out = jnp.concatenate(outs, axis=-1)
        if pre_scale is not None:
            edge_out = edge_out * pre_scale
        if not reduce:
            return edge_out.astype(out_dtype)
        edge_out = edge_out.astype(cd)
        out = segment_sum(edge_out, edge_dst, num_nodes)
        return out.astype(out_dtype)


class FusedScalarFCTP:
    """Fast path for the FullyConnectedTensorProduct self-connection when the
    right input is pure scalars (node_attrs '<k>x0e', the reference default):
    ``out[n] = x_block(n) @ A(n)`` with ``A(n) = attrs(n) @ W`` — two dense
    matmuls instead of per-path einsums.

    Parameter-compatible with ``ops.tensor_product.fully_connected_tp``.
    """

    def __init__(self, tp, compute_dtype=jnp.bfloat16):
        self.compute_dtype = compute_dtype
        self.tp = tp
        ir1, ir2, iro = tp.irreps_in1, tp.irreps_in2, tp.irreps_out
        assert all(mi.ir.l == 0 and mi.ir.p == 1 for mi in ir2), "scalars only"
        self.mul2 = sum(mi.mul for mi in ir2)
        # instructions are (i1, i2, io) with ir1[i1].ir == iro[io].ir
        self.items = []
        w_ofs = 0
        for ins in tp.instructions:
            shape = tp._weight_shape(ins)
            n = int(np.prod(shape))
            self.items.append((ins, w_ofs, shape))
            w_ofs += n

    def apply(self, params, x, attrs):
        cd = self.compute_dtype
        tp = self.tp
        weight = params["weight"]
        N = x.shape[0]
        slices1 = tp.irreps_in1.slices()
        slices2 = tp.irreps_in2.slices()
        a = attrs.astype(cd)  # [N, mul2]
        out_chunks = {}
        for ins, w_ofs, shape in self.items:
            mul1, mul2, mul_out = shape
            d = tp.irreps_in1[ins.i_in1].ir.dim
            # wigner_3j(l, 0, l) is delta/sqrt(2l+1) — fold it in
            w = (weight[w_ofs : w_ofs + mul1 * mul2 * mul_out]
                 .reshape(mul1, mul2, mul_out)
                 * (ins.path_weight / np.sqrt(d)))
            # A[n, u, w] = attrs[n, v] W[u, v, w]
            # the attrs of this path's irrep; the model's node_attrs is one
            # irrep, taken whole (no slice in the traced program)
            a_i = a if len(slices2) == 1 else a[:, slices2[ins.i_in2]]
            A = jax.lax.dot_general(
                a_i, w.astype(cd),
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            ).astype(cd)  # [N, mul1, mul_out]
            xb = x[:, slices1[ins.i_in1]].reshape(N, mul1, d).astype(cd)
            # out[n, w, k] = sum_u xb[n, u, k] A[n, u, w]
            o = jax.lax.dot_general(
                A, xb,
                dimension_numbers=(((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
            )  # [N, mul_out, d]
            o = o.reshape(N, mul_out * d)
            key = ins.i_out
            out_chunks[key] = out_chunks.get(key, 0) + o
        outs = []
        for io, mo in enumerate(tp.irreps_out):
            if io in out_chunks:
                outs.append(out_chunks[io].astype(jnp.float32))
            else:
                outs.append(jnp.zeros((N, mo.dim), jnp.float32))
        return jnp.concatenate(outs, axis=-1)
