"""Output heads: autograd gradients (forces), pooling, pairwise features,
tensor-product matrix contraction (Hamiltonian blocks).

Reference parity: e3_layers/nn/output.py (C11 in SURVEY.md §2).
"""

from __future__ import annotations

from copy import copy
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .message_passing import FactorizedConvolution
from .module import Module
from .pointwise import PointwiseLinear, ResBlock, TensorProductExpansion
from ..data.graph_batch import GraphBatch
from ..ops.irreps import Irreps, tp_path_exists
from ..ops.segment import segment_sum, segment_mean
from ..ops.wigner import wigner_3j
from ..utils.utils import build


class GradientOutput(Module):
    """Compute d(sum y)/dx of a wrapped network — the force head.

    Reference parity: output.py:18-53 — but instead of
    ``torch.autograd.grad(create_graph=training)`` this is a plain
    ``jax.value_and_grad`` through the wrapped pure function; training takes
    a second derivative through it with no special flags.
    """

    def __init__(self, func, x, y, gradients, sign: float = 1.0, **kwargs):
        super().__init__()
        sign = float(sign)
        assert sign in (1.0, -1.0)
        self.sign = sign
        self.init_irreps(x=x, y=y, gradients=gradients, output_keys=["gradients"])
        assert Irreps(self.irreps_in["y"]).lmax == 0
        if isinstance(func, dict):
            func = build(func, **kwargs)
        self.func = self.add_child("func", func)
        # custom (data-side) key names for x and y
        inv = {v: k for k, v in self.input_key_mapping.items()}
        self.x_key = inv.get("x", "x")
        self.y_key = inv.get("y", "y")

    def apply(self, params, data, attrs: Dict = None):
        is_batch = isinstance(data, GraphBatch)
        if is_batch:
            batch = data
            data, attrs = dict(batch.data), dict(batch.attrs)
        else:
            data = dict(data)
        x0 = data[self.x_key]

        def f(x):
            d = dict(data)
            d[self.x_key] = x
            out_data, out_attrs = self.func.apply(params["func"], d, attrs)
            y = out_data[self.y_key]
            return jnp.sum(y), (out_data, out_attrs)

        (_, (out_data, out_attrs)), grad = jax.value_and_grad(f, has_aux=True)(x0)
        grad = self.sign * grad

        is_per = attrs[self.x_key][0] if self.x_key in attrs else "node"
        merged = dict(data)
        merged.update(out_data)
        merged_attrs = dict(attrs)
        merged_attrs.update(out_attrs)
        merged.update(self.outputKeyMap({"gradients": grad}))
        merged_attrs.update(
            self.outputKeyMap(
                {"gradients": (is_per, self.irreps_out["gradients"])}
            )
        )
        if is_batch:
            return GraphBatch(
                merged, merged_attrs, batch.n_graphs, batch.node_capacity,
                batch.edge_capacity,
            )
        return merged, merged_attrs

    def init(self, key):
        return {"func": self.func.init(key)}


class Pooling(Module):
    """Node -> graph pooling (sum or mean) via a static segment reduction.

    Reference parity: output.py:56-74.  The padding segment row is dropped.
    """

    def __init__(self, irreps_in, irreps_out, reduce):
        super().__init__()
        self.init_irreps(input=irreps_in, output=irreps_out, output_keys=["output"])
        assert reduce in ("sum", "mean")
        self.reduce = reduce

    def apply(self, params, data: Dict, attrs: Dict):
        x = data["input"]
        seg = data["_node_segment"]
        n_graphs = data["_graph_mask"].shape[0] if "_graph_mask" in data else (
            int(np.max(np.asarray(seg))) + 1
        )
        fn = segment_sum if self.reduce == "sum" else segment_mean
        out = fn(x, seg, n_graphs + 1)[:-1]
        return {"output": out}, {"output": ("graph", self.irreps_out["output"])}


class Pairwise(Module):
    """Pairwise (edge) features from node features:
    f_ii = res(f_i) + tp(f_i, f_i);  f_ij = res(f_i) + tp(f_i, conv_j(Ylm)).

    Reference parity: output.py:77-164.
    """

    def __init__(
        self,
        node_features,
        edge_radial,
        edge_spherical,
        diagonal,
        off_diagonal,
        invariant_layers=2,
        invariant_neurons=16,
        conv=None,
    ):
        super().__init__()
        self.init_irreps(
            node_features=node_features,
            edge_radial=edge_radial,
            edge_spherical=edge_spherical,
            diagonal=diagonal,
            off_diagonal=off_diagonal,
            output_keys=["diagonal", "off_diagonal"],
        )
        irreps_in = self.irreps_in["node_features"]
        if conv == "auto":
            dic = {
                "input_features": (irreps_in, "node_features"),
                "edge_radial": self.irreps_in["edge_radial"],
                "edge_spherical": self.irreps_in["edge_spherical"],
                "node_attrs": None,
            }
            # remap custom keys from our own input mapping
            inv = {v: k for k, v in self.input_key_mapping.items()}
            dic["edge_radial"] = (self.irreps_in["edge_radial"],
                                  inv.get("edge_radial", "edge_radial"))
            dic["edge_spherical"] = (self.irreps_in["edge_spherical"],
                                     inv.get("edge_spherical", "edge_spherical"))
            self.conv = self.add_child(
                "conv",
                FactorizedConvolution(
                    output_features=irreps_in,
                    invariant_layers=2,
                    invariant_neurons=32,
                    avg_num_neighbors=1,
                    use_sc=False,
                    reduce=False,
                    **dic,
                ),
            )
        else:
            self.conv = None

        irreps_out = self.irreps_out["diagonal"]
        self.tp = self.add_child(
            "tp", TensorProductExpansion(irreps_in, irreps_in, irreps_out, "uvu")
        )
        self.res_center = self.add_child("res_center", ResBlock(irreps_in, irreps_in))
        self.res_pair = self.add_child("res_pair", ResBlock(irreps_out, irreps_out))
        self.res_res = self.add_child("res_res", ResBlock(irreps_in, irreps_out))

        self.tp_off = self.add_child(
            "tp_off", TensorProductExpansion(irreps_in, irreps_in, irreps_out, "uvu")
        )
        self.res_center_off = self.add_child(
            "res_center_off", ResBlock(irreps_in, irreps_in)
        )
        self.res_pair_off = self.add_child(
            "res_pair_off", ResBlock(irreps_out, irreps_out)
        )
        self.res_res_off = self.add_child(
            "res_res_off", ResBlock(irreps_in, irreps_out)
        )

    def apply(self, params, data: Dict, attrs: Dict):
        node_features = data["node_features"]
        edge_index = data["edge_index"]
        src, dst = edge_index[0], edge_index[1]

        if self.conv is None:
            neighbor = node_features[src]
        else:
            conv_in = self.conv.inputKeyMap(data)
            conv_attrs = self.conv.inputKeyMap(attrs)
            conv_in["input_features"] = node_features
            out, _ = self.conv.apply(params["conv"], conv_in, conv_attrs)
            neighbor = out["output_features"]
        center = node_features[dst]
        off_left = self.res_center_off.block(params["res_center_off"], center)
        off = self.tp_off.expand(params["tp_off"], off_left, neighbor)
        off = self.res_pair_off.block(params["res_pair_off"], off)
        off = self.res_res_off.block(params["res_res_off"], center) + off

        center = node_features
        diag_left = self.res_center.block(params["res_center"], center)
        diag = self.tp.expand(params["tp"], diag_left, center)
        diag = self.res_pair.block(params["res_pair"], diag)
        diag = self.res_res.block(params["res_res"], center) + diag

        out_attrs = {
            "diagonal": ("node", self.irreps_out["diagonal"]),
            "off_diagonal": ("edge", self.irreps_out["off_diagonal"]),
        }
        return {"diagonal": diag, "off_diagonal": off}, out_attrs


class TensorProductContraction(Module):
    """Compose irreducible features into tensor-product matrix blocks
    (tp_l ⊗ tp_r), e.g. Hamiltonian sub-blocks per atom(-pair).

    Reference parity: output.py:175-243 including the fill-from-the-tail
    slice bookkeeping and the einsum ``bmni,lri->bmlnr`` against cached
    Wigner-3j tables.
    """

    def __init__(self, irreps_in, tp_l, tp_r):
        super().__init__()
        self.init_irreps(
            irreducible=irreps_in, tp_l=tp_l, tp_r=tp_r,
            output_keys=["tp_l", "tp_r"],
        )
        self.irreps_mul = {}
        for mi_l in Irreps(self.irreps_out["tp_l"]):
            for mi_r in Irreps(self.irreps_out["tp_r"]):
                parity = "e" if mi_l.ir.p * mi_r.ir.p == 1 else "o"
                mul = mi_l.mul * mi_r.mul
                for degree in range(
                    abs(mi_l.ir.l - mi_r.ir.l), mi_l.ir.l + mi_r.ir.l + 1
                ):
                    key = f"{degree}{parity}"
                    self.irreps_mul[key] = self.irreps_mul.get(key, 0) + mul
        self.irreps = Irreps(
            "+".join(f"{v}x{k}" for k, v in self.irreps_mul.items())
        )
        self.linear = self.add_child(
            "linear", PointwiseLinear(irreps_in, self.irreps)
        )

    def apply(self, params, data: Dict, attrs: Dict):
        x = data["irreducible"]
        out, _ = self.linear.apply(
            params["linear"], {"input": x},
            {"input": (attrs["irreducible"][0], self.irreps_in["irreducible"])},
        )
        x = out["output"]
        irreps_mul = copy(self.irreps_mul)
        tp = {}
        slices = self.irreps.slices()
        for mi_l in Irreps(self.irreps_out["tp_l"]):
            for mi_r in Irreps(self.irreps_out["tp_r"]):
                p_l = "e" if mi_l.ir.p == 1 else "o"
                p_r = "e" if mi_r.ir.p == 1 else "o"
                tp_key = f"{mi_l.mul}x{mi_l.ir.l}{p_l}*{mi_r.mul}x{mi_r.ir.l}{p_r}"
                tp[tp_key] = 0
                mul = mi_l.mul * mi_r.mul
                for i, mi in enumerate(self.irreps):
                    degree = mi.ir.l
                    parity = "e" if mi.ir.p == 1 else "o"
                    if not tp_path_exists(
                        f"{mi_l.ir.l}{p_l}", f"{mi_r.ir.l}{p_r}",
                        f"{degree}{parity}",
                    ):
                        continue
                    key = repr(mi.ir)
                    # fetch irreps from the tail of the allocated block
                    start = slices[i].start
                    stop = start + irreps_mul[key] * (degree * 2 + 1)
                    start = stop - mul * (degree * 2 + 1)
                    basis = jnp.asarray(
                        wigner_3j(mi_l.ir.l, mi_r.ir.l, degree), dtype=x.dtype
                    )
                    a = x[:, start:stop].reshape(
                        -1, mi_l.mul, mi_r.mul, degree * 2 + 1
                    )
                    tp[tp_key] = tp[tp_key] + jnp.einsum(
                        "bmni,lri->bmlnr", a, basis
                    )
                    irreps_mul[key] -= mul
        for key, value in irreps_mul.items():
            assert value == 0, f"unconsumed irreps {key}: {value}"
        return {"tp_l": tp}, {}
