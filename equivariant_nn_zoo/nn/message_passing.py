"""NequIP-style factorized convolution + gated message-passing block.

Reference parity: e3_layers/nn/message_passing.py (C10 in SURVEY.md §2).

Shape of the hot loop (§3.3 of SURVEY.md):

    weight  = MLP(edge_radial)                 [E, weight_numel]  dense
    sc      = FCTP(x, node_attrs)              per-node           dense
    x       = Linear(x)                        per-node           dense
    edge_f  = uvu-TP(x[src], Ylm; weight)      per-edge           einsums
    msum    = segment_sum(edge_f, dst, N_cap)  static scatter
    x       = Linear_mix(msum)/sqrt(avg_n)+sc  per-node           dense

vs the reference, the expansion's mix-linear is moved *after* the
segment-sum (they commute, the linear has no bias) so the dense mix runs
per-node instead of per-edge — an ~avg_num_neighbors-fold FLOP saving on
the widest matmul.  Everything is static-shaped: the scatter is an XLA
segment-sum over node_capacity slots (padded edges land in the dummy node).
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

from .mlp import FullyConnectedNet
from .module import Module
from .pointwise import LayerNormalization, TensorProductExpansion
from ..ops.gate import Gate, NormActivation, activations
from ..ops.irreps import Irreps, tp_path_exists
from ..ops.segment import segment_sum
from ..ops.tensor_product import Linear, fully_connected_tp
from ..utils.utils import build


class FactorizedConvolution(Module):
    def __init__(
        self,
        input_features,
        output_features,
        node_attrs,
        edge_radial,
        edge_spherical,
        invariant_layers=1,
        invariant_neurons=8,
        avg_num_neighbors=None,
        use_sc=True,
        nonlinearity_scalars: Dict = {"e": "ssp"},
        reduce=True,
        fused: bool = None,
        compute_dtype=None,
    ):
        super().__init__()
        self.init_irreps(
            input_features=input_features,
            output_features=output_features,
            node_attrs=node_attrs,
            edge_radial=edge_radial,
            edge_spherical=edge_spherical,
            output_keys=["output_features"],
        )
        self.avg_num_neighbors = avg_num_neighbors
        self.use_sc = use_sc and ("node_attrs" in self.irreps_in)
        self.reduce = reduce

        feature_irreps_in = Irreps(self.irreps_in["input_features"])
        feature_irreps_out = Irreps(self.irreps_out["output_features"])
        irreps_edge_attr = Irreps(self.irreps_in["edge_spherical"])

        self.linear_1 = self.declare_op(
            "linear_1", Linear(feature_irreps_in, feature_irreps_in)
        )
        self.tp = self.add_child(
            "tp",
            TensorProductExpansion(
                feature_irreps_in,
                (irreps_edge_attr, "edge_spherical"),
                (feature_irreps_out, "edge_features"),
                "uvu",
                internal_weight=False,
            ),
        )
        self.fc = self.declare_op(
            "fc",
            FullyConnectedNet(
                [Irreps(self.irreps_in["edge_radial"]).num_irreps]
                + invariant_layers * [invariant_neurons]
                + [self.tp.tp.weight_numel],
                activations["ssp"],
            ),
        )
        if self.use_sc:
            self.sc = self.declare_op(
                "sc",
                fully_connected_tp(
                    feature_irreps_in,
                    Irreps(self.irreps_in["node_attrs"]),
                    feature_irreps_out,
                ),
            )

        # compute dtype of the radial MLP and the fused conv (bfloat16 by
        # default, with float32 accumulation)
        import os

        if compute_dtype is None:
            compute_dtype = os.environ.get("E3_COMPUTE_DTYPE", "bfloat16")
        self.compute_dtype = str(compute_dtype)
        cd = dict(bfloat16=jnp.bfloat16, float32=jnp.float32)[
            self.compute_dtype
        ]
        # fused path (see ops/fused_tp.py): available when the feature
        # multiplicity is uniform and the edge attrs are mul-1 sh
        if fused is None:
            fused = os.environ.get("E3_FUSED", "1") == "1"
        self.fused_conv = None
        self.fused_sc = None
        if fused:
            from ..ops.fused_tp import FusedScalarFCTP, FusedUVUConv

            try:
                self.fused_conv = FusedUVUConv(self.tp, compute_dtype=cd)
            except AssertionError:
                pass
            if self.use_sc:
                try:
                    self.fused_sc = FusedScalarFCTP(self.sc, compute_dtype=cd)
                except AssertionError:
                    pass

    def apply(self, params, data: Dict, attrs: Dict):
        edge_radial = data["edge_radial"]
        # masking the radial features zeroes the weights (bias-free MLP) and
        # therefore every padded-edge message — cheaper than masking messages
        if "_edge_mask" in data:
            edge_radial = edge_radial * data["_edge_mask"]
        x = data["input_features"]
        edge_src = data["edge_index"][0]
        edge_dst = data["edge_index"][1]

        if self.use_sc:
            if self.fused_sc is not None:
                sc = self.fused_sc.apply(params["sc"], x, data["node_attrs"])
            else:
                sc = self.sc.apply(params["sc"], x, data["node_attrs"])

        x = self.linear_1.apply(params["linear_1"], x)
        tp_params = params["tp"]
        weight = self.fc.apply(params["fc"], edge_radial,
                               compute_dtype=self.compute_dtype)
        is_per = attrs["input_features"][0]
        out_attrs = {
            "output_features": (
                is_per if not self.reduce else "node",
                self.irreps_out["output_features"],
            )
        }
        if self.fused_conv is not None:
            # the unfused reduce=False path applies no neighbor-count
            # normalization (see below); mirror that for parity
            pre = (
                1.0 / (self.avg_num_neighbors ** 0.5)
                if self.avg_num_neighbors is not None and self.reduce
                else None
            )
            out = self.fused_conv(
                tp_params["linear"], x, edge_src, edge_dst,
                data["edge_spherical"], weight, x.shape[0], pre_scale=pre,
                reduce=self.reduce,
            )
            if self.use_sc:
                out = out + sc
            return {"output_features": out}, out_attrs
        edge_mid = self.tp.tp.apply(
            tp_params["tp"], x[edge_src], data["edge_spherical"], weight
        )
        if self.reduce:
            # scatter the *unmixed* TP output, then mix per-node (commutes)
            mid = segment_sum(edge_mid, edge_dst, x.shape[0])
            out = self.tp.linear.apply(tp_params["linear"], mid)
            if self.avg_num_neighbors is not None:
                out = out / (self.avg_num_neighbors ** 0.5)
            if self.use_sc:
                out = out + sc
        else:
            out = self.tp.linear.apply(tp_params["linear"], edge_mid)
        return {"output_features": out}, out_attrs


class MessagePassing(Module):
    """Convolution + gate/norm nonlinearity + optional resnet + layer norm.

    Reference parity: message_passing.py:126-262, including the
    tp_path_exists-based narrowing of scalar/gated irreps.
    """

    def __init__(
        self,
        input_features,
        output_features,
        node_attrs,
        edge_radial,
        edge_spherical,
        convolution,
        resnet: bool = False,
        nonlinearity_type: str = "gate",
        nonlinearity_scalars: Dict = {"e": "ssp", "o": "tanh"},
        nonlinearity_gates: Dict = {"e": "ssp", "o": "abs"},
        normalize=False,
    ):
        super().__init__()
        self.init_irreps(
            input_features=input_features,
            output_features=output_features,
            node_attrs=node_attrs,
            edge_radial=edge_radial,
            edge_spherical=edge_spherical,
            output_keys=["output_features"],
        )
        assert nonlinearity_type in ("gate", "norm")
        nonlinearity_scalars = {
            1: nonlinearity_scalars["e"],
            -1: nonlinearity_scalars["o"],
        }
        nonlinearity_gates = {
            1: nonlinearity_gates["e"],
            -1: nonlinearity_gates["o"],
        }

        edge_attr_irreps = Irreps(self.irreps_in["edge_spherical"])
        irreps_layer_out_prev = Irreps(self.irreps_in["input_features"])
        feature_irreps_hidden = Irreps(self.irreps_out["output_features"])

        irreps_scalars = Irreps(
            [
                (mi.mul, mi.ir)
                for mi in feature_irreps_hidden
                if mi.ir.l == 0
                and tp_path_exists(irreps_layer_out_prev, edge_attr_irreps, mi.ir)
            ]
        )
        irreps_gated = Irreps(
            [
                (mi.mul, mi.ir)
                for mi in feature_irreps_hidden
                if mi.ir.l > 0
                and tp_path_exists(irreps_layer_out_prev, edge_attr_irreps, mi.ir)
            ]
        )
        irreps_layer_out = (irreps_scalars + irreps_gated).simplify()

        if nonlinearity_type == "gate":
            irreps_gates = Irreps([(mi.mul, "0e") for mi in irreps_gated])
            self.equivariant_nonlin = Gate(
                irreps_scalars=irreps_scalars,
                act_scalars=[
                    nonlinearity_scalars[mi.ir.p] for mi in irreps_scalars
                ],
                irreps_gates=irreps_gates,
                act_gates=[nonlinearity_gates[mi.ir.p] for mi in irreps_gates],
                irreps_gated=irreps_gated,
            )
            conv_irreps_out = self.equivariant_nonlin.irreps_in.simplify()
        else:
            conv_irreps_out = irreps_layer_out.simplify()
            self.equivariant_nonlin = NormActivation(
                conv_irreps_out,
                nonlinearity_scalars[1],
                normalize=True,
                epsilon=1e-8,
                bias=False,
            )

        self.resnet = bool(resnet) and irreps_layer_out == irreps_layer_out_prev

        self.conv = self.add_child(
            "conv",
            build(
                convolution,
                input_features=input_features,
                output_features=conv_irreps_out,
                node_attrs=node_attrs,
                edge_radial=edge_radial,
                edge_spherical=edge_spherical,
            ),
        )
        self.normalize = normalize
        if self.normalize:
            self.norm = self.add_child(
                "norm",
                LayerNormalization(
                    self.irreps_out["output_features"],
                    self.irreps_out["output_features"],
                ),
            )

    def apply(self, params, data: Dict, attrs: Dict):
        old_x = data["input_features"]
        conv_out, _ = self.conv.apply(params["conv"], data, attrs)
        output = self.equivariant_nonlin(conv_out["output_features"])
        if self.resnet:
            output = old_x + output
        if self.normalize:
            normed, _ = self.norm.apply(
                params["norm"], {"input": output},
                {"input": (attrs["input_features"][0],
                           self.irreps_out["output_features"])},
            )
            output = normed["output"]
        is_per = attrs["input_features"][0]
        out_attrs = {
            "output_features": (is_per, self.irreps_out["output_features"])
        }
        return {"output_features": output}, out_attrs
