"""SequentialGraphNetwork — the key-matched DAG executor.

Reference parity: e3_layers/nn/sequential.py:42-88.  Runs an ordered list of
(name, module-or-callable) layers; each layer reads the running data dict
through its input key map, writes its outputs back through its output key
map, and the dict-merge induces an arbitrary DAG.  Instead of per-layer
TorchScript (reference sequential.py:63-65) the *whole* network is traced
once under ``jax.jit``; per-layer ``jax.named_scope`` keeps profiler
readability (reference uses torch.profiler record_function, sequential.py:73).
"""

from __future__ import annotations

from typing import Dict, List

import jax

from .module import Module
from ..data.graph_batch import GraphBatch
from ..utils.utils import build


class SequentialGraphNetwork(Module):
    def __init__(self, **config):
        super().__init__()
        layer_configs = config["layers"]
        self.layers: List = []
        self.layer_configs = layer_configs
        for key, value in layer_configs:
            if isinstance(value, Module):
                self.add_child(key, value)
                self.layers.append((key, value))
            elif isinstance(value, dict):
                module = build(value)
                self.add_child(key, module)
                self.layers.append((key, module))
            elif callable(value):
                self.layers.append((key, value))
            else:
                raise TypeError(f"invalid config node for layer {key!r}")

    def apply(self, params, data, attrs: Dict = None):
        """Accepts a GraphBatch (returns a GraphBatch) or a raw (data, attrs)
        pair (returns the updated pair)."""
        is_batch = isinstance(data, GraphBatch)
        if is_batch:
            batch = data
            data, attrs = dict(batch.data), dict(batch.attrs)
        else:
            data, attrs = dict(data), dict(attrs)
        for key, module in self.layers:
            with jax.named_scope(key):
                if isinstance(module, Module):
                    _data = module.inputKeyMap(data)
                    _attrs = module.inputKeyMap(attrs)
                    _data, _attrs = module.apply(params[key], _data, _attrs)
                    _data = module.outputKeyMap(_data)
                    _attrs = module.outputKeyMap(_attrs)
                else:
                    _data, _attrs = module(data, attrs)
                data.update(_data)
                attrs.update(_attrs)
        if is_batch:
            return GraphBatch(
                data, attrs, batch.n_graphs, batch.node_capacity,
                batch.edge_capacity,
            )
        return data, attrs
