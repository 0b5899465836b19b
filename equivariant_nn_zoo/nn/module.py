"""The functional module system.

The reference builds stateful ``torch.nn.Module`` trees (e3_layers/nn/
sequential.py:12-39).  Here a Module separates *static structure*
from *parameters*: a Module here is a plain Python object holding config,
irreps metadata, key mappings, and constant tables; its parameters live in an
external pytree created by ``init(key)`` and consumed by
``apply(params, data, attrs)``.  That makes the whole model a pure function —
jit/grad/vmap/pjit compose freely, EMA is a tree-map, and checkpoints are
plain array trees.

Key-matching semantics are identical to the reference (Module.init_irreps,
inputKeyMap/outputKeyMap at sequential.py:13-39): each module declares
canonical field names with irreps and optional custom data keys; the
SequentialGraphNetwork induces an arbitrary DAG from key matching.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.irreps import Irreps
from ..utils.utils import keyMap


def _init_array(key, shape, init):
    if callable(init):
        return init(key, shape)
    if isinstance(init, (np.ndarray, jnp.ndarray, list, tuple, float, int)):
        arr = jnp.asarray(init, dtype=jnp.float32)
        return jnp.broadcast_to(arr, shape) if arr.shape != tuple(shape) else arr
    if init == "normal":
        return jax.random.normal(key, shape, dtype=jnp.float32)
    if init == "zeros":
        return jnp.zeros(shape, dtype=jnp.float32)
    if init == "ones":
        return jnp.ones(shape, dtype=jnp.float32)
    raise ValueError(f"unknown init {init!r}")


class Module:
    """Base class: static config + param declarations + key mapping."""

    def __init__(self):
        self._param_specs: Dict[str, Tuple[tuple, object]] = {}
        self._children: Dict[str, "Module"] = {}
        self._ops: Dict[str, object] = {}
        self.irreps_in: Dict[str, object] = {}
        self.irreps_out: Dict[str, object] = {}
        self.input_key_mapping: Dict[str, str] = {}
        self.output_key_mapping: Dict[str, str] = {}

    # -- irreps / key declaration (reference sequential.py:13-33) -----------

    def init_irreps(self, output_keys=(), **kwargs):
        if isinstance(output_keys, str):
            output_keys = [output_keys]
        for key, value in kwargs.items():
            if value is None:
                continue
            if isinstance(value, (str, Irreps)) or isinstance(value, int):
                irreps, custom_key = value, key
            elif isinstance(value, (list, tuple)):
                assert len(value) == 2, f"bad irreps spec for {key}: {value}"
                irreps, custom_key = value
            else:
                continue
            if key in output_keys:
                self.irreps_out[key] = irreps
                self.output_key_mapping[key] = custom_key
            else:
                self.irreps_in[key] = irreps
                self.input_key_mapping[custom_key] = key

    def inputKeyMap(self, d):
        return keyMap(d, self.input_key_mapping)

    def outputKeyMap(self, d):
        return keyMap(d, self.output_key_mapping)

    # -- parameter declaration ----------------------------------------------

    def declare(self, name: str, shape, init="normal"):
        self._param_specs[name] = (tuple(shape), init)

    def declare_op(self, name: str, op):
        """Register an ops-layer (Linear/TensorProduct/...) whose param_specs
        become a sub-dict of this module's params."""
        self._ops[name] = op
        return op

    def add_child(self, name: str, module: "Module"):
        self._children[name] = module
        return module

    # -- init / apply ---------------------------------------------------------

    def init(self, key) -> Dict:
        params: Dict = {}
        names = (
            sorted(self._param_specs)
            + sorted(self._ops)
            + sorted(self._children)
        )
        if names:
            keys = jax.random.split(key, len(names))
        for name, k in zip(names, keys if names else []):
            if name in self._param_specs:
                shape, init = self._param_specs[name]
                params[name] = _init_array(k, shape, init)
            elif name in self._ops:
                op = self._ops[name]
                sub = {}
                specs = sorted(op.param_specs().items())
                if specs:
                    subkeys = jax.random.split(k, len(specs))
                    for (pname, (shape, init)), sk in zip(specs, subkeys):
                        sub[pname] = _init_array(sk, shape, init)
                params[name] = sub
            else:
                params[name] = self._children[name].init(k)
        return params

    def apply(self, params, data: Dict, attrs: Dict):
        raise NotImplementedError

    def __call__(self, params, data, attrs):
        return self.apply(params, data, attrs)


class Lambda(Module):
    """Wrap a pure function (data, attrs) -> (data, attrs) as a Module."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def apply(self, params, data, attrs):
        return self.fn(data, attrs)
