"""Reflection build, kwarg pruning, key mapping, config surgery, scalers.

Reference parity: e3_layers/utils/utils.py (C13/C14 in SURVEY.md §2).
"""

from __future__ import annotations

import inspect
from typing import Dict

import numpy as np


def build(node, **kwargs):
    """Instantiate a layer/module from its config node {"module": cls, ...}.

    Reference parity: utils.py:99-116.
    """
    if isinstance(node, dict):
        func = node["module"]
        kwargs.update(**node)
    elif isinstance(node, (list, tuple)):
        func = node[0]
    else:
        func = node
    kwargs.pop("module", None)
    kwargs = pruneArgs(func, **kwargs)
    return func(**kwargs)


def pruneArgs(_func=None, prefix: str = "", **kwargs):
    """Filter kwargs by prefix and by the callee's signature.

    Reference parity: utils.py:119-136.
    """
    if prefix:
        args = {
            key[len(prefix) + 1 :]: value
            for key, value in kwargs.items()
            if key.startswith(prefix)
        }
    else:
        args = kwargs
    if _func is not None:
        arg_spec = inspect.getfullargspec(
            _func.__init__ if inspect.isclass(_func) else _func
        )
        if arg_spec.varkw:
            return args
        pnames = inspect.signature(_func).parameters
        return {key: args[key] for key in args if key in pnames}
    return args


def keyMap(dic, key_mapping: Dict):
    """Rename dict keys (one-to-one or one-to-many).

    Reference parity: utils.py:139-156.  Also accepts Data/Batch objects.
    """
    if isinstance(dic, dict):
        result = {}
        for key, value in dic.items():
            if key in key_mapping:
                new_key = key_mapping[key]
                if isinstance(new_key, str):
                    result[new_key] = value
                else:
                    for item in new_key:
                        result[item] = value
            else:
                result[key] = value
        return result
    attrs = keyMap(dic.attrs, key_mapping)
    data = keyMap(dic.data, key_mapping)
    return type(dic)(attrs, **data)


def insertAfter(lst, key, item):
    """Insert a (name, node) layer entry after the named layer.

    Reference parity: utils.py:49-54.
    """
    for i, layer in enumerate(lst):
        if layer[0] == key:
            return lst[: i + 1] + [item] + lst[i + 1 :]
    raise ValueError(f"Key {key} not found.")


def replace(lst, key, item):
    """Reference parity: utils.py:56-61."""
    for i, layer in enumerate(lst):
        if layer[0] == key:
            return lst[:i] + [item] + lst[i + 1 :]
    raise ValueError(f"Key {key} not found.")


def getScaler(operations):
    """Batch normalizer for diffusion training: scaling, shifting by another
    key, or mean-centering per graph.

    Reference parity: utils.py:15-47.
    Example args: [('N', ('shift', 'CA', -1)), ('CA', ('scale', 25))]

    Works on host Batch objects AND on device GraphBatches (jit-compatible,
    mask-aware) — diffusion training never round-trips to host.
    """

    def scaler(batch):
        from ..data.graph_batch import GraphBatch

        if isinstance(batch, GraphBatch):
            return _device_scale(batch, operations)
        batch = batch.clone()
        node_segment = batch.nodeSegment()
        for key, op in operations:
            if op[0] == "scale":
                keys = key if isinstance(key, (tuple, list)) else [key]
                for k in keys:
                    batch[k] = batch[k] * op[1]
            elif op[0] == "shift":
                if op[1] == "mean":
                    n_nodes = batch["_n_nodes"].reshape(-1, 1)
                    sums = np.zeros((len(n_nodes), batch[key].shape[1]))
                    np.add.at(sums, node_segment, batch[key])
                    center = sums / n_nodes
                    batch[key] = batch[key] - center[node_segment]
                elif op[1] in batch:
                    sign = op[2] if len(op) == 3 else 1
                    batch[key] = batch[key] + sign * batch[op[1]]
                else:
                    raise ValueError(f"unknown shift target {op[1]!r}")
            else:
                raise ValueError(f"unknown scaler op {op[0]!r}")
        return batch

    return scaler


def _device_scale(batch, operations):
    """jit-compatible GraphBatch version of getScaler's operations."""
    import jax
    import jax.numpy as jnp

    updates = {}

    def cur(k):
        return updates.get(k, batch[k])

    for key, op in operations:
        if op[0] == "scale":
            keys = key if isinstance(key, (tuple, list)) else [key]
            for k in keys:
                updates[k] = cur(k) * op[1]
        elif op[0] == "shift":
            if op[1] == "mean":
                seg = batch["_node_segment"]
                mask = batch["_node_mask"]
                g = batch["_graph_mask"].shape[0]
                x = cur(key) * mask
                sums = jax.ops.segment_sum(x, seg, num_segments=g + 1)[:-1]
                counts = jax.ops.segment_sum(
                    mask[:, 0], seg, num_segments=g + 1
                )[:-1]
                center = sums / jnp.maximum(counts, 1.0)[:, None]
                centered = cur(key) - center[jnp.clip(seg, 0, g - 1)]
                updates[key] = centered * mask
            elif op[1] in updates or op[1] in batch.keys():
                sign = op[2] if len(op) == 3 else 1
                updates[key] = cur(key) + sign * cur(op[1])
            else:
                raise ValueError(f"unknown shift target {op[1]!r}")
        else:
            raise ValueError(f"unknown scaler op {op[0]!r}")
    return batch.replace(**updates)


def countParameters(params) -> int:
    """Total number of parameters in a pytree."""
    import jax

    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))


# minimal periodic table (the reference pulls this from ase.atom.atomic_numbers;
# ase is not available here, so inline the standard symbol order)
ATOMIC_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn",
    "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb",
    "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In",
    "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm",
    "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta",
    "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At",
    "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk",
    "Cf", "Es", "Fm", "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt",
    "Ds", "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]


def default_type_names(num_types: int = None):
    """Equivalent of ``list(ase.atom.atomic_numbers.keys())`` (reference:
    e3_layers/data/dataset.py:42-44, configs/config_energy.py:47)."""
    names = ATOMIC_SYMBOLS
    return names[:num_types] if num_types else list(names)
