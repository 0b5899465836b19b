"""Host-side data model: a dict of numpy arrays with irreps annotations.

Reference parity: e3_layers/data/data.py (C1 in SURVEY.md §2).  Host data
stays ragged/concatenated exactly like the reference (that is fine on CPU);
the device-facing counterpart is ``graph_batch.GraphBatch`` which pads
everything to static capacities before crossing to the device.

Each tensor is shaped ``[cat_dim, irreps_dim]`` and annotated
``attrs[key] = (is_per, irreps)`` with ``is_per in {graph, node, edge}``.
Keys starting with an underscore are auxiliary (``_n_nodes``, ``_n_edges``).
"""

from __future__ import annotations

import copy
import re
from typing import Dict

import numpy as np

from ..ops.irreps import irreps_dim


class Data:
    """A single graph (or a raw dict of annotated tensors)."""

    def __init__(self, attrs=None, **tensors):
        self.attrs = dict(attrs) if attrs else {}
        self.data: Dict[str, np.ndarray] = {}
        for key, value in tensors.items():
            self[key] = value

    # -- dict protocol ------------------------------------------------------

    def keys(self):
        return self.data.keys()

    def items(self):
        return list(self.data.items())

    def __contains__(self, key):
        return key in self.data

    def __len__(self):
        return len(self.data)

    def __getitem__(self, key):
        return self.data[key]

    def __setitem__(self, key, item):
        item = np.asarray(item)
        dim = self.num_dims(key)
        if dim is not None and not (item.ndim == 2 and item.shape[-1] == dim):
            item = item.reshape(-1, dim)
        self.data[key] = item
        self.computeSums()

    def update(self, other):
        other = other.items() if hasattr(other, "items") else other
        for key, value in other:
            self[key] = value

    def pop(self, key):
        self.data.pop(key, None)
        self.attrs.pop(key, None)

    # -- semantics ----------------------------------------------------------

    def num_dims(self, key):
        """Declared feature dim of a key, or None if unannotated.

        Reference parity: data.py:73-85.
        """
        if key in self.attrs:
            return irreps_dim(self.attrs[key][1])
        return None

    def __cat_dim__(self, key):
        """Concat dim when batching: edge_index/face concat on -1.

        Reference parity: data.py:112-124.
        """
        return -1 if re.search("(index|face)", key) else 0

    def computeSums(self):
        node_key = edge_key = graph_key = None
        for key in self.data:
            if key not in self.attrs:
                continue
            per = self.attrs[key][0]
            if per == "node":
                node_key = key
            elif per == "edge":
                edge_key = key
            elif per == "graph":
                graph_key = key
        if node_key:
            self.n_nodes = self.data[node_key].shape[self.__cat_dim__(node_key)]
        if edge_key:
            self.n_edges = self.data[edge_key].shape[self.__cat_dim__(edge_key)]
        if graph_key:
            self.n_graphs = self.data[graph_key].shape[self.__cat_dim__(graph_key)]

    def clone(self):
        return type(self)(
            copy.deepcopy(self.attrs),
            **{k: np.array(v, copy=True) for k, v in self.data.items()},
        )

    def __call__(self, *keys):
        for key in sorted(self.keys()) if not keys else keys:
            if key in self:
                yield key, self[key]

    def __repr__(self):
        data = {k: (v.shape, v.dtype) for k, v in self.data.items()}
        return f"attrs:{self.attrs}\n tensors:{data}"

    # -- IO -----------------------------------------------------------------

    def dumpHDF5(self, path):
        """Reference parity: data.py:226-238."""
        import h5py

        with h5py.File(path, "w") as f:
            for key in self.keys():
                if key in ("_node_segment", "_edge_segment"):
                    continue
                f[key] = np.asarray(self[key])
            for key, value in self.attrs.items():
                if key in ("_node_segment", "_edge_segment"):
                    continue
                f.attrs[key] = tuple(str(x) for x in value) if isinstance(
                    value, (tuple, list)
                ) else value
