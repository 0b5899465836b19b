"""GraphBatch — the device-facing, statically-shaped view of a batch of graphs.

This is the single biggest architectural inversion vs the reference: the
reference concatenates graphs without padding (e3_layers/data/batch.py,
README "no padding"), which is hostile to XLA.  Here every batch is padded to
fixed ``(n_graphs, node_capacity, edge_capacity)`` so the whole train step
compiles once:

- nodes:  ``[node_capacity, d]`` with the LAST slot reserved as a dummy node;
- edges:  ``[edge_capacity, ...]``; padded edges point src=dst=dummy node, so
  gathers read zeros/inert values and scatters land in the dummy row;
- graphs: ``[n_graphs, d]`` plus a ``_graph_mask`` (a batch may carry fewer
  real graphs, e.g. after capacity overflow dropping);
- ``_node_segment``/``_edge_segment`` map into ``n_graphs + 1`` segments, the
  last being the padding segment (dropped after each segment reduction).

GraphBatch is a pytree: arrays are leaves, (attrs, capacities) are static, so
it flows through jit/pjit/scan and can be sharded over a mesh on the graph
axis for data parallelism.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import numpy as np

from .batch import Batch


@jax.tree_util.register_pytree_node_class
class GraphBatch:
    __slots__ = (
        "data", "attrs", "n_graphs", "node_capacity", "edge_capacity", "dropped",
    )

    def __init__(self, data, attrs, n_graphs, node_capacity, edge_capacity,
                 dropped: int = 0):
        self.data: Dict = data
        self.attrs: Dict[str, Tuple[str, str]] = attrs
        self.n_graphs = n_graphs
        self.node_capacity = node_capacity
        self.edge_capacity = edge_capacity
        # host-side bookkeeping only (not part of the pytree): graphs that did
        # not fit the static capacities when this batch was padded
        self.dropped = dropped

    # -- pytree protocol ----------------------------------------------------

    def tree_flatten(self):
        keys = tuple(sorted(self.data.keys()))
        leaves = tuple(self.data[k] for k in keys)
        aux = (
            keys,
            tuple(sorted((k, tuple(v)) for k, v in self.attrs.items())),
            self.n_graphs,
            self.node_capacity,
            self.edge_capacity,
        )
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        keys, attrs, n_graphs, node_capacity, edge_capacity = aux
        return cls(
            dict(zip(keys, leaves)),
            {k: v for k, v in attrs},
            n_graphs,
            node_capacity,
            edge_capacity,
        )

    # -- dict-ish access ----------------------------------------------------

    def __getitem__(self, key):
        return self.data[key]

    def __contains__(self, key):
        return key in self.data

    def keys(self):
        return self.data.keys()

    def replace(self, **updates) -> "GraphBatch":
        data = dict(self.data)
        data.update(updates)
        return GraphBatch(
            data, dict(self.attrs), self.n_graphs, self.node_capacity,
            self.edge_capacity,
        )

    @property
    def dummy_node(self) -> int:
        return self.node_capacity - 1

    @property
    def padding_segment(self) -> int:
        return self.n_graphs

    # -- wire format ---------------------------------------------------------
    #
    # to_wire() flattens the batch into ONE contiguous buffer per dtype
    # (all leaves are f32 or i32 by from_batch's coercion), so a batch
    # goes to the device in 2 transfers instead of one per leaf (~14);
    # from_wire() re-slices the blobs with static offsets INSIDE the step
    # jit, where XLA fuses the slices.  Whether this pays on a local GPU
    # is open: it was built for a backend with a high per-transfer cost.

    _WIRE_KEY = "_wire_spec"

    def to_wire(self) -> "GraphBatch":
        """Host-side: pack every leaf into one 1-D numpy blob per dtype."""
        if self._WIRE_KEY in self.attrs:
            return self
        blobs: Dict[str, list] = {}
        spec = []
        offs: Dict[str, int] = {}
        for key in sorted(self.data.keys()):
            a = np.asarray(self.data[key])
            kind = "f" if a.dtype.kind == "f" else "i"
            a = a.astype(np.float32 if kind == "f" else np.int32,
                         copy=False)
            off = offs.get(kind, 0)
            spec.append((key, kind, tuple(int(s) for s in a.shape), off))
            offs[kind] = off + a.size
            blobs.setdefault(kind, []).append(a.reshape(-1))
        data = {
            f"_wire_{kind}": np.concatenate(parts)
            for kind, parts in blobs.items()
        }
        attrs = dict(self.attrs)
        attrs[self._WIRE_KEY] = tuple(spec)
        return GraphBatch(data, attrs, self.n_graphs, self.node_capacity,
                          self.edge_capacity, dropped=self.dropped)

    def from_wire(self) -> "GraphBatch":
        """Unpack a wire batch (identity on a regular one); jit-traceable."""
        spec = self.attrs.get(self._WIRE_KEY)
        if spec is None:
            return self
        data = {}
        for key, kind, shape, off in spec:
            size = int(np.prod(shape)) if shape else 1
            blob = self.data[f"_wire_{kind}"]
            data[key] = jax.lax.slice(blob, (off,), (off + size,)).reshape(
                shape
            )
        attrs = {k: v for k, v in self.attrs.items() if k != self._WIRE_KEY}
        return GraphBatch(data, attrs, self.n_graphs, self.node_capacity,
                          self.edge_capacity, dropped=self.dropped)

    # -- conversion ---------------------------------------------------------

    @classmethod
    def from_batch(
        cls,
        batch: Batch,
        node_capacity: int,
        edge_capacity: int,
        n_graphs: int = None,
    ) -> "GraphBatch":
        """Pad a host Batch to static capacities (numpy; no device transfer).

        Graphs that don't fit the capacities are dropped from the tail and
        the count is recorded in ``.dropped`` (never silently ignored —
        the dataloader logs it).
        """
        batch.computeCumsums()
        g_total = batch.n_graphs
        n_graphs = g_total if n_graphs is None else n_graphs

        n_nodes = batch.data["_n_nodes"][:, 0].astype(np.int64)
        has_edges = "_n_edges" in batch.data
        n_edges = (
            batch.data["_n_edges"][:, 0].astype(np.int64)
            if has_edges
            else np.zeros(g_total, np.int64)
        )
        # how many graphs fit (one node slot reserved for the dummy node)
        g_keep = 0
        nodes_used = edges_used = 0
        for i in range(min(g_total, n_graphs)):
            if (
                nodes_used + n_nodes[i] <= node_capacity - 1
                and edges_used + n_edges[i] <= edge_capacity
            ):
                nodes_used += int(n_nodes[i])
                edges_used += int(n_edges[i])
                g_keep += 1
            else:
                break
        dropped = min(g_total, n_graphs) - g_keep

        N, E, G = node_capacity, edge_capacity, n_graphs
        dummy = N - 1
        data: Dict[str, np.ndarray] = {}
        node_seg = np.full((N,), G, dtype=np.int32)
        node_seg[:nodes_used] = batch.nodeSegment()[:nodes_used]
        data["_node_segment"] = node_seg
        edge_seg = np.full((E,), G, dtype=np.int32)
        if has_edges:
            edge_seg[:edges_used] = batch.edgeSegment()[:edges_used]
        data["_edge_segment"] = edge_seg
        node_mask = np.zeros((N, 1), np.float32)
        node_mask[:nodes_used] = 1.0
        data["_node_mask"] = node_mask
        edge_mask = np.zeros((E, 1), np.float32)
        edge_mask[:edges_used] = 1.0
        data["_edge_mask"] = edge_mask
        graph_mask = np.zeros((G, 1), np.float32)
        graph_mask[:g_keep] = 1.0
        data["_graph_mask"] = graph_mask

        def pad_to(a, rows, fill=0):
            out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
            out[: min(len(a), rows)] = a[: min(len(a), rows)]
            return out

        if "edge_index" not in batch.data:
            # no host-side edges: synthesize empty buffers at capacity so a
            # device-side edge layer (computeEdgeIndexDevice) can fill them
            data["edge_index"] = np.full((2, E), dummy, dtype=np.int32)
            data["_n_edges"] = np.zeros((G, 1), np.int32)

        for key, value in batch.data.items():
            if key in ("_node_segment", "_edge_segment"):
                continue
            if key == "edge_index":
                ei = np.full((2, E), dummy, dtype=np.int32)
                ei[:, :edges_used] = value[:, :edges_used]
                data[key] = ei
                continue
            per = batch.attrs.get(key, ("graph",))[0]
            if np.issubdtype(value.dtype, np.floating):
                value = value.astype(np.float32)
            elif np.issubdtype(value.dtype, np.integer):
                value = value.astype(np.int32)
            if per == "node":
                data[key] = pad_to(value[:nodes_used], N)
            elif per == "edge":
                data[key] = pad_to(value[:edges_used], E)
            else:  # graph
                data[key] = pad_to(value[:g_keep], G)

        return cls(data, dict(batch.attrs), G, N, E, dropped=dropped)

    def to_batch(self) -> Batch:
        """Trim padding and return a host-side Batch (for dumps/analysis)."""
        data = {k: np.asarray(v) for k, v in self.data.items()}
        g = int(data["_graph_mask"][:, 0].sum())
        # compact by mask (real nodes and edges form a prefix) and renumber
        # edge endpoints to the compacted node ids
        n_sel = data["_node_mask"][:, 0] > 0
        e_sel = data["_edge_mask"][:, 0] > 0
        inv = np.zeros(len(n_sel), np.int64)
        inv[n_sel] = np.arange(int(n_sel.sum()))
        out = {}
        for key, value in data.items():
            if key.startswith("_") and key not in ("_n_nodes", "_n_edges"):
                continue
            if key == "edge_index":
                out[key] = inv[value[:, e_sel].astype(np.int64)]
                continue
            per = self.attrs.get(key, ("graph",))[0]
            if per == "node":
                out[key] = value[n_sel]
            elif per == "edge":
                out[key] = value[e_sel]
            else:
                out[key] = value[:g]
        return Batch(dict(self.attrs), **out)
