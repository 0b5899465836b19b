"""Device mesh / sharding helpers — data parallelism.

The reference's distribution layer is NCCL DDP (train.py:272, trainer.py:
138-139): replicate the model, shard the batch, all-reduce gradients.  Here
a 1-D ``dp`` mesh spans the devices, every GraphBatch leaf is sharded on its
leading (capacity) axis, params stay replicated, and XLA inserts the
gradient all-reduce (NCCL on GPUs) when the jitted train step averages the
loss.

Batch sharding works because GraphBatch leaves are all either
graph-/node-/edge-capacity leading-axis arrays (shardable) and the segment
ids/edge indices are *local* to each graph — provided the capacities are
multiples of the mesh size and graphs never straddle shard boundaries.  The
simpler, always-correct layout used here: each process feeds its own batch
(per-process file sharding, reference dataloader.py:50-56) and inside one
process the batch is sharded by graph via equal-sized sub-batches stacked on
a leading device axis.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: the first ``n_devices`` of
    ``jax.devices()``, or all of them).  Raises when there are fewer devices
    than asked for; it never substitutes devices of another platform."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"mesh of {n_devices} devices asked for, but only "
                    f"{len(devices)} {devices[0].platform} device(s) exist"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def replicated_spec(mesh: Mesh):
    return NamedSharding(mesh, PartitionSpec())


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans devices owned by other processes (multi-host
    DP: each process feeds only its local shard of the global batch)."""
    pi = jax.process_index()
    return any(d.process_index != pi for d in mesh.devices.flat)


def local_mesh_size(mesh: Mesh) -> int:
    """Number of mesh devices owned by this process — the number of batch
    sub-shards this process's loader must produce."""
    pi = jax.process_index()
    return sum(1 for d in mesh.devices.flat if d.process_index == pi)
