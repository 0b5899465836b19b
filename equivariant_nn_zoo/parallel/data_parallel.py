"""Data-parallel training over a device mesh via shard_map.

The replacement for the reference's DDP/NCCL layer (SURVEY.md §2.3-2.4): each device holds a full replica of the params and its own
shard of the batch; the per-device computation is *closed* (graphs never
straddle devices because each device gets its own padded sub-batch), and the
only cross-device traffic is the gradient/loss psum over the ``dp`` axis that
JAX inserts when differentiating through shard_map — the exact analogue of
DDP's bucketed all-reduce, but compiled into the step by XLA.

Usage:
    mesh = make_mesh(8)
    shards = [GraphBatch(...), ...]          # one per device, equal shapes
    stacked = stack_shards(shards)           # leaves get leading [D] axis
    step = make_dp_train_step(model, loss, optimizer, mesh, stacked)
    params, opt_state, ema, loss = step(params, opt_state, ema, stacked)
"""

from __future__ import annotations

from functools import partial
from typing import Callable, List

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.graph_batch import GraphBatch


def stack_shards(shards: List[GraphBatch]) -> GraphBatch:
    """Stack per-device GraphBatches into one with leading [D] leaf axes.

    All shards must have identical static shapes.  The result's static
    metadata describes the *local* (per-device) batch.
    """
    first = shards[0]
    data = {
        k: np.stack([np.asarray(s.data[k]) for s in shards])
        for k in first.data
    }
    return GraphBatch(
        data, dict(first.attrs), first.n_graphs, first.node_capacity,
        first.edge_capacity,
    )


def _local_batch(stacked: GraphBatch) -> GraphBatch:
    """Inside shard_map: strip the leading (device) axis of size 1."""
    data = {k: v[0] for k, v in stacked.data.items()}
    return GraphBatch(
        data, dict(stacked.attrs), stacked.n_graphs, stacked.node_capacity,
        stacked.edge_capacity,
    )


def put_sharded(stacked: GraphBatch, mesh: Mesh, axis: str = "dp") -> GraphBatch:
    """Place a stacked batch so its leading axis is split over the mesh.

    Single-process meshes device_put the whole array; multi-process (multi-
    host) meshes assemble the global batch from each process's local shards
    via ``jax.make_array_from_process_local_data`` — the leading axis of
    ``stacked`` then holds only this process's sub-batches."""
    from .mesh import is_multiprocess

    sharding = NamedSharding(mesh, P(axis))
    if is_multiprocess(mesh):
        data = {
            k: jax.make_array_from_process_local_data(
                sharding, np.asarray(v)
            )
            for k, v in stacked.data.items()
        }
    else:
        data = {k: jax.device_put(v, sharding) for k, v in stacked.data.items()}
    return GraphBatch(
        data, dict(stacked.attrs), stacked.n_graphs, stacked.node_capacity,
        stacked.edge_capacity,
    )


def make_dp_loss_fn(model, loss_obj, mesh: Mesh, axis: str = "dp") -> Callable:
    """Mean loss over all shards: per-device masked sums + psum."""

    def local_loss(params, stacked):
        batch = _local_batch(stacked)
        out = model.apply(params, batch)
        loss, contrib = loss_obj(out.data, batch.data)
        # average the per-device means over the dp axis
        loss = jax.lax.pmean(loss, axis)
        contrib = {k: jax.lax.pmean(v, axis) for k, v in contrib.items()}
        return loss, contrib

    from jax import shard_map

    specs_in = (P(), P(axis))
    sharded = shard_map(
        local_loss, mesh=mesh, in_specs=specs_in, out_specs=(P(), P()),
        
    )
    return sharded


def make_dp_train_step(model, loss_obj, optimizer, mesh: Mesh,
                       ema_update=None, axis: str = "dp") -> Callable:
    """One jitted DP train step: grads psum'd over the mesh by autodiff."""
    loss_fn = make_dp_loss_fn(model, loss_obj, mesh, axis)

    @partial(jax.jit, donate_argnums=(0, 1, 2))
    def step(params, opt_state, ema, stacked):
        (loss, contrib), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params, stacked)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(
            lambda p, u: p + u, params, updates
        )
        if ema_update is not None and ema is not None:
            ema = ema_update(ema, params)
        return params, opt_state, ema, loss, contrib

    return step
