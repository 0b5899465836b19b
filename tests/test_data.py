"""Dataset loading variants (file/dir/regex/list), file sharding, capacity
estimation, loader state."""

import numpy as np
import h5py
import pytest

from equivariant_nn_zoo.data import Batch, Data
from equivariant_nn_zoo.data.dataloader import (
    DataLoader,
    estimate_capacities,
    shard_paths,
)
from equivariant_nn_zoo.data.dataset import CondensedDataset


RNG = np.random.default_rng(9)


def write_file(path, n_mols=8, tag=0.0):
    items = []
    for _ in range(n_mols):
        n = int(RNG.integers(3, 7))
        items.append({
            "pos": RNG.normal(size=(n, 3)).astype(np.float32) + tag,
            "species": RNG.integers(1, 5, size=(n, 1)),
            "y": np.asarray([[tag]], np.float32),
            "_n_nodes": n,
        })
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "y": ("graph", "1x0e"), "_n_nodes": ("graph", "1x0e")}
    Batch.from_data_list(items, attrs).dumpHDF5(str(path))


def test_load_single_file(tmp_path):
    write_file(tmp_path / "a.hdf5")
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    assert len(ds) == 8
    assert ds.attrs["pos"] == ("node", "1x1o")


def test_load_directory_and_regex(tmp_path):
    write_file(tmp_path / "a.hdf5", tag=1.0)
    write_file(tmp_path / "b.hdf5", tag=2.0)
    write_file(tmp_path / "skip.other.hdf5", tag=3.0)
    ds = CondensedDataset(path=str(tmp_path))
    assert len(ds) == 24
    ds2 = CondensedDataset(path=f"{tmp_path}:.*[ab]\\.hdf5")
    assert len(ds2) == 16


def test_load_list_of_paths(tmp_path):
    write_file(tmp_path / "a.hdf5", tag=1.0)
    write_file(tmp_path / "b.hdf5", tag=2.0)
    ds = CondensedDataset(
        path=[str(tmp_path / "a.hdf5"), str(tmp_path / "b.hdf5")]
    )
    assert len(ds) == 16


def test_key_map_one_to_many(tmp_path):
    write_file(tmp_path / "a.hdf5")
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"),
                          key_map={"species": ("Z", "atom_types")})
    assert "Z" in ds.data and "atom_types" in ds.data
    assert "species" not in ds.data


def test_shard_paths():
    paths = [f"f{i}" for i in range(8)]
    # 4 processes x 8 files -> each gets 2
    shards = [shard_paths(paths, r, 4) for r in range(4)]
    assert all(len(s) == 2 for s in shards)
    assert sorted(sum(shards, [])) == sorted(paths)
    # gcd sharding: 3 processes x 8 files -> gcd 1, everyone gets all
    assert shard_paths(paths, 1, 3) == paths
    # non-list passes through
    assert shard_paths("single.hdf5", 0, 4) == "single.hdf5"


def test_estimate_capacities_covers_max(tmp_path):
    write_file(tmp_path / "a.hdf5")
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    node_cap, edge_cap = estimate_capacities(ds, batch_size=4)
    max_nodes = int(np.asarray(ds["_n_nodes"]).max())
    assert node_cap > max_nodes
    assert node_cap % 128 == 0


def test_loader_iterates_and_state(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=12)
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    dl = DataLoader(ds, batch_size=4, shuffle=True, seed=3, prefetch=0)
    batches = list(dl)
    assert len(batches) == 3
    assert all(b.n_graphs == 4 for b in batches)
    state = dl.state_dict()
    dl2 = DataLoader(ds, batch_size=4, shuffle=True, seed=99, prefetch=0)
    dl2.load_state_dict(state)
    a = np.asarray(next(iter(dl))["pos"])
    b = np.asarray(next(iter(dl2))["pos"])
    np.testing.assert_array_equal(a, b)


def test_loader_defers_overflow(tmp_path):
    """With tight capacities, single-shard loaders carry overflowing graphs
    to the next batch instead of dropping them — every graph is seen once."""
    write_file(tmp_path / "a.hdf5", n_mols=16)
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    sizes = [int(n) for n in np.asarray(ds["_n_nodes"]).reshape(-1)]
    # capacity fits ~3 of 4 graphs per batch -> every batch defers some
    tight = int(np.ceil(np.mean(sizes) * 3)) + 1
    dl = DataLoader(ds, batch_size=4, node_capacity=tight,
                    edge_capacity=512, prefetch=0, shuffle=False)
    seen = 0.0
    batches = list(dl)
    for b in batches:
        seen += float(np.asarray(b["_graph_mask"]).sum())
    # graphs deferred past the final batch carry into the NEXT epoch —
    # nothing is ever dropped
    assert dl.dropped_graphs == 0
    assert seen + len(dl._carry) == 16
    assert seen > 8  # deferral actually produced fuller batches than drops


def test_loader_epoch_carry_never_drops(tmp_path):
    """Graphs deferred past an epoch's last batch lead the next epoch: over
    k epochs every graph is consumed exactly k times (modulo the final
    pending carry) and ``dropped_graphs`` stays 0.  Reference parity: the
    torch loader never loses data (e3_layers/data/dataloader.py:109-117)."""
    write_file(tmp_path / "a.hdf5", n_mols=16)
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    sizes = [int(n) for n in np.asarray(ds["_n_nodes"]).reshape(-1)]
    tight = int(np.ceil(np.mean(sizes) * 3)) + 1
    dl = DataLoader(ds, batch_size=4, node_capacity=tight,
                    edge_capacity=512, prefetch=0, shuffle=False)
    k = 3
    seen = 0.0
    for _ in range(k):
        for b in dl:
            seen += float(np.asarray(b["_graph_mask"]).sum())
    assert dl.dropped_graphs == 0
    assert seen + len(dl._carry) == k * 16
    # the carry is bounded (it drains at each epoch start, not accumulates)
    assert len(dl._carry) < 16


def test_loader_workers_match_serial(tmp_path):
    """num_workers>0 parallelizes item preprocessing (the protein-pipeline
    hotspot) in forked processes; batches must be identical to the serial
    loader, in order.  Reference parity: torch DataLoader workers
    (e3_layers/run/trainer.py:286-299)."""
    from functools import partial

    from equivariant_nn_zoo.data.compute_edge import computeEdgeIndex

    write_file(tmp_path / "a.hdf5", n_mols=12)
    kw = dict(path=str(tmp_path / "a.hdf5"),
              preprocess=[partial(computeEdgeIndex, r_max=2.5)])
    serial = DataLoader(CondensedDataset(**kw), batch_size=4, shuffle=True,
                        seed=7, prefetch=0)
    par = DataLoader(CondensedDataset(**kw), batch_size=4, shuffle=True,
                     seed=7, prefetch=2, num_workers=2)
    a = list(serial)
    b = list(par)
    par.close()
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for k in x.data:
            np.testing.assert_array_equal(
                np.asarray(x[k]), np.asarray(y[k]), err_msg=k
            )


def test_loader_drop_last_false(tmp_path):
    write_file(tmp_path / "a.hdf5", n_mols=10)
    ds = CondensedDataset(path=str(tmp_path / "a.hdf5"))
    dl = DataLoader(ds, batch_size=4, drop_last=False, prefetch=0)
    batches = list(dl)
    assert len(batches) == 3
    # last batch padded with empty graphs, masked out
    last = batches[-1]
    assert float(np.asarray(last["_graph_mask"]).sum()) == 2


def test_graphbatch_wire_roundtrip():
    """to_wire packs every leaf into one blob per dtype; from_wire (inside
    jit or eager) reconstructs values, shapes, dtype kinds, and attrs."""
    import jax
    import jax.numpy as jnp

    from equivariant_nn_zoo.data import GraphBatch

    items = []
    for _ in range(4):
        n = int(RNG.integers(3, 7))
        ei = np.stack([RNG.integers(0, n, 10), RNG.integers(0, n, 10)])
        items.append({
            "pos": RNG.normal(size=(n, 3)).astype(np.float32),
            "species": RNG.integers(1, 5, size=(n, 1)),
            "edge_index": ei.astype(np.int64),
            "y": np.asarray([[1.5]], np.float32),
            "_n_nodes": n,
        })
    attrs = {"pos": ("node", "1x1o"), "species": ("node", "1x0e"),
             "y": ("graph", "1x0e"), "_n_nodes": ("graph", "1x0e")}
    gb = GraphBatch.from_batch(
        Batch.from_data_list(items, attrs), 64, 64, 4
    )
    w = gb.to_wire()
    assert set(w.data.keys()) == {"_wire_f", "_wire_i"}
    # identity / idempotence
    assert gb.from_wire() is gb
    assert w.to_wire() is w
    r = w.from_wire()
    assert set(r.data.keys()) == set(gb.data.keys())
    for k in gb.data:
        a, b = np.asarray(gb.data[k]), np.asarray(r.data[k])
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, k
        np.testing.assert_array_equal(
            a.astype(np.float64), b.astype(np.float64), err_msg=k
        )
    assert r.attrs == gb.attrs

    # through a jit boundary (the production path: device_put the wire
    # batch, unpack inside the step)
    f = jax.jit(lambda b: (b.from_wire()["pos"].sum()
                           + b.from_wire()["edge_index"].sum()))
    g = jax.jit(lambda b: (b["pos"].sum()
                           + b["edge_index"].astype(jnp.float32).sum()))
    assert abs(float(f(jax.device_put(w)))
               - float(g(jax.device_put(gb)))) < 1e-4
