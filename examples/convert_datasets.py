#!/usr/bin/env python
"""Dataset conversion utilities — script parity for the reference's
``data.ipynb`` (C30 in SURVEY.md §2): QM9 npz -> condensed HDF5, padded-HDF5
-> condensed Batch, and dataset statistics (incl. the per-species GP solve
used to produce the energy shifts in config_energy).

Usage:
    python examples/convert_datasets.py qm9 INPUT.npz OUT.hdf5
    python examples/convert_datasets.py stats DATASET.hdf5 field-mode [...]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from equivariant_nn_zoo.data.batch import Batch
from equivariant_nn_zoo.data.dataset import CondensedDataset


def convert_qm9(npz_path, out_path):
    """QM9 npz (padded R/Z arrays per molecule) -> condensed HDF5.

    Mirrors data.ipynb cells 9-14: drop padding atoms (Z == 0), concatenate,
    and annotate irreps.
    """
    f = np.load(npz_path, allow_pickle=True)
    R, Z, U0 = f["R"], f["Z"], f["U0"] if "U0" in f else f["U"]
    items = []
    for i in range(len(Z)):
        z = np.asarray(Z[i]).reshape(-1)
        mask = z > 0
        items.append({
            "R": np.asarray(R[i]).reshape(-1, 3)[mask].astype(np.float32),
            "Z": z[mask].reshape(-1, 1).astype(np.int64),
            "U0": np.asarray(U0[i]).reshape(1, 1).astype(np.float32),
            "_n_nodes": int(mask.sum()),
        })
    attrs = {
        "R": ("node", "1x1o"),
        "Z": ("node", "1x0e"),
        "U0": ("graph", "1x0e"),
        "_n_nodes": ("graph", "1x0e"),
    }
    batch = Batch.from_data_list(items, attrs)
    batch.dumpHDF5(out_path)
    print(f"wrote {len(batch)} molecules to {out_path}")


def convert_padded_hdf5(in_path, out_path, pad_key="Z", pad_value=0):
    """Padded per-molecule HDF5 -> condensed Batch (data.ipynb parity)."""
    import h5py

    with h5py.File(in_path) as f:
        keys = list(f.keys())
        arrays = {k: np.asarray(f[k]) for k in keys}
        attrs = {k: tuple(v) for k, v in f.attrs.items()}
    n_mol = len(arrays[pad_key])
    items = []
    for i in range(n_mol):
        mask = np.asarray(arrays[pad_key][i]).reshape(-1) != pad_value
        item = {}
        for k, v in arrays.items():
            vi = np.asarray(v[i])
            item[k] = vi[mask] if vi.shape[:1] == mask.shape else vi
        item["_n_nodes"] = int(mask.sum())
        items.append(item)
    Batch.from_data_list(items, attrs).dumpHDF5(out_path)
    print(f"wrote {n_mol} graphs to {out_path}")


def statistics(path, fields, stride=1):
    """e.g. fields = ['U0-per-Z-mean_std'] reproduces the per-species energy
    shifts hardcoded in config_energy (data.ipynb cell 41)."""
    ds = CondensedDataset(path=path)
    out = ds.statistics(fields, stride=stride)
    for field, res in zip(fields, out):
        print(field, "->")
        for r in res:
            print(np.asarray(r))
    return out


if __name__ == "__main__":
    cmd = sys.argv[1]
    if cmd == "qm9":
        convert_qm9(sys.argv[2], sys.argv[3])
    elif cmd == "padded":
        convert_padded_hdf5(sys.argv[2], sys.argv[3])
    elif cmd == "stats":
        statistics(sys.argv[2], sys.argv[3:])
    else:
        raise SystemExit(__doc__)
