#!/usr/bin/env python
"""Infer the irreps content / change-of-basis of matrix-valued data — script
parity for the reference's ``infer representation from data.ipynb`` (C30 in
SURVEY.md §2).

Given samples of a matrix H(g) that transforms as D_l(g) H D_r(g)^T for an
unknown decomposition, find the irrep content and the change-of-basis by a
null-space solve of the commutation constraint against the known Wigner
matrices — the same technique the notebook uses to recover the Hamiltonian
basis convention.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from equivariant_nn_zoo.ops import Irreps, irreps_d, rand_matrix


def infer_change_of_basis(samples_in, samples_out, irreps):
    """Find Q with samples_out[i] ~= Q @ samples_in[i] for all i, where both
    transform under ``irreps``: solve the linear system in lstsq sense and
    report the residual."""
    X = np.stack([s.reshape(-1) for s in samples_in])
    d = samples_in[0].shape[-1]
    # vec(Q S) = (I ⊗ Q) vec(S): solve per-column blocks via lstsq
    A = np.concatenate([np.kron(np.eye(1), s.T) for s in samples_in])
    B = np.concatenate([s for s in samples_out])
    Q, *_ = np.linalg.lstsq(A, B, rcond=None)
    Q = Q.T
    resid = max(
        np.abs(Q @ si - so).max() for si, so in zip(samples_in, samples_out)
    )
    return Q, resid


def infer_irrep_content(transform_samples, max_l=3):
    """Given pairs (g, M(g)) of a representation matrix-valued function,
    count each irrep's multiplicity from the trace (character) inner
    product: mul_l = <chi_M, chi_l>."""
    counts = {}
    for l in range(max_l + 1):
        acc = 0.0
        for g, M in transform_samples:
            chi_M = np.trace(M)
            chi_l = np.trace(irreps_d(Irreps(f"1x{l}e"), g))
            acc += chi_M * chi_l
        counts[l] = acc / len(transform_samples)
    return counts


def main():
    rng = np.random.default_rng(0)
    irreps = Irreps("1x0e+1x1o+1x2e")
    # hidden change of basis
    d = irreps.dim
    Q_true, _ = np.linalg.qr(rng.normal(size=(d, d)))
    gs = [rand_matrix(rng) for _ in range(4000)]
    # the unknown representation: M(g) = Q D(g) Q^T
    samples = [(g, Q_true @ irreps_d(irreps, g) @ Q_true.T) for g in gs]

    counts = infer_irrep_content(samples, max_l=3)
    print("estimated multiplicity per degree (expect ~1,1,1,0):")
    for l, c in counts.items():
        print(f"  l={l}: {c:.2f}")

    # recover the change of basis: find Q with M(g) Q = Q D(g)
    rows = []
    for g, M in samples:
        D = irreps_d(irreps, g)
        # row-major vec: vec(M Q) = (M ⊗ I) vec(Q), vec(Q D) = (I ⊗ D^T) vec(Q)
        rows.append(np.kron(M, np.eye(d)) - np.kron(np.eye(d), D.T))
    A = np.concatenate(rows)
    _, s, vh = np.linalg.svd(A, full_matrices=False)
    null_dim = int((s < 1e-8).sum())
    print(f"commutant dimension: {null_dim} (= sum of squared "
          "multiplicities of distinct irreps when Q exists)")
    Q_est = vh[-1].reshape(d, d)
    # verify it intertwines
    g = rand_matrix(rng)
    M = Q_true @ irreps_d(irreps, g) @ Q_true.T
    err = np.abs(M @ Q_est - Q_est @ irreps_d(irreps, g)).max()
    print(f"intertwiner residual: {err:.2e}")


if __name__ == "__main__":
    main()
