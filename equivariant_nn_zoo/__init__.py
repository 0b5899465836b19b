"""equivariant_nn_zoo — an E(3)-equivariant neural network framework with
the capabilities of 20171130/Equivariant-NN-Zoo, rebuilt from scratch on
JAX/XLA.

Subpackages:
- ops:      irreps algebra, Wigner/CG tables, spherical harmonics, tensor
            products (incl. the fused conv), equivariant nonlinearities, segment ops.
- data:     padded static-shape graph batches, HDF5 datasets, edge building.
- nn:       the layer zoo (embeddings, message passing, output heads) and the
            key-matched sequential DAG executor.
- run:      trainer, losses, metrics, early stopping, SDE diffusion, samplers.
- models:   named workload configs (energy, forces, dipole, hamiltonian,
            diffusion) — the model definitions, as data.
- parallel: device mesh / sharding helpers (shard_map data parallelism).
- utils:    config dict, build/reflection, key mapping, atomic async
            checkpoint IO, stats, compile cache, device label, trace reader.
"""

__version__ = "0.1.0"
