#!/usr/bin/env python
"""Conv microbenchmark on a GPU: CG tensor-product contractions per second.

Measures the fused gather -> uvu-TP(+weights) -> mix -> scatter pipeline
(``FusedUVUConv``, bfloat16 compute) at config_energy's hot-layer shapes,
counting one "CG contraction" per (edge, path, output component) triple —
i.e. the number of weighted Clebsch-Gordan product terms evaluated.

Prints one JSON line with the device and the card's name and power limit;
refuses to run without a GPU.
"""

import json
import sys
import time


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from equivariant_nn_zoo.nn.pointwise import TensorProductExpansion
    from equivariant_nn_zoo.ops import Irreps
    from equivariant_nn_zoo.ops.fused_tp import FusedUVUConv
    from equivariant_nn_zoo.utils.device_info import (
        device_record,
        gpu_label,
        require_gpu,
    )

    require_gpu()
    E, N = 28672, 2048
    feats = Irreps("+".join(f"64x{l}e+64x{l}o" for l in range(4)))
    sh_ir = Irreps("1x0e+1x1o+1x2e")
    tpe = TensorProductExpansion(feats, sh_ir, feats, "uvu",
                                 internal_weight=False)
    fused = FusedUVUConv(tpe, compute_dtype=jnp.bfloat16)

    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    x = jax.random.normal(k1, (N, feats.dim))
    sh = jax.random.normal(k2, (E, sh_ir.dim))
    w = jax.random.normal(k3, (E, tpe.tp.weight_numel))
    src = jax.random.randint(k4, (E,), 0, N)
    dst = jax.random.randint(k4, (E,), 0, N)
    lp = {}
    for name, (shape, init) in sorted(tpe.linear.param_specs().items()):
        key, kk = jax.random.split(key)
        lp[name] = jax.random.normal(kk, shape)

    @jax.jit
    def run(c, lp, x, src, dst, sh, w):
        return jnp.sum(fused(lp, x * c, src, dst, sh, w, N))

    cs = jnp.arange(2, 300, dtype=jnp.float32)
    o = run(cs[0], lp, x, src, dst, sh, w)
    jax.block_until_ready(o)
    n_iter = 200
    t0 = time.perf_counter()
    for i in range(n_iter):
        o = run(cs[i % len(cs)], lp, x, src, dst, sh, w)
    jax.block_until_ready(o)
    dt = (time.perf_counter() - t0) / n_iter

    # CG contraction terms per call: sum over paths of mul * d1*d2*d3
    terms = 0
    from equivariant_nn_zoo.ops.wigner import wigner_3j

    for ins in tpe.tp.instructions:
        l1 = tpe.tp.irreps_in1[ins.i_in1].ir.l
        l2 = tpe.tp.irreps_in2[ins.i_in2].ir.l
        l3 = tpe.tp.irreps_out[ins.i_out].ir.l
        terms += 64 * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
    contractions_per_sec = E * terms / dt
    print(json.dumps({
        "metric": "cg_tensor_product_contractions",
        "value": contractions_per_sec / 1e9,
        "unit": "G contractions/sec",
        "detail": {
            "edges": E, "paths": len(tpe.tp.instructions),
            "terms_per_edge": terms, "ms_per_call": dt * 1e3,
        },
        "device": device_record(),
        "gpu": gpu_label(),
    }))


if __name__ == "__main__":
    sys.exit(main())
