"""Top device kernels of one bench.py workload's train step on a GPU.

    python tools/profile_step.py [mode] [batch_size] [n_steps]

mode is a bench.py workload (energy, energy_force, dipole, hamiltonian,
diffusion).  Traces ``n_steps`` steady steps and prints device busy time,
idle share and the top kernels per step, with the card's label.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main():
    import jax

    from equivariant_nn_zoo.utils.compile_cache import setup_compile_cache
    from equivariant_nn_zoo.utils.device_info import gpu_label, require_gpu

    mode = sys.argv[1] if len(sys.argv) > 1 else "energy"
    batch_size = int(sys.argv[2]) if len(sys.argv) > 2 else None
    n_steps = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    require_gpu()
    setup_compile_cache()
    wl = bench.build_workload(mode, batch_size)
    out = None
    for i in range(8):  # compile + warm-up
        out = wl.step(i)
    jax.block_until_ready(out)
    s = bench.trace_steps(wl.step, n_steps, top=30)
    print(f"[{gpu_label()}] {mode} batch {wl.batch_size}: device "
          f"{s['device_ms_per_step']:.3f} ms/step busy, "
          f"{s['kernel_ms_per_step']:.3f} ms/step in kernels, window "
          f"{s['window_ms_per_step']:.3f} ms/step, idle share "
          f"{s['idle_share']:.3f}")
    for name, ms in s["top_kernels_ms_per_step"]:
        print(f"{ms:10.4f} ms  {name[:100]}")


if __name__ == "__main__":
    main()
