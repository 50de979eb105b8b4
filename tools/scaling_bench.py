"""Scaling table in the spirit of decks/vpic32.csv: sweep particle counts
and grid sizes on the reconnection-class deck and print one CSV row per
configuration (ms/step, pushes/s, speedup vs the reference's 7.8M/s CPU
headline).  Runs only on an NVIDIA GPU.

Usage: python tools/scaling_bench.py [steps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

CONFIGS = [
    # (npart_total, nx, ny, nz)
    (1_000_000, 128, 128, 1),
    (4_000_000, 128, 128, 1),
    (8_000_000, 128, 128, 1),
    (8_000_000, 256, 256, 1),
    (16_000_000, 256, 256, 1),
    (8_000_000, 512, 512, 1),
    (8_000_000, 64, 64, 64),
]


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    from vpic_tpu.core.diagnostics import require_gpu

    dev = require_gpu()
    print(f"# {dev['kind']} x{dev['count']} [{dev['nvidia_smi']}]")
    from __graft_entry__ import _build

    only = os.environ.get("SCALE_ONLY")  # e.g. "512" to filter configs
    print("npart,nx,ny,nz,ms_per_step,pushes_per_s,vs_ref_cpu")
    for npart, nx, ny, nz in CONFIGS:
        if only and only not in (str(nx), f"{nx}x{ny}x{nz}"):
            continue
        sim = _build(nx=nx, ny=ny, nz=nz, npart=npart // 2)
        # whole cycles, so the warm-up compiles the dispatch that the
        # timed window replays
        k = sim.opts.resort_interval
        nst = max(k, (steps // k) * k)
        jax.block_until_ready(sim.advance(nst))
        t0 = time.perf_counter()
        jax.block_until_ready(sim.advance(nst))
        dt = time.perf_counter() - t0
        total = sum(int(np.asarray(sp.np)) for sp in sim.state.species)
        pps = total * nst / dt
        print(f"{total},{nx},{ny},{nz},{dt / nst * 1e3:.3f},"
              f"{pps:.4e},{pps / 7.8e6:.2f}", flush=True)
        del sim


if __name__ == "__main__":
    main()
