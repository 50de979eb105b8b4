"""Per-phase device timings on the GPU: each advance-step phase of the
bench-class deck jitted and timed on its own, ending in
``jax.block_until_ready`` (Simulation.time_phases).

The sum won't exactly match one advance step (XLA fuses across phases
inside the step), but it localizes the cost.

Usage: python tools/phase_bench.py [npart] [nx] [reps]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    npart = int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000
    nx = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5

    from vpic_tpu.core.diagnostics import require_gpu

    dev = require_gpu()
    from __graft_entry__ import _build

    sim = _build(nx=nx, ny=nx, nz=1, npart=npart // 2)
    sim.advance(2)          # warm state off the cold start
    out = sim.time_phases(reps)
    print(f"== phase timings ({npart / 1e6:.1f}M total, {nx}x{nx}, "
          f"reps={reps}) on {dev['kind']} [{dev['nvidia_smi']}] ==")
    for name, s in out.items():
        print(f"  {name:34s} {s * 1e3:8.3f} ms")


if __name__ == "__main__":
    main()
