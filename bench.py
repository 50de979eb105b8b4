"""Benchmark: particle-push throughput on the 2D reconnection-class deck
(the reference's headline metric, README.performance:8-10 — 7.8M
pushes/s/processor on the 2004-era cluster).

Runs only on an NVIDIA GPU: on any other backend it exits non-zero before
building anything.  Prints the device (platform, device_kind, count, and
the cards' names and power limits from nvidia-smi) on one line, then ONE
JSON line:
  {"metric": "particle_pushes_per_s", "value": N, "unit": "pushes/s",
   "vs_baseline": N / 7.8e6, "dropped_movers": {...}, "device": {...}}

Knobs via environment: BENCH_NPART (both species together), BENCH_NX/NY/NZ,
BENCH_STEPS, BENCH_RESORT (steps per dispatched cycle), BENCH_ION_MULT.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vpic_tpu.core.diagnostics import require_gpu

    dev = require_gpu()
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']} jax={dev['jax']} "
          f"nvidia-smi: {dev['nvidia_smi']}", flush=True)

    npart = int(os.environ.get("BENCH_NPART", 4_000_000))
    nx = int(os.environ.get("BENCH_NX", 128))
    ny = int(os.environ.get("BENCH_NY", 128))
    nz = int(os.environ.get("BENCH_NZ", 1))
    steps = int(os.environ.get("BENCH_STEPS", 32))
    resort = int(os.environ.get("BENCH_RESORT", 2))
    ion_mult = int(os.environ.get("BENCH_ION_MULT", 4))

    from __graft_entry__ import _build

    sim = _build(nx=nx, ny=ny, nz=nz, npart=npart // 2,  # 2 species
                 resort_interval=resort, ion_sort_mult=ion_mult)
    # whole cycles only, so the warm-up compiles the exact dispatch the
    # timed window replays
    steps = max(resort, (steps // resort) * resort)

    t0 = time.perf_counter()
    jax.block_until_ready(sim.advance(steps))
    compile_s = time.perf_counter() - t0

    # mover-drop baseline BEFORE the timed window: sp.nm accumulates the
    # reference's "Ignoring %i unprocessed movers" count (advance.cxx:
    # 98-103) across steps, so the delta over the timed window certifies
    # the measured configuration is physically clean (a closed periodic
    # box processes every mover, move_p.c:34-134).
    nm0 = {sp.name: int(np.asarray(sp.nm)) for sp in sim.state.species}

    t0 = time.perf_counter()
    jax.block_until_ready(sim.advance(steps))
    dt = time.perf_counter() - t0

    total_particles = sum(
        int(np.asarray(sp.np)) for sp in sim.state.species)
    pushes_per_s = total_particles * steps / dt
    dropped = {sp.name: int(np.asarray(sp.nm)) - nm0[sp.name]
               for sp in sim.state.species}
    stats = jax.devices()[0].memory_stats() or {}

    baseline = 7.8e6  # pushes/s/processor, README.performance:8-10
    print(json.dumps({
        "metric": "particle_pushes_per_s",
        "value": pushes_per_s,
        "unit": "pushes/s",
        "vs_baseline": pushes_per_s / baseline,
        "ms_per_step": dt / steps * 1e3,
        "warmup_incl_compile_s": compile_s,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "dropped_movers": dropped,
        "device": dev,
        "config": {"npart": npart, "nx": nx, "ny": ny, "nz": nz,
                   "steps": steps, "resort": resort,
                   "ion_mult": ion_mult},
    }))


if __name__ == "__main__":
    main()
