"""Same-deck energy-drift comparison against the NumPy f64 reference
transcription (tests/ref/ref_impl.py) — splits fp32 physics drift from
bugs (BASELINE's 1e-6 drift bar is defined against the reference scalar
CPU build).

The bench-class deck (two species, force-free sheet, periodic vacuum)
is built once via __graft_entry__._build; its EXACT post-finalize state
(fields incl. ghosts + live particles) is mirrored into f64 arrays and
time-stepped with the reference kernels (advance_p/move_p, unload,
advance_b/e — the same composition as engine/step.py for a closed
vacuum periodic deck with cleaning off).  Energies on both sides are
measured by the SAME functional (Simulation.energies on a state
mirror), so the printed numbers are directly comparable:

  drift_fw   = framework fp32 relative total-energy drift over N steps
  drift_ref  = reference f64 drift on the identical deck (pure physics
               + scheme: what the drift WOULD be with exact arithmetic)
  field_rms  = relative RMS difference of cb/e components after N steps

Usage: python tools/drift_compare.py [steps] [npart_total] [nx]
Prints one JSON line (kind=drift_compare); ``compare()`` returns it as a
dict.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def _fold_jf(fr, rg):
    """Periodic shared-plane current merge (the LocalComm analogue of
    synchronize_jf, remote.c:416-506): each jf component is summed over
    its two transverse axes' shared node planes (1 and n+1)."""
    def fold(a, axis, n):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = 1
        sl_hi[axis] = n + 1
        tot = a[tuple(sl_lo)] + a[tuple(sl_hi)]
        a[tuple(sl_lo)] = tot
        a[tuple(sl_hi)] = tot

    dims = {0: rg.nz, 1: rg.ny, 2: rg.nx}   # array axes are [z, y, x]
    # jfx: transverse y, z ; jfy: z, x ; jfz: x, y
    for comp, axes in (("jfx", (1, 0)), ("jfy", (0, 2)), ("jfz", (2, 1))):
        for ax in axes:
            fold(fr[comp], ax, dims[ax])


def compare(steps=24, npart=16_000, nx=16, resort=2, ion_mult=4):
    """Run the bench-class deck ``steps`` steps in the framework (on the
    default device) and in the f64 scalar reference; return the record
    described in the module docstring."""
    from tests.ref import ref_impl as R

    from __graft_entry__ import _build

    sim = _build(nx=nx, ny=nx, nz=1, npart=npart // 2,
                 resort_interval=resort, ion_sort_mult=ion_mult)
    g = sim.grid
    steps = max(resort, (steps // resort) * resort)

    # ---- mirror the post-finalize state into f64 ----
    st0 = sim.state
    rg = R.G(g.nx, g.ny, g.nz, lx=float(g.gx1 - g.gx0),
             ly=float(g.gy1 - g.gy0), lz=float(g.gz1 - g.gz0),
             dt=float(g.dt), cvac=float(g.cvac), eps0=float(g.eps0))
    fr = R.zero_fields(rg)
    for k in fr:
        fr[k][...] = np.asarray(getattr(st0.field, k), np.float64)
    parts = []
    for sp in st0.species:
        n = int(np.asarray(sp.np))
        parts.append((float(sp.q_m), {
            k: np.asarray(getattr(sp, a), np.float64)[:n].copy()
            for k, a in (("dx", "dx"), ("dy", "dy"), ("dz", "dz"),
                         ("ux", "ux"), ("uy", "uy"), ("uz", "uz"),
                         ("q", "q"))}
            | {"i": np.asarray(sp.i, np.int64)[:n].copy()}))

    # ---- framework fp32 run ----
    e0 = sim.energies()
    tot0 = float(sum(e0.values()))
    t0 = time.perf_counter()
    jax.block_until_ready(sim.advance(steps))
    wall_fw = time.perf_counter() - t0
    e1 = sim.energies()
    tot1 = float(sum(e1.values()))
    drift_fw = (tot1 - tot0) / tot0
    movers = sim.mover_counts()

    # ---- reference f64 run, same composition (step.py for a closed
    # periodic vacuum deck: push -> jf -> b/2 -> e -> b/2) ----
    t0 = time.perf_counter()
    for _ in range(steps):
        ip = R.load_interpolator(fr, rg)
        acc = np.zeros((rg.nv, 12))
        for q_m, p in parts:
            R.advance_p(p, q_m, ip, acc, rg)
        for k in ("jfx", "jfy", "jfz"):
            fr[k][...] = 0.0
        R.unload_accumulator(fr, acc, rg)
        _fold_jf(fr, rg)
        R.advance_b(fr, rg, 0.5)
        R.advance_e_vacuum(fr, rg)
        R.advance_b(fr, rg, 0.5)
    wall_ref = time.perf_counter() - t0

    # ---- measure the reference run with the SAME energy functional:
    # mirror the f64 state back into a fresh framework state ----
    import jax.numpy as jnp
    sim2 = _build(nx=nx, ny=nx, nz=1, npart=npart // 2,
                  resort_interval=resort, ion_sort_mult=ion_mult)

    def energies_of(fr_arr, parts_arr):
        f2 = sim2.state.field.replace(
            **{k: jnp.asarray(fr_arr[k], jnp.float32) for k in
               ("ex", "ey", "ez", "cbx", "cby", "cbz")})
        species = []
        for sp, (_, p) in zip(sim2.state.species, parts_arr):
            n = len(p["i"])
            pad = sp.max_np - n

            def col(v, fill=0.0):
                return jnp.asarray(
                    np.concatenate([v, np.full(pad, fill)]), jnp.float32)

            species.append(sp.replace(
                np=jnp.int32(n),
                dx=col(p["dx"]), dy=col(p["dy"]), dz=col(p["dz"]),
                ux=col(p["ux"]), uy=col(p["uy"]), uz=col(p["uz"]),
                q=col(p["q"]),
                i=jnp.asarray(
                    np.concatenate([p["i"], np.zeros(pad, np.int64)]),
                    jnp.int32)))
        import dataclasses
        sim2.state = dataclasses.replace(
            sim2.state, field=f2, species=tuple(species),
            interpolator=jnp.asarray(
                R.load_interpolator(fr_arr, rg), jnp.float32))
        return sim2.energies()

    er1 = energies_of(fr, parts)
    totr1 = float(sum(er1.values()))
    drift_ref = (totr1 - tot0) / tot0

    # relative RMS field difference after N steps (fp32 vs f64 evolution)
    rms = {}
    for k in ("ex", "ey", "ez", "cbx", "cby", "cbz"):
        a = np.asarray(getattr(sim.state.field, k), np.float64)
        b = fr[k]
        scale = max(np.sqrt(np.mean(b * b)), 1e-30)
        rms[k] = float(np.sqrt(np.mean((a - b) ** 2)) / scale)

    return dict(
        ts=time.time(), kind="drift_compare",
        backend=jax.default_backend(),
        deck=f"{nx}x{nx} npart={npart}", steps=steps,
        knobs=dict(resort=resort, ion_mult=ion_mult),
        drift_fw=drift_fw, drift_ref=drift_ref,
        drift_excess=drift_fw - drift_ref,
        field_rms=rms, dropped_movers=movers,
        wall_fw=wall_fw, wall_ref=wall_ref)


def main():
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    npart = int(sys.argv[2]) if len(sys.argv) > 2 else 16_000
    nx = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    rec = compare(steps, npart, nx,
                  resort=int(os.environ.get("BENCH_RESORT", 2)),
                  ion_mult=int(os.environ.get("BENCH_ION_MULT", 4)))
    print(json.dumps(rec))
    movers = rec["dropped_movers"]
    if movers and any(movers.values()):
        print("DRIFT SUSPECT: dropped movers nonzero", movers)


if __name__ == "__main__":
    main()
