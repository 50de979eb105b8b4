"""Observability: checksums, phase timers, and logging — the reference's
auxiliary diagnostics (SURVEY.md §5).

- Checksums (misc.cxx:107-171 + util/CheckSum.hxx): SHA-1 digests of the
  field / particle state for bitwise regression checks across runs and
  topologies.
- Phase timers (vpic.hxx:214-218 p/s/g/f/u_time accumulated around every
  phase of advance, reported at status_interval): here a phase-profiled
  step that jits each phase separately and synchronizes between them.
- sim_log (deck_wrapper.cxx:45-53): rank-0 stderr logging.
- Device report: which accelerator a measurement ran on, and the refusal
  to measure anywhere but on a GPU.
"""

from __future__ import annotations

import hashlib
import subprocess
import sys
import time

import jax
import numpy as np


def sim_log(msg, rank: int = 0):
    """Rank-0 stderr log line (deck_wrapper.cxx:48-53)."""
    if rank == 0:
        print(f"[vpic_tpu] {msg}", file=sys.stderr, flush=True)


def gpu_name_and_power_limit() -> str:
    """The cards' names and power limits as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (one
    card per line, joined by "; ").  A card set below its maximum power
    runs slower under load, so every timing is reported beside this."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if lines else f"nvidia-smi rc={r.returncode}"


def require_gpu() -> dict:
    """Return the device report of an NVIDIA GPU backend, or exit with a
    non-zero status: a measurement never falls back to the CPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"no GPU backend: JAX's default backend is {backend!r}; "
            "this measurement runs only on an NVIDIA GPU")
    devs = jax.devices()
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs), jax=jax.__version__,
                nvidia_smi=gpu_name_and_power_limit())


def checksum_fields(state) -> str:
    """SHA-1 over every field component (output_checksum_fields,
    misc.cxx:109-139)."""
    h = hashlib.sha1()
    f = state.field
    for name in ("ex", "ey", "ez", "div_e_err", "cbx", "cby", "cbz",
                 "div_b_err", "tcax", "tcay", "tcaz", "rhob",
                 "jfx", "jfy", "jfz", "rhof"):
        h.update(np.ascontiguousarray(np.asarray(getattr(f, name))))
    return h.hexdigest()


def checksum_species(state, sid: int) -> str:
    """SHA-1 over the live particles of one species, in canonical (sorted
    by voxel, then tag) order so it is invariant to slot permutation
    (output_checksum_species, misc.cxx:141-171)."""
    sp = state.species[sid]
    alive = np.asarray(sp.alive)
    cols = [np.asarray(getattr(sp, k))[alive]
            for k in ("i", "tag", "dx", "dy", "dz", "ux", "uy", "uz", "q")]
    order = np.lexsort((cols[2], cols[1], cols[0]))
    h = hashlib.sha1()
    for c in cols:
        h.update(np.ascontiguousarray(c[order]))
    return h.hexdigest()


class PhaseTimers:
    """Accumulating stopwatch set mirroring p/s/g/f/u_time."""

    PHASES = ("particle", "sort", "guard", "field", "user")

    def __init__(self):
        self.t = {k: 0.0 for k in self.PHASES}
        self.steps = 0

    def add(self, phase, dt):
        self.t[phase] += dt

    def report(self) -> str:
        n = max(self.steps, 1)
        return " ".join(f"{k}={v / n * 1e3:.2f}ms" for k, v in self.t.items())


def time_phases(sim, n_steps: int = 3) -> dict:
    """Measure per-phase device time by running each phase as its own
    jitted function with synchronization (debug utility; the production
    step stays fully fused)."""
    from ..engine.step import make_advance
    from ..particles import aux as paux
    from ..particles import push as ppush
    from ..field import stencil, sync
    import jax.numpy as jnp

    g, st = sim.grid, sim.state
    nb = st.grid_arrays.neighbor
    out = {}

    def timed(name, fn, *args):
        r = jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(n_steps):
            r = fn(*args)
        jax.block_until_ready(r)
        out[name] = (time.perf_counter() - t0) / n_steps
        return r

    n_axes = (g.gnx > 1) + (g.gny > 1) + (g.gnz > 1)
    n_walk = min(4, n_axes + 1)

    acc0 = jnp.zeros((g.nv, 12), jnp.float32)
    for sp in st.species:
        timed(f"sort[{sp.name}]", jax.jit(paux.sort_p), sp)
        timed(f"advance_p[{sp.name}]",
              jax.jit(lambda s, a: ppush.advance_p(
                  s, st.interpolator, a, nb, g, n_walk=n_walk)),
              sp, acc0)
    timed("advance_b", jax.jit(lambda f: stencil.advance_b(f, g, 0.5)),
          st.field)
    timed("advance_e", jax.jit(lambda f: stencil.advance_e(
        f, g, st.materials, st.material_grid, sim.comm)), st.field)
    timed("synchronize_jf",
          jax.jit(lambda f: sync.synchronize_jf(f, g, sim.comm)), st.field)
    from ..sf import interp as sfi
    timed("load_interpolator",
          jax.jit(lambda f: sfi.load_interpolator(f, g)), st.field)
    timed("unload_accumulator",
          jax.jit(lambda f, a: sfi.unload_accumulator(f, a, g)),
          st.field, acc0)
    # a non-donating jit of the production step: the timing loop feeds
    # the same state to every call
    timed("full_step", jax.jit(make_advance(
        g, sim.comm, pcomm=None, opts=sim.opts,
        boundary_handlers=tuple(sim._boundary_handlers),
        emitters=tuple(sim._emitters), **sim._hooks)), st)
    return out
