"""On-card smoke test: drive the PIC step through its normal entry points
on one NVIDIA GPU at full width and check the physics.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded phase only

Phases (one process; each prints its numbers beside the card's name and
power limit, and any failure exits non-zero with no "ok" line):

  device    JAX's default backend must be "gpu"; print device_kind, count,
            JAX version and nvidia-smi's name and power limit.
  bench     the bench deck (__graft_entry__._build, 2D 128x128, two
            species, 4M particles): warm-up, then a timed window through
            Simulation.advance.  Finite energies, zero dropped movers, and
            an energy drift of the same order as the same deck on the CPU.
  parity    one jitted make_advance step of the same 4M-particle state on
            the GPU and on the CPU, compared field by field and particle
            by particle; then tools/drift_compare against the f64 scalar
            reference (tests/ref/ref_impl.py).
  cli       vpic_tpu.cli.run.main on decks/trecon.py at its defaults
            (256x128, 64 ppc, ~4.2M particles + tracers): 20 steps with
            checkpoints, a restart from step 10, and the continued run
            compared with the uninterrupted one.
  four      (--four-cards only) decks/trecon.py sharded 2x2 over four
            cards against the same deck on one card.

The last line of stdout is {"ok": true, "device": {...}}.
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vpic_tpu.core.diagnostics import require_gpu  # noqa: E402

OUT = os.path.join(ROOT, ".smoke_out")
FIELDS = ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx", "jfy", "jfz")
PARTICLE_COLS = ("dx", "dy", "dz", "ux", "uy", "uz")

# Tolerances, each with its reason:
# - GPU vs CPU after ONE step of the same state.  The deposit is a
#   scatter-add, an atomic add on the GPU, so each voxel's ~250 current
#   contributions are summed in another (and run-to-run varying) order;
#   XLA also contracts multiply-adds into FMAs on the GPU.  Both are
#   rounding-level: ~1e-6 relative, not bitwise.  Compared as
#   max|a-b| <= RTOL_ONE_STEP * max|b| per array.
RTOL_ONE_STEP = 1e-5
# - A particle sitting within rounding of a cell face can land in the
#   neighbouring voxel on one backend and not the other; such particles
#   are counted, must stay rare, and are left out of the position check.
MAX_VOXEL_FLIP_FRAC = 1e-5
# - Two GPU runs of the same 10 steps (restart vs uninterrupted): atomic
#   summation order differs between the runs and rounding differences
#   grow over the steps.  Energies and fields agree to RTOL_RESTART.
RTOL_RESTART = 1e-4
# - One card vs four cards over 20 steps: the shards' shared-face current
#   and field merges add the same terms in another order.
RTOL_SHARDED = 1e-4
# - Energy drift of the bench deck over the same steps, GPU vs CPU: the
#   two runs must agree in order of magnitude (factor DRIFT_FACTOR) or both
#   sit below DRIFT_FLOOR.
DRIFT_FACTOR = 10.0
DRIFT_FLOOR = 1e-6


def _p(msg):
    print(msg, flush=True)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _live(sp):
    """Live particles of a species, summed over shards (slots below np
    whose voxel is not a zombie's -1; np alone also counts the zombies
    that migration leaves behind until the next sort)."""
    i = np.asarray(sp.i)
    n = np.asarray(sp.np)[..., None]
    return int(((np.arange(i.shape[-1]) < n) & (i >= 0)).sum())


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def phase_device():
    dev = require_gpu()
    _p(f"[device] platform={dev['platform']} kind={dev['kind']} "
       f"count={dev['count']} jax={dev['jax']}")
    _p(f"[device] nvidia-smi name, power.limit: {dev['nvidia_smi']}")
    return dev


def _energies(sim, state):
    """Simulation.energies of ``state`` (on whichever device it lives)."""
    keep, sim.state = sim.state, state
    try:
        e = sim.energies()
    finally:
        sim.state = keep
    _check(all(np.isfinite(v) for v in e.values()), f"non-finite {e}")
    return e


def _total_energy(sim, state):
    return float(sum(_energies(sim, state).values()))


def phase_bench(card, npart=2_000_000, nx=128, steps=32):
    """The bench deck through Simulation.advance; returns the sim and its
    first-window energy drift, for the CPU comparison."""
    from __graft_entry__ import _build

    t0 = time.perf_counter()
    sim = _build(nx=nx, ny=nx, nz=1, npart=npart)
    build_s = time.perf_counter() - t0
    n = sum(_live(sp) for sp in sim.state.species)
    e0 = _total_energy(sim, sim.state)

    t0 = time.perf_counter()
    jax.block_until_ready(sim.advance(steps))
    warm_s = time.perf_counter() - t0
    e1 = _total_energy(sim, sim.state)
    nm0 = {sp.name: int(np.asarray(sp.nm)) for sp in sim.state.species}

    t0 = time.perf_counter()
    jax.block_until_ready(sim.advance(steps))
    dt = time.perf_counter() - t0
    e2 = _total_energy(sim, sim.state)
    dropped = {sp.name: int(np.asarray(sp.nm)) - nm0[sp.name]
               for sp in sim.state.species}
    n2 = sum(_live(sp) for sp in sim.state.species)
    stats = jax.devices()[0].memory_stats() or {}

    drift_gpu = (e1 - e0) / e0
    _p(f"[bench] {nx}x{nx} 2 species {n} particles, {steps} steps "
       f"on {card}: {dt / steps * 1e3:.3f} ms/step, "
       f"{n * steps / dt:.4e} pushes/s")
    _p(f"[bench] warm-up {steps} steps incl. compile {warm_s:.1f} s "
       f"(compile ~{warm_s - dt:.1f} s), deck build {build_s:.1f} s, "
       f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    _p(f"[bench] energy drift steps 0-{steps} {drift_gpu:.3e}, "
       f"steps {steps}-{2 * steps} {(e2 - e1) / e1:.3e}; dropped movers "
       f"in the timed window {dropped}; live {n} -> {n2}")
    _check(all(v == 0 for v in dropped.values()), f"dropped {dropped}")
    _check(n2 == n, f"closed box lost particles: {n} -> {n2}")
    return sim, drift_gpu


def phase_parity(card, drift_gpu, npart=2_000_000, nx=128,
                 steps=32, drift_args=(24, 16_000, 16)):
    """One step of the same state on GPU and CPU; the CPU run continues
    for the drift comparison; then drift_compare against the f64
    reference."""
    from __graft_entry__ import _build
    from vpic_tpu.engine.step import make_advance

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    sim = _build(nx=nx, ny=nx, nz=1, npart=npart)
    # step 1: no species sorts in the compared step (an unstable sort
    # orders the particles of one voxel differently on each backend)
    st0 = dataclasses.replace(sim.state, step=jnp.asarray(
        1, sim.state.step.dtype))
    adv = jax.jit(make_advance(sim.grid, sim.comm, opts=sim.opts))
    s_gpu = jax.block_until_ready(adv(jax.device_put(st0, gpu)))
    s_cpu = jax.block_until_ready(adv(jax.device_put(st0, cpu)))
    worst = {}
    for k in FIELDS:
        worst[k] = _rel(getattr(s_gpu.field, k), getattr(s_cpu.field, k))
    flips = 0
    for sg, sc in zip(s_gpu.species, s_cpu.species):
        live = np.asarray(sc.alive)
        ig, ic = np.asarray(sg.i)[live], np.asarray(sc.i)[live]
        same = ig == ic
        flips += int((~same).sum())
        for k in PARTICLE_COLS:
            a = np.asarray(getattr(sg, k))[live][same]
            b = np.asarray(getattr(sc, k))[live][same]
            worst[f"{sg.name}.{k}"] = _rel(a, b)
        _check(int(np.asarray(sg.nm)) == 0 and int(np.asarray(sc.nm)) == 0,
               "dropped movers in the parity step")
    n = sum(_live(sp) for sp in s_cpu.species)
    _p(f"[parity] one step GPU vs CPU, {n} particles: voxel flips {flips} "
       f"(limit {MAX_VOXEL_FLIP_FRAC * n:.0f}); max |gpu-cpu|/max|cpu| "
       + ", ".join(f"{k}={v:.2e}" for k, v in worst.items())
       + f" (limit {RTOL_ONE_STEP:.0e})")
    _check(flips <= MAX_VOXEL_FLIP_FRAC * n, f"voxel flips {flips}")
    _check(all(v <= RTOL_ONE_STEP for v in worst.values()),
           f"GPU vs CPU beyond {RTOL_ONE_STEP}: {worst}")

    # the CPU's drift over the bench phase's first window, same deck
    st = jax.device_put(sim.state, cpu)
    e0 = _total_energy(sim, st)
    t0 = time.perf_counter()
    for _ in range(steps):
        st = adv(st)
    jax.block_until_ready(st)
    cpu_s = time.perf_counter() - t0
    drift_cpu = (_total_energy(sim, st) - e0) / e0
    _p(f"[parity] energy drift steps 0-{steps}: GPU {drift_gpu:.3e}, "
       f"CPU {drift_cpu:.3e} (CPU {cpu_s / steps * 1e3:.1f} ms/step)")
    lo, hi = sorted((abs(drift_gpu), abs(drift_cpu)))
    _check(hi <= DRIFT_FLOOR or hi <= DRIFT_FACTOR * max(lo, DRIFT_FLOOR),
           f"drift GPU {drift_gpu} vs CPU {drift_cpu}")
    del sim, st, s_gpu, s_cpu

    from tools.drift_compare import compare
    rec = compare(*drift_args)
    _p(f"[parity] drift_compare on {card} ({rec['deck']}, {rec['steps']} "
       f"steps): drift_fw={rec['drift_fw']:.4e} "
       f"drift_ref={rec['drift_ref']:.4e} field_rms="
       + json.dumps({k: float(f"{v:.3e}")
                     for k, v in rec["field_rms"].items()})
       + f" dropped={rec['dropped_movers']}"
       + f" (reference loop {rec['wall_ref']:.1f} s)")
    _check(not any(rec["dropped_movers"].values()), "drift_compare drops")
    _check(all(np.isfinite(v) and v < 1e-3
               for v in rec["field_rms"].values()),
           f"field_rms {rec['field_rms']}")
    _check(abs(rec["drift_fw"] - rec["drift_ref"]) < 1e-4,
           "framework drift departs from the reference")


def phase_cli(card, steps=20):
    """trecon through the CLI: an uninterrupted run, then a restart from
    its step-10 checkpoint, continued to the same step."""
    from vpic_tpu.cli.run import load_deck, main
    from vpic_tpu.io import checkpoint as ckpt

    deck = os.path.join(ROOT, "decks", "trecon.py")
    base = os.path.join(OUT, "cli")
    shutil.rmtree(base, ignore_errors=True)
    half = steps // 2

    def run(tag, *extra):
        os.environ["TRECON_OUT"] = os.path.join(base, tag, "diag")
        t0 = time.perf_counter()
        rc = main([deck, "--num-step", str(steps),
                   "--status-interval", str(half),
                   "--checkpoint-interval", str(half),
                   "--checkpoint-dir", os.path.join(base, tag, "restart"),
                   *extra])
        _check(rc == 0, f"cli {tag} rc={rc}")
        return time.perf_counter() - t0

    wall_a = run("full")
    wall_b = run("resumed", "--restart",
                 os.path.join(base, "full", "restart", "restart1", "restart"))

    tmpl = load_deck(deck).deck()
    tmpl.finalize()
    # rotation: the uninterrupted run wrote step 10 to restart1 and
    # step 20 to restart2; the resumed run wrote step 20 to restart1
    a = ckpt.load_checkpoint(
        os.path.join(base, "full", "restart", "restart2", "restart"),
        tmpl.state)
    b = ckpt.load_checkpoint(
        os.path.join(base, "resumed", "restart", "restart1", "restart"),
        tmpl.state)
    _check(int(a.step) == int(b.step) == steps, "restart step mismatch")
    ea, eb = _energies(tmpl, a), _energies(tmpl, b)
    de = {k: abs(ea[k] - eb[k]) / max(abs(ea[k]), 1e-30) for k in ea}
    df = {k: _rel(getattr(b.field, k), getattr(a.field, k))
          for k in FIELDS}
    na = [_live(sp) for sp in a.species]
    nb = [_live(sp) for sp in b.species]
    drops = [int(np.asarray(sp.nm)) for sp in a.species + b.species]
    _p(f"[cli] trecon {tmpl.grid.nx}x{tmpl.grid.nz}, {sum(na)} particles, "
       f"{steps} steps on {card}: uninterrupted {wall_a:.1f} s, resumed "
       f"from step {half} {wall_b:.1f} s (walls incl. compile)")
    _p("[cli] resumed vs uninterrupted at step "
       f"{steps}: energy rel diff "
       + ", ".join(f"{k}={v:.2e}" for k, v in de.items())
       + "; field max rel diff "
       + ", ".join(f"{k}={v:.2e}" for k, v in df.items())
       + f"; live {na} vs {nb}; dropped movers {drops}"
       + f" (limit {RTOL_RESTART:.0e})")
    _check(na == nb, "live counts differ after restart")
    _check(not any(drops), f"dropped movers {drops}")
    _check(all(v <= RTOL_RESTART for v in de.values()), f"energies {de}")
    _check(all(v <= RTOL_RESTART for v in df.values()), f"fields {df}")


def phase_four(card, steps=20):
    """decks/trecon.py sharded 2x2 over four cards vs one card."""
    from vpic_tpu.cli.run import load_deck

    deck = os.path.join(ROOT, "decks", "trecon.py")
    res = {}
    for tag, px, pz in (("4 cards", 2, 2), ("1 card", 1, 1)):
        os.environ["TRECON_PX"], os.environ["TRECON_PZ"] = str(px), str(pz)
        sim = load_deck(deck).deck()
        sim.finalize()
        e0 = _energies(sim, sim.state)
        t0 = time.perf_counter()
        jax.block_until_ready(sim.advance(1))
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(sim.advance(steps - 1))
        dt = time.perf_counter() - t0
        e = _energies(sim, sim.state)
        live = sum(_live(sp) for sp in sim.state.species)
        drops = sim.mover_counts()
        res[tag] = (e0, e, live, drops)
        _p(f"[four] trecon {sim.grid.gnx}x{sim.grid.gnz} on {tag} "
           f"(px={px}, pz={pz}) [{card}]: {dt / (steps - 1) * 1e3:.3f} "
           f"ms/step over {steps - 1} steps, {live * (steps - 1) / dt:.4e} "
           f"pushes/s, first step incl. compile {warm:.1f} s, live {live}, "
           f"dropped {drops}")
        del sim
    (e04, e4, n4, d4), (e01, e1, n1, d1) = res["4 cards"], res["1 card"]
    de0 = {k: abs(e04[k] - e01[k]) / max(abs(e01[k]), 1e-30) for k in e1}
    de = {k: abs(e4[k] - e1[k]) / max(abs(e1[k]), 1e-30) for k in e1}
    _p("[four] 4 cards vs 1 card at step 0: energy rel diff "
       + ", ".join(f"{k}={v:.2e}" for k, v in de0.items()))
    _p(f"[four] 4 cards vs 1 card at step {steps}: energy rel diff "
       + ", ".join(f"{k}={v:.2e}" for k, v in de.items())
       + f" (limit {RTOL_SHARDED:.0e}); live {n4} vs {n1}")
    _check(n4 == n1, f"live {n4} vs {n1}")
    _check(not any(d4.values()) and not any(d1.values()), "dropped movers")
    _check(all(v <= RTOL_SHARDED for v in de.values()), f"energies {de}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 2x2-sharded trecon phase on 4 cards")
    args = ap.parse_args(argv)

    dev = phase_device()
    card = dev["nvidia_smi"]
    if args.four_cards:
        _check(dev["count"] >= 4, f"--four-cards needs 4 cards, have "
               f"{dev['count']}")
        phase_four(card)
    else:
        sim, drift_gpu = phase_bench(card)
        del sim
        phase_parity(card, drift_gpu)
        phase_cli(card)
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
