"""Round-3 regression tests: modfile rebuilds keep handlers/emitters,
LinkBoundary ring drains in arrival order, tracer trajectories survive a
checkpoint/restore, repeated per-tag dumps don't duplicate, and dropped
movers surface as warnings."""

import dataclasses

import numpy as np
import pytest

from vpic_tpu.boundary.models import LinkBoundary, MaxwellianReflux
from vpic_tpu.deck.api import Simulation
from vpic_tpu.engine.step import StepOptions


def reflux_box(seed=2, nx=8, ut=0.3, drift=0.5):
    """Drifting electrons between reflux x-walls (periodic y/z)."""
    sim = Simulation(seed=seed)
    sim.define_units(1.0, 1.0)
    L = 1.0
    sim.define_timestep(0.7 * sim.courant_length(L, L, L, nx, nx, 1))
    sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, nx, 1)
    from vpic_tpu.core.types import PERIODIC_FIELDS
    for face in (1, 2, 4, 5):
        sim.set_domain_field_bc(face, PERIODIC_FIELDS)
        sim.set_domain_particle_bc(face, "periodic")
    e = sim.define_species("electron", -1.0, 4096)
    n = 512
    sim.inject_particle(
        e, sim.uniform(n, 0.05, 0.95), sim.uniform(n, 0, L),
        sim.uniform(n, 0, L),
        sim.maxwellian(n, ut) + drift, sim.maxwellian(n, ut),
        sim.maxwellian(n, ut), q=-1.0 / n)
    reflux = sim.define_boundary(
        MaxwellianReflux(ut_para=(0.2,), ut_perp=(0.2,)))
    sim.set_domain_particle_bc(0, reflux)
    sim.set_domain_particle_bc(3, reflux)
    return sim


def alive_count(sim):
    return int(np.asarray(sim.state.species[0].alive).sum())


def test_modify_runparams_keeps_boundary_handlers():
    """A --modfile rebuild must not drop reflux walls (api.py
    _rebuild_advance): with handlers lost, wall hits are never serviced
    and particles disappear."""
    sim = reflux_box()
    sim.finalize()
    n0 = alive_count(sim)
    sim.advance(6)
    assert alive_count(sim) == n0

    # the modfile path: opts change forces an executable rebuild
    sim.modify_runparams(num_comm_round=2, status_interval=10)
    sim.advance(12)
    assert alive_count(sim) == n0          # reflux still active
    assert int(sim.state.species[0].nm) == 0


def test_link_boundary_drain_ring_order(tmp_path):
    """After the ring wraps, drain must emit oldest->newest in arrival
    order with the recorded step (link.c appends per hit)."""
    lb = LinkBoundary(capacity=4)
    hstate = dict(
        count=np.int32(6),              # 6 hits through a 4-slot ring
        # slots hold absolute hits [4, 5, 2, 3] (0 and 1 overwritten)
        vox=np.array([40, 50, 20, 30], np.int32),
        q=np.array([4.0, 5.0, 2.0, 3.0], np.float32),
        step=np.array([14, 15, 12, 13], np.int32),
    )
    from vpic_tpu.boundary.models import drain_link_file
    fname = tmp_path / "link.0"
    n = drain_link_file(hstate, fname)
    assert n == 6
    rows = [line.split() for line in fname.read_text().splitlines()]
    # oldest retained hit is absolute index 2 -> 12/20, then 13/30, 14/40,
    # 15/50
    assert [int(r[0]) for r in rows] == [12, 13, 14, 15]
    assert [int(r[1]) for r in rows] == [20, 30, 40, 50]


def test_link_boundary_records_step():
    """End-to-end: LinkBoundary hits carry the simulation step."""
    sim = reflux_box(seed=7)
    lb = sim.define_boundary(LinkBoundary(capacity=512))
    sim.set_domain_particle_bc(0, lb)
    sim.set_domain_particle_bc(3, lb)
    sim.finalize()
    sim.advance(8)
    st = sim.state.boundary_state[-1]
    count = int(np.asarray(st["count"]))
    assert count > 0
    steps = np.asarray(st["step"])[:min(count, 512)]
    assert steps.min() >= 0 and steps.max() <= 8
    assert steps.max() >= 1                 # stamped, not left zero


def test_tracer_restart_roundtrip(tmp_path):
    """Accumulated trajectories survive checkpoint/restore
    (dump_tracer_restart semantics, tracer.cxx:199-253), and repeated
    per-tag dumps append without duplication."""
    def build():
        sim = Simulation(seed=11)
        sim.define_units(1.0, 1.0)
        L = 1.0
        nx = 8
        sim.define_timestep(0.7 * sim.courant_length(L, L, L, nx, nx, 1))
        sim.define_periodic_grid(0, 0, 0, L, L, L, nx, nx, 1)
        e = sim.define_species("electron", -1.0, 2048)
        n = 64
        sim.inject_particle(
            e, sim.uniform(n, 0, L), sim.uniform(n, 0, L),
            sim.uniform(n, 0, L), sim.maxwellian(n, 0.3),
            sim.maxwellian(n, 0.3), sim.maxwellian(n, 0.3), q=-1.0 / n)
        sim.make_tracers(e, "tracer", stride=16)
        return sim

    sim = build()
    sim.finalize()
    for _ in range(3):
        sim.advance(1)
        sim.collect_trajectories()

    rec_before = sim._traj.records("tracer").copy()
    assert rec_before.shape[0] > 0

    # double per-tag dump: second must be a no-op (watermark)
    out_dir = tmp_path / "traj"
    sim.dump_traj(out_dir, per_tag_files=True)
    sizes1 = {p.name: p.stat().st_size for p in out_dir.iterdir()}
    sim.dump_traj(out_dir, per_tag_files=True)
    sizes2 = {p.name: p.stat().st_size for p in out_dir.iterdir()}
    assert sizes1 == sizes2

    # checkpoint carries both the records and the flushed watermark
    ck = tmp_path / "ck" / "restart"
    sim.checkpoint(ck)

    # quota-kill analogue: fresh process restores the accumulator
    sim2 = build()
    sim2.finalize()
    sim2.restore(ck)
    rec_after = sim2._traj.records("tracer")
    np.testing.assert_array_equal(rec_before, rec_after)
    # and the watermark survives too: an immediate dump appends nothing
    out2 = tmp_path / "traj2"
    sim2.dump_traj(out2, per_tag_files=True)
    total2 = sum(p.stat().st_size for p in out2.iterdir()) \
        if out2.exists() else 0
    assert total2 == 0


def test_dropped_movers_warn():
    """With zero comm rounds, wall hits are never serviced; the leftovers
    must be counted and surfaced (advance.cxx:98-103 WARN semantics)."""
    sim = reflux_box(seed=3)
    sim.opts = dataclasses.replace(sim.opts, num_comm_round=0)
    sim.finalize()
    sim.advance(6)
    counts = sim.mover_counts()
    assert counts["electron"] > 0
    with pytest.warns(RuntimeWarning, match="unprocessed movers"):
        sim.warn_dropped_movers()
    # delta semantics: nothing new since the last call -> silent
    logged = []
    sim.warn_dropped_movers(log=logged.append)
    assert logged == []
    # new drops re-arm the warning
    sim.advance(6)
    sim.warn_dropped_movers(log=logged.append)
    assert logged and "unprocessed movers" in logged[0]


def test_sigma_deck_relativistic_walls(monkeypatch):
    """The sigma deck (conductive walls + relativistic 0.6c load) runs
    without dropping a single mover: exercises the >=0 streak-fraction
    clamp (a reflected lane 1 ulp outside its face must not walk
    backward), the while_loop streak walker (flat-axis wraps of fast
    lanes need more than n_axes+1 segments), and the max_np//2 mover
    buffer (sigma.cxx:474-523 load crosses faces at ~0.5/step)."""
    monkeypatch.setenv("SIGMA_NX", "32")
    monkeypatch.setenv("SIGMA_NZ", "16")
    monkeypatch.setenv("SIGMA_PPC", "8")
    import importlib
    import decks.sigma as sigma
    importlib.reload(sigma)
    sim = sigma.deck()
    sim.finalize()
    tot0 = sum(sim.energies().values())
    sim.advance(25)
    e1 = sim.energies()
    assert all(np.isfinite(v) for v in e1.values())
    # energy conserved to fp32 PIC tolerance over 25 steps
    assert abs(sum(e1.values()) - tot0) / tot0 < 5e-3
    # every mover serviced: no silent charge loss at the walls
    assert all(c == 0 for c in sim.mover_counts().values())
    # reflecting z walls keep every particle inside the box
    for sp in sim.state.species:
        alive = np.asarray(sp.i) >= 0
        assert np.asarray(sp.i)[alive].max() < sim.grid.nv


def test_per_species_sort_cadence_dispatch():
    """advance() folds whole cycles into one scanned dispatch, runs the
    remainder as single steps with exact step accounting, and each
    species still sorts on its own sort_interval inside the folded
    dispatch (the ion of this deck every 8 steps, the electron never)."""
    import sys
    sys.path.insert(0, ".")
    from __graft_entry__ import _build

    sim = _build(nx=8, ny=8, nz=1, npart=256)
    k = sim.opts.resort_interval
    assert k == 2
    assert [sp.sort_interval for sp in sim.state.species] == [0, 8]
    calls = []

    def rec(tag):
        def fn(state):
            calls.append(tag)
            return state
        return fn

    real_scan = sim._cycles_scan
    sim._advance_cycle = rec("C")
    sim._cycles_scan = lambda m: rec(f"S{m}")
    sim._advance_fn = rec("s")

    sim.step_count = 0
    sim.advance(24)          # 12 whole cycles: ONE dispatch
    assert calls == ["S12"]
    assert sim.step_count == 24

    calls.clear()
    sim.advance(3)           # one cycle + one single step
    assert calls == ["C", "s"]
    assert sim.step_count == 27

    calls.clear()
    sim.advance(1)
    assert calls == ["s"]
    assert sim.step_count == 28

    # the real scanned dispatch over steps 1..8: the ion (sort_interval
    # 8) is sorted at the start of step 8, so only that step's few cell
    # crossers break its voxel order; the electron (sort_interval 0)
    # keeps the shuffled order it was given
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    st = sim.state
    species = []
    for sp in st.species:
        n = int(sp.np)
        perm = jnp.asarray(np.concatenate([rng.permutation(n),
                                           np.arange(n, sp.max_np)]))
        species.append(sp.replace(**{c: getattr(sp, c)[perm] for c in (
            "dx", "dy", "dz", "i", "ux", "uy", "uz", "q", "tag")}))
    st = dataclasses.replace(st, species=tuple(species),
                             step=jnp.asarray(1, st.step.dtype))
    out = real_scan(4)(st)

    def descents(sp):
        i = np.asarray(sp.i)[:int(sp.np)]
        return float(np.mean(np.diff(i) < 0))

    e, ion = out.species
    assert descents(ion) < 0.1
    assert descents(e) > 0.3
