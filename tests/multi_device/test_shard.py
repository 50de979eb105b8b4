"""Multi-shard correctness: an x-sharded periodic plasma must evolve
identically (to fp32 roundoff) to the single-device run — this exercises
field halo exchange, shared-face sync, jf/rho merges, and particle
migration over the device mesh."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax


def _require_devices(n: int):
    """Skip unless the process has ``n`` devices (tests/conftest.py gives
    the CPU backend 8 virtual devices)."""
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices, have {len(jax.devices())}")


from vpic_tpu.deck.api import Simulation


def build(px=1, py=1, pz=1, seed=3):
    nx, ny, nz = 8, 4, 4
    L = 1.0
    sim = Simulation(seed=seed)
    sim.define_units(1.0, 1.0)
    dt = 0.9 * sim.courant_length(L, L, L, nx, ny, nz)
    sim.define_timestep(dt)
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, py, pz)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)

    # deterministic global particle set (identical for every topology)
    rng = np.random.default_rng(12345)
    n = 1024
    x, y, z = (rng.uniform(0, L, n) for _ in range(3))
    ux, uy, uz = (rng.normal(0, 0.3, n) for _ in range(3))
    sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)

    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.set_field("cbz", lambda x, y, z: 0.02 * np.cos(2 * np.pi * y))
    sim.finalize()
    return sim


def global_field(sim, comp):
    g = sim.grid
    a = np.asarray(getattr(sim.state.field, comp))
    if a.ndim == 3:
        return a[1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1]
    # (pz,py,px,nzg,nyg,nxg) -> assemble owned blocks
    blocks = []
    for sz in range(a.shape[0]):
        yrow = []
        for sy in range(a.shape[1]):
            xrow = [a[sz, sy, sx, 1:g.nz + 1, 1:g.ny + 1, 1:g.nx + 1]
                    for sx in range(a.shape[2])]
            yrow.append(np.concatenate(xrow, axis=2))
        blocks.append(np.concatenate(yrow, axis=1))
    return np.concatenate(blocks, axis=0)


def test_two_shard_equivalence():
    _require_devices(2)
    s1 = build(px=1)
    s2 = build(px=2)

    n_steps = 5
    s1.advance(n_steps)
    s2.advance(n_steps)

    for comp in ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx"):
        a = global_field(s1, comp)
        b = global_field(s2, comp)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=comp)

    e1, e2 = s1.energies(), s2.energies()
    for k in e1:
        np.testing.assert_allclose(e1[k], e2[k], rtol=1e-4, atol=1e-9,
                                   err_msg=k)

    # particle counts conserved globally
    np1 = int(np.sum(np.asarray(s1.state.species[0].alive)))
    alive2 = np.asarray(s2.state.species[0].i >= 0) & (
        np.arange(s2.state.species[0].max_np)[None, None, None, :]
        < np.asarray(s2.state.species[0].np)[..., None])
    np2 = int(alive2.sum())
    assert np1 == np2 == 1024


def test_eight_shard_runs():
    _require_devices(8)
    s = build(px=2, py=2, pz=2)
    s.advance(3)
    e = s.energies()
    assert all(np.isfinite(v) for v in e.values())


def build_bounded(px=1, pz=1, seed=9):
    """Reflecting x faces + absorbing y faces: exercises non-periodic
    global faces of a sharded axis (reflect resolves in-walk, absorb goes
    through the guard-list rounds with rhob deposition)."""
    nx, ny, nz = 8, 6, 4
    L = 1.0
    sim = Simulation(seed=seed)
    sim.define_units(1.0, 1.0)
    dt = 0.9 * sim.courant_length(L, L, L, nx, ny, nz)
    sim.define_timestep(dt)
    sim.define_reflecting_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, pz)
    sim.set_domain_particle_bc(1, "absorb")
    sim.set_domain_particle_bc(4, "absorb")
    # absorbed-charge rhob on shared shard faces is only defined after a
    # synchronize_rho pass; run the div-E clean like the reference decks do
    import dataclasses as _dc
    sim.opts = _dc.replace(sim.opts, clean_div_e_interval=1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)

    rng = np.random.default_rng(777)
    n = 1024
    x, y, z = (rng.uniform(0.05, 0.95, n) for _ in range(3))
    ux, uy, uz = (rng.normal(0, 0.4, n) for _ in range(3))
    sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(np.pi * x))
    sim.finalize()
    return sim


def _alive_count(sim):
    sp = sim.state.species[0]
    a = np.asarray(sp.i)
    if a.ndim == 1:
        return int(np.asarray(sp.alive).sum())
    live = (a >= 0) & (
        np.arange(sp.max_np)[None, None, None, :]
        < np.asarray(sp.np)[..., None])
    return int(live.sum())


def test_two_shard_reflect_absorb():
    """Sharded non-periodic faces must match the single-shard run."""
    _require_devices(2)
    s1 = build_bounded(px=1)
    s2 = build_bounded(px=2)
    n_steps = 6
    s1.advance(n_steps)
    s2.advance(n_steps)

    for comp in ("ex", "ey", "ez", "cbx", "cby", "cbz", "rhob"):
        a = global_field(s1, comp)
        b = global_field(s2, comp)
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5, err_msg=comp)

    # identical absorption on both topologies
    n1, n2 = _alive_count(s1), _alive_count(s2)
    assert n1 == n2
    assert n1 < 1024  # something was absorbed through the y faces

    e1, e2 = s1.energies(), s2.energies()
    for k in e1:
        np.testing.assert_allclose(e1[k], e2[k], rtol=2e-4, atol=1e-9,
                                   err_msg=k)


def test_3d_eight_shard_migration():
    """(2,2,2) topology: 3D migration across all axes vs 1 shard."""
    _require_devices(8)
    s1 = build(px=1, py=1, pz=1, seed=21)
    s8 = build(px=2, py=2, pz=2, seed=21)
    n_steps = 4
    s1.advance(n_steps)
    s8.advance(n_steps)
    for comp in ("ex", "cbz", "jfx"):
        a = global_field(s1, comp)
        b = global_field(s8, comp)
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5, err_msg=comp)
    assert _alive_count(s1) == _alive_count(s8) == 1024


def _build_cycled(px=1, py=1, pz=1, seed=3, resort=2, ion_mult=2):
    """Deck with the multi-step cycle dispatch enabled (two species, ion
    sorts every ion_mult-th cycle)."""
    import dataclasses as _dc

    nx, ny, nz = 8, 4, 4
    L = 1.0
    sim = Simulation(seed=seed)
    sim.define_units(1.0, 1.0)
    dt = 0.9 * sim.courant_length(L, L, L, nx, ny, nz)
    sim.define_timestep(dt)
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, py, pz)
    sim.define_material("vacuum")
    sim.opts = _dc.replace(sim.opts, resort_interval=resort)
    e = sim.define_species("electron", -1.0, 4096)
    i = sim.define_species("ion", 1.0 / 25.0, 4096,
                           sort_interval=ion_mult * resort)
    rng = np.random.default_rng(777)
    n = 1024
    for sp, sgn, ut in ((e, -1.0, 0.3), (i, 1.0, 0.06)):
        x, y, z = (rng.uniform(0, L, n) for _ in range(3))
        sim.inject_particle(sp, x, y, z, rng.normal(0, ut, n),
                            rng.normal(0, ut, n), rng.normal(0, ut, n),
                            q=sgn / n)
    sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
    sim.finalize()
    return sim


def test_multishard_cycle_executables():
    """The cycle fast path must run distributed: a multishard deck with
    resort_interval > 1 builds the shard_mapped cycle executables, folds
    whole cycles into ONE scanned dispatch, and
    matches the single-shard run (round-4: previously _build_cycle
    early-returned on is_multishard and distributed runs dispatched one
    jitted step at a time)."""
    _require_devices(2)
    s1 = _build_cycled(px=1)
    s2 = _build_cycled(px=2)
    assert s2._advance_cycle is not None

    dispatches = {"n": 0}
    orig = s2._dispatch_cycle

    def counting(fn):
        dispatches["n"] += 1
        return orig(fn)

    s2._dispatch_cycle = counting
    n_steps = 8   # 4 whole cycles of resort 2; the ion sorts twice
    s1.advance(n_steps)
    s2.advance(n_steps)
    # whole cycles fold into ONE dispatch
    assert dispatches["n"] == 1, dispatches
    for comp in ("ex", "ey", "cbz", "jfx"):
        a = global_field(s1, comp)
        b = global_field(s2, comp)
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5, err_msg=comp)
    e1, e2 = s1.energies(), s2.energies()
    for k in e1:
        np.testing.assert_allclose(e2[k], e1[k], rtol=2e-4, atol=1e-9,
                                   err_msg=k)


def test_two_shard_drift_bounded():
    """Characterize 1-shard vs 2-shard divergence over 20 steps: fp32
    reduction-order drift must stay bounded (roughly linear), not grow
    multiplicatively (which would indicate a real topology bug rather
    than roundoff)."""
    _require_devices(2)
    s1 = build(px=1, seed=31)
    s2 = build(px=2, seed=31)
    drift = []
    for _ in range(20):
        s1.advance(1)
        s2.advance(1)
        d = 0.0
        for comp in ("ex", "ey", "cbz"):
            a = global_field(s1, comp)
            b = global_field(s2, comp)
            scale = max(np.abs(a).max(), 1e-12)
            d = max(d, float(np.abs(a - b).max() / scale))
        drift.append(d)
    # absolute bound after 20 steps
    assert drift[-1] < 5e-3, f"drift history: {drift}"
    # growth is bounded: late drift not explosively larger than mid-run
    mid = max(max(drift[4:10]), 1e-9)
    assert drift[-1] < 60 * mid, f"drift history: {drift}"


def test_two_shard_hydro_sync_matches_single():
    """Multishard hydro must merge shared node planes over the mesh
    before dumps (sf_interface.h:156-163): the 2-shard synchronized
    hydro must equal the single-shard one everywhere, including the
    shard-boundary planes."""
    _require_devices(2)
    from vpic_tpu.comm.facecomm import LocalComm
    from vpic_tpu.engine import distributed as dist
    from vpic_tpu.particles import aux as paux
    from vpic_tpu.sf import hydro as sfhydro

    import jax as _jax

    s1 = build(px=1)
    s2 = build(px=2)
    s1.advance(3)
    s2.advance(3)

    g1, g2 = s1.grid, s2.grid

    @_jax.jit
    def hy_single(st):
        hy = sfhydro.clear_hydro(g1)
        hy = paux.accumulate_hydro_p(hy, st.species[0], st.interpolator, g1)
        return hy

    h1 = sfhydro.synchronize_hydro(hy_single(s1.state), g1, LocalComm(g1))
    h1 = np.asarray(h1).reshape(g1.nzg, g1.nyg, g1.nxg, -1)

    h2 = np.asarray(dist.make_distributed_hydro(g2, s2.mesh, 0)(s2.state))
    h2 = h2.reshape(1, 1, 2, g2.nzg, g2.nyg, g2.nxg, -1)

    # every owned node of every shard (x: 1..nx locally, global sx*nx+ix)
    for sx in range(2):
        a = h2[0, 0, sx][1:g2.nz + 1, 1:g2.ny + 1, 1:g2.nx + 1]
        b = h1[1:g1.nz + 1, 1:g1.ny + 1,
               sx * g2.nx + 1:sx * g2.nx + g2.nx + 1]
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6,
                                   err_msg=f"shard {sx}")
    # the shared plane itself (shard 1's low-x owned nodes include it)
    shared = h2[0, 0, 1][1:g2.nz + 1, 1:g2.ny + 1, 1]
    assert np.abs(shared[..., 3]).max() > 0   # rho present on the seam


def test_multishard_cli_smoke(tmp_path):
    """python -m vpic_tpu.cli.run on a 2-shard deck: the status line must
    handle distributed np leaves (run.py)."""
    _require_devices(2)
    deck = tmp_path / "deck2.py"
    deck.write_text("""
import numpy as np
from vpic_tpu.deck.api import Simulation

def deck():
    nx, ny, nz = 8, 4, 4
    L = 1.0
    sim = Simulation(seed=3)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
    sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, 2, 1, 1)
    sim.define_material("vacuum")
    e = sim.define_species("electron", -1.0, 4096)
    rng = np.random.default_rng(5)
    n = 256
    sim.inject_particle(e, rng.uniform(0, L, n), rng.uniform(0, L, n),
                        rng.uniform(0, L, n), rng.normal(0, 0.3, n),
                        rng.normal(0, 0.3, n), rng.normal(0, 0.3, n),
                        q=-1.0 / n)
    sim.num_step = 2
    return sim
""")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    r = subprocess.run(
        [sys.executable, "-m", "vpic_tpu.cli.run", str(deck),
         "--status-interval", "1"],
        env=env, capture_output=True, text=True, timeout=1200,
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
    assert r.returncode == 0, f"CLI failed:\n{r.stdout}\n{r.stderr}"
    assert "pushes/s" in r.stdout
    assert "done: 2 steps" in r.stdout


def test_join_domain_pairwise_loops():
    """join_domain (vpic.hxx:313-331): wire a 4-shard x axis into TWO
    independent 2-shard loops; the left loop must evolve exactly like a
    standalone 2-shard periodic box, and nothing may leak into the right
    loop."""
    _require_devices(4)
    L = 1.0
    ny, nz = 4, 4
    rng_init = np.random.default_rng(9911)
    n = 512
    x = rng_init.uniform(0, L, n)           # left half of the 4-shard box
    y, z = rng_init.uniform(0, L, n), rng_init.uniform(0, L, n)
    ux = rng_init.normal(0.4, 0.3, n)       # drift so particles migrate
    uy, uz = rng_init.normal(0, 0.3, (2, n))

    def build_A():
        sim = Simulation(seed=5)
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.9 * sim.courant_length(L, L, L, 8, ny, nz))
        # global box [0, 2L], 4 x-shards of nx=4 each; x nominally
        # absorbing but then fully rewired pairwise: (0,1) and (2,3)
        sim.define_periodic_grid(0, 0, 0, 2 * L, L, L, 16, ny, nz,
                                 4, 1, 1)
        from vpic_tpu.core.types import ABSORB_FIELDS
        sim.set_domain_field_bc(0, ABSORB_FIELDS)
        sim.set_domain_field_bc(3, ABSORB_FIELDS)
        sim.set_domain_particle_bc(0, "absorb")
        sim.set_domain_particle_bc(3, "absorb")
        sim.join_domain(3, (1, 0, 3, 2))
        sim.join_domain(0, (1, 0, 3, 2))
        sim.define_material("vacuum")
        e = sim.define_species("electron", -1.0, 4096)
        sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)
        sim.finalize()
        return sim

    def build_B():
        sim = Simulation(seed=5)
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.9 * sim.courant_length(L, L, L, 8, ny, nz))
        sim.define_periodic_grid(0, 0, 0, L, L, L, 8, ny, nz, 2, 1, 1)
        sim.define_material("vacuum")
        e = sim.define_species("electron", -1.0, 4096)
        sim.inject_particle(e, x, y, z, ux, uy, uz, q=-1.0 / n)
        sim.finalize()
        return sim

    sA, sB = build_A(), build_B()
    n_steps = 6
    sA.advance(n_steps)
    sB.advance(n_steps)

    gB = sB.grid
    for comp in ("ex", "ey", "cbz", "jfx"):
        a = np.asarray(getattr(sA.state.field, comp))   # (1,1,4,nzg,nyg,nxg)
        b = global_field(sB, comp)
        # left loop of A (shards 0,1) == B's two shards
        left = np.concatenate(
            [a[0, 0, sx, 1:nz + 1, 1:ny + 1, 1:gB.nx + 1]
             for sx in (0, 1)], axis=2)
        np.testing.assert_allclose(left, b, rtol=3e-4, atol=3e-5,
                                   err_msg=comp)
        # right loop stays exactly empty (no leakage through the seam)
        right = np.concatenate(
            [a[0, 0, sx, 1:nz + 1, 1:ny + 1, 1:gB.nx + 1]
             for sx in (2, 3)], axis=2)
        assert np.abs(right).max() == 0.0, comp

    assert _alive_count(sA) == _alive_count(sB) == n


def test_two_shard_absorb_tally():
    """Per-shard AbsorbTally counters sum to the single-shard count (the
    reference's per-rank counters, absorb_tally.c)."""
    _require_devices(2)
    from vpic_tpu.boundary.models import AbsorbTally

    def build_tally(px):
        nx, ny, nz = 8, 4, 4
        L = 1.0
        sim = Simulation(seed=13)
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
        sim.define_absorbing_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
        tally = sim.define_boundary(AbsorbTally(n_species=1))
        for face in range(6):
            sim.set_domain_particle_bc(face, tally)
        sim.define_material("vacuum")
        e = sim.define_species("electron", -1.0, 4096)
        rng = np.random.default_rng(55)
        n = 1024
        sim.inject_particle(e, rng.uniform(0.05, 0.95, n),
                            rng.uniform(0.05, 0.95, n),
                            rng.uniform(0.05, 0.95, n),
                            rng.normal(0.3, 0.3, n), rng.normal(0, 0.2, n),
                            rng.normal(0, 0.2, n), q=-1.0 / n)
        sim.finalize()
        return sim, tally

    s1, t1 = build_tally(px=1)
    s2, t2 = build_tally(px=2)
    s1.advance(10)
    s2.advance(10)
    c1 = s1.boundary_tallies(t1)
    c2 = s2.boundary_tallies(t2)
    n1, n2 = _alive_count(s1), _alive_count(s2)
    assert c1[0] == 1024 - n1 > 0
    assert c2[0] == 1024 - n2
    assert int(c1[0]) == int(c2[0])


def test_two_shard_static_load_imbalance():
    """Design-decision pin for the reference's non-uniform domains
    (size_grid, src/grid/ops.c:26-130 + mismatched-cell-size ghost
    interpolation, remote.c:105-117): the reference lets ranks carry
    DIFFERENT grid portions so a statically imbalanced particle load
    balances across ranks.  SPMD over a device mesh wants identical shards
    (one program, one shape — an unequal shard would bottleneck the
    lockstep collectives anyway), so the framework serves the same use
    case with identical shards + per-shard capacity headroom + mesh-shape
    choice, and this test pins that a maximally imbalanced load (ALL
    particles in shard 0's half of the box) evolves identically to the
    single-device run — correctness is load-independent, which is what
    size_grid buys the reference."""
    _require_devices(2)

    def build_skewed(px):
        nx, ny, nz = 8, 4, 4
        L = 1.0
        sim = Simulation(seed=7)
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.9 * sim.courant_length(L, L, L, nx, ny, nz))
        sim.define_periodic_grid(0, 0, 0, L, L, L, nx, ny, nz, px, 1, 1)
        sim.define_material("vacuum")
        e = sim.define_species("electron", -1.0, 4096)
        rng = np.random.default_rng(99)
        n = 1024
        # every particle in x < L/2 (shard 0 of the px=2 split)
        sim.inject_particle(e, rng.uniform(0, 0.5 * L, n),
                            rng.uniform(0, L, n), rng.uniform(0, L, n),
                            rng.normal(0, 0.3, n), rng.normal(0, 0.3, n),
                            rng.normal(0, 0.3, n), q=-1.0 / n)
        sim.set_field("ex", lambda x, y, z: 0.01 * np.sin(2 * np.pi * x))
        sim.finalize()
        return sim

    s1 = build_skewed(px=1)
    s2 = build_skewed(px=2)
    s1.advance(6)
    s2.advance(6)

    for comp in ("ex", "ey", "ez", "cbx", "cby", "cbz"):
        np.testing.assert_allclose(global_field(s1, comp),
                                   global_field(s2, comp),
                                   rtol=2e-4, atol=2e-5, err_msg=comp)
    e1, e2 = s1.energies(), s2.energies()
    for k in e1:
        np.testing.assert_allclose(e1[k], e2[k], rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    assert _alive_count(s1) == _alive_count(s2) == 1024
