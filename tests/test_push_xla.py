"""The XLA particle path — push, streak walk, scatter-add deposit, sort —
against the f64 scalar transcription of the reference (tests/ref/ref_impl.py)
and against plain NumPy, plus the whole-deck invariants it must keep.

No matrix product is on this path (the deposit is a scatter-add), so the
GPU's TF32 matmul precision never applies to it; GPU-vs-CPU differences
come from atomic summation order and FMA contraction only."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.ref import ref_impl as R

from vpic_tpu.core.types import (
    Grid,
    NEIGHBOR_REFLECT,
    PERIODIC_FIELDS,
    SpeciesState,
)
from vpic_tpu.grid.partition import make_grid_arrays
from vpic_tpu.particles import aux as paux
from vpic_tpu.particles import push as ppush

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 0.04


def _grid(nx, ny, nz, reflect_x=False):
    wall = NEIGHBOR_REFLECT if reflect_x else PERIODIC_FIELDS
    pbc = (wall, PERIODIC_FIELDS, PERIODIC_FIELDS,
           wall, PERIODIC_FIELDS, PERIODIC_FIELDS)
    g = Grid(nx=nx, ny=ny, nz=nz, dt=DT, cvac=1.0, eps0=1.0,
             gx1=1.0, gy1=1.0, gz1=1.0,
             fbc=(PERIODIC_FIELDS,) * 6, pbc=pbc)
    return g, R.G(nx, ny, nz, dt=DT, reflect_x=reflect_x)


def _particles(rng, rg, n, ut, q):
    x = rng.integers(1, rg.nx + 1, n)
    y = rng.integers(1, rg.ny + 1, n)
    z = rng.integers(1, rg.nz + 1, n)
    return dict(
        dx=rng.uniform(-1, 1, n), dy=rng.uniform(-1, 1, n),
        dz=rng.uniform(-1, 1, n), i=rg.voxel(x, y, z).astype(np.int64),
        ux=rng.normal(0, ut, n), uy=rng.normal(0, ut, n),
        uz=rng.normal(0, ut, n), q=q)


def _species(p, max_np):
    n = len(p["i"])
    pad = max_np - n

    def col(v, dtype=jnp.float32):
        return jnp.asarray(np.concatenate([v, np.zeros(pad)]), dtype)

    return SpeciesState.create("e", 0, -1.0, max_np).replace(
        np=jnp.int32(n), i=col(p["i"], jnp.int32),
        **{k: col(p[k]) for k in ("dx", "dy", "dz", "ux", "uy", "uz",
                                  "q")})


@pytest.mark.parametrize("q", ["uniform", "varied"])
@pytest.mark.parametrize("walls", ["periodic", "reflect_x"])
@pytest.mark.parametrize("dims", ["2d", "3d"])
def test_advance_p_matches_reference(dims, walls, q):
    """Push + streak walk + deposit of hot particles (many face crossings,
    wraps, and wall reflections) against the scalar reference."""
    rng = np.random.default_rng(11)
    g, rg = _grid(6, 5, 1 if dims == "2d" else 4, walls == "reflect_x")
    n = 300
    p = _particles(rng, rg, n, 3.0,
                   np.full(n, 0.7) if q == "uniform"
                   else rng.uniform(0.5, 1.5, n))
    ip = 0.1 * rng.normal(size=(g.nv, 18))

    pr = {k: v.copy() for k, v in p.items()}
    acc_ref = np.zeros((g.nv, 12))
    R.advance_p(pr, -1.0, ip, acc_ref, rg)

    ga = make_grid_arrays(g)
    sp, acc = jax.jit(lambda sp: ppush.advance_p(
        sp, jnp.asarray(ip, jnp.float32),
        jnp.zeros((g.nv, 12), jnp.float32), ga.neighbor, g,
        max_nm=n, n_walk=4))(_species(p, n + 20))

    assert int(sp.nm) == 0
    np.testing.assert_array_equal(np.asarray(sp.i)[:n], pr["i"])
    for c in ("ux", "uy", "uz"):
        np.testing.assert_allclose(np.asarray(getattr(sp, c))[:n], pr[c],
                                   rtol=1e-4, atol=1e-5, err_msg=c)
    for c in ("dx", "dy", "dz"):
        np.testing.assert_allclose(np.asarray(getattr(sp, c))[:n], pr[c],
                                   rtol=1e-3, atol=2e-4, err_msg=c)
    np.testing.assert_allclose(np.asarray(acc), acc_ref,
                               rtol=1e-3, atol=2e-4)


def _accumulate_j_np(q, sd, sm):
    """(n, 12) ACCUMULATE_J rows (advance_p.cxx:140-158) in f64 NumPy."""
    v5 = q * sd[0] * sd[1] * sd[2] / 3.0
    cols = []
    for X, Y, Z in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        vX = q * sd[X]
        cols += [vX * (1 - sm[Y]) * (1 - sm[Z]) + v5,
                 vX * (1 + sm[Y]) * (1 - sm[Z]) - v5,
                 vX * (1 - sm[Y]) * (1 + sm[Z]) - v5,
                 vX * (1 + sm[Y]) * (1 + sm[Z]) + v5]
    return np.stack(cols, axis=-1)


@pytest.mark.parametrize("dims", ["2d", "3d"])
def test_scatter_add_deposit_matches_np_add_at(dims):
    """Particles that stay in their cell deposit one streak each; many
    share a voxel, so the scatter-add sums colliding rows.  Field-free,
    so the push leaves u unchanged and the streak is known exactly."""
    rng = np.random.default_rng(5)
    g, rg = _grid(6, 5, 1 if dims == "2d" else 4)
    n = 600
    hot_vox = rg.voxel(np.array([1, 3, 6]), np.array([1, 2, 5]),
                       np.array([1, 1, rg.nz]))
    p = dict(dx=rng.uniform(-0.5, 0.5, n), dy=rng.uniform(-0.5, 0.5, n),
             dz=rng.uniform(-0.5, 0.5, n),
             i=rng.choice(hot_vox, n).astype(np.int64),
             ux=rng.normal(0, 0.05, n), uy=rng.normal(0, 0.05, n),
             uz=rng.normal(0, 0.05, n), q=rng.uniform(0.5, 1.5, n))
    ga = make_grid_arrays(g)
    sp, acc = jax.jit(lambda sp: ppush.advance_p(
        sp, jnp.zeros((g.nv, 18), jnp.float32),
        jnp.zeros((g.nv, 12), jnp.float32), ga.neighbor, g))(
            _species(p, n))
    np.testing.assert_array_equal(np.asarray(sp.i), p["i"])

    gamma = np.sqrt(1 + p["ux"] ** 2 + p["uy"] ** 2 + p["uz"] ** 2)
    sd = [p[u] * DT * r / gamma
          for u, r in (("ux", rg.rdx), ("uy", rg.rdy), ("uz", rg.rdz))]
    sm = [p[d] + s for d, s in zip(("dx", "dy", "dz"), sd)]
    want = np.zeros((g.nv, 12))
    np.add.at(want, p["i"], _accumulate_j_np(p["q"], sd, sm))
    np.testing.assert_allclose(np.asarray(acc), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("zombies", [False, True])
@pytest.mark.parametrize("has_tags", [False, True])
@pytest.mark.parametrize("uniform_q", [False, True])
def test_sort_p_invariants(uniform_q, has_tags, zombies):
    """sort_p orders live particles by voxel, keeps every live row intact
    (whichever payload columns it carries), drops zombies, re-counts np
    and clears the free tail."""
    rng = np.random.default_rng(3)
    max_np, n = 256, 200
    vox = rng.integers(20, 60, n)
    if zombies:
        vox[rng.choice(n, 30, replace=False)] = -1
    q = np.full(n, 0.25) if uniform_q else rng.uniform(0.5, 1.5, n)
    tag = rng.integers(1, 1000, n) if has_tags else np.zeros(n, int)
    pad = max_np - n

    def col(v, dtype=jnp.float32):
        return jnp.asarray(np.concatenate([v, np.zeros(pad)]), dtype)

    sp = SpeciesState.create("e", 0, -1.0, max_np, has_tags=has_tags,
                             uniform_q=uniform_q).replace(
        np=jnp.int32(n), i=col(vox, jnp.int32), q=col(q),
        tag=col(tag, jnp.int32),
        **{k: col(rng.normal(size=n)) for k in ("dx", "dy", "dz", "ux",
                                                "uy", "uz")})
    out = jax.jit(paux.sort_p)(sp)

    def rows(s, m):
        cols = [np.asarray(getattr(s, k))[m].astype(np.float64)
                for k in ("i", "dx", "dy", "dz", "ux", "uy", "uz", "q",
                          "tag")]
        return sorted(map(tuple, np.stack(cols, axis=1)))

    live = vox >= 0
    n_live = int(live.sum())
    assert int(out.np) == n_live
    i_out = np.asarray(out.i)
    assert np.all(np.diff(i_out[:n_live]) >= 0)
    assert rows(out, slice(0, n_live)) == rows(
        sp, np.concatenate([live, np.zeros(pad, bool)]))
    assert np.all(i_out[n_live:] == 0)
    assert np.all(np.asarray(out.q)[n_live:] == 0)
    assert np.all(np.asarray(out.tag)[n_live:] == 0)


@pytest.mark.parametrize("deck,env", [
    ("collisions", dict(COLL_NX="8", COLL_PPC="4")),
    ("sigma", dict(SIGMA_NX="16", SIGMA_NZ="8", SIGMA_PPC="4")),
    ("trecon", dict(TRECON_NX="16", TRECON_NZ="8", TRECON_PPC="4")),
    ("turbulence", dict(TURB_NX="8", TURB_NY="4", TURB_NZ="4",
                        TURB_PPC="2")),
    ("turbulence_fan", dict(FAN_NX="4", FAN_NY="4", FAN_NZ="4",
                            FAN_PPC="2")),
])
def test_deck_runs_two_steps(deck, env, monkeypatch, tmp_path):
    """Every deck in decks/ builds through the CLI's loader at a tiny size
    and advances two steps with finite energies and no dropped movers."""
    from vpic_tpu.cli.run import load_deck

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    sim = load_deck(os.path.join(ROOT, "decks", f"{deck}.py")).deck()
    if sim.state is None:
        sim.finalize()
    sim.advance(2)
    assert sim.step_count == 2
    assert all(np.isfinite(v) for v in sim.energies().values())
    assert all(c == 0 for c in sim.mover_counts().values())


@pytest.mark.parametrize("n_walk", [None, 2])
def test_closed_deck_drops_no_movers(n_walk):
    """A closed periodic deck must process EVERY mover: sp.nm == 0 after
    several cycles and np conserved — the invariant the reference WARNs
    about (advance.cxx:98-103), including at n_walk=2, where double
    crossers need the streak walker's extra segments."""
    import __graft_entry__ as ge

    sim = ge._build(nx=8, ny=8, nz=1, npart=1500, ion_sort_mult=2,
                    n_walk=n_walk)
    np0 = sum(int(np.asarray(sp.np)) for sp in sim.state.species)
    sim.advance(8)
    for sp in sim.state.species:
        assert int(np.asarray(sp.nm)) == 0, sp.name
    assert sum(int(np.asarray(sp.np)) for sp in sim.state.species) == np0
    assert all(np.isfinite(v) for v in sim.energies().values())


def test_closed_deck_drops_no_movers_3d():
    """Same invariant on a 3D (nz > 1) closed box, where z crossings add
    a third active axis to the walk."""
    import __graft_entry__ as ge

    sim = ge._build(nx=16, ny=16, nz=8, npart=1500, ion_sort_mult=2)
    np0 = sum(int(np.asarray(sp.np)) for sp in sim.state.species)
    sim.advance(8)
    for sp in sim.state.species:
        assert int(np.asarray(sp.nm)) == 0, sp.name
    assert sum(int(np.asarray(sp.np)) for sp in sim.state.species) == np0
    assert all(np.isfinite(v) for v in sim.energies().values())


@pytest.mark.parametrize("dens,k", [(0.0, 64), (0.001, 64), (0.02, 64),
                                    (0.02, 8), (0.5, 256), (1.0, 128)])
def test_compact_indices_matches_numpy(dens, k):
    """The prefix-sum compaction returns the first k set lanes in order,
    the full count, and a validity mask; empty slots carry max_np."""
    from vpic_tpu.particles.push import compact_indices

    rng = np.random.default_rng(7)
    n = 4096
    mask = rng.random(n) < dens
    sel, n_true, valid = compact_indices(jnp.asarray(mask), k, n)
    want = np.flatnonzero(mask)[:k]
    assert int(n_true) == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(valid),
                                  np.arange(k) < len(want))
    np.testing.assert_array_equal(np.asarray(sel)[:len(want)], want)
    assert np.all(np.asarray(sel)[len(want):] == n)


def test_compact_indices_overflow_counted():
    """Set lanes beyond k are dropped from sel but still counted in n_true
    (callers charge them against the mover-drop counter)."""
    from vpic_tpu.particles.push import compact_indices

    n = 1024
    mask = np.zeros(n, bool)
    mask[[5, 200, 300, 900]] = True
    sel, n_true, valid = compact_indices(jnp.asarray(mask), 2, n)
    assert int(n_true) == 4
    assert list(np.asarray(sel)) == [5, 200]
    assert list(np.asarray(valid)) == [True, True]


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_placement(env_set, tmp_path):
    """Without JAX_COMPILATION_CACHE_DIR the cache sits at the fixed path
    <checkout>/.jax_cache, which .gitignore lists; with it set, the
    package sets no cache directory at all."""
    import vpic_tpu

    before = jax.config.jax_compilation_cache_dir
    try:
        env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
        got = vpic_tpu.configure_compile_cache(env)
        if env_set:
            assert got is None
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert got == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            with open(os.path.join(ROOT, ".gitignore")) as fh:
                assert ".jax_cache/" in fh.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("entry", ["require_gpu", "bench", "chip_smoke"])
def test_gpu_entry_points_refuse_cpu(entry, monkeypatch):
    """Measurements never fall back to the CPU: the device check and the
    two on-card entry points exit non-zero before building anything."""
    import importlib
    import sys

    from vpic_tpu.core.diagnostics import require_gpu

    assert jax.default_backend() != "gpu"
    if entry == "require_gpu":
        fn = require_gpu
    else:
        monkeypatch.syspath_prepend(ROOT)
        mod = importlib.import_module(entry)
        fn = mod.main
        monkeypatch.setattr(sys, "argv", [entry])
    with pytest.raises(SystemExit) as exc:
        fn()
    assert exc.value.code not in (0, None)
    assert "no GPU backend" in str(exc.value.code)


@pytest.mark.gpu
def test_advance_p_gpu_matches_cpu():
    """One push of the same hot particles on the GPU and on the CPU agrees
    to rounding: atomic deposit order and FMA contraction only."""
    rng = np.random.default_rng(2)
    g, rg = _grid(16, 16, 4)
    n = 20_000
    p = _particles(rng, rg, n, 1.0, rng.uniform(0.5, 1.5, n))
    ip = jnp.asarray(0.1 * rng.normal(size=(g.nv, 18)), jnp.float32)
    nb = make_grid_arrays(g).neighbor

    def run(dev):
        sp = jax.device_put(_species(p, n), dev)
        f = jax.jit(lambda sp, ip, nb: ppush.advance_p(
            sp, ip, jnp.zeros((g.nv, 12), jnp.float32), nb, g))
        return f(sp, jax.device_put(ip, dev), jax.device_put(nb, dev))

    sg, ag = run(jax.devices("gpu")[0])
    sc, ac = run(jax.devices("cpu")[0])
    same = np.asarray(sg.i) == np.asarray(sc.i)
    assert (~same).sum() <= 2
    for c in ("dx", "dy", "dz", "ux", "uy", "uz"):
        np.testing.assert_allclose(np.asarray(getattr(sg, c))[same],
                                   np.asarray(getattr(sc, c))[same],
                                   rtol=1e-5, atol=1e-6, err_msg=c)
    np.testing.assert_allclose(np.asarray(ag), np.asarray(ac),
                               rtol=1e-4, atol=1e-5)
