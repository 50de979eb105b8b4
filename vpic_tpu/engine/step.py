"""The time step: a pure jitted SimState -> SimState function.

Composition mirrors vpic_simulation::advance (src/vpic/advance.cxx:13-244):

  clear accumulators -> sort (interval) -> user collisions ->
  advance_p per species -> emitters/user injection ->
  boundary_p x num_comm_round -> clear_jf + unload_accumulator +
  synchronize_jf -> user current injection -> advance_b(1/2) ->
  advance_e -> user field injection -> advance_b(1/2) ->
  (interval) div-E clean -> (interval) div-B clean ->
  (interval) shared-face sync -> load_interpolator -> step++
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.types import Grid, NEIGHBOR_REFLECT, PERIODIC_FIELDS, SimState
from ..field import stencil, sync
from ..particles import aux as paux
from ..particles import boundary as pboundary
from ..particles import push as ppush
from ..sf import interp as sfi


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """Runtime-adjustable controls (reference: vpic.cxx:13-48 defaults +
    modify_runparams, dump.cxx:824-890)."""

    num_comm_round: int = 3
    clean_div_e_interval: int = 0
    clean_div_b_interval: int = 0
    sync_shared_interval: int = 0
    n_walk: int = 4
    max_inj: int = 16384  # pending/injector buffer capacity
    # Per-face migration payload cap (lanes ppermuted per face per round);
    # None = max_inj.  Overflow is retried on later rounds, mirroring the
    # reference's bounded two-phase exchange (boundary_p.c:341-385).
    mig_cap: int | None = None
    # Steps per dispatched cycle: the deck API jits k steps as one
    # executable (and scans whole runs of cycles) so the host does not pay
    # a round trip per step.  Sorting follows each species' own
    # sort_interval (sort_p.c; species_advance.h:56).
    resort_interval: int = 1


def _interval_hit(step, interval: int):
    if interval <= 0:
        return None
    return (step % interval) == 0


def _clean_div_e(state: SimState, g: Grid, comm) -> SimState:
    """advance.cxx:151-173: rho accumulation + up to two Marder passes."""
    f = sfi.clear_rhof(state.field, g)
    for sp in state.species:
        f = paux.accumulate_rho_p(f, sp, g)
    f = sync.synchronize_rho(f, g, comm)
    f = stencil.compute_div_e_err(f, g, state.materials, state.material_grid,
                                  comm)
    err, vol = stencil.local_rms_div_e_err(f, g)
    err, vol = comm.allsum(err), comm.allsum(vol)
    rms = stencil.finish_rms(g, err, vol)

    def clean(f):
        f = stencil.clean_div_e(f, g, state.materials, state.material_grid)
        f2 = stencil.compute_div_e_err(f, g, state.materials,
                                       state.material_grid, comm)
        e2, v2 = stencil.local_rms_div_e_err(f2, g)
        rms2 = stencil.finish_rms(g, comm.allsum(e2), comm.allsum(v2))
        return lax.cond(
            rms2 > 0,
            lambda f2: stencil.clean_div_e(f2, g, state.materials,
                                           state.material_grid),
            lambda f2: f2,
            f2)

    f = lax.cond(rms > 0, clean, lambda f: f, f)
    return dataclasses.replace(state, field=f)


def _clean_div_b(state: SimState, g: Grid, comm) -> SimState:
    """advance.cxx:177-195."""
    f = stencil.compute_div_b_err(state.field, g)
    err, vol = stencil.local_rms_div_b_err(f, g)
    rms = stencil.finish_rms(g, comm.allsum(err), comm.allsum(vol))

    def clean(f):
        f = stencil.clean_div_b(f, g, comm)
        f2 = stencil.compute_div_b_err(f, g)
        e2, v2 = stencil.local_rms_div_b_err(f2, g)
        rms2 = stencil.finish_rms(g, comm.allsum(e2), comm.allsum(v2))
        return lax.cond(rms2 > 0,
                        lambda f2: stencil.clean_div_b(f2, g, comm),
                        lambda f2: f2, f2)

    f = lax.cond(rms > 0, clean, lambda f: f, f)
    return dataclasses.replace(state, field=f)


def make_advance(
    g: Grid,
    comm,
    pcomm=None,
    opts: StepOptions = StepOptions(),
    user_particle_collisions: Optional[Callable] = None,
    user_particle_injection: Optional[Callable] = None,
    user_current_injection: Optional[Callable] = None,
    user_field_injection: Optional[Callable] = None,
    emitters: tuple = (),
    boundary_handlers: tuple = (),
):
    """Build the (jittable) advance function for a fixed configuration.
    The ``user_*`` hooks are jax-traceable callbacks
    (SimState -> SimState), the deck section analogues
    (deck_wrapper.cxx:16-36)."""

    # under the Courant limit a particle crosses at most one face per
    # ACTIVE axis, so n_axes+1 streak segments always suffice (2D decks:
    # 3 instead of 4).  Reflecting walls burn an extra zero-length
    # segment when a lane lands exactly on the face, so wall decks get
    # one more.
    n_axes = (g.gnx > 1) + (g.gny > 1) + (g.gnz > 1)
    has_refl = any(b == NEIGHBOR_REFLECT for b in g.pbc)
    n_walk = min(opts.n_walk, n_axes + 1 + int(has_refl))

    # Boundary (guard-list) rounds are only reachable when something can
    # actually put a particle on the guard list or inject one mid-step:
    # inter-shard migration, absorbing/custom faces, handlers, emitters,
    # or user injection.  Periodic/reflecting faces resolve inside the
    # walk; leftover exhausted walkers are dropped+counted, mirroring the
    # reference's "Ignoring unprocessed movers" path (advance.cxx:98-103).
    needs_boundary = (
        pcomm is not None
        or bool(boundary_handlers)
        or bool(emitters)
        or user_particle_injection is not None
        or any(b not in (PERIODIC_FIELDS, NEIGHBOR_REFLECT) for b in g.pbc))

    def advance(state: SimState) -> SimState:
        f = state.field
        nb = state.grid_arrays.neighbor
        acc = jnp.zeros((g.nv, 12), dtype=jnp.float32)

        # -- sort (deposition locality) on each species' sort_interval --
        scope = jax.named_scope
        species = []
        for sp in state.species:
            if sp.sort_interval > 0:
                hit = (state.step % sp.sort_interval) == 0
                with scope("phase_sort"):
                    sp = lax.cond(hit, paux.sort_p, lambda s: s, sp)
            species.append(sp)

        state = dataclasses.replace(state, species=tuple(species))
        if user_particle_collisions is not None:
            state = user_particle_collisions(state)

        # -- particle push + current deposition --
        species = []
        for sp in state.species:
            with scope("phase_push"):
                sp, acc = ppush.advance_p(sp, state.interpolator, acc, nb, g,
                                          n_walk=n_walk,
                                          count_pending=not needs_boundary)
            species.append(sp)
        state = dataclasses.replace(state, species=tuple(species))

        # -- emission + user injection --
        for emitter in emitters:
            with scope("phase_emit"):
                state, acc, f = emitter(state, acc, f)
        if user_particle_injection is not None:
            # preferred signature (state, acc, f) -> (state, acc, f) so a
            # deck can inject_particle with rhob + aged-current deposits
            # (misc.cxx:16-106 via deck/inject.py); legacy state -> state
            # hooks still work
            try:
                state, acc, f = user_particle_injection(state, acc, f)
            except TypeError:
                state = user_particle_injection(state)

        # -- guard list processing (migration/absorption rounds) --
        # rounds run unconditionally when reachable; process_boundary is
        # O(max_inj) except for its one compaction pass.
        if needs_boundary:
            rng, sub = jax.random.split(state.rng)
            state = dataclasses.replace(state, rng=rng)
            bstate = state.boundary_state
            key = sub
            for _ in range(opts.num_comm_round if state.species else 0):
                species = []
                for sp in state.species:
                    key, k2 = jax.random.split(key)
                    with scope("phase_boundary"):
                        sp, f, acc, bstate = pboundary.process_boundary(
                            sp, f, acc, nb, g, pcomm, opts.max_inj, n_walk,
                            handlers=boundary_handlers, bstate=bstate,
                            key=k2, step=state.step, mig_cap=opts.mig_cap)
                    species.append(sp)
                state = dataclasses.replace(state, species=tuple(species))
            state = dataclasses.replace(state, boundary_state=bstate)
            state = dataclasses.replace(
                state,
                species=tuple(pboundary.finish_boundary(sp)
                              for sp in state.species))

        # -- currents -> fields --
        with scope("phase_jf"):
            f = sfi.clear_jf(f, g)
            if state.species:
                f = sfi.unload_accumulator(f, acc, g)
            f = sync.synchronize_jf(f, g, comm)

        state = dataclasses.replace(state, field=f)
        if user_current_injection is not None:
            state = user_current_injection(state)
        f = state.field

        # -- field advance --
        with scope("phase_field"):
            f = stencil.advance_b(f, g, 0.5)
            f = stencil.advance_e(f, g, state.materials,
                                  state.material_grid, comm)
        state = dataclasses.replace(state, field=f)
        if user_field_injection is not None:
            state = user_field_injection(state)
        f = state.field
        with scope("phase_field"):
            f = stencil.advance_b(f, g, 0.5)
        state = dataclasses.replace(state, field=f)

        # -- divergence cleaning / face sync on intervals --
        hit = _interval_hit(state.step, opts.clean_div_e_interval)
        if hit is not None:
            state = lax.cond(hit, partial(_clean_div_e, g=g, comm=comm),
                             lambda s: s, state)
        hit = _interval_hit(state.step, opts.clean_div_b_interval)
        if hit is not None:
            state = lax.cond(hit, partial(_clean_div_b, g=g, comm=comm),
                             lambda s: s, state)
        hit = _interval_hit(state.step, opts.sync_shared_interval)
        if hit is not None:
            def do_sync(state):
                f, _ = sync.synchronize_tang_e_norm_b(state.field, g, comm)
                return dataclasses.replace(state, field=f)
            state = lax.cond(hit, do_sync, lambda s: s, state)

        # -- interpolator for the next step --
        interp = state.interpolator
        if state.species:
            with scope("phase_interp"):
                interp = sfi.load_interpolator(state.field, g)

        return dataclasses.replace(
            state, interpolator=interp, step=state.step + 1)

    return advance
