"""Particle push + charge-conserving current deposition.

Re-design of the reference's hot loop:

- ``advance_p`` (src/species_advance/standard/advance_p.cxx:68-183): gather
  18 interpolation coefficients, half-E kick, 6th-order-accurate Boris
  rotation (Taylor tan expansion, :91-96), half-E kick, relativistic
  displacement, in-bounds check, 12-component quadrant current deposition
  with the q*ux*uy*uz/3 charge-conservation correction (:137-163).
- ``move_p`` (src/species_advance/standard/move_p.c:20-136): the
  streak-splitting cell walker for particles that leave their voxel.

Re-design decisions:
- One fused vectorized phase over all particles (the in-bounds fast path),
  then a fixed-capacity "mover buffer" (the SoA analogue of
  ``particle_mover_t``, species_advance.h:39-42) gathered by stable argsort
  compaction; the walker runs a *bounded* number of streak iterations on the
  buffer only (under the Courant limit a particle crosses at most one face
  per axis, so 4 segments suffice; extra rounds mirror num_comm_round).
- Deposition accumulates into a dense (nv, 12) float32 accumulator with
  XLA scatter-add, replacing the per-pipeline accumulator replicas +
  reduce_accumulators (sf_interface.h:60-77).  On a GPU the scatter is an
  atomic add, so the summation order (and the last bits of the current)
  can change from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.types import (
    Grid,
    IP,
    NEIGHBOR_REFLECT,
    SpeciesState,
)

ONE_THIRD = 1.0 / 3.0
TWO_FIFTEENTHS = 2.0 / 15.0

# pcode values (per-particle boundary status)
PC_DONE = 0          # settled in a voxel
PC_EXHAUSTED = 1     # walker ran out of iterations (mirror of mover overflow)
# negative: the neighbor-table boundary code that stopped the walk


def interpolate_fields(ip, dx, dy, dz):
    """E (first-order in-plane expansion) and cB (linear) at the particle
    (advance_p.cxx:74-82).  ``ip`` is the gathered (n, 18) coefficient rows."""
    c = lambda k: ip[:, IP[k]]
    ex = (c("ex") + dy * c("dexdy")) + dz * (c("dexdz") + dy * c("d2exdydz"))
    ey = (c("ey") + dz * c("deydz")) + dx * (c("deydx") + dz * c("d2eydzdx"))
    ez = (c("ez") + dx * c("dezdx")) + dy * (c("dezdy") + dx * c("d2ezdxdy"))
    cbx = c("cbx") + dx * c("dcbxdx")
    cby = c("cby") + dy * c("dcbydy")
    cbz = c("cbz") + dz * c("dcbzdz")
    return ex, ey, ez, cbx, cby, cbz


def boris_rotation(ux, uy, uz, cbx, cby, cbz, v0):
    """The Boris rotation given v0 = (q dt'/2mc)/gamma (advance_p.cxx:91-102);
    v3 = v0*(1 + v2*(1/3 + v2*2/15)) is the tan(theta/2)/(theta/2) Taylor
    correction making the rotation 6th-order accurate."""
    one = jnp.float32(1.0)
    v1 = cbx * cbx + (cby * cby + cbz * cbz)
    v2 = (v0 * v0) * v1
    v3 = v0 * (one + v2 * (jnp.float32(ONE_THIRD) + v2 * jnp.float32(TWO_FIFTEENTHS)))
    v4 = v3 / (one + v1 * (v3 * v3))
    v4 = v4 + v4
    w0 = ux + v3 * (uy * cbz - uz * cby)
    w1 = uy + v3 * (uz * cbx - ux * cbz)
    w2 = uz + v3 * (ux * cby - uy * cbx)
    ux = ux + v4 * (w1 * cbz - w2 * cby)
    uy = uy + v4 * (w2 * cbx - w0 * cbz)
    uz = uz + v4 * (w0 * cby - w1 * cbx)
    return ux, uy, uz


def deposit12_cols(q, sdx, sdy, sdz, smx, smy, smz):
    """Quadrant current contributions for a streak with half-displacement
    (sdx,sdy,sdz) and midpoint (smx,smy,smz): the ACCUMULATE_J macro
    (advance_p.cxx:140-158), all three axis permutations.  Returns a tuple
    of 12 (n,) arrays."""
    one = jnp.float32(1.0)
    v5 = q * sdx * sdy * sdz * jnp.float32(ONE_THIRD)
    sd = (sdx, sdy, sdz)
    sm = (smx, smy, smz)
    cols = []
    for X, Y, Z in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        vX = q * sd[X]
        my, mz = sm[Y], sm[Z]
        cols += [
            vX * (one - my) * (one - mz) + v5,
            vX * (one + my) * (one - mz) - v5,
            vX * (one - my) * (one + mz) - v5,
            vX * (one + my) * (one + mz) + v5,
        ]
    return tuple(cols)


class WalkState(NamedTuple):
    """Streak-walker state, all-1D SoA."""
    x: jax.Array; y: jax.Array; z: jax.Array        # cell-relative position
    vox: jax.Array                                  # voxel
    ux: jax.Array; uy: jax.Array; uz: jax.Array     # momentum
    rx: jax.Array; ry: jax.Array; rz: jax.Array     # remaining half-disp
    q: jax.Array
    pcode: jax.Array
    active: jax.Array


def compact_indices(mask, k: int, max_np: int):
    """Stable indices of the first k True entries (padded with max_np).
    O(n) prefix-sum compaction (no sort).  Returns (sel, n_true, valid)."""
    k = min(k, mask.shape[0])
    n_arr = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1          # slot per True
    slot = jnp.where(mask & (pos < k), pos, k)            # k = drop sentinel
    sel = jnp.full((k,), max_np, dtype=jnp.int32).at[slot].set(
        jnp.arange(n_arr, dtype=jnp.int32), mode="drop")
    n = jnp.sum(mask).astype(jnp.int32)
    valid = jnp.arange(k, dtype=jnp.int32) < n
    return jnp.where(valid, sel, max_np), n, valid


def _neighbor_lookup(vox, face, done, neighbor, g):
    """neighbor[vox, face]: row-gather of the 6-entry neighbor row, then a
    select of the face."""
    rows = neighbor[vox]                      # (n, 6) row gather
    face_oh = face[:, None] == jnp.arange(6, dtype=face.dtype)[None, :]
    return jnp.sum(jnp.where(face_oh, rows, 0), axis=1).astype(vox.dtype)


def walk_segment(st: WalkState, neighbor, g):
    """One streak-split segment for every lane (the loop body of
    move_p.c:34-134).  Returns (new_state, dep_vox, contrib_cols): the
    quadrant current contributions of this segment as 12 (n,) arrays
    (zero for inactive lanes), deposited at the PRE-crossing voxel."""
    big = jnp.float32(3.4e38)
    one = jnp.float32(1.0)

    pos = (st.x, st.y, st.z)
    rem = (st.rx, st.ry, st.rz)
    u = (st.ux, st.uy, st.uz)

    sdir = tuple(jnp.where(r > 0, one, -one) for r in rem)
    # clamp to >= 0: a lane 1 ulp OUTSIDE its face (reflection/wrap
    # rounding) would otherwise get a negative fraction and walk
    # backward forever; 0 makes it a zero-length crossing that snaps the
    # coordinate exactly onto the face
    frac2 = tuple(
        jnp.where(r == 0, big, jnp.maximum((d - p) / r, 0.0))
        for r, d, p in zip(rem, sdir, pos))
    # sequential min with later-axis tie priority (move_p.c:59-62)
    v3 = jnp.full_like(st.q, 2.0)
    stype = jnp.full_like(st.vox, 3)
    for a in range(3):
        hit = frac2[a] < v3
        v3 = jnp.where(hit, frac2[a], v3)
        stype = jnp.where(hit, a, stype)
    v3 = v3 * jnp.float32(0.5)

    sd = tuple(r * v3 for r in rem)
    sm = tuple(p + d for p, d in zip(pos, sd))

    q_eff = jnp.where(st.active, st.q, jnp.float32(0.0))
    contrib = deposit12_cols(q_eff, *sd, *sm)
    dep_vox = jnp.where(st.active, st.vox, 0)

    rem_new = tuple(r - d for r, d in zip(rem, sd))
    pos_new = tuple(p + 2.0 * d for p, d in zip(pos, sd))

    st = resolve_crossing(st, pos, rem, u, pos_new, rem_new, stype, sdir,
                          neighbor, g)
    return st, dep_vox, contrib


def resolve_crossing(st: WalkState, pos, rem, u, pos_new, rem_new,
                     stype, sdir, neighbor, g):
    """The boundary half of a streak segment (move_p.c:112-133): consult
    the neighbor for the crossed face; local crossing flips the
    coordinate, reflect flips momentum/displacement, anything else stops
    with the boundary code."""
    done = stype == 3
    # face = type + 3*(dir>0)  (move_p.c:123)
    hit_ax = tuple(stype == a for a in range(3))
    dir_hit = sum(jnp.where(h, d, 0.0) for h, d in zip(hit_ax, sdir))
    face = stype + jnp.where(dir_hit > 0, 3, 0)

    nb = _neighbor_lookup(st.vox, face, done, neighbor, g)

    crossed = (~done) & (nb >= 0) & st.active
    reflected = (~done) & (nb == NEIGHBOR_REFLECT) & st.active
    stopped = (~done) & (nb < 0) & (nb != NEIGHBOR_REFLECT) & st.active

    out_pos, out_rem, out_u = [], [], []
    for a in range(3):
        h = hit_ax[a]
        # crossing flips the coordinate; boundary hits land exactly on it
        pa = jnp.where(crossed & h, -dir_hit,
                       jnp.where((reflected | stopped) & h, dir_hit,
                                 pos_new[a]))
        ra = jnp.where(reflected & h, -rem_new[a], rem_new[a])
        ua = jnp.where(reflected & h, -u[a], u[a])
        out_pos.append(jnp.where(st.active, pa, pos[a]))
        out_rem.append(jnp.where(st.active, ra, rem[a]))
        out_u.append(jnp.where(st.active, ua, u[a]))

    vox_out = jnp.where(crossed, nb, st.vox)
    pcode_out = jnp.where(stopped, nb, st.pcode)
    active_out = st.active & ~(done | stopped)

    return WalkState(
        x=out_pos[0], y=out_pos[1], z=out_pos[2],
        vox=vox_out,
        ux=out_u[0], uy=out_u[1], uz=out_u[2],
        rx=out_rem[0], ry=out_rem[1], rz=out_rem[2],
        q=st.q, pcode=pcode_out, active=active_out,
    )


def streak_walk(st: WalkState, acc, neighbor, g, n_iter: int):
    """Run streak-split segments until every lane finishes (or a generous
    static bound trips), depositing each segment's quadrant currents via
    scatter-add — move_p's unbounded while loop (move_p.c:34-134).

    ``n_iter`` sizes the guaranteed-sufficient interior budget (one face
    event per active axis); flat-axis wraps of relativistic lanes (a 2D
    deck's out-of-plane drift crosses its one-cell y axis several times,
    each wrap a segment) extend past it, so the loop runs while any lane
    is active up to ``4*n_iter + 8`` — beyond that lanes are dropped and
    counted (advance.cxx:98-103 semantics)."""
    cap = jnp.int32(4 * n_iter + 8)

    def cond(carry):
        i, st, _ = carry
        return (i < cap) & jnp.any(st.active)

    def body(carry):
        i, st, acc = carry
        st, dep_vox, contrib = walk_segment(st, neighbor, g)
        acc = acc.at[dep_vox].add(jnp.stack(contrib, axis=-1),
                                  mode="promise_in_bounds")
        return i + 1, st, acc

    _, st, acc = jax.lax.while_loop(cond, body, (jnp.int32(0), st, acc))
    # anything still active exhausted the bound
    pcode = jnp.where(st.active, jnp.int32(PC_EXHAUSTED), st.pcode)
    return st._replace(pcode=pcode, active=jnp.zeros_like(st.active)), acc


def advance_p(sp: SpeciesState, interp, acc, neighbor, g: Grid,
              max_nm: int | None = None, n_walk: int = 4,
              count_pending: bool = True):
    """One particle push for a whole species.

    Segment 1 of the streak walk runs vectorized over ALL particles (for
    in-bounds particles — the vast majority — it IS the full streak), and
    its deposition is one scatter-add into the (nv, 12) accumulator.  Cell
    crossers finish in a fixed-capacity compacted mover buffer
    (particle_mover_t analogue); results merge back by one row gather.

    ``sp.nm`` ACCUMULATES dropped movers across steps (the per-step
    "Ignoring %i unprocessed movers" of advance.cxx:98-103, summed so a
    multi-step jitted dispatch cannot silently reset it — round-4 lesson:
    the old replace semantics masked real drops between reads).  Lanes
    stopped with a boundary code are pending, not dropped, when a
    boundary-round pass follows (``count_pending=False``); the rounds'
    own ``finish_boundary`` counts their leftovers."""
    if max_nm is None:
        # sized for relativistic decks (v ~ c near the Courant limit can
        # cross a face for half the particles per step); overflow is
        # dropped+counted in sp.nm (advance.cxx:98-103 semantics)
        max_nm = max(1, sp.max_np // 2)
    max_nm = min(max_nm, sp.max_np)

    qdt_2mc = (0.5 * sp.q_m * g.dt / g.cvac).astype(jnp.float32)
    cdt_dx = jnp.float32(g.cvac * g.dt * g.rdx)
    cdt_dy = jnp.float32(g.cvac * g.dt * g.rdy)
    cdt_dz = jnp.float32(g.cvac * g.dt * g.rdz)
    one = jnp.float32(1.0)

    alive = sp.alive
    vox = jnp.where(alive, sp.i, 0)

    ip = interp[vox]

    ex, ey, ez, cbx, cby, cbz = interpolate_fields(ip, sp.dx, sp.dy, sp.dz)
    hax, hay, haz = qdt_2mc * ex, qdt_2mc * ey, qdt_2mc * ez

    ux = sp.ux + hax
    uy = sp.uy + hay
    uz = sp.uz + haz
    v0 = qdt_2mc / jnp.sqrt(one + (ux * ux + (uy * uy + uz * uz)))
    ux, uy, uz = boris_rotation(ux, uy, uz, cbx, cby, cbz, v0)
    ux = ux + hax
    uy = uy + hay
    uz = uz + haz

    # normalized half-displacement (advance_p.cxx:109-116)
    v0 = one / jnp.sqrt(one + (ux * ux + (uy * uy + uz * uz)))
    ddx = (ux * cdt_dx) * v0
    ddy = (uy * cdt_dy) * v0
    ddz = (uz * cdt_dz) * v0

    # ---- segment 1 for every particle ----
    st = WalkState(
        x=sp.dx, y=sp.dy, z=sp.dz, vox=vox,
        ux=ux, uy=uy, uz=uz, rx=ddx, ry=ddy, rz=ddz,
        q=sp.q, pcode=jnp.zeros((sp.max_np,), dtype=jnp.int32),
        active=alive,
    )
    st, dep_vox, contrib = walk_segment(st, neighbor, g)
    acc = acc.at[dep_vox].add(jnp.stack(contrib, axis=-1),
                              mode="promise_in_bounds")

    return _finish_after_segment1(sp, st, acc, neighbor, g, alive,
                                  max_nm, n_walk, count_pending)


def _finish_after_segment1(sp, st, acc, neighbor, g, alive, max_nm, n_walk,
                           count_pending=True):
    # ---- remaining segments on a compacted mover buffer ----
    unfinished = st.active
    pos_c = jnp.cumsum(unfinished.astype(jnp.int32)) - 1
    n_out = jnp.sum(unfinished).astype(jnp.int32)
    slot = jnp.where(unfinished & (pos_c < max_nm), pos_c, max_nm)
    sel = jnp.zeros((max_nm,), jnp.int32).at[slot].set(
        jnp.arange(sp.max_np, dtype=jnp.int32), mode="drop")
    buf_active = jnp.arange(max_nm, dtype=jnp.int32) < jnp.minimum(
        n_out, max_nm)
    sel = jnp.where(buf_active, sel, 0)
    in_buf = unfinished & (pos_c < max_nm)
    ignored = unfinished & ~in_buf            # buffer overflow -> rounds

    # gather the buffer as packed rows (one row-gather, not 11 1D gathers)
    full_packed = jnp.stack(
        [st.x, st.y, st.z, st.ux, st.uy, st.uz, st.rx, st.ry, st.rz,
         st.vox.astype(jnp.float32), st.q], axis=-1)     # (max_np, 11)
    bp = full_packed[sel]                                # (max_nm, 11)
    bst = WalkState(
        x=bp[:, 0], y=bp[:, 1], z=bp[:, 2],
        vox=bp[:, 9].astype(jnp.int32),
        ux=bp[:, 3], uy=bp[:, 4], uz=bp[:, 5],
        rx=bp[:, 6], ry=bp[:, 7], rz=bp[:, 8],
        q=jnp.where(buf_active, bp[:, 10], 0.0),
        pcode=jnp.zeros((max_nm,), dtype=jnp.int32),
        active=buf_active,
    )
    bst, acc = streak_walk(bst, acc, neighbor, g, n_walk - 1)

    # ---- merge: ONE packed row-gather of the buffer results ----
    rank = jnp.where(in_buf, pos_c, 0)
    packed = jnp.stack(
        [bst.x, bst.y, bst.z, bst.ux, bst.uy, bst.uz,
         bst.rx, bst.ry, bst.rz,
         bst.vox.astype(jnp.float32),
         bst.pcode.astype(jnp.float32)], axis=-1)      # (max_nm, 11)
    got = packed[rank]                                  # (max_np, 11) rows

    def merge(full, col):
        return jnp.where(in_buf, got[:, col], full)

    dx = merge(st.x, 0)
    dy = merge(st.y, 1)
    dz = merge(st.z, 2)
    uxo = merge(st.ux, 3)
    uyo = merge(st.uy, 4)
    uzo = merge(st.uz, 5)
    vox_o = jnp.where(in_buf, got[:, 9].astype(jnp.int32), st.vox)

    pc = jnp.where(ignored, jnp.int32(PC_EXHAUSTED), st.pcode)
    pc = jnp.where(in_buf, got[:, 10].astype(jnp.int32), pc)
    pend = pc != PC_DONE
    mdx = jnp.where(pend, merge(st.rx, 6), 0.0)
    mdy = jnp.where(pend, merge(st.ry, 7), 0.0)
    mdz = jnp.where(pend, merge(st.rz, 8), 0.0)

    # keep dead slots dead
    vox_o = jnp.where(alive, vox_o, sp.i)
    # pending movers go to the boundary rounds when one follows (their
    # leftovers are counted there); in a closed config they are drops
    nm = sp.nm + (jnp.sum(alive & pend).astype(jnp.int32)
                  if count_pending else 0)

    sp = sp.replace(dx=dx, dy=dy, dz=dz, i=vox_o, ux=uxo, uy=uyo, uz=uzo,
                    mdx=mdx, mdy=mdy, mdz=mdz, pc=pc, nm=nm)
    return sp, acc


def center_p(sp: SpeciesState, interp, g: Grid) -> SpeciesState:
    """u_{-1/2} -> u_0: half-E kick then half Boris rotation
    (center_p.cxx:13-70)."""
    qdt_2mc = (0.5 * sp.q_m * g.dt / g.cvac).astype(jnp.float32)
    return _center(sp, interp, qdt_2mc, 0.5 * qdt_2mc, kick_first=True)


def uncenter_p(sp: SpeciesState, interp, g: Grid) -> SpeciesState:
    """u_0 -> u_{-1/2}: backward half rotation then backward half kick
    (uncenter_p.cxx:14-70)."""
    qdt_2mc = (0.5 * sp.q_m * g.dt / g.cvac).astype(jnp.float32)
    return _center(sp, interp, -qdt_2mc, -0.5 * qdt_2mc, kick_first=False)


def _center(sp, interp, kick, rot, kick_first):
    one = jnp.float32(1.0)
    ip = interp[sp.i]
    ex, ey, ez, cbx, cby, cbz = interpolate_fields(ip, sp.dx, sp.dy, sp.dz)
    hax, hay, haz = kick * ex, kick * ey, kick * ez
    ux, uy, uz = sp.ux, sp.uy, sp.uz
    if kick_first:
        ux, uy, uz = ux + hax, uy + hay, uz + haz
    v0 = rot / jnp.sqrt(one + (ux * ux + (uy * uy + uz * uz)))
    ux, uy, uz = boris_rotation(ux, uy, uz, cbx, cby, cbz, v0)
    if not kick_first:
        ux, uy, uz = ux + hax, uy + hay, uz + haz
    return sp.replace(ux=ux, uy=uy, uz=uz)


def energy_p(sp: SpeciesState, interp, g: Grid):
    """Local kinetic energy of a species (energy_p.cxx:31-46 + :124-157):
    sum q * |u+halfkick|^2/(sqrt(1+|u|^2)+1), double accumulation; caller
    psums and scales by cvac^2/q_m."""
    one = jnp.float32(1.0)
    qdt_2mc = (0.5 * sp.q_m * g.dt / g.cvac).astype(jnp.float32)
    ip = interp[sp.i]
    ex, ey, ez, _, _, _ = interpolate_fields(ip, sp.dx, sp.dy, sp.dz)
    v0 = sp.ux + qdt_2mc * ex
    v1 = sp.uy + qdt_2mc * ey
    v2 = sp.uz + qdt_2mc * ez
    usq = v0 * v0 + v1 * v1 + v2 * v2
    ke = usq / (jnp.sqrt(one + usq) + one)
    en = jnp.sum(jnp.where(sp.alive,
                           ke.astype(jnp.float64) * sp.q.astype(jnp.float64),
                           0.0))
    return en


def finish_energy_p(sp: SpeciesState, g: Grid, global_en):
    return (g.cvac * g.cvac / sp.q_m).astype(jnp.float64) * global_en
