"""Charge / hydro deposits and the particle sort.

- accumulate_rho_p  (src/species_advance/standard/rho_p.c:24-79)
- accumulate_rhob   (boundary-corrected, boundary_p.c:9-71)
- accumulate_hydro_p(src/species_advance/standard/hydro_p.c:25-161)
- sort_p            (src/species_advance/standard/sort_p.c:16-102) — here an
  argsort-by-voxel compaction that also reclaims zombie slots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import FieldState, Grid, SpeciesState
from .push import interpolate_fields, ONE_THIRD

# node offsets in deposit order w0..w7 (rho_p.c:70-79): (x,y,z) low corner
# first, x fastest.
_NODE_OFFS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
              (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1))


def trilinear_weights(q, dx, dy, dz, r8V):
    """(n, 8) trilinear node weights, w/8 * (1 +/- x)(1 +/- y)(1 +/- z)."""
    w = r8V * q
    ws = []
    for ox, oy, oz in _NODE_OFFS:
        wx = (1.0 + dx) if ox else (1.0 - dx)
        wy = (1.0 + dy) if oy else (1.0 - dy)
        wz = (1.0 + dz) if oz else (1.0 - dz)
        ws.append(w * wx * wy * wz)
    return jnp.stack(ws, axis=-1)


def _node_indices(g: Grid, vox):
    """(n, 8) linear voxel indices of the 8 surrounding nodes."""
    offs = jnp.asarray(
        [ox + g.nxg * (oy + g.nyg * oz) for ox, oy, oz in _NODE_OFFS],
        dtype=jnp.int32)
    return vox[:, None] + offs[None, :]


def accumulate_rho_p(f: FieldState, sp: SpeciesState, g: Grid) -> FieldState:
    """Trilinear node deposit of charge to rhof (rho_p.c)."""
    alive = sp.alive
    q = jnp.where(alive, sp.q, 0.0)
    r8V = jnp.float32(0.125 * g.rdx * g.rdy * g.rdz)
    w = trilinear_weights(q, sp.dx, sp.dy, sp.dz, r8V)
    idx = _node_indices(g, jnp.where(alive, sp.i, 0))
    rhof = f.rhof.reshape(-1).at[idx].add(w, mode="promise_in_bounds")
    return f.replace(rhof=rhof.reshape(g.shape))


def rhob_weights(g: Grid, vox, w):
    """Boundary-corrected weights for rhob accumulation: weights double on
    each domain-edge node plane the node sits on (boundary_p.c:53-63)."""
    j = vox // g.nxg
    ix = vox - j * g.nxg
    iz = j // g.nyg
    iy = j - iz * g.nyg

    for a, (n, idx) in enumerate(((g.nx, ix), (g.ny, iy), (g.nz, iz))):
        low = (idx == 1)
        high = (idx == n)
        # nodes on the low side of the low cell / high side of the high cell
        for k, (ox, oy, oz) in enumerate(_NODE_OFFS):
            o = (ox, oy, oz)[a]
            dbl = jnp.where(o == 0, low, jnp.zeros_like(low)) | \
                  jnp.where(o == 1, high, jnp.zeros_like(high))
            w = w.at[:, k].multiply(jnp.where(dbl, 2.0, 1.0))
    return w


def accumulate_rhob(f: FieldState, g: Grid, vox, q, dx, dy, dz,
                    mask) -> FieldState:
    """Deposit (masked) particles' charge to rhob with boundary-corrected
    weights (used for absorbed/injected particles, boundary_p.c:9-71)."""
    qm = jnp.where(mask, q, 0.0)
    r8V = jnp.float32(0.125 * g.rdx * g.rdy * g.rdz)
    vox0 = jnp.where(mask, vox, 0)
    w = trilinear_weights(qm, dx, dy, dz, r8V)
    w = rhob_weights(g, vox0, w)
    idx = _node_indices(g, vox0)
    rhob = f.rhob.reshape(-1).at[idx].add(w, mode="promise_in_bounds")
    return f.replace(rhob=rhob.reshape(g.shape))


N_HYDRO = 14
HYDRO = dict(jx=0, jy=1, jz=2, rho=3, px=4, py=5, pz=6, ke=7,
             txx=8, tyy=9, tzz=10, tyz=11, tzx=12, txy=13)


def accumulate_hydro_p(h, sp: SpeciesState, interp, g: Grid):
    """Deposit the 14 hydrodynamic moments (hydro_p.c:25-161) into the
    (nv, 14) array ``h``."""
    alive = sp.alive
    qdt_2mc = (0.5 * sp.q_m * g.dt / g.cvac).astype(jnp.float32)
    qdt_4mc2 = (0.25 * sp.q_m * g.dt / (g.cvac * g.cvac)).astype(jnp.float32)
    c = jnp.float32(g.cvac)
    r8V = jnp.float32(0.125 * g.rdx * g.rdy * g.rdz)
    mc_q = (g.cvac / sp.q_m).astype(jnp.float32)

    vox = jnp.where(alive, sp.i, 0)
    ip = interp[vox]
    ex, ey, ez, cbx, cby, cbz = interpolate_fields(ip, sp.dx, sp.dy, sp.dz)
    ux = sp.ux + qdt_2mc * ex
    uy = sp.uy + qdt_2mc * ey
    uz = sp.uz + qdt_2mc * ez

    ke_mc = ux * ux + uy * uy + uz * uz
    gamma = jnp.sqrt(1.0 + ke_mc)
    ke_mc = ke_mc * c / (gamma + 1.0)
    vg = c / gamma
    w0 = qdt_4mc2 * vg
    w1 = cbx * cbx + cby * cby + cbz * cbz
    w2 = w0 * w0 * w1
    w3 = w0 * (1.0 + jnp.float32(ONE_THIRD) * w2 * (1.0 + 0.4 * w2))
    w4 = w3 / (1.0 + w1 * w3 * w3)
    w4 = w4 + w4
    a0 = ux + w3 * (uy * cbz - uz * cby)
    a1 = uy + w3 * (uz * cbx - ux * cbz)
    a2 = uz + w3 * (ux * cby - uy * cbx)
    ux = ux + w4 * (a1 * cbz - a2 * cby)
    uy = uy + w4 * (a2 * cbx - a0 * cbz)
    uz = uz + w4 * (a0 * cby - a1 * cbx)
    vx, vy, vz = ux * vg, uy * vg, uz * vg

    q = jnp.where(alive, sp.q, 0.0)
    w = trilinear_weights(q, sp.dx, sp.dy, sp.dz, r8V)  # (n, 8)

    wn = w  # q-weights
    wm = w * mc_q
    vals = jnp.stack([
        vx, vy, vz, jnp.ones_like(vx),            # scaled by wn
    ], axis=-1)  # (n, 4)
    pvals = jnp.stack([
        ux, uy, uz, ke_mc,                        # px,py,pz,ke (scaled by wm)
        ux * vx, uy * vy, uz * vz, uy * vz, uz * vx, ux * vy,
    ], axis=-1)  # (n, 10)

    # (n, 8, 14) contributions
    contrib = jnp.concatenate([
        wn[:, :, None] * vals[:, None, :],
        wm[:, :, None] * pvals[:, None, :],
    ], axis=-1)
    idx = _node_indices(g, vox)
    return h.at[idx].add(contrib, mode="promise_in_bounds")


def sort_p(sp: SpeciesState) -> SpeciesState:
    """Sort particles by voxel (counting-sort analogue of sort_p.c:16-102,
    here a multi-operand ``lax.sort``) and compact zombies/free slots to the
    tail, refreshing ``np``.  Assumes mover state (mdx..., pc) is clear,
    which holds between steps (finish_boundary)."""
    big = jnp.int32(2 ** 30)
    key = jnp.where(sp.alive, sp.i, big)

    # The sort's cost grows with its payload columns, so carry only what
    # the species actually needs: tag is dropped when no tracer was ever
    # tagged (all-zero column is permutation-invariant), and q is
    # reconstructed from one scalar when the weight is uniform.
    cols = [sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz]
    if not sp.uniform_q:
        cols.append(sp.q)
    if sp.has_tags:
        cols.append(sp.tag)
    # unstable: intra-voxel lane order is physically meaningless (deposits
    # are linear sums)
    out = jax.lax.sort((key,) + tuple(cols), num_keys=1, is_stable=False)
    vox = out[0]
    dx, dy, dz, ux, uy, uz = out[1:7]
    rest = list(out[7:])
    q = sp.q if sp.uniform_q else rest.pop(0)
    tag = rest.pop(0) if sp.has_tags else sp.tag

    live = jnp.sum(sp.alive).astype(jnp.int32)
    in_range = jnp.arange(sp.max_np, dtype=jnp.int32) < live

    if sp.uniform_q:
        # any live lane's weight (exact; zombies may carry 0 or the same
        # uniform value, argmax |q| lands on a live lane whenever one exists)
        qv = sp.q[jnp.argmax(jnp.abs(sp.q))]
        q_out = jnp.where(in_range, qv, 0.0)
    else:
        q_out = jnp.where(in_range, q, 0.0)

    return sp.replace(
        np=live,
        dx=dx, dy=dy, dz=dz,
        i=jnp.where(in_range, vox, 0),
        ux=ux, uy=uy, uz=uz, q=q_out,
        tag=tag if not sp.has_tags else jnp.where(in_range, tag, 0),
    )
