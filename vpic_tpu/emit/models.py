"""Particle emission models (src/emitter/, 494 LoC).

An emitter owns a static list of surface components (packed cell+face like
the reference's ``e->component[n] = cell<<5 | face``, emitter.h:21-24) and
injects particles each step before user injection (advance.cxx:83-84).

Models:
- :class:`ChildLangmuir` (child-langmuir.c): space-charge-limited emission;
  per emitting face, m particles of charge
  qp = eps0 dA dt sqrt((32/81) |q_m| E^3 / dX) / m  when q_m*E_norm drives
  emission, placed randomly on the face with bi-Maxwellian momenta, rhob
  updated, and aged by a random fraction of the step.
- :class:`Ccube` / :class:`Ivory` (ccube.c, ivory.c): fixed-rate thermal
  surface emission variants; here expressed as ChildLangmuir subclasses
  overriding the per-face charge law.

Re-design: the component list is a fixed array; every step emits a
static K = n_components * n_emit_per_face block of slots (non-emitting
faces produce dead slots reclaimed by the per-step sort/compaction).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import FACE_AXIS, FACE_DIR, Grid, IP
from ..particles.aux import accumulate_rhob
from ..particles.push import PC_EXHAUSTED


def _cell_centers(g: Grid, origin=(0.0, 0.0, 0.0)):
    """(nz, ny, nx) meshgrids of owned-cell center positions (the
    _xc/_yc/_zc probes of deck_wrapper.cxx:346-463)."""
    xs = origin[0] + g.dx * (np.arange(1, g.nx + 1) - 0.5)
    ys = origin[1] + g.dy * (np.arange(1, g.ny + 1) - 0.5)
    zs = origin[2] + g.dz * (np.arange(1, g.nz + 1) - 0.5)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    return X, Y, Z


def _cell_vox(g: Grid):
    zi, yi, xi = np.meshgrid(np.arange(1, g.nz + 1), np.arange(1, g.ny + 1),
                             np.arange(1, g.nx + 1), indexing="ij")
    return (xi + g.nxg * (yi + g.nyg * zi)).astype(np.int32)


def region_surface_components(g: Grid, region_fn, origin=None):
    """Faces of EXTERIOR cells that touch the region — the
    define_surface_emitter component scan (deck_wrapper.cxx:390-463): a
    surface emitter emits into the exterior of ``region_fn(x,y,z)``.
    Returns (vox, face) int32 arrays."""
    if origin is None:
        origin = (g.gx0, g.gy0, g.gz0)
    X, Y, Z = _cell_centers(g, origin)
    inside = np.asarray(region_fn(X, Y, Z), bool)
    vox = _cell_vox(g)
    voxes, faces = [], []
    for face in range(6):
        ax, d = FACE_AXIS[face], FACE_DIR[face]
        # the reference probes the region AT the neighbor cell center
        # (_xl/_xh etc., deck_wrapper.cxx:396-417) — same here, so domain-
        # edge cells probe ghost positions naturally
        off = (d * g.dx if ax == 0 else 0.0,
               d * g.dy if ax == 1 else 0.0,
               d * g.dz if ax == 2 else 0.0)
        neigh = np.asarray(
            region_fn(X + off[0], Y + off[1], Z + off[2]), bool)
        sel = (~inside) & neigh
        voxes.append(vox[sel])
        faces.append(np.full(int(sel.sum()), face, np.int32))
    return (np.concatenate(voxes).astype(np.int32),
            np.concatenate(faces).astype(np.int32))


def region_volume_components(g: Grid, region_fn, origin=None):
    """Cells inside the region, as face-less components (face = -1) — the
    define_volume_emitter scan (deck_wrapper.cxx:346-383).  Face-emission
    models skip these exactly like the reference's non-face default
    branch; user models may emit from them."""
    if origin is None:
        origin = (g.gx0, g.gy0, g.gz0)
    X, Y, Z = _cell_centers(g, origin)
    inside = np.asarray(region_fn(X, Y, Z), bool)
    vox = _cell_vox(g)[inside]
    return vox.astype(np.int32), np.full(vox.shape[0], -1, np.int32)


def domain_face_components(g: Grid, face: int) -> np.ndarray:
    """All owned cells whose ``face`` lies on the local domain boundary —
    the common define_surface_emitter use (deck_wrapper.cxx:346-463)."""
    ax = FACE_AXIS[face]
    lo = FACE_DIR[face] < 0
    dims = (g.nx, g.ny, g.nz)
    fixed = 1 if lo else dims[ax]
    ranges = [np.arange(1, d + 1) for d in dims]
    ranges[ax] = np.array([fixed])
    X, Y, Z = np.meshgrid(*ranges, indexing="ij")
    vox = (X + g.nxg * (Y + g.nyg * Z)).reshape(-1)
    return vox.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ChildLangmuir:
    """Space-charge-limited surface emission (child-langmuir.c:49-51):
    per emitting face, m particles each of charge
    qp = eps0 dA dt sqrt(LAW_FACTOR |q_m E_n^3| / dX) / m.
    Subclasses change LAW_FACTOR and may gate on ``thresh_e_norm``
    (ccube.c:48-52, ivory.c:48-52)."""

    LAW_FACTOR = 32.0 / 81.0
    USE_THRESH = False

    sid: int                    # species index
    q_m: float
    components: tuple           # (vox tuple, face tuple) as static numpy
    n_emit_per_face: int = 1
    ut_para: float = 0.0
    ut_perp: float = 0.0
    thresh_e_norm: float = 0.0  # |E_n| emission threshold (ccube/ivory)

    def __call__(self, state, acc, f):
        g = self.grid
        vox = jnp.asarray(self.components[0])
        face = jnp.asarray(self.components[1])
        nc = vox.shape[0]
        m = self.n_emit_per_face
        K = nc * m

        rng, sub = jax.random.split(state.rng)
        state = dataclasses.replace(state, rng=rng)
        sp = state.species[self.sid]

        ip = state.interpolator[vox]
        axis = face % 3
        e_norm = jnp.where(axis == 0, ip[:, IP["ex"]],
                           jnp.where(axis == 1, ip[:, IP["ey"]],
                                     ip[:, IP["ez"]]))
        # emit if the normal E accelerates this species off the surface
        sign = jnp.where(face < 3, 1.0, -1.0)
        emits = (self.q_m * sign * e_norm) > 0
        # volume (face-less) components don't face-emit, exactly like the
        # reference's default switch branch (ccube.c:101)
        emits = emits & (face >= 0)
        if self.USE_THRESH:
            # m=0 when |E_n| < thresh_e_norm (ccube.c:48, ivory.c:48)
            emits = emits & (jnp.abs(e_norm)
                             >= jnp.float32(self.thresh_e_norm))
        qp = self._qp_vec(g, e_norm, axis)

        # expand per-component -> per-particle
        rep = lambda a: jnp.repeat(a, m, total_repeat_length=K)
        vox_p, face_p, axis_p = rep(vox), rep(face), rep(axis)
        emits_p, qp_p = rep(emits), rep(qp)
        sign_p = jnp.where(face_p < 3, 1.0, -1.0)

        ks = jax.random.split(sub, 6)
        t1 = jax.random.uniform(ks[0], (K,), jnp.float32, -1.0, 1.0)
        t2 = jax.random.uniform(ks[1], (K,), jnp.float32, -1.0, 1.0)
        upar = sign_p * jnp.abs(
            self.ut_para * jax.random.normal(ks[2], (K,), jnp.float32))
        up1 = self.ut_perp * jax.random.normal(ks[3], (K,), jnp.float32)
        up2 = self.ut_perp * jax.random.normal(ks[4], (K,), jnp.float32)
        age = jax.random.uniform(ks[5], (K,), jnp.float32)

        # map (normal, t1, t2) onto (x, y, z) by the face's cyclic frame
        def pick(a, b, c):
            return jnp.where(axis_p == 0, a,
                             jnp.where(axis_p == 1, b, c))

        posn = -sign_p  # on the emitting face
        dx = pick(posn, t2, t1)
        dy = pick(t1, posn, t2)
        dz = pick(t2, t1, posn)
        ux = pick(upar, up2, up1)
        uy = pick(up1, upar, up2)
        uz = pick(up2, up1, upar)

        # slot allocation: the K-block is claimed statically; slots whose
        # face didn't emit this step become zombies (i = -1, q = 0)
        # reclaimed by the next sort/compaction
        slot = sp.np + jnp.arange(K, dtype=jnp.int32)
        ok = emits_p & (slot < sp.max_np)
        tgt = jnp.where(slot < sp.max_np, slot, sp.max_np)
        q_new = jnp.where(ok, qp_p, 0.0)
        vox_w = jnp.where(ok, vox_p, -1)

        # rhob: emitted charge leaves the surface (deposit -qp)
        f = accumulate_rhob(f, g, vox_p, -qp_p, dx, dy, dz, ok)

        gamma = jnp.sqrt(ux * ux + uy * uy + uz * uz + 1.0)
        aging = age * g.cvac * g.dt / gamma

        def put(arr, vals):
            return arr.at[tgt].set(vals, mode="drop")

        sp = sp.replace(
            dx=put(sp.dx, dx), dy=put(sp.dy, dy), dz=put(sp.dz, dz),
            i=put(sp.i, vox_w),
            ux=put(sp.ux, ux), uy=put(sp.uy, uy), uz=put(sp.uz, uz),
            q=put(sp.q, q_new),
            mdx=put(sp.mdx, ux * aging * g.rdx),
            mdy=put(sp.mdy, uy * aging * g.rdy),
            mdz=put(sp.mdz, uz * aging * g.rdz),
            pc=put(sp.pc, jnp.where(ok, PC_EXHAUSTED, 0)),
            # claim slots only up to the highest emitted one, so fully
            # gated steps (thresh/field direction) don't grow np at all
            np=jnp.minimum(
                sp.np + jnp.max(jnp.where(
                    ok, jnp.arange(1, K + 1, dtype=jnp.int32), 0)),
                sp.max_np),
        )
        species = list(state.species)
        species[self.sid] = sp
        state = dataclasses.replace(state, species=tuple(species))
        return state, acc, f

    def _qp_vec(self, g: Grid, e_norm, axis):
        d = jnp.asarray([g.dx, g.dy, g.dz], jnp.float32)
        dA = d[(axis + 1) % 3] * d[(axis + 2) % 3]
        qp = (g.eps0 * dA * g.dt
              * jnp.sqrt(jnp.float32(self.LAW_FACTOR)
                         * jnp.abs(self.q_m * e_norm ** 3) / d[axis])
              / self.n_emit_per_face)
        return jnp.where(self.q_m < 0, -qp, qp)

    def bind(self, g: Grid):
        object.__setattr__(self, "grid", g)
        return self


@dataclasses.dataclass(frozen=True)
class Ccube(ChildLangmuir):
    """ccube law (ccube.c:50-52): the Child-Langmuir charge law WITHOUT
    the (32/81) factor — qp = eps0 dA dt sqrt(|q_m E_n^3|/dX)/m — gated
    on |E_n| >= thresh_e_norm (ccube.c:48).  (The reference notes this is
    the ivory model without the sqrt(1/6); true magnetic-insulation
    treatment is a FIXME upstream too, ccube.c:3-4.)"""

    LAW_FACTOR = 1.0
    USE_THRESH = True


@dataclasses.dataclass(frozen=True)
class Ivory(ChildLangmuir):
    """ivory law (ivory.c:50-52): Child-Langmuir-proportional with the
    sqrt(1/6) factor — qp = eps0 dA dt sqrt((1/6)|q_m E_n^3|/dX)/m —
    gated on |E_n| >= thresh_e_norm (ivory.c:48)."""

    LAW_FACTOR = 1.0 / 6.0
    USE_THRESH = True
