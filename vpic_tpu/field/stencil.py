"""Yee-mesh FDTD field solver kernels.

Faithful JAX re-implementations (as fused XLA slab stencils over the whole
owned region at once — the reference's interior/exterior pipeline split,
advance_e.c:110-330, existed only for comm overlap, which XLA's scheduler
now provides) of:

- advance_b            (standard/advance_b.c:12-161)
- advance_e            (standard/advance_e.c:8-330, exp-differenced Ampere
                        with TCA radiation damping)
- compute_curl_b       (standard/compute_curl_b.c:8-18)
- compute_div_e_err    (standard/compute_div_e_err.c:7-12)
- compute_rms_div_e_err(standard/compute_rms_div_e_err.c; boundary nodes
                        weighted 1/2 per boundary plane)
- clean_div_e          (standard/clean_div_e.c:6-14, modified Marder)
- compute_div_b_err / compute_rms_div_b_err / clean_div_b
                       (standard/{compute_div_b_err,compute_rms_div_b_err,
                        clean_div_b}.c)
- compute_rhob         (standard/compute_rhob.c:8-12)
- energy_f             (standard/energy_f.c:50-77)

Material coefficients: when ``matg`` is None the single-material fast path is
used (scalar coefficients from table row 0 — the reference's vacuum variant,
standard/vacuum/vfa.c); otherwise coefficients are gathered through per-voxel
material ids.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.types import FieldState, Grid, MaterialGrid, MaterialTable
from . import ghost
from .slabs import own_slice, shifted


def _p(g: Grid, axis: int, scale: float):
    n = (g.nx * g.gpx, g.ny * g.gpy, g.nz * g.gpz)[axis]
    rd = (g.rdx, g.rdy, g.rdz)[axis]
    return scale * rd if n > 1 else 0.0


def _ix(g: Grid, kind: str):
    return tuple(own_slice(g, kind, a) for a in (2, 1, 0))


def _coef(mat: MaterialTable, matg, name: str, g: Grid, kind: str,
          id_field: str, dx=0, dy=0, dz=0):
    """Material coefficient sampled over `kind`'s owned block (shifted).
    Single-material: scalar.  Multi-material: gather via the id grid."""
    table = getattr(mat, name)
    if matg is None:
        return table[0]
    ids = shifted(g, getattr(matg, id_field), kind, dx, dy, dz)
    return table[ids]


# ---------------------------------------------------------------------------
# advance_b — Faraday half step: cB -= frac*c*dt * curl E
# ---------------------------------------------------------------------------


def advance_b(f: FieldState, g: Grid, frac: float) -> FieldState:
    px = _p(g, 0, frac * g.cvac * g.dt)
    py = _p(g, 1, frac * g.cvac * g.dt)
    pz = _p(g, 2, frac * g.cvac * g.dt)

    def curl(kind, e_a, e_b, p_a, p_b, da, db):
        # p_a*( e_b(shift da) - e_b ) - p_b*( e_a(shift db) - e_a )
        return (
            p_a * (shifted(g, e_b, kind, **da) - shifted(g, e_b, kind))
            - p_b * (shifted(g, e_a, kind, **db) - shifted(g, e_a, kind))
        )

    dbx = curl("face_x", f.ey, f.ez, py, pz, dict(dy=1), dict(dz=1))
    dby = curl("face_y", f.ez, f.ex, pz, px, dict(dz=1), dict(dx=1))
    dbz = curl("face_z", f.ex, f.ey, px, py, dict(dx=1), dict(dy=1))

    return f.replace(
        cbx=f.cbx.at[_ix(g, "face_x")].add(-dbx),
        cby=f.cby.at[_ix(g, "face_y")].add(-dby),
        cbz=f.cbz.at[_ix(g, "face_z")].add(-dbz),
    )


# ---------------------------------------------------------------------------
# curl(cB/mu) over the E edges (shared by advance_e and compute_curl_b)
# ---------------------------------------------------------------------------


def _rmu_curl_b(f: FieldState, g: Grid, mat: MaterialTable,
                matg, scale: float):
    """For each E component, p_a*d_a(cB_b*rmu_b) - p_b*d_b(cB_a*rmu_a) with
    backward differences (reads the tang-B ghost planes)."""
    px, py, pz = (_p(g, a, scale) for a in range(3))

    def term(kind, cb_name, rmu, id_field, p, axis):
        cb = getattr(f, cb_name)
        d = {("dx", "dy", "dz")[axis]: -1}
        here = shifted(g, cb, kind) * _coef(mat, matg, rmu, g, kind, id_field)
        there = shifted(g, cb, kind, **d) * _coef(
            mat, matg, rmu, g, kind, id_field, **d)
        return p * (here - there)

    tcax = (term("edge_x", "cbz", "rmuz", "fmatz", py, 1)
            - term("edge_x", "cby", "rmuy", "fmaty", pz, 2))
    tcay = (term("edge_y", "cbx", "rmux", "fmatx", pz, 2)
            - term("edge_y", "cbz", "rmuz", "fmatz", px, 0))
    tcaz = (term("edge_z", "cby", "rmuy", "fmaty", px, 0)
            - term("edge_z", "cbx", "rmux", "fmatx", py, 1))
    return tcax, tcay, tcaz


def compute_curl_b(f: FieldState, g: Grid, mat: MaterialTable,
                   matg, comm) -> FieldState:
    """Initialize tca = c*dt*curl(cB/mu) (compute_curl_b.c:8-18)."""
    f = ghost.ghost_tang_b(f, g, comm)
    tcax, tcay, tcaz = _rmu_curl_b(f, g, mat, matg, g.cvac * g.dt)
    f = f.replace(
        tcax=f.tcax.at[_ix(g, "edge_x")].set(tcax),
        tcay=f.tcay.at[_ix(g, "edge_y")].set(tcay),
        tcaz=f.tcaz.at[_ix(g, "edge_z")].set(tcaz),
    )
    return ghost.adjust_tang_e(f, g, comm)


def advance_e(f: FieldState, g: Grid, mat: MaterialTable,
              matg, comm) -> FieldState:
    """Exponentially differenced Ampere with TCA radiation damping
    (advance_e.c:8-25):
      tca = (1+damp)*c*dt*curl(cB/mu) - damp*tca
      e   = decay*e + drive*(tca - dt/eps0 * jf)
    """
    f = ghost.ghost_tang_b(f, g, comm)
    damp = g.damp
    cj = g.dt / g.eps0
    cx, cy, cz = _rmu_curl_b(f, g, mat, matg, (1.0 + damp) * g.cvac * g.dt)

    out = {}
    for comp, curl in (("x", cx), ("y", cy), ("z", cz)):
        kind = "edge_" + comp
        ix = _ix(g, kind)
        e = getattr(f, "e" + comp)
        tca_old = getattr(f, "tca" + comp)[ix]
        jf = getattr(f, "jf" + comp)[ix]
        decay = _coef(mat, matg, "decay" + comp, g, kind, "emat" + comp)
        drive = _coef(mat, matg, "drive" + comp, g, kind, "emat" + comp)
        tca = curl - damp * tca_old
        e_new = decay * e[ix] + drive * (tca - cj * jf)
        out["tca" + comp] = getattr(f, "tca" + comp).at[ix].set(tca)
        out["e" + comp] = e.at[ix].set(e_new)

    f = f.replace(**out)
    return ghost.adjust_tang_e(f, g, comm)


# ---------------------------------------------------------------------------
# Divergence diagnostics / Marder cleaning
# ---------------------------------------------------------------------------


def compute_div_e_err(f: FieldState, g: Grid, mat: MaterialTable,
                      matg, comm) -> FieldState:
    """div_e_err = nonconductive*( div(eps*E) - (rhof+rhob)/eps0 ) on nodes
    (compute_div_e_err.c:7-12)."""
    f = ghost.ghost_norm_e(f, g, comm)
    px, py, pz = (_p(g, a, 1.0) for a in range(3))
    cj = 1.0 / g.eps0
    kind = "node"

    def dterm(e_name, eps, id_field, p, axis):
        e = getattr(f, e_name)
        d = {("dx", "dy", "dz")[axis]: -1}
        here = shifted(g, e, kind) * _coef(mat, matg, eps, g, kind, id_field)
        there = shifted(g, e, kind, **d) * _coef(
            mat, matg, eps, g, kind, id_field, **d)
        return p * (here - there)

    nonc = _coef(mat, matg, "nonconductive", g, kind, "nmat")
    ix = _ix(g, kind)
    err = nonc * (
        dterm("ex", "epsx", "ematx", px, 0)
        + dterm("ey", "epsy", "ematy", py, 1)
        + dterm("ez", "epsz", "ematz", pz, 2)
        - cj * (f.rhof[ix] + f.rhob[ix])
    )
    f = f.replace(div_e_err=f.div_e_err.at[ix].set(err))
    return ghost.adjust_div_e_err(f, g, comm)


def local_rms_div_e_err(f: FieldState, g: Grid):
    """Local (sum, volume) pair; boundary node planes weighted by 1/2 each
    (compute_rms_div_e_err.c host loops).  Caller psums across shards and
    finishes with eps0*sqrt(sum/volume)."""
    e = f.div_e_err[_ix(g, "node")].astype(jnp.float64)

    def w(n):
        v = jnp.ones((n + 1,), dtype=jnp.float64)
        return v.at[0].set(0.5).at[-1].set(0.5)

    wt = (w(g.nz)[:, None, None] * w(g.ny)[None, :, None]
          * w(g.nx)[None, None, :])
    err = jnp.sum(wt * e * e)
    vol = g.nx * g.ny * g.nz * g.dx * g.dy * g.dz
    return err * g.dx * g.dy * g.dz, jnp.float64(vol)


def finish_rms(g: Grid, global_err, global_vol):
    return g.eps0 * jnp.sqrt(global_err / global_vol)


def _marder_coeff(g: Grid):
    px, py, pz = (_p(g, a, 1.0) for a in range(3))
    alphadt = 0.3888889 / (px * px + py * py + pz * pz)
    return alphadt * px, alphadt * py, alphadt * pz


def clean_div_e(f: FieldState, g: Grid, mat: MaterialTable,
                matg) -> FieldState:
    """Modified Marder pass: e += drive*alphadt*grad(div_e_err)
    (clean_div_e.c:6-14).  Forward differences read owned div_e_err only."""
    px, py, pz = _marder_coeff(g)
    out = {}
    for comp, p, axis in (("x", px, 0), ("y", py, 1), ("z", pz, 2)):
        kind = "edge_" + comp
        d = {("dx", "dy", "dz")[axis]: 1}
        grad = shifted(g, f.div_e_err, kind, **d) - shifted(g, f.div_e_err, kind)
        drive = _coef(mat, matg, "drive" + comp, g, kind, "emat" + comp)
        ix = _ix(g, kind)
        e = getattr(f, "e" + comp)
        out["e" + comp] = e.at[ix].add(drive * p * grad)
    return f.replace(**out)


def compute_div_b_err(f: FieldState, g: Grid) -> FieldState:
    """div_b_err = div cB on cells (compute_div_b_err.c:44-48)."""
    px, py, pz = (_p(g, a, 1.0) for a in range(3))
    kind = "cell"
    err = (
        px * (shifted(g, f.cbx, kind, dx=1) - shifted(g, f.cbx, kind))
        + py * (shifted(g, f.cby, kind, dy=1) - shifted(g, f.cby, kind))
        + pz * (shifted(g, f.cbz, kind, dz=1) - shifted(g, f.cbz, kind))
    )
    return f.replace(div_b_err=f.div_b_err.at[_ix(g, kind)].set(err))


def local_rms_div_b_err(f: FieldState, g: Grid):
    e = f.div_b_err[_ix(g, "cell")].astype(jnp.float64)
    err = jnp.sum(e * e)
    vol = g.nx * g.ny * g.nz * g.dx * g.dy * g.dz
    return err * g.dx * g.dy * g.dz, jnp.float64(vol)


def clean_div_b(f: FieldState, g: Grid, comm) -> FieldState:
    """Marder pass cb += alphadt*grad(div_b_err) (clean_div_b.c:6-50);
    backward differences read the div_b ghost planes."""
    f = ghost.ghost_div_b(f, g, comm)
    px, py, pz = _marder_coeff(g)
    out = {}
    for comp, p, axis in (("x", px, 0), ("y", py, 1), ("z", pz, 2)):
        kind = "face_" + comp
        d = {("dx", "dy", "dz")[axis]: -1}
        grad = shifted(g, f.div_b_err, kind) - shifted(g, f.div_b_err, kind, **d)
        ix = _ix(g, kind)
        cb = getattr(f, "cb" + comp)
        out["cb" + comp] = cb.at[ix].add(p * grad)
    return f.replace(**out)


def compute_rhob(f: FieldState, g: Grid, mat: MaterialTable,
                 matg, comm) -> FieldState:
    """rhob = nonconductive*( eps0*div(eps*E) - rhof ) (compute_rhob.c:8-12).
    Requires rhof freshly accumulated+synchronized."""
    f = ghost.ghost_norm_e(f, g, comm)
    px, py, pz = (_p(g, a, g.eps0) for a in range(3))
    kind = "node"

    def dterm(e_name, eps, id_field, p, axis):
        e = getattr(f, e_name)
        d = {("dx", "dy", "dz")[axis]: -1}
        here = shifted(g, e, kind) * _coef(mat, matg, eps, g, kind, id_field)
        there = shifted(g, e, kind, **d) * _coef(
            mat, matg, eps, g, kind, id_field, **d)
        return p * (here - there)

    nonc = _coef(mat, matg, "nonconductive", g, kind, "nmat")
    ix = _ix(g, kind)
    rhob = nonc * (
        dterm("ex", "epsx", "ematx", px, 0)
        + dterm("ey", "epsy", "ematy", py, 1)
        + dterm("ez", "epsz", "ematz", pz, 2)
        - f.rhof[ix]
    )
    f = f.replace(rhob=f.rhob.at[ix].set(rhob))
    return ghost.adjust_rhob(f, g, comm)


# ---------------------------------------------------------------------------
# Field energies
# ---------------------------------------------------------------------------


def local_energy_f(f: FieldState, g: Grid, mat: MaterialTable, matg):
    """Per-component field energies, stencil-averaged to cell centers with
    material weighting (energy_f.c:50-77).  Returns local (6,) float64;
    caller psums and scales by 0.5*eps0*dV (energy_f.c epilogue)."""
    kind = "cell"

    def esum(e_name, eps, id_field, sh1, sh2, sh3):
        e = getattr(f, e_name)
        total = 0.0
        for sh in ((), sh1, sh2, sh3):
            d = dict(sh)
            v = shifted(g, e, kind, **d)
            c = _coef(mat, matg, eps, g, kind, id_field, **d)
            total = total + jnp.sum((c * v * v).astype(jnp.float64))
        return 0.25 * total

    def bsum(b_name, rmu, id_field, sh1):
        b = getattr(f, b_name)
        total = 0.0
        for sh in ((), sh1):
            d = dict(sh)
            v = shifted(g, b, kind, **d)
            c = _coef(mat, matg, rmu, g, kind, id_field, **d)
            total = total + jnp.sum((c * v * v).astype(jnp.float64))
        return 0.5 * total

    en = jnp.stack([
        esum("ex", "epsx", "ematx",
             (("dy", 1),), (("dz", 1),), (("dy", 1), ("dz", 1))),
        esum("ey", "epsy", "ematy",
             (("dz", 1),), (("dx", 1),), (("dz", 1), ("dx", 1))),
        esum("ez", "epsz", "ematz",
             (("dx", 1),), (("dy", 1),), (("dx", 1), ("dy", 1))),
        bsum("cbx", "rmux", "fmatx", (("dx", 1),)),
        bsum("cby", "rmuy", "fmaty", (("dy", 1),)),
        bsum("cbz", "rmuz", "fmatz", (("dz", 1),)),
    ])
    return en


def finish_energy_f(g: Grid, global_en):
    v0 = 0.5 * g.eps0 * g.dx * g.dy * g.dz
    return v0 * global_en
