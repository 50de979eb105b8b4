"""Ghost fills and local boundary-condition adjusts for the Yee mesh.

Faithful JAX re-implementation of:
- src/field_advance/standard/local.c:50-445 (local ghosts + adjusts)
- src/field_advance/standard/remote.c:61-297 (inter-domain ghost exchange)

The begin/end split of the reference (compute/comm overlap) is left to XLA's
async collective scheduling: exchanges are expressed as pure data flow and the
compiler overlaps them with independent stencil work.

Uniform cell spacing per axis is assumed (partition_periodic_box-style
domains), so the reference's mismatched-cell-size interpolation weights
(remote.c:105-117) reduce to a straight copy.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.types import (
    ABSORB_FIELDS,
    ANTI_SYMMETRIC_FIELDS,
    FACE_AXIS,
    FACE_DIR,
    FieldState,
    Grid,
    PERIODIC_FIELDS,
    PMC_FIELDS,
    REMOTE_FIELDS,
    SYMMETRIC_FIELDS,
)
from .slabs import own_slice

# cyclic transverse axes for a face axis: x->(y,z), y->(z,x), z->(x,y)
CYC = ((1, 2), (2, 0), (0, 1))
_E = ("ex", "ey", "ez")
_CB = ("cbx", "cby", "cbz")
_TCA = ("tcax", "tcay", "tcaz")
_JF = ("jfx", "jfy", "jfz")


def _kp(g: Grid, arr, kind: str, axis: int, idx: int, shift=(0, 0, 0)):
    """Plane ``axis == idx + shift[axis]`` of ``arr`` restricted to `kind`'s
    transverse ownership ranges (shifted)."""
    ix = [None, None, None]
    for a in range(3):
        if a == axis:
            ix[a] = idx + shift[a]
        else:
            s = own_slice(g, kind, a)
            ix[a] = slice(s.start + shift[a], s.stop + shift[a])
    return arr[(ix[2], ix[1], ix[0])]


def _kp_ix(g: Grid, kind: str, axis: int, idx: int):
    ix = [None, None, None]
    for a in range(3):
        ix[a] = idx if a == axis else own_slice(g, kind, a)
    return (ix[2], ix[1], ix[0])


def _nax(g: Grid, axis: int) -> int:
    return (g.nx, g.ny, g.nz)[axis]


def _rd(g: Grid, axis: int) -> float:
    return (g.rdx, g.rdy, g.rdz)[axis]


def _face_geom(g: Grid, face: int):
    """(axis X, transverse (Y,Z), lo?, ghost idx, mirror idx, face idx)."""
    X = FACE_AXIS[face]
    lo = FACE_DIR[face] < 0
    n = _nax(g, X)
    gi = 0 if lo else n + 1
    mi = 1 if lo else n
    fi = 1 if lo else n + 1
    return X, CYC[X], lo, gi, mi, fi


def _local_bc(g: Grid, face: int) -> int:
    return g.fbc[face]


def _blend(comm, g: Grid, face: int, local_val, recv_val):
    """Pick between the locally-computed BC plane and the received plane.

    recv_val None -> pure local face.  On multishard non-periodic axes every
    shard computes both and boundary shards select the local value."""
    if recv_val is None:
        return local_val
    if local_val is None:
        return recv_val
    mask = comm.is_global_boundary(face) if hasattr(comm, "is_global_boundary") else False
    if mask is False:
        return recv_val
    return jnp.where(mask, local_val, recv_val)


def _apply_local_mask(comm, g: Grid, face: int, orig, adjusted):
    """For local adjusts: apply `adjusted` only where the face really is a
    local (global-boundary) face."""
    if hasattr(comm, "is_global_boundary"):
        if comm.joined(face) and g.fbc[face] == PERIODIC_FIELDS:
            return None
        mask = comm.is_global_boundary(face)
        if mask is True:
            return adjusted
        if mask is False:
            return None
        return jnp.where(mask, adjusted, orig)
    # LocalComm: joined == periodic -> no local adjust
    if comm.joined(face):
        return None
    return adjusted


# ---------------------------------------------------------------------------
# Ghost fills
# ---------------------------------------------------------------------------


def ghost_tang_b(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill tangential cB ghosts on every face (local.c:50-122 +
    remote.c:61-134)."""
    payloads = {}
    for face in range(6):
        X, (Y, Z), lo, gi, mi, fi = _face_geom(g, face)
        payloads[face] = (
            _kp(g, getattr(f, _CB[Y]), "face_" + "xyz"[Y], X, mi),
            _kp(g, getattr(f, _CB[Z]), "face_" + "xyz"[Z], X, mi),
        )
    recv = comm.exchange(payloads)

    out = {c: getattr(f, c) for c in _CB}
    for face in range(6):
        X, (Y, Z), lo, gi, mi, fi = _face_geom(g, face)
        sgn = 1.0 if lo else -1.0
        bc = _local_bc(g, face)
        shift = [0, 0, 0]

        for T, other in ((Y, Z), (Z, Y)):
            kind = "face_" + "xyz"[T]
            cb = out[_CB[T]]
            mirror = _kp(g, cb, kind, X, mi)
            local_val = None
            if bc in (ANTI_SYMMETRIC_FIELDS,):
                local_val = mirror
            elif bc in (SYMMETRIC_FIELDS, PMC_FIELDS):
                local_val = -mirror
            elif bc == ABSORB_FIELDS:
                # 2nd-order 1st-order Higdon ABC w/ 15 degree cone
                # (local.c:61-107)
                higend = 1.03527618 if (g.nx > 1 or g.ny > 1 or g.nz > 1) else 1.0
                cdt = g.cvac * g.dt
                drv = cdt * _rd(g, X) * higend
                decay = (1.0 - drv) / (1.0 + drv)
                drive = 2.0 * drv / (1.0 + drv)
                eT = getattr(f, _E[other])   # tangential E (the "e##Z" / "e##Y")
                eX = getattr(f, _E[X])       # normal E on the face-side plane
                d = -1 if lo else 1
                t1 = (cdt * _rd(g, X)) * (
                    _kp(g, eT, kind, X, fi - d) - _kp(g, eT, kind, X, fi)
                ) * sgn
                sh = [0, 0, 0]
                sh[other] = 1
                t2 = (cdt * _rd(g, other)) * (
                    _kp(g, eX, kind, X, mi, tuple(sh)) - _kp(g, eX, kind, X, mi)
                )
                ghost_old = _kp(g, cb, kind, X, gi)
                if T == Y:
                    local_val = decay * ghost_old + drive * mirror - t1 + t2
                else:
                    local_val = decay * ghost_old + drive * mirror + t1 - t2
            elif bc == PERIODIC_FIELDS:
                local_val = None  # handled by exchange
            else:
                raise ValueError(f"bad field bc {bc} on face {face}")

            rv = recv[face][0 if T == Y else 1] if recv[face] is not None else None
            val = _blend(comm, g, face, local_val, rv)
            if val is not None:
                out[_CB[T]] = out[_CB[T]].at[_kp_ix(g, kind, X, gi)].set(val)

    return f.replace(**out)


def ghost_norm_e(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill normal-E ghosts (local.c:128-179 + remote.c:136-206).  Local BCs
    also fill the tca ghost like the reference; the remote path exchanges E
    only."""
    payloads = {}
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        payloads[face] = _kp(g, getattr(f, _E[X]), "edge_" + "xyz"[X], X, mi)
    recv = comm.exchange(payloads)

    out = {c: getattr(f, c) for c in _E + _TCA}
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        kind = "edge_" + "xyz"[X]
        bc = _local_bc(g, face)
        e, tca = out[_E[X]], out[_TCA[X]]
        e_m, tca_m = _kp(g, e, kind, X, mi), _kp(g, tca, kind, X, mi)
        local_e = local_tca = None
        if bc == ANTI_SYMMETRIC_FIELDS:
            local_e, local_tca = e_m, tca_m
        elif bc in (SYMMETRIC_FIELDS, PMC_FIELDS):
            local_e, local_tca = -e_m, -tca_m
        elif bc == ABSORB_FIELDS:
            d = -1 if lo else 1
            mi2 = gi - 2 * d
            local_e = 2.0 * e_m - _kp(g, e, kind, X, mi2)
            local_tca = 2.0 * tca_m - _kp(g, tca, kind, X, mi2)
        elif bc == PERIODIC_FIELDS:
            pass
        else:
            raise ValueError(f"bad field bc {bc} on face {face}")

        val = _blend(comm, g, face, local_e, recv[face])
        if val is not None:
            out[_E[X]] = out[_E[X]].at[_kp_ix(g, kind, X, gi)].set(val)
        if local_tca is not None:
            # the remote path exchanges E only (remote.c:136-206); on
            # blended (multishard, non-periodic) faces keep the original
            # tca ghost where the face is interior
            gix = _kp_ix(g, kind, X, gi)
            sel = _apply_local_mask(comm, g, face, out[_TCA[X]][gix], local_tca)
            if sel is not None:
                out[_TCA[X]] = out[_TCA[X]].at[gix].set(sel)

    return f.replace(**out)


def ghost_div_b(f: FieldState, g: Grid, comm) -> FieldState:
    """Fill div_b_err ghosts (local.c:182-215 + remote.c:208-279)."""
    payloads = {}
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        payloads[face] = _kp(g, f.div_b_err, "cell", X, mi)
    recv = comm.exchange(payloads)

    dbe = f.div_b_err
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        bc = _local_bc(g, face)
        mirror = _kp(g, dbe, "cell", X, mi)
        local_val = None
        if bc == ANTI_SYMMETRIC_FIELDS:
            local_val = mirror
        elif bc in (SYMMETRIC_FIELDS, PMC_FIELDS):
            local_val = -mirror
        elif bc == ABSORB_FIELDS:
            local_val = jnp.zeros_like(mirror)
        elif bc == PERIODIC_FIELDS:
            pass
        else:
            raise ValueError(f"bad field bc {bc} on face {face}")
        val = _blend(comm, g, face, local_val, recv[face])
        if val is not None:
            dbe = dbe.at[_kp_ix(g, "cell", X, gi)].set(val)
    return f.replace(div_b_err=dbe)


# ---------------------------------------------------------------------------
# Local adjusts (local.c:224-444)
# ---------------------------------------------------------------------------


def _adjust(comm, g, face, arr, kind, X, fi, new_plane_fn):
    ix = _kp_ix(g, kind, X, fi)
    orig = arr[ix]
    adjusted = new_plane_fn(orig)
    sel = _apply_local_mask(comm, g, face, orig, adjusted)
    if sel is None:
        return arr
    return arr.at[ix].set(sel)


def adjust_tang_e(f: FieldState, g: Grid, comm) -> FieldState:
    out = {c: getattr(f, c) for c in _E + _TCA}
    for face in range(6):
        X, (Y, Z), lo, gi, mi, fi = _face_geom(g, face)
        bc = _local_bc(g, face)
        if bc != ANTI_SYMMETRIC_FIELDS:
            continue
        for T in (Y, Z):
            kind = "edge_" + "xyz"[T]
            for c in (_E[T], _TCA[T]):
                out[c] = _adjust(comm, g, face, out[c], kind, X, fi,
                                 lambda p: jnp.zeros_like(p))
    return f.replace(**out)


def adjust_norm_b(f: FieldState, g: Grid, comm) -> FieldState:
    out = {c: getattr(f, c) for c in _CB}
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        if _local_bc(g, face) != SYMMETRIC_FIELDS:
            continue
        kind = "face_" + "xyz"[X]
        out[_CB[X]] = _adjust(comm, g, face, out[_CB[X]], kind, X, fi,
                              lambda p: jnp.zeros_like(p))
    return f.replace(**out)


def adjust_div_e_err(f: FieldState, g: Grid, comm) -> FieldState:
    dee = f.div_e_err
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        if _local_bc(g, face) not in (ANTI_SYMMETRIC_FIELDS, ABSORB_FIELDS):
            continue
        dee = _adjust(comm, g, face, dee, "node", X, fi,
                      lambda p: jnp.zeros_like(p))
    return f.replace(div_e_err=dee)


def adjust_jf(f: FieldState, g: Grid, comm) -> FieldState:
    out = {c: getattr(f, c) for c in _JF}
    for face in range(6):
        X, (Y, Z), lo, gi, mi, fi = _face_geom(g, face)
        bc = _local_bc(g, face)
        if bc == PERIODIC_FIELDS:
            continue
        if bc == ANTI_SYMMETRIC_FIELDS:
            fn = lambda p: jnp.zeros_like(p)
        elif bc in (SYMMETRIC_FIELDS, PMC_FIELDS, ABSORB_FIELDS):
            fn = lambda p: 2.0 * p
        else:
            raise ValueError(f"bad field bc {bc}")
        for T in (Y, Z):
            kind = "edge_" + "xyz"[T]
            out[_JF[T]] = _adjust(comm, g, face, out[_JF[T]], kind, X, fi, fn)
    return f.replace(**out)


def adjust_rhof(f: FieldState, g: Grid, comm) -> FieldState:
    rhof = f.rhof
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        bc = _local_bc(g, face)
        if bc == PERIODIC_FIELDS:
            continue
        if bc == ANTI_SYMMETRIC_FIELDS:
            fn = lambda p: jnp.zeros_like(p)
        else:
            fn = lambda p: 2.0 * p
        rhof = _adjust(comm, g, face, rhof, "node", X, fi, fn)
    return f.replace(rhof=rhof)


def adjust_rhob(f: FieldState, g: Grid, comm) -> FieldState:
    rhob = f.rhob
    for face in range(6):
        X, _, lo, gi, mi, fi = _face_geom(g, face)
        bc = _local_bc(g, face)
        if bc != ANTI_SYMMETRIC_FIELDS:
            continue
        rhob = _adjust(comm, g, face, rhob, "node", X, fi,
                       lambda p: jnp.zeros_like(p))
    return f.replace(rhob=rhob)
