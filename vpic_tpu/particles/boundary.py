"""Guard-list processing: absorption, custom handlers, inter-shard particle
migration, and continuation of unfinished streak walks.

Re-design of ``boundary_p`` (src/species_advance/standard/boundary_p.c:
77-505): instead of variable-length mover/injector lists, each species
carries per-particle boundary codes (``pc``); each comm round compacts ALL
pending particles into one fixed-capacity buffer (the particle_injector_t
analogue, species_advance.h:48-55), resolves absorption / packs per-face
migration payloads / re-runs the streak walker on that buffer only, then
scatters results back.  Mirrors ``num_comm_round`` (vpic.cxx:17, default 3).

Everything here is O(max_np) only for the one mask/compaction pass; all
physics work is O(max_inj), so rounds with nothing pending cost almost
nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import (
    FieldState,
    Grid,
    NEIGHBOR_ABSORB,
    NEIGHBOR_MIGRATE_BASE,
    SpeciesState,
)
from .aux import accumulate_rhob
from .push import (PC_EXHAUSTED, WalkState, streak_walk,
                   compact_indices as _compact_indices)


def _remap_voxel_through_face(g: Grid, vox, face: int):
    """Destination-shard voxel for a particle that left through ``face``:
    same transverse cell coordinates, axis coordinate snapped to the
    entering edge (every shard has identical local dims)."""
    j = vox // g.nxg
    x = vox - j * g.nxg
    z = j // g.nyg
    y = j - z * g.nyg
    axis = face % 3
    n = (g.nx, g.ny, g.nz)[axis]
    # leaving through a high face -> enter at low edge cell (1); low -> n
    new_c = 1 if face >= 3 else n
    coords = [x, y, z]
    coords[axis] = jnp.full_like(coords[axis], new_c)
    return coords[0] + g.nxg * (coords[1] + g.nyg * coords[2])


def process_boundary(sp: SpeciesState, f: FieldState, acc, neighbor,
                     g: Grid, pcomm, max_inj: int, n_walk: int = 4,
                     handlers=(), bstate=(), key=None, step=None,
                     mig_cap: int | None = None):
    """One boundary round for one species.
    Returns (sp, f, acc, bstate)."""
    max_np = sp.max_np
    max_inj = min(max_inj, max_np)

    # ---- compact every pending particle into one buffer ----
    pending = sp.alive & (sp.pc != 0)
    sel, n_pend, valid = _compact_indices(pending, max_inj, max_np)
    safe = jnp.where(valid, sel, 0)

    b = dict(
        dx=sp.dx[safe], dy=sp.dy[safe], dz=sp.dz[safe],
        vox=sp.i[safe],
        ux=sp.ux[safe], uy=sp.uy[safe], uz=sp.uz[safe],
        q=jnp.where(valid, sp.q[safe], 0.0),
        mdx=sp.mdx[safe], mdy=sp.mdy[safe], mdz=sp.mdz[safe],
        pc=jnp.where(valid, sp.pc[safe], 0),
        tag=sp.tag[safe],
    )
    # buffer-local liveness (killed by absorb/migration below)
    b_live = valid

    # ---- 1. absorption: deposit rhob at the boundary position ----
    absorbed = b["pc"] == NEIGHBOR_ABSORB
    f = accumulate_rhob(f, g, b["vox"], b["q"], b["dx"], b["dy"], b["dz"],
                        absorbed)
    b_live = b_live & ~absorbed

    # ---- 1b. custom boundary handlers (boundary/models.py) ----
    if handlers:
        from ..boundary.models import decode_handler
        import jax as _jax
        hid, hface = decode_handler(b["pc"])
        bstate = list(bstate)
        keys = _jax.random.split(key, len(handlers))
        for hi, handler in enumerate(handlers):
            hmask = b_live & (b["pc"] <= -9) & (hid == hi)
            b, f, bstate[hi], killed = handler.apply(
                keys[hi], b, hmask, hface, f, g, sp.sid, bstate[hi],
                step=step)
            b_live = b_live & ~killed
        bstate = tuple(bstate)

    # ---- 2. migration: ONE packed (13, cap) payload per face ----
    # The reference's two-phase count-then-payload exchange
    # (boundary_p.c:341-385) exists to bound message sizes; with XLA's
    # static shapes the analogue is one fused payload per face (13 rows:
    # dx,dy,dz,ux,uy,uz,q,mdx,mdy,mdz,tag,vox,unused) at a configurable
    # cap, with overflow RETAINED (pc kept) and retried next round
    # instead of silently dropped.  Lane validity rides in the vox row
    # (vox < 0 = empty), so no separate count is exchanged.
    recv = None
    if pcomm is not None:
        kcap = max_inj if mig_cap is None else min(mig_cap, max_inj)
        bc_f32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
        payloads = {}
        sent_any = jnp.zeros_like(b_live)
        for face in range(6):
            code = NEIGHBOR_MIGRATE_BASE - face
            mask = (b["pc"] == code) & b_live
            fsel, fn_, fvalid = _compact_indices(mask, kcap, max_inj)
            fsafe = jnp.where(fvalid, fsel, 0)
            axis = face % 3
            pos = [b["dx"][fsafe], b["dy"][fsafe], b["dz"][fsafe]]
            pos[axis] = -pos[axis]    # leave at +1 -> enter at -1
            vox_new = jnp.where(
                fvalid,
                _remap_voxel_through_face(g, b["vox"][fsafe], face),
                -1)
            payloads[face] = jnp.stack([
                jnp.where(fvalid, pos[0], 0.0),
                jnp.where(fvalid, pos[1], 0.0),
                jnp.where(fvalid, pos[2], 0.0),
                b["ux"][fsafe], b["uy"][fsafe], b["uz"][fsafe],
                jnp.where(fvalid, b["q"][fsafe], 0.0),
                b["mdx"][fsafe], b["mdy"][fsafe], b["mdz"][fsafe],
                bc_f32(b["tag"][fsafe]),
                bc_f32(vox_new),
            ], axis=0)                                    # (12, kcap)
            # only lanes that actually made it into the payload leave
            # this shard; overflow keeps pc and is retried next round
            pos_c2 = jnp.cumsum(mask.astype(jnp.int32)) - 1
            sent_any = sent_any | (mask & (pos_c2 < kcap))
        recv = pcomm.exchange(payloads)
        b_live = b_live & ~sent_any

    # ---- 3. walk the still-live pending buffer ----
    walkable = b_live & (b["pc"] == PC_EXHAUSTED)
    st = WalkState(
        x=b["dx"], y=b["dy"], z=b["dz"], vox=b["vox"],
        ux=b["ux"], uy=b["uy"], uz=b["uz"],
        rx=b["mdx"], ry=b["mdy"], rz=b["mdz"],
        q=jnp.where(walkable, b["q"], 0.0),
        pcode=jnp.zeros((max_inj,), dtype=jnp.int32),
        active=walkable,
    )
    st, acc = streak_walk(st, acc, neighbor, g, n_walk)

    # merge walk results for walkable lanes; others keep buffer values
    def mix(walked, kept):
        return jnp.where(walkable, walked, kept)

    res = dict(
        dx=mix(st.x, b["dx"]), dy=mix(st.y, b["dy"]),
        dz=mix(st.z, b["dz"]),
        vox=mix(st.vox, b["vox"]),
        ux=mix(st.ux, b["ux"]), uy=mix(st.uy, b["uy"]),
        uz=mix(st.uz, b["uz"]),
        pc=jnp.where(walkable, st.pcode, jnp.where(b_live, b["pc"], 0)),
    )
    pend_new = res["pc"] != 0
    res["mdx"] = jnp.where(walkable, jnp.where(pend_new, st.rx, 0.0),
                           b["mdx"])
    res["mdy"] = jnp.where(walkable, jnp.where(pend_new, st.ry, 0.0),
                           b["mdy"])
    res["mdz"] = jnp.where(walkable, jnp.where(pend_new, st.rz, 0.0),
                           b["mdz"])

    # dead buffer lanes (absorbed / migrated away) are tombstoned
    res["vox"] = jnp.where(b_live, res["vox"], -1)
    res["q"] = jnp.where(b_live, b["q"], 0.0)
    res["tag"] = b["tag"]

    # ---- 4. scatter buffer back into the species SoA ----
    tgt = jnp.where(valid, sel, max_np)

    def put(arr, key):
        return arr.at[tgt].set(res[key], mode="drop")

    sp = sp.replace(
        dx=put(sp.dx, "dx"), dy=put(sp.dy, "dy"), dz=put(sp.dz, "dz"),
        i=put(sp.i, "vox"),
        ux=put(sp.ux, "ux"), uy=put(sp.uy, "uy"), uz=put(sp.uz, "uz"),
        q=put(sp.q, "q"),
        mdx=put(sp.mdx, "mdx"), mdy=put(sp.mdy, "mdy"),
        mdz=put(sp.mdz, "mdz"), pc=put(sp.pc, "pc"),
        tag=put(sp.tag, "tag"),
    )

    # ---- 5. inject received migrants into free slots ----
    if recv is not None:
        bc_i32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
        for face in range(6):
            rp = recv.get(face)
            if rp is None:
                continue
            k = rp.shape[1]
            r = dict(
                dx=rp[0], dy=rp[1], dz=rp[2],
                ux=rp[3], uy=rp[4], uz=rp[5], q=rp[6],
                mdx=rp[7], mdy=rp[8], mdz=rp[9],
                tag=bc_i32(rp[10]), vox=bc_i32(rp[11]),
            )
            filled = r["vox"] >= 0            # validity rides in vox
            slot = sp.np + jnp.arange(k, dtype=jnp.int32)
            ok = filled & (slot < max_np)
            tgt2 = jnp.where(ok, slot, max_np)

            def put2(arr, vals):
                return arr.at[tgt2].set(vals, mode="drop")

            sp = sp.replace(
                dx=put2(sp.dx, r["dx"]), dy=put2(sp.dy, r["dy"]),
                dz=put2(sp.dz, r["dz"]),
                ux=put2(sp.ux, r["ux"]), uy=put2(sp.uy, r["uy"]),
                uz=put2(sp.uz, r["uz"]),
                q=put2(sp.q, r["q"]), i=put2(sp.i, r["vox"]),
                mdx=put2(sp.mdx, r["mdx"]), mdy=put2(sp.mdy, r["mdy"]),
                mdz=put2(sp.mdz, r["mdz"]), tag=put2(sp.tag, r["tag"]),
                pc=put2(sp.pc, jnp.full((k,), PC_EXHAUSTED, jnp.int32)),
                np=jnp.minimum(sp.np + jnp.sum(ok).astype(jnp.int32),
                               max_np),
            )
            # continue the migrants' walks in the same round
            mig_valid = ok
            st = WalkState(
                x=r["dx"], y=r["dy"], z=r["dz"],
                vox=jnp.where(mig_valid, r["vox"], 0),
                ux=r["ux"], uy=r["uy"], uz=r["uz"],
                rx=r["mdx"], ry=r["mdy"], rz=r["mdz"],
                q=jnp.where(mig_valid, r["q"], 0.0),
                pcode=jnp.zeros((k,), dtype=jnp.int32),
                active=mig_valid,
            )
            st, acc = streak_walk(st, acc, neighbor, g, n_walk)
            pnew = st.pcode != 0
            sp = sp.replace(
                dx=put2(sp.dx, st.x), dy=put2(sp.dy, st.y),
                dz=put2(sp.dz, st.z),
                i=put2(sp.i, st.vox),
                ux=put2(sp.ux, st.ux), uy=put2(sp.uy, st.uy),
                uz=put2(sp.uz, st.uz),
                mdx=put2(sp.mdx, jnp.where(pnew, st.rx, 0.0)),
                mdy=put2(sp.mdy, jnp.where(pnew, st.ry, 0.0)),
                mdz=put2(sp.mdz, jnp.where(pnew, st.rz, 0.0)),
                pc=put2(sp.pc, st.pcode),
            )

    return sp, f, acc, bstate


def finish_boundary(sp: SpeciesState) -> SpeciesState:
    """After the comm rounds: count and drop still-unresolved movers
    (mirror of the "Ignoring %i unprocessed movers" warning,
    advance.cxx:98-103)."""
    leftover = sp.alive & (sp.pc != 0)
    # ACCUMULATE across steps (matches push.advance_p's cumulative drop
    # counter; a jitted multi-step dispatch must never reset it)
    nm = sp.nm + jnp.sum(leftover).astype(jnp.int32)
    return sp.replace(nm=nm, pc=jnp.zeros_like(sp.pc),
                      mdx=jnp.zeros_like(sp.mdx),
                      mdy=jnp.zeros_like(sp.mdy),
                      mdz=jnp.zeros_like(sp.mdz))
