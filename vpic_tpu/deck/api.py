"""Deck API — the Python analogue of the reference's compile-time input deck
DSL (src/deck_wrapper.cxx + the ~60 deck-facing helpers of
vpic_simulation, src/vpic/vpic.hxx:126-555).

A deck is a Python module/function that builds a :class:`Simulation` with the
same vocabulary: define_units, define_timestep, define_periodic_grid,
define_material, define_species, set_field (region equations over staggered
meshgrids), inject_particle, then steps it.  Multi-shard domains (px,py,pz
topology, partition.c:36-85) build one state per shard and run under
shard_map (engine/distributed.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..comm.facecomm import LocalComm, ShardComm
from ..core.types import (
    ABSORB_FIELDS,
    ANTI_SYMMETRIC_FIELDS,
    FieldState,
    Grid,
    MaterialGrid,
    MaterialTable,
    NEIGHBOR_ABSORB,
    NEIGHBOR_REFLECT,
    PERIODIC_FIELDS,
    SimState,
    SpeciesState,
)
from ..engine import distributed as dist
from ..engine.init import initialize_state
from ..engine.step import StepOptions, make_advance
from ..field import stencil
from ..field.slabs import own_slice
from ..io import checkpoint as ckpt
from ..io import dump as iodump
from ..io import energies as ioenergies
from ..particles import boundary as pboundary
from ..sf import hydro as sfhydro
from ..sf import interp as sfinterp
from ..grid.partition import make_grid_arrays, shard_origin
from ..particles import aux as paux
from ..particles import push as ppush


@dataclasses.dataclass
class _Material:
    name: str
    id: int
    epsx: float; epsy: float; epsz: float
    mux: float; muy: float; muz: float
    sigmax: float; sigmay: float; sigmaz: float
    zetax: float; zetay: float; zetaz: float


def _as3(v):
    if np.isscalar(v):
        return (float(v),) * 3
    v = tuple(float(x) for x in v)
    assert len(v) == 3
    return v


def build_material_table(materials: List[_Material], g: Grid) -> MaterialTable:
    """Precompute FDTD coefficients exactly like new_material_coefficients
    (standard/sfa.c:138-174)."""
    n = len(materials)
    cols = {k: np.zeros((n,), np.float32) for k in (
        "decayx decayy decayz drivex drivey drivez rmux rmuy rmuz "
        "nonconductive epsx epsy epsz".split())}
    for m in materials:
        i = m.id
        axs = {}
        for c, eps, sigma in (("x", m.epsx, m.sigmax),
                              ("y", m.epsy, m.sigmay),
                              ("z", m.epsz, m.sigmaz)):
            a = (sigma * g.dt) / (eps * g.eps0)
            decay = math.exp(-a)
            if a == 0:
                drive = 1.0 / eps
            elif decay == 0:
                drive = 0.0
            else:
                drive = 2.0 * math.exp(-0.5 * a) * math.sinh(0.5 * a) / (a * eps)
            cols["decay" + c][i] = decay
            cols["drive" + c][i] = drive
            cols["eps" + c][i] = eps
            axs[c] = a
        cols["rmux"][i] = 1.0 / m.mux
        cols["rmuy"][i] = 1.0 / m.muy
        cols["rmuz"][i] = 1.0 / m.muz
        cols["nonconductive"][i] = 1.0 if all(
            v == 0 for v in axs.values()) else 0.0
    return MaterialTable(**{k: jnp.asarray(v) for k, v in cols.items()})


_PBC_MAP = {"periodic": PERIODIC_FIELDS, "absorb": NEIGHBOR_ABSORB,
            "reflect": NEIGHBOR_REFLECT}

_KIND_OF = {
    "ex": "edge_x", "ey": "edge_y", "ez": "edge_z",
    "cbx": "face_x", "cby": "face_y", "cbz": "face_z",
    "jfx": "edge_x", "jfy": "edge_y", "jfz": "edge_z",
    "rhof": "node", "rhob": "node",
}


class Simulation:
    """Single top-level simulation object (vpic_simulation analogue)."""

    def __init__(self, seed: int = 0):
        self.cvac = 1.0
        self.eps0 = 1.0
        self.damp = 0.0
        self.dt = 0.0
        self.num_step = 0
        self.seed = seed
        self.grid: Optional[Grid] = None
        self.materials: List[_Material] = []
        self._species: List[dict] = []
        self._field_sets: List[tuple] = []
        self._material_regions: List[tuple] = []
        self.rng = np.random.default_rng(seed)
        self.state: Optional[SimState] = None
        self.opts = StepOptions()
        self._advance_fn = None
        self._advance_cycle = None
        self._traj = None
        self._energies_fn = None
        self.mesh = None
        self.step_count = 0
        self._boundary_handlers = []
        self._emitters = []

    # -- units / time ----------------------------------------------------
    def define_units(self, cvac: float, eps0: float):
        self.cvac, self.eps0 = float(cvac), float(eps0)

    def define_timestep(self, dt: float):
        self.dt = float(dt)

    def courant_length(self, lx, ly, lz, nx, ny, nz):
        """vpic.hxx:537-544."""
        w = 0.0
        if nx > 1:
            w += (nx / lx) ** 2
        if ny > 1:
            w += (ny / ly) ** 2
        if nz > 1:
            w += (nz / lz) ** 2
        return 1.0 / math.sqrt(w)

    # -- grid -------------------------------------------------------------
    def _make_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz, px, py, pz,
                   fbc, pbc):
        assert nx % px == 0 and ny % py == 0 and nz % pz == 0
        self.grid = Grid(
            nx=nx // px, ny=ny // py, nz=nz // pz,
            dt=self.dt, cvac=self.cvac, eps0=self.eps0, damp=self.damp,
            gx0=x0, gy0=y0, gz0=z0, gx1=x1, gy1=y1, gz1=z1,
            gpx=px, gpy=py, gpz=pz, fbc=tuple(fbc), pbc=tuple(pbc),
        )
        return self.grid

    def define_periodic_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz,
                             px=1, py=1, pz=1):
        """partition_periodic_box (src/grid/partition.c:36-85)."""
        return self._make_grid(x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               px, py, pz,
                               (PERIODIC_FIELDS,) * 6,
                               (PERIODIC_FIELDS,) * 6)

    def define_absorbing_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz,
                              px=1, py=1, pz=1, pbc="absorb"):
        """partition_absorbing_box (partition.c:88-140)."""
        return self._make_grid(x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               px, py, pz,
                               (ABSORB_FIELDS,) * 6,
                               (_PBC_MAP[pbc],) * 6)

    def define_reflecting_grid(self, x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               px=1, py=1, pz=1):
        """partition_metal_box (partition.c:142-177)."""
        return self._make_grid(x0, y0, z0, x1, y1, z1, nx, ny, nz,
                               px, py, pz,
                               (ANTI_SYMMETRIC_FIELDS,) * 6,
                               (NEIGHBOR_REFLECT,) * 6)

    def set_domain_field_bc(self, face: int, bc: int):
        """set_fbc analogue (src/grid/ops.c)."""
        fbc = list(self.grid.fbc)
        fbc[face] = bc
        self.grid = dataclasses.replace(self.grid, fbc=tuple(fbc))

    def set_domain_particle_bc(self, face: int, bc):
        """set_pbc analogue; ``bc`` may be 'periodic'/'absorb'/'reflect', a
        raw code, or a registered BoundaryHandler."""
        from ..boundary.models import BoundaryHandler, handler_code

        if isinstance(bc, BoundaryHandler):
            bc = handler_code(self._boundary_handlers.index(bc), face)
        pbc = list(self.grid.pbc)
        pbc[face] = _PBC_MAP.get(bc, bc)
        self.grid = dataclasses.replace(self.grid, pbc=tuple(pbc))

    def join_domain(self, face: int, neighbors):
        """Custom interdomain wiring for a sharded axis — the join_domain
        analogue (vpic.hxx:313-331, grid/ops.c join_grid): ``neighbors[s]``
        is the axis index of the shard adjacent through ``face`` of the
        shard at axis position s.  Joined faces become fully interior
        (migration + field halos ride the custom ppermute).  Wire BOTH
        opposite faces consistently; this validates the pairing."""
        from ..comm.facecomm import OPP
        from ..core.types import FACE_AXIS

        ax = FACE_AXIS[face]
        n = (self.grid.gpx, self.grid.gpy, self.grid.gpz)[ax]
        assert n > 1, "join_domain requires the axis to be sharded"
        neighbors = tuple(int(v) for v in neighbors)
        assert len(neighbors) == n and sorted(neighbors) == list(range(n)), \
            f"neighbors must be a permutation of 0..{n-1}"
        join = list(self.grid.join)
        join[face] = neighbors
        opp = join[OPP[face]]
        if opp is not None:
            # consistency: join[f][s] = t <=> join[OPP[f]][t] = s
            assert all(opp[t] == s for s, t in enumerate(neighbors)), \
                "inconsistent opposite-face wiring"
        self.grid = dataclasses.replace(self.grid, join=tuple(join))
        return self.grid

    def define_boundary(self, handler):
        """Register a custom particle boundary handler (add_boundary,
        src/grid/add_boundary.c:9-32); use with set_domain_particle_bc."""
        self._boundary_handlers.append(handler)
        return handler

    def define_surface_emitter(self, model, face=None, components=None,
                               region=None):
        """Register a surface emitter (define_surface_emitter,
        deck_wrapper.cxx:390-463): all cells on a domain ``face``, an
        explicit (vox, face) component list, or — like the reference's
        rgn form — every exterior-cell face touching ``region(x,y,z)``
        (emission is into the exterior)."""
        from ..emit.models import (domain_face_components,
                                   region_surface_components)

        if components is None:
            if region is not None:
                vox, faces = region_surface_components(self.grid, region)
                components = (tuple(vox.tolist()), tuple(faces.tolist()))
            else:
                assert face is not None
                vox = domain_face_components(self.grid, face)
                components = (tuple(vox.tolist()),
                              tuple([face] * len(vox)))
        model = dataclasses.replace(model, components=components)
        model.bind(self.grid)
        self._emitters.append(model)
        return model

    def define_volume_emitter(self, model, region):
        """Register a volume emitter (define_volume_emitter,
        deck_wrapper.cxx:346-383): every cell inside ``region(x,y,z)``
        becomes a face-less component (face = -1).  The stock face-law
        models skip face-less components exactly like the reference's
        non-face switch branch; custom models may emit from them."""
        from ..emit.models import region_volume_components

        vox, faces = region_volume_components(self.grid, region)
        model = dataclasses.replace(
            model, components=(tuple(vox.tolist()), tuple(faces.tolist())))
        model.bind(self.grid)
        self._emitters.append(model)
        return model

    # -- materials / species ----------------------------------------------
    def define_material(self, name, eps=1.0, mu=1.0, sigma=0.0, zeta=0.0):
        ex, ey, ez = _as3(eps)
        mx, my, mz = _as3(mu)
        sx, sy, sz = _as3(sigma)
        zx, zy, zz = _as3(zeta)
        m = _Material(name, len(self.materials), ex, ey, ez,
                      mx, my, mz, sx, sy, sz, zx, zy, zz)
        self.materials.append(m)
        return m

    def define_species(self, name, q_m, max_np, sort_interval=0):
        # capacity rounds up to a whole number of 1024 slots (checkpoints
        # saved with other capacities still restore, io/checkpoint.py)
        h = dict(name=name, sid=len(self._species), q_m=float(q_m),
                 max_np=-(-int(max_np) // 1024) * 1024,
                 sort_interval=int(sort_interval),
                 batches=[])
        self._species.append(h)
        return h

    # -- field regions ----------------------------------------------------
    def component_coords(self, comp: str, shard=(0, 0, 0)):
        """Sparse [z,y,x]-shaped meshgrids of the physical positions of one
        field component's owned sublattice on one shard (the 8 Yee
        sub-lattices, deck_wrapper.cxx:467-503)."""
        g = self.grid
        kind = _KIND_OF[comp]
        axes = []
        for a, (gmin, d, n, s_) in enumerate((
                (g.gx0, g.dx, g.nx, shard[0]), (g.gy0, g.dy, g.ny, shard[1]),
                (g.gz0, g.dz, g.nz, shard[2]))):
            sl = own_slice(g, kind, a)
            idx = np.arange(sl.start, sl.stop) + s_ * n
            node_aligned = (
                kind == "node"
                or (kind.startswith("edge_") and "xyz".index(kind[-1]) != a)
                or (kind.startswith("face_") and "xyz".index(kind[-1]) == a))
            pos = gmin + (idx - 1 + (0.0 if node_aligned else 0.5)) * d
            axes.append(pos)
        Z, Y, X = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        return X, Y, Z

    def set_region_material(self, region_fn, material):
        """Assign ``material`` to every material-id sublattice point whose
        position satisfies ``region_fn(x,y,z)`` (set_region_material,
        deck_wrapper.cxx:119-227: ids are set per edge/node/face/cell
        sub-lattice)."""
        self._material_regions.append((region_fn, material.id))

    def set_field(self, comp: str, fn):
        """Register comp = fn(x, y, z) over its owned sublattice (the
        set_region_field analogue, deck_wrapper.cxx:228-345; fold regions
        into the equation with np.where)."""
        assert comp in _KIND_OF, comp
        self._field_sets.append((comp, fn))

    # -- particles ---------------------------------------------------------
    def inject_particle(self, species, x, y, z, ux, uy, uz, q,
                        tag=0, update_rhob=False):
        """Vectorized injection (misc.cxx:16-106).  Coordinates are global;
        shard assignment + the robust double-precision global->local
        conversion happen at finalize."""
        x = np.atleast_1d(np.asarray(x, np.float64))
        shape = x.shape
        arr = lambda v: np.broadcast_to(
            np.atleast_1d(np.asarray(v, np.float64)), shape).astype(
                np.float64)
        species["batches"].append(dict(
            x=x, y=arr(y), z=arr(z), ux=arr(ux), uy=arr(uy), uz=arr(uz),
            q=arr(q),
            tag=np.broadcast_to(np.atleast_1d(
                np.asarray(tag, np.int32)), shape),
            update_rhob=bool(update_rhob)))

    def make_injector(self, species):
        """Build a runtime in-step injector for ``species`` (name or the
        handle from define_species), callable from the
        ``user_particle_injection`` hook — the traced analogue of
        misc.cxx:16-106 with global fp64 placement, optional rhob update,
        and aged partial pushes via the boundary rounds.  See
        deck/inject.py."""
        from . import inject as _inject
        from ..grid.partition import shard_origin

        g = self.grid
        assert g is not None, "define a grid first"
        h = (self._species_by_name(species) if isinstance(species, str)
             else species)
        origins = np.zeros((g.gpz, g.gpy, g.gpx, 3), np.float64)
        for sz in range(g.gpz):
            for sy in range(g.gpy):
                for sx in range(g.gpx):
                    origins[sz, sy, sx] = shard_origin(g, (sx, sy, sz))
        return _inject.Injector(sid=h["sid"], g=g, origins=origins)

    def maxwellian(self, n, ut):
        """n normal momenta with thermal spread ut (mt_{d,f}randn analogue,
        mtrand.h:39-146)."""
        return self.rng.normal(0.0, ut, size=n)

    def uniform(self, n, lo, hi):
        return self.rng.uniform(lo, hi, size=n)

    # -- finalize ----------------------------------------------------------
    def _build_shard_state(self, shard, mat) -> SimState:
        g = self.grid
        sx, sy, sz = shard
        x0s, y0s, z0s = shard_origin(g, shard)
        lx = (g.gx1 - g.gx0) / g.gpx
        ly = (g.gy1 - g.gy0) / g.gpy
        lz = (g.gz1 - g.gz0) / g.gpz
        x1s, y1s, z1s = x0s + lx, y0s + ly, z0s + lz

        field_np = {k: np.zeros(g.shape, np.float32)
                    for k in ("ex", "ey", "ez", "cbx", "cby", "cbz",
                              "jfx", "jfy", "jfz", "rhof", "rhob")}
        for comp, fn in self._field_sets:
            x, y, z = self.component_coords(comp, shard)
            vals = np.broadcast_to(
                np.asarray(fn(x, y, z), np.float32), x.shape)
            ix = tuple(own_slice(g, _KIND_OF[comp], a) for a in (2, 1, 0))
            field_np[comp][ix] = vals

        f = FieldState.zeros(g).replace(
            **{k: jnp.asarray(v) for k, v in field_np.items()})

        matg = None
        if self._material_regions:
            id_kinds = dict(
                ematx="ex", ematy="ey", ematz="ez", nmat="rhof",
                fmatx="cbx", fmaty="cby", fmatz="cbz", cmat=None)
            ids = {}
            for name, comp in id_kinds.items():
                arr = np.zeros(g.shape, np.int32)
                if comp is None:   # cell centers
                    xs = [g.gx0 + (np.arange(1, g.nx + 1)
                                   + shard[0] * g.nx - 0.5) * g.dx,
                          g.gy0 + (np.arange(1, g.ny + 1)
                                   + shard[1] * g.ny - 0.5) * g.dy,
                          g.gz0 + (np.arange(1, g.nz + 1)
                                   + shard[2] * g.nz - 0.5) * g.dz]
                    Z, Y, X = np.meshgrid(xs[2], xs[1], xs[0],
                                          indexing="ij")
                    ix = (slice(1, g.nz + 1), slice(1, g.ny + 1),
                          slice(1, g.nx + 1))
                else:
                    X, Y, Z = self.component_coords(comp, shard)
                    ix = tuple(own_slice(g, _KIND_OF[comp], a)
                               for a in (2, 1, 0))
                sub = arr[ix] * 0
                for region_fn, mid in self._material_regions:
                    inside = np.asarray(region_fn(X, Y, Z), bool)
                    sub = np.where(inside, np.int32(mid), sub)
                arr[ix] = sub
                ids[name] = jnp.asarray(arr)
            matg = MaterialGrid(**ids)

        def cellify(c, c0, c1, n):
            t = n * ((c - c0) / (c1 - c0))
            ic = t.astype(np.int64)
            t = t - ic
            t = (t + t) - 1.0
            far = ic == n
            t = np.where(far, 1.0, t)
            ic = np.where(far, n - 1, ic) + 1
            return t, ic

        species = []
        rhob_batches = []
        emit_sids = {e.sid for e in self._emitters}
        for h in self._species:
            # Static sort-payload hints (must be identical across shards):
            # tags ride the sort only if some injection tagged a tracer;
            # q is carried only if weights vary or an emitter (which
            # computes per-slot q_emit) can inject into this species.
            has_tags = any(bool(np.any(b["tag"] != 0))
                           for b in h["batches"])
            qs = (np.concatenate([b["q"].astype(np.float32)
                                  for b in h["batches"]])
                  if h["batches"] else np.zeros(0, np.float32))
            uniform_q = (h["sid"] not in emit_sids
                         and np.unique(qs).size <= 1)
            sp = SpeciesState.create(h["name"], h["sid"], h["q_m"],
                                     h["max_np"], h["sort_interval"],
                                     has_tags=has_tags, uniform_q=uniform_q)
            cols = {k: [] for k in ("dx", "dy", "dz", "i", "ux", "uy",
                                    "uz", "q", "tag")}
            total = 0
            for b in h["batches"]:
                own = ((b["x"] >= x0s) & (b["y"] >= y0s) & (b["z"] >= z0s)
                       & (b["x"] < x1s) & (b["y"] < y1s) & (b["z"] < z1s))
                # far-wall ownership on the global high faces with local BCs
                # (misc.cxx:37-40)
                if sx == g.gpx - 1 and g.fbc[3] != PERIODIC_FIELDS:
                    own |= ((b["x"] == x1s) & (b["y"] >= y0s) & (b["z"] >= z0s)
                            & (b["y"] < y1s) & (b["z"] < z1s))
                if not own.any():
                    continue
                dxv, ix = cellify(b["x"][own], x0s, x1s, g.nx)
                dyv, iy = cellify(b["y"][own], y0s, y1s, g.ny)
                dzv, iz = cellify(b["z"][own], z0s, z1s, g.nz)
                vox = (ix + g.nxg * (iy + g.nyg * iz)).astype(np.int32)
                cols["dx"].append(dxv.astype(np.float32))
                cols["dy"].append(dyv.astype(np.float32))
                cols["dz"].append(dzv.astype(np.float32))
                cols["i"].append(vox)
                for k in ("ux", "uy", "uz", "q"):
                    cols[k].append(b[k][own].astype(np.float32))
                cols["tag"].append(b["tag"][own].astype(np.int32))
                n_own = int(own.sum())
                if b["update_rhob"]:
                    rhob_batches.append(dict(
                        i=vox, q=cols["q"][-1], dx=cols["dx"][-1],
                        dy=cols["dy"][-1], dz=cols["dz"][-1]))
                total += n_own
            if total > h["max_np"]:
                raise ValueError(
                    f"species {h['name']}: {total} > max_np {h['max_np']}")
            if total:
                upd = {}
                for k in cols:
                    cat = np.concatenate(cols[k])
                    buf = np.asarray(getattr(sp, k)).copy()
                    buf[:total] = cat
                    upd[k] = jnp.asarray(buf)
                sp = sp.replace(np=jnp.int32(total), **upd)
            species.append(sp)

        state = SimState(
            field=f,
            interpolator=jnp.zeros((g.nv, 18), jnp.float32),
            species=tuple(species),
            grid_arrays=make_grid_arrays(g, shard),
            materials=mat,
            material_grid=matg,
            rng=jax.random.key(
                self.seed * 65537 + (sx + g.gpx * (sy + g.gpy * sz))),
            step=jnp.int32(0),
            boundary_state=tuple(
                h.init_state(len(self._species))
                for h in self._boundary_handlers),
        )
        for b in rhob_batches:
            state = dataclasses.replace(state, field=paux.accumulate_rhob(
                state.field, g,
                jnp.asarray(b["i"]), jnp.asarray(-b["q"]),
                jnp.asarray(b["dx"]), jnp.asarray(b["dy"]),
                jnp.asarray(b["dz"]),
                jnp.ones((len(b["i"]),), bool)))
        return state

    def finalize(self, devices=None, **hooks):
        self._hooks = hooks
        g = self.grid
        assert g is not None, "define a grid first"
        if not self.materials:
            self.define_material("vacuum")
        mat = build_material_table(self.materials, g)

        if g.is_multishard:
            self.mesh = dist.make_mesh(g, devices)
            shards = [[[self._build_shard_state((sx, sy, sz), mat)
                        for sx in range(g.gpx)]
                       for sy in range(g.gpy)]
                      for sz in range(g.gpz)]
            state = dist.stack_shards(shards, g)
            state = dist.shard_state(state, self.mesh)
            state = dist.make_distributed_init(g, self.mesh)(state)
            self.comm = ShardComm(g, dist._axis_names_for(g))
        else:
            state = self._build_shard_state((0, 0, 0), mat)
            self.comm = LocalComm(g)
            state = jax.jit(
                lambda s: initialize_state(s, g, self.comm))(state)
        self._rebuild_advance()
        self.state = state
        return state

    def _jit_step_fn(self, body):
        """jit a per-shard ``state -> state`` body; on a multishard grid
        the body runs under ``shard_map`` over the device mesh (so cycle
        executables — including their internal lax.scan — are ONE SPMD
        dispatch, the distributed analogue of the single-device fast
        path; reference bar: 99.85% parallel fraction,
        README.features:16-19)."""
        g = self.grid
        if g is None or not g.is_multishard:
            return jax.jit(body, donate_argnums=0)
        from jax.sharding import PartitionSpec as P

        def per_shard(state):
            state = jax.tree.map(lambda a: a.reshape(a.shape[3:]), state)
            state = body(state)
            return jax.tree.map(lambda a: a.reshape((1, 1, 1) + a.shape),
                                state)

        spec = P(*dist.AXIS_NAMES)
        fn = jax.shard_map(per_shard, mesh=self.mesh, in_specs=spec,
                           out_specs=spec, check_vma=False)
        return jax.jit(fn, donate_argnums=0)

    def _build_cycle(self, g, hooks):
        """One jitted executable for a cycle of k = ``opts.resort_interval``
        steps.  Alternating per-step executables costs a host round trip
        per step; a single k-step executable amortizes it, and
        ``_cycles_scan`` folds m cycles into one dispatch.  Multishard
        grids build the same cycle body with the mesh comm (halo
        ppermutes + migration inside the cycle) and wrap it in shard_map
        via _jit_step_fn."""
        k = self.opts.resort_interval
        self._advance_cycle = None
        if k <= 1:
            return
        pcomm = self.comm if g.is_multishard else None
        adv = make_advance(
            g, self.comm, pcomm=pcomm, opts=self.opts,
            boundary_handlers=tuple(self._boundary_handlers),
            emitters=tuple(self._emitters), **hooks)

        def cycle(state):
            for _ in range(k):
                state = adv(state)
            return state

        self._cycle_body = cycle
        self._advance_cycle = self._jit_step_fn(cycle)
        self._cycles_scan_cache = {}

    def _cycles_scan(self, m: int):
        """One executable running ``m`` cycles via ``lax.scan`` — a single
        dispatch (and a single XLA program) instead of ``m``, which
        matters when per-dispatch overhead rivals the step itself (small
        grids).  Cached per ``m``; the scan body is the already-traced
        cycle, so compile cost is one cycle + loop plumbing."""
        fn = self._cycles_scan_cache.get(m)
        if fn is None:
            body = self._cycle_body

            def run(state):
                return jax.lax.scan(lambda s, _: (body(s), None), state,
                                    None, length=m)[0]

            fn = self._cycles_scan_cache[m] = self._jit_step_fn(run)
        return fn

    def _dispatch_cycle(self, fn):
        """Run one jitted cycle executable on the current state."""
        self.state = fn(self.state)

    def advance(self, n=1):
        """Advance ``n`` steps: whole cycles first (two or more in one
        scanned dispatch), then single steps for the remainder."""
        k = self.opts.resort_interval
        left = n
        if self._advance_cycle is not None and left >= k:
            m = left // k
            self._dispatch_cycle(self._cycles_scan(m) if m >= 2
                                 else self._advance_cycle)
            self.step_count += m * k
            left -= m * k
        for _ in range(left):
            self.state = self._advance_fn(self.state)
            self.step_count += 1
        return self.state

    # -- diagnostics -------------------------------------------------------
    def _diag_energies(self):
        g = self.grid

        def per_shard(st):
            ef = stencil.local_energy_f(st.field, g, st.materials,
                                        st.material_grid)
            ep = jnp.stack([ppush.energy_p(sp, st.interpolator, g)
                            for sp in st.species]) \
                if st.species else jnp.zeros((0,), jnp.float64)
            return ef, ep

        if g.is_multishard:
            from jax.sharding import PartitionSpec as P

            def fn(st):
                st = jax.tree.map(lambda a: a.reshape(a.shape[3:]), st)
                ef, ep = per_shard(st)
                return (ef.reshape((1, 1, 1) + ef.shape),
                        ep.reshape((1, 1, 1) + ep.shape))

            spec = P(*dist.AXIS_NAMES)
            sm = jax.shard_map(fn, mesh=self.mesh, in_specs=spec,
                               out_specs=spec, check_vma=False)
            ef, ep = jax.jit(sm)(self.state)
            ef = np.asarray(ef).sum(axis=(0, 1, 2))
            ep = np.asarray(ep).sum(axis=(0, 1, 2))
        else:
            ef, ep = jax.jit(per_shard)(self.state)
            ef, ep = np.asarray(ef), np.asarray(ep)
        return ef, ep

    def energies(self):
        """dump_energies values (dump.cxx:37-78): 6 field energies + per-
        species kinetic energies."""
        g = self.grid
        ef, ep = self._diag_energies()
        ef = np.asarray(stencil.finish_energy_f(g, ef))
        out = {k: float(v) for k, v in zip(
            ("ex", "ey", "ez", "bx", "by", "bz"), ef)}
        for h, e in zip(self._species, ep):
            out[h["name"]] = float(e) * (g.cvac * g.cvac / h["q_m"])
        return out

    # -- dumps (reference-compatible V0 binary + energies text) ----------
    def _shard_states(self):
        """Yield (shard, rank, per-shard SimState as host arrays)."""
        g = self.grid
        st = jax.device_get(self.state)
        nproc = g.gpx * g.gpy * g.gpz
        if not g.is_multishard:
            yield (0, 0, 0), 0, st
            return
        rank = 0
        for sz in range(g.gpz):
            for sy in range(g.gpy):
                for sx in range(g.gpx):
                    shard_state = jax.tree.map(
                        lambda a: a[sz, sy, sx], st)
                    yield (sx, sy, sz), rank, shard_state
                    rank += 1

    def dump_energies(self, fname, append=True):
        """dump.cxx:37-78."""
        g = self.grid
        e = self.energies()
        field_en = [e[k] for k in ("ex", "ey", "ez", "bx", "by", "bz")]
        sp_en = {h["name"]: e[h["name"]] for h in self._species}
        ioenergies.dump_energies(fname, self.step_count, field_en, sp_en,
                                 g.dt, append)

    def dump_fields(self, fbase, ftag=True):
        g = self.grid
        nproc = g.gpx * g.gpy * g.gpz
        for shard, rank, st in self._shard_states():
            iodump.dump_fields(st, g, fbase, self.step_count, shard, rank,
                               nproc, ftag)

    def dump_grid(self, fbase):
        g = self.grid
        nproc = g.gpx * g.gpy * g.gpz
        for shard, rank, st in self._shard_states():
            iodump.dump_grid(st, g, fbase, shard, rank, nproc)

    def dump_hydro(self, sp_name, fbase, ftag=True):
        """clear+accumulate+synchronize hydro then write (dump.cxx:224-265).
        Multishard: shared faces merge over the mesh before writing
        (sf_interface.h:156-163)."""
        g = self.grid
        nproc = g.gpx * g.gpy * g.gpz
        h = self._species_by_name(sp_name)

        if g.is_multishard:
            hy_all = np.asarray(dist.make_distributed_hydro(
                g, self.mesh, h["sid"])(self.state))
            for shard, rank, st in self._shard_states():
                sx, sy, sz = shard
                iodump.dump_hydro(hy_all[sz, sy, sx], g, fbase,
                                  self.step_count, h["sid"], h["q_m"],
                                  shard, rank, nproc, ftag)
            return

        @jax.jit
        def compute(st):
            hy = sfhydro.clear_hydro(g)
            sp = st.species[h["sid"]]
            hy = paux.accumulate_hydro_p(hy, sp, st.interpolator, g)
            return hy

        from ..comm.facecomm import LocalComm
        for shard, rank, st in self._shard_states():
            hy = compute(st)
            hy = sfhydro.synchronize_hydro(hy, g, LocalComm(g))
            iodump.dump_hydro(np.asarray(hy), g, fbase, self.step_count,
                              h["sid"], h["q_m"], shard, rank, nproc, ftag)

    def dump_species(self, fname):
        """ASCII species listing (dump.cxx:82-101)."""
        iodump.dump_species_ascii(
            fname, [(h["name"], h["sid"], h["q_m"]) for h in self._species])

    def dump_materials(self, fname):
        """ASCII material listing (dump.cxx:103-120)."""
        iodump.dump_materials_ascii(fname, self.materials)

    def dump_particles(self, sp_name, fbase, ftag=True):
        """Time-centered particle dump (dump.cxx:267-325)."""
        g = self.grid
        nproc = g.gpx * g.gpy * g.gpz
        h = self._species_by_name(sp_name)

        @jax.jit
        def centered(st):
            sp = st.species[h["sid"]]
            return ppush.center_p(sp, st.interpolator, g)

        for shard, rank, st in self._shard_states():
            sp_c = centered(st)
            iodump.dump_particles(sp_c, g, fbase, self.step_count,
                                  shard, rank, nproc, ftag)

    # -- tracers (the pdlfs tracer deck library, trecon-part/tracer.cxx) --
    def make_tracers(self, src_species, name, stride=1, max_np=None,
                     tag_base=1):
        """Create a zero-charge tracer species from every ``stride``-th
        staged particle of ``src_species`` (tag_tracer + hijack_tracers,
        tracer.cxx:118-198; q=0 already makes the core loop's deposition
        skip them, so no species-list detach is needed).  Call between
        injection and finalize."""
        batches = src_species["batches"]
        xs = np.concatenate([b["x"] for b in batches]) if batches else \
            np.zeros((0,))
        cat = lambda k: (np.concatenate([b[k] for b in batches])
                         if batches else np.zeros((0,)))
        sel = slice(0, None, stride)
        n = xs[sel].shape[0]
        if max_np is None:
            max_np = max(8 * n, 64)
        tr = self.define_species(name, src_species["q_m"], max_np)
        self.inject_particle(
            tr, xs[sel], cat("y")[sel], cat("z")[sel],
            cat("ux")[sel], cat("uy")[sel], cat("uz")[sel], q=0.0,
            tag=np.arange(tag_base, tag_base + n, dtype=np.int32))
        return tr

    def collect_trajectories(self):
        """Record every tagged particle's state at the current step
        (the per-step half of dump_traj, tracer.cxx:254-301)."""
        from ..io import tracers as iotracers

        if self._traj is None:
            self._traj = iotracers.TrajectoryAccumulator()
        g = self.grid
        for h in self._species:
            recs = []
            for shard, rank, st in self._shard_states():
                sp = st.species[h["sid"]]
                # store GLOBAL ghosted voxels so multishard trajectories
                # decode with one origin (exact in the f32 record slot
                # below 2^24 global voxels)
                gi = (iotracers.globalize_voxels(g, np.asarray(sp.i), shard)
                      if g.is_multishard else sp.i)
                arrays = dict(tag=sp.tag, alive=sp.alive,
                              dx=sp.dx, dy=sp.dy, dz=sp.dz, i=gi,
                              ux=sp.ux, uy=sp.uy, uz=sp.uz)
                rec = iotracers.collect_records(arrays, self.step_count,
                                                g.dt)
                if rec.shape[0]:
                    recs.append(rec)
            if recs:
                self._traj.add(h["name"], np.concatenate(recs, axis=0))

    def dump_traj(self, dirname, per_tag_files=False):
        """Write accumulated tracer trajectories (dump_traj,
        tracer.cxx:254-301; per_tag_files=True reproduces the reference's
        one-file-per-tracer append layout)."""
        from ..io import tracers as iotracers

        if self._traj is None:
            return []
        return iotracers.write_traj(self._traj, dirname, per_tag_files)

    def dump_tracers_h5part(self, path, species_name):
        """H5Part tracer file (trecon-hdf5's dumptracer_h5part.cxx)."""
        from ..io import tracers as iotracers

        assert self._traj is not None, "call collect_trajectories() first"
        return iotracers.write_h5part(self._traj, path, species_name)

    def write_global_header(self, base, field_dp=None, species_dumps=None,
                            field_dir="fields", field_base="fields"):
        """Banded-dump global header <base>.vpc (dump.cxx:978-1115)."""
        from ..io.banded import DumpParameters
        from ..io.global_header import write_global_header

        if field_dp is None:
            field_dp = DumpParameters()
        if species_dumps is None:
            species_dumps = [
                (h["name"], "hydro", h["name"], DumpParameters())
                for h in self._species]
        return write_global_header(base, self.grid, field_dp,
                                   species_dumps, field_dir, field_base)

    def boundary_tallies(self, handler):
        """A handler's state with shard axes reduced by summation — the
        global view of counter-style states (AbsorbTally; the analogue of
        summing the reference's per-rank absorb_tally counters).  For
        non-additive states (LinkBoundary ring buffers) read
        ``state.boundary_state`` per shard instead."""
        idx = (handler if isinstance(handler, int)
               else self._boundary_handlers.index(handler))
        st = self.state.boundary_state[idx]
        if not self.grid.is_multishard:
            return jax.tree.map(np.asarray, st)
        return jax.tree.map(
            lambda a: np.asarray(a).sum(axis=(0, 1, 2)), st)

    def dump_energy_diag(self, sp_name, dirname, nex: int, emax: float,
                         vth: float, nbin: int = 800):
        """In-deck KE diagnostics (energy.cxx:1-201): per-cell energy-band
        distribution + global log-KE spectrum, one file pair per rank."""
        from ..diag import energy_dist as ed

        g = self.grid
        h = self._species_by_name(sp_name)
        out = []
        for shard, rank, st in self._shard_states():
            sp = st.species[h["sid"]]
            dist = ed.energy_band_dist(
                g, sp.ux, sp.uy, sp.uz, sp.i, sp.alive, nex, emax, vth)
            edist = ed.energy_spectrum(sp.ux, sp.uy, sp.uz, sp.alive, vth,
                                       nbin=nbin)
            out.append(ed.dump_energy_diag(dirname, self.step_count,
                                           h["name"], rank, dist, edist))
        return out

    def mover_counts(self):
        """Per-species CUMULATIVE dropped-mover counts since t=0 (or the
        last restore), summed over shards — particles whose remaining
        displacement was dropped (the reference's "Ignoring %i unprocessed
        movers" condition, advance.cxx:98-103; cumulative so multi-step
        jitted dispatches cannot silently reset it)."""
        return {h["name"]:
                int(np.asarray(self.state.species[h["sid"]].nm).sum())
                for h in self._species}

    def warn_dropped_movers(self, log=None):
        """WARN (advance.cxx:98-103 semantics) when any species dropped
        unprocessed movers since the previous call.  Returns the
        cumulative counts."""
        import warnings
        counts = self.mover_counts()
        prev = getattr(self, "_warned_movers", {})
        self._warned_movers = counts
        for name, total in counts.items():
            nm = total - prev.get(name, 0)
            if nm:
                msg = (f"ignoring {nm} unprocessed movers for species "
                       f"{name!r} by step {self.step_count} (mover "
                       f"buffer or walker bound exceeded; raise max_inj "
                       f"when boundary rounds run)")
                if log is not None:
                    log(f"WARNING: {msg}")
                else:
                    warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return counts

    def checksum_fields(self):
        """SHA-1 of the full field state (output_checksum_fields,
        misc.cxx:109-139)."""
        from ..core.diagnostics import checksum_fields
        return checksum_fields(jax.device_get(self.state))

    def checksum_species(self, sp_name):
        from ..core.diagnostics import checksum_species
        return checksum_species(jax.device_get(self.state),
                                self._species_by_name(sp_name)["sid"])

    def time_phases(self, n_steps=3):
        """Per-phase device timing report (the p/s/g/f/u_time analogue,
        vpic.hxx:214-218)."""
        from ..core.diagnostics import time_phases
        return time_phases(self, n_steps)

    def _species_by_name(self, name):
        for h in self._species:
            if h["name"] == name:
                return h
        raise KeyError(f"no species {name!r}")

    def standard_diagnostics(self, outdir=".", *, energies_interval=50,
                             fields_interval=0, hydro_interval=None,
                             hydro_species=None, particle_interval=0,
                             particle_species=(), restart_interval=0,
                             quota_hours=None, field_dp=None,
                             hydro_dp=None):
        """The production decks' ``begin_diagnostics`` orchestration as a
        reusable helper (trecon-part turbulence.cxx:1015-1247): the
        rundata directory layout, one-time grid/materials/species dumps
        + global header at step 0, interval-cadenced energies and banded
        field/hydro dumps, particle dumps, and the two-slot rotating
        restart with wall-clock-quota self-termination.

        Returns ``diag()`` — call it after each :meth:`advance` (exactly
        where the reference's main loop calls user_diagnostics).  It
        returns False when the quota fired (a defensive checkpoint was
        written; stop the run, exactly like turbulence.cxx:1148-1247).
        """
        import os as _os

        from ..io.banded import DumpParameters, field_dump, hydro_dump

        out = str(outdir)
        for d in ("fields", "hydro", "rundata", "restart1", "restart2",
                  "particle", "tracer"):
            _os.makedirs(_os.path.join(out, d), exist_ok=True)
        if hydro_interval is None:
            hydro_interval = fields_interval
        if hydro_species is None:
            hydro_species = [h["name"] for h in self._species]
        fdp = field_dp or DumpParameters()
        hdp = hydro_dp or DumpParameters()
        rot = ckpt.RotatingCheckpointer(out, quota_hours=quota_hours)

        def diag():
            s = self.step_count
            if s == 0 or not getattr(diag, "_init_done", False):
                self.dump_grid(f"{out}/rundata/grid")
                self.dump_materials(f"{out}/rundata/materials")
                self.dump_species(f"{out}/rundata/species")
                self.write_global_header(
                    f"{out}/global", field_dp=fdp,
                    species_dumps=[
                        (h["name"], "hydro", f"{h['name']}hydro", hdp)
                        for h in self._species])
                diag._init_done = True
            if energies_interval and s % energies_interval == 0:
                self.dump_energies(f"{out}/rundata/energies",
                                   append=s != 0)
            if fields_interval and (s == 1 or s % fields_interval == 0):
                g = self.grid
                nproc = g.gpx * g.gpy * g.gpz
                for shard, rank, st in self._shard_states():
                    field_dump(st, g, f"{out}/fields/fields.{s}.{rank}",
                               fdp, s, shard, rank, nproc)
            if hydro_interval and s % hydro_interval == 0:
                for name in hydro_species:
                    self.dump_hydro(name, f"{out}/hydro/{name}hydro")
            if particle_interval and s and s % particle_interval == 0:
                for name in particle_species:
                    self.dump_particles(name,
                                        f"{out}/particle/{name}particle")
            if restart_interval and s and s % restart_interval == 0:
                rot.save(self.state, self.grid,
                         dict(step_count=s,
                              opts=dataclasses.asdict(self.opts)))
            if rot.over_quota():
                rot.save(self.state, self.grid,
                         dict(step_count=s,
                              opts=dataclasses.asdict(self.opts)))
                return False
            return True

        return diag

    # -- checkpoint / restart ---------------------------------------------
    def checkpoint(self, path, extra=None):
        """Versioned pytree checkpoint (replaces dump_restart,
        dump.cxx:333-556)."""
        meta = dict(step_count=self.step_count,
                    opts=dataclasses.asdict(self.opts))
        meta.update(extra or {})
        out = ckpt.save_checkpoint(path, self.state, self.grid, meta)
        if self._traj is not None:
            # tracer trajectories survive a quota kill
            # (dump_tracer_restart, tracer.cxx:199-253)
            self._traj.save_npz(str(path) + ".traj.npz")
        return out

    def restore(self, path):
        """Load a checkpoint saved by :meth:`checkpoint` into this
        (identically configured) simulation."""
        import os

        from ..io import tracers as iotracers

        meta = ckpt.load_meta(path)
        self.state = ckpt.load_checkpoint(path, self.state)
        self.step_count = meta["extra"].get("step_count",
                                            int(self.state.step))
        tr = str(path) + ".traj.npz"
        if os.path.exists(tr):
            self._traj = iotracers.TrajectoryAccumulator.load_npz(tr)
        return self.state

    def modify_runparams(self, **kw):
        """Runtime overrides without re-finalizing physics state
        (modify_runparams, dump.cxx:824-890): num_step, intervals, etc."""
        opt_fields = {f.name for f in dataclasses.fields(self.opts)}
        opt_kw = {k: v for k, v in kw.items() if k in opt_fields}
        if "num_step" in kw:
            self.num_step = kw["num_step"]
        if opt_kw:
            self.opts = dataclasses.replace(self.opts, **opt_kw)
            self._rebuild_advance()

    def _rebuild_advance(self):
        """(Re)build the advance executables from the current opts —
        shared by finalize and modify_runparams so a --modfile rebuild
        keeps boundary handlers, emitters, and the resort cycle."""
        g = self.grid
        handlers = tuple(self._boundary_handlers)
        emitters = tuple(self._emitters)
        if g.is_multishard:
            self._advance_fn = dist.make_distributed_advance(
                g, self.mesh, opts=self.opts,
                boundary_handlers=handlers, emitters=emitters,
                **self._hooks)
        else:
            self._advance_fn = jax.jit(make_advance(
                g, self.comm, pcomm=None, opts=self.opts,
                boundary_handlers=handlers, emitters=emitters,
                **self._hooks), donate_argnums=0)
        self._build_cycle(g, self._hooks)
