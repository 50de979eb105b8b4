"""Core pytree state types.

Re-design of the reference's core structs for JAX:

- ``field_t`` (16 floats + 8 material ids per voxel,
  src/field_advance/field_advance.h:56-171) becomes :class:`FieldState`, a
  pytree of separate dense ``(nz+2, ny+2, nx+2)`` float32 arrays (structure of
  arrays; x is the fastest/lane dimension).
- ``particle_t`` AoS (src/species_advance/species_advance.h:28-34) becomes
  :class:`SpeciesState`, an SoA pytree with a fixed capacity ``max_np`` and a
  traced live count ``np`` (XLA requires static shapes; dead slots carry
  ``q = 0`` and voxel 0 so they are exact no-ops in every kernel).
- ``grid_t`` (src/grid/grid.h:112-167) splits into the static, hashable
  :class:`Grid` (jit-constant geometry/units/topology) and the device-resident
  :class:`GridArrays` (the per-cell 6-neighbor table).

Voxel linear index convention matches the reference's FORTRAN indexing
(src/util/util_base.h:158-161): ``i = x + (nx+2)*(y + (ny+2)*z)``, which is
exactly C-order flattening of an ``[z, y, x]`` array.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Boundary condition codes
# ---------------------------------------------------------------------------

# Field boundary conditions on a domain face (reference: grid.h:57-66).
ANTI_SYMMETRIC_FIELDS = PEC_FIELDS = METAL_FIELDS = -1
SYMMETRIC_FIELDS = -2
PMC_FIELDS = -3
ABSORB_FIELDS = -4
PERIODIC_FIELDS = -5   # self-join of a face (single shard along that axis)
REMOTE_FIELDS = -6     # face joined to a neighboring shard (halo exchange)

# Particle boundary interactions encoded in the local neighbor table.
# (reference encodes these as negative "global ids", grid.h:68-69; we use a
# local int32 encoding since shards never need global voxel ids)
NEIGHBOR_REFLECT = -1          # reflect_particles
NEIGHBOR_ABSORB = -2           # absorb_particles
# -3 - face: particle leaves through `face` to the neighboring shard
NEIGHBOR_MIGRATE_BASE = -3
# <= -9: custom boundary handler id = -(code + 9)
NEIGHBOR_CUSTOM_BASE = -9

# Face numbering (matches move_p's neighbor[6*i + (v0>0 ? 3 : 0) + type],
# src/species_advance/standard/move_p.c:123):
#   0,1,2 = low x, low y, low z faces;  3,4,5 = high x, high y, high z.
FACE_LOW_X, FACE_LOW_Y, FACE_LOW_Z = 0, 1, 2
FACE_HIGH_X, FACE_HIGH_Y, FACE_HIGH_Z = 3, 4, 5

# Face index -> (physical axis, direction)
FACE_AXIS = (0, 1, 2, 0, 1, 2)
FACE_DIR = (-1, -1, -1, 1, 1, 1)


def register_dataclass(cls=None, *, meta: tuple = ()):
    """Register a dataclass as a pytree with the given static (meta) fields."""
    if cls is None:
        return partial(register_dataclass, meta=meta)
    fields = [f.name for f in dataclasses.fields(cls)]
    data = tuple(f for f in fields if f not in meta)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls


# ---------------------------------------------------------------------------
# Grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static (hashable, jit-constant) grid geometry, units and topology.

    Mirrors the scalar part of ``grid_t`` (src/grid/grid.h:112-167) for ONE
    shard; the same Grid is shared by every shard in SPMD style, and the
    per-shard origin is derived from the mesh coordinates at trace time.
    """

    # Local (per-shard) cell counts.
    nx: int
    ny: int
    nz: int
    # System of units.
    dt: float = 1.0
    cvac: float = 1.0
    eps0: float = 1.0
    damp: float = 0.0
    # Global domain corners.
    gx0: float = 0.0
    gy0: float = 0.0
    gz0: float = 0.0
    gx1: float = 1.0
    gy1: float = 1.0
    gz1: float = 1.0
    # Process/device topology (shards per axis).
    gpx: int = 1
    gpy: int = 1
    gpz: int = 1
    # Field boundary condition per global face (order: -x,-y,-z,+x,+y,+z).
    # PERIODIC_FIELDS means the global axis wraps.
    fbc: tuple = (PERIODIC_FIELDS,) * 6
    # Particle boundary condition per global face: one of NEIGHBOR_REFLECT,
    # NEIGHBOR_ABSORB, PERIODIC_FIELDS (wrap), or a custom handler code.
    pbc: tuple = (PERIODIC_FIELDS,) * 6
    # Custom interdomain wiring (the join_domain analogue,
    # vpic.hxx:313-331 / grid/ops.c): join[face] is None (default Cartesian
    # ring) or a tuple where join[face][s] = axis index of the shard
    # adjacent through ``face`` for the shard at axis position s.  Both
    # directions must be wired consistently (join[f][s] = t <=>
    # join[OPP[f]][t] = s).  Joined faces are fully interior: migration +
    # field halos ride the custom permutation and local BCs never apply.
    join: tuple = (None,) * 6

    # -- derived geometry (global cells = local cells * shards per axis) -----
    @property
    def gnx(self) -> int:
        return self.nx * self.gpx

    @property
    def gny(self) -> int:
        return self.ny * self.gpy

    @property
    def gnz(self) -> int:
        return self.nz * self.gpz

    @property
    def dx(self) -> float:
        return (self.gx1 - self.gx0) / self.gnx

    @property
    def dy(self) -> float:
        return (self.gy1 - self.gy0) / self.gny

    @property
    def dz(self) -> float:
        return (self.gz1 - self.gz0) / self.gnz

    @property
    def rdx(self) -> float:
        return 1.0 / self.dx

    @property
    def rdy(self) -> float:
        return 1.0 / self.dy

    @property
    def rdz(self) -> float:
        return 1.0 / self.dz

    @property
    def nxg(self) -> int:  # padded (ghosted) extents
        return self.nx + 2

    @property
    def nyg(self) -> int:
        return self.ny + 2

    @property
    def nzg(self) -> int:
        return self.nz + 2

    @property
    def nv(self) -> int:
        """Number of voxels including ghosts (= (nx+2)(ny+2)(nz+2))."""
        return self.nxg * self.nyg * self.nzg

    @property
    def shape(self) -> tuple:
        """Ghosted array shape, ``[z, y, x]`` order."""
        return (self.nzg, self.nyg, self.nxg)

    @property
    def is_multishard(self) -> bool:
        return self.gpx * self.gpy * self.gpz > 1

    def voxel(self, x, y, z):
        """Linear voxel index (works on ints or arrays)."""
        return x + self.nxg * (y + self.nyg * z)

    def face_bc(self, face: int, axis_shards: int):
        """Effective local BC on a local face: REMOTE_FIELDS when the face
        touches another shard, otherwise the configured global-face BC."""
        if axis_shards > 1:
            return REMOTE_FIELDS
        return self.fbc[face]

    def courant_length(self) -> float:
        """Reference: vpic.hxx:537-544."""
        import math

        w = 0.0
        if self.gnx > 1:
            w += self.rdx ** 2
        if self.gny > 1:
            w += self.rdy ** 2
        if self.gnz > 1:
            w += self.rdz ** 2
        return 1.0 / math.sqrt(w)


# ---------------------------------------------------------------------------
# Device-resident grid data
# ---------------------------------------------------------------------------


@register_dataclass
@dataclasses.dataclass
class GridArrays:
    """Per-cell particle-boundary neighbor table (device array).

    ``neighbor[i, f]`` for face f of voxel i is either a local destination
    voxel (>= 0) or a negative boundary code (see NEIGHBOR_*).  Mirrors
    ``grid_t::neighbor`` (grid.h:149-154) with local int32 encoding.
    """

    neighbor: jax.Array  # (nv, 6) int32


# ---------------------------------------------------------------------------
# Fields
# ---------------------------------------------------------------------------

_FIELD_COMPONENTS = (
    "ex", "ey", "ez", "div_e_err",
    "cbx", "cby", "cbz", "div_b_err",
    "tcax", "tcay", "tcaz", "rhob",
    "jfx", "jfy", "jfz", "rhof",
)


@register_dataclass
@dataclasses.dataclass
class FieldState:
    """Yee-mesh electromagnetic field state (SoA re-design of ``field_t``,
    src/field_advance/field_advance.h:56-171; staggering is documented there:
    ex on x-edges, cbx on x-faces, rho on nodes, etc.).

    Every component is a float32 array of shape ``(nz+2, ny+2, nx+2)``.
    ``cb*`` store c*B like the reference.  ``tca*`` is the TCA radiation
    damping accumulator; ``rhob`` bound charge; ``jf*``/``rhof`` free
    current/charge deposited fresh each step.
    """

    ex: jax.Array
    ey: jax.Array
    ez: jax.Array
    div_e_err: jax.Array
    cbx: jax.Array
    cby: jax.Array
    cbz: jax.Array
    div_b_err: jax.Array
    tcax: jax.Array
    tcay: jax.Array
    tcaz: jax.Array
    rhob: jax.Array
    jfx: jax.Array
    jfy: jax.Array
    jfz: jax.Array
    rhof: jax.Array

    @classmethod
    def zeros(cls, g: Grid) -> "FieldState":
        z = jnp.zeros(g.shape, dtype=jnp.float32)
        return cls(**{k: z for k in _FIELD_COMPONENTS})

    def replace(self, **kw) -> "FieldState":
        return dataclasses.replace(self, **kw)


@register_dataclass
@dataclasses.dataclass
class MaterialGrid:
    """Per-voxel material ids (``field_t``'s emat/nmat/fmat/cmat bytes).
    ``None`` in :class:`SimState` means single-material (vacuum-style) fast
    path — the reference's sfa/vfa split (standard/vacuum/vfa.c)."""

    ematx: jax.Array  # (nz+2, ny+2, nx+2) int32
    ematy: jax.Array
    ematz: jax.Array
    nmat: jax.Array
    fmatx: jax.Array
    fmaty: jax.Array
    fmatz: jax.Array
    cmat: jax.Array

    @classmethod
    def zeros(cls, g: Grid) -> "MaterialGrid":
        z = jnp.zeros(g.shape, dtype=jnp.int32)
        return cls(z, z, z, z, z, z, z, z)


@register_dataclass
@dataclasses.dataclass
class MaterialTable:
    """Precomputed per-material FDTD coefficients
    (``material_coefficient_t``; computed per standard/sfa.c:138-174)."""

    decayx: jax.Array  # (n_mat,) float32 each
    decayy: jax.Array
    decayz: jax.Array
    drivex: jax.Array
    drivey: jax.Array
    drivez: jax.Array
    rmux: jax.Array
    rmuy: jax.Array
    rmuz: jax.Array
    nonconductive: jax.Array
    epsx: jax.Array
    epsy: jax.Array
    epsz: jax.Array

    @property
    def n_mat(self) -> int:
        return self.decayx.shape[0]


# ---------------------------------------------------------------------------
# Particles
# ---------------------------------------------------------------------------


@register_dataclass(meta=("name", "sid", "max_np", "sort_interval",
                          "has_tags", "uniform_q"))
@dataclasses.dataclass
class SpeciesState:
    """One particle species (SoA, fixed capacity).

    Mirrors ``species_t`` + its particle array
    (src/species_advance/species_advance.h:28-93).  ``dx,dy,dz`` are
    cell-relative positions in [-1,1]; ``i`` the local voxel; ``ux,uy,uz``
    normalized momenta (gamma*beta); ``q`` the per-particle charge (charge *
    statistical weight).  Slots >= ``np`` are dead: q=0, i=0.
    """

    name: str
    sid: int
    max_np: int
    sort_interval: int

    q_m: jax.Array          # charge/mass ratio (scalar f32)
    np: jax.Array           # live particle count (scalar int32)
    nm: jax.Array           # unfinished-mover count, mirrors sp->nm (int32)
    dx: jax.Array           # (max_np,) f32
    dy: jax.Array
    dz: jax.Array
    i: jax.Array            # (max_np,) int32
    ux: jax.Array
    uy: jax.Array
    uz: jax.Array
    q: jax.Array
    # residual half-displacement for particles awaiting boundary processing
    # (the mover list, species_advance.h:39-42, folded into the SoA)
    mdx: jax.Array
    mdy: jax.Array
    mdz: jax.Array
    # per-particle boundary status: 0 = settled, 1 = walker exhausted,
    # negative = the neighbor-table boundary code pending resolution
    pc: jax.Array
    # tracer identification tag (particle_t::tag, species_advance.h:33;
    # 0 for untagged particles)
    tag: jax.Array

    # Static sort-payload hints, set at finalize time (deck/api.py):
    # has_tags=False means every tag is (and stays) 0, so sort_p need not
    # carry the tag column; uniform_q=True means all live particles share
    # one charge-weight (and nothing injects differing weights), so sort_p
    # reconstructs q from a single scalar instead of permuting the column.
    has_tags: bool = True
    uniform_q: bool = False

    @classmethod
    def create(cls, name: str, sid: int, q_m: float, max_np: int,
               sort_interval: int = 0, has_tags: bool = True,
               uniform_q: bool = False) -> "SpeciesState":
        zf = jnp.zeros((max_np,), dtype=jnp.float32)
        zi = jnp.zeros((max_np,), dtype=jnp.int32)
        return cls(
            name=name, sid=sid, max_np=max_np, sort_interval=sort_interval,
            q_m=jnp.float32(q_m), np=jnp.int32(0), nm=jnp.int32(0),
            dx=zf, dy=zf, dz=zf, i=zi, ux=zf, uy=zf, uz=zf, q=zf,
            mdx=zf, mdy=zf, mdz=zf, pc=zi, tag=zi,
            has_tags=has_tags, uniform_q=uniform_q,
        )

    def replace(self, **kw) -> "SpeciesState":
        return dataclasses.replace(self, **kw)

    @property
    def alive(self) -> jax.Array:
        """(max_np,) bool mask of live slots.  Slots past ``np`` are free;
        slots with ``i < 0`` are zombies (killed by absorption, reclaimed at
        the next sort/compaction — the fixed-capacity analogue of the
        reference's backfill delete, boundary_p.c:221-266)."""
        return (
            jnp.arange(self.max_np, dtype=jnp.int32) < self.np
        ) & (self.i >= 0)


# ---------------------------------------------------------------------------
# Whole-simulation state
# ---------------------------------------------------------------------------


@register_dataclass
@dataclasses.dataclass
class SimState:
    """Everything that evolves across a step — a pure pytree, so the whole
    advance() is one jitted ``SimState -> SimState`` function and checkpoints
    are plain serialized pytrees (no function-pointer hacks; contrast
    dump.cxx:333-556)."""

    field: FieldState
    interpolator: jax.Array          # (nv, 18) f32, layout below
    species: tuple                   # tuple[SpeciesState, ...]
    grid_arrays: GridArrays
    materials: MaterialTable
    material_grid: Optional[MaterialGrid]
    rng: jax.Array                   # jax.random key
    step: jax.Array                  # scalar int32
    # per-custom-boundary-handler state pytrees (tally counters, link ring
    # buffers, ...; boundary/models.py), () when no handlers registered
    boundary_state: tuple = ()


# Interpolator component layout, matching interpolator_t order
# (src/sf_interface/sf_interface.h:45-58):
IP = dict(
    ex=0, dexdy=1, dexdz=2, d2exdydz=3,
    ey=4, deydz=5, deydx=6, d2eydzdx=7,
    ez=8, dezdx=9, dezdy=10, d2ezdxdy=11,
    cbx=12, dcbxdx=13,
    cby=14, dcbydy=15,
    cbz=16, dcbzdz=17,
)
N_IP = 18


def vacuum_material_table() -> MaterialTable:
    """Single vacuum material (eps=mu=1, sigma=0): decay=1, drive=1, rmu=1."""
    one = jnp.ones((1,), dtype=jnp.float32)
    return MaterialTable(
        decayx=one, decayy=one, decayz=one,
        drivex=one, drivey=one, drivez=one,
        rmux=one, rmuy=one, rmuz=one,
        nonconductive=one, epsx=one, epsy=one, epsz=one,
    )
