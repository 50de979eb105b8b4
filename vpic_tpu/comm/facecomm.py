"""Face-neighbor exchange strategy.

Re-designs the reference's mp port layer (src/grid/grid_comm.c:6-78 +
src/util/mp/) for XLA: an exchange is a pure function from per-face payload
pytrees to per-face received pytrees.  Pairing follows the reference's port
convention: the value received at face ``f`` is the payload our face-``f``
neighbor sent through its opposite face (grid_comm.c: sender =
bc[BOUNDARY(-i,-j,-k)]).

- :class:`LocalComm`: single shard along an axis — a periodic (self-joined)
  face receives our own opposite-face payload; unjoined faces receive None
  (local BCs handle them).
- :class:`ShardComm`: inside ``shard_map`` — joined faces are a
  ``lax.ppermute`` ring per mesh axis (neighbor exchange between devices).
"""

from __future__ import annotations

import jax
from jax import lax

from ..core.types import Grid, PERIODIC_FIELDS, FACE_AXIS, FACE_DIR

OPP = (3, 4, 5, 0, 1, 2)


class LocalComm:
    """Single-device (or single shard per axis) exchange."""

    def __init__(self, g: Grid):
        self.g = g

    def joined(self, face: int) -> bool:
        ax = FACE_AXIS[face]
        shards = (self.g.gpx, self.g.gpy, self.g.gpz)[ax]
        if shards > 1:
            raise NotImplementedError("use ShardComm for multishard axes")
        return self.g.fbc[face] == PERIODIC_FIELDS

    def exchange(self, payloads: dict) -> dict:
        recv = {}
        for f, payload in payloads.items():
            recv[f] = payloads[OPP[f]] if self.joined(f) else None
        return recv

    def allsum(self, x):
        """mp_allsum_d analogue (mp.h collectives) — identity on one shard."""
        return x


class ShardComm:
    """Exchange inside shard_map over a ('z','y','x') device mesh.

    ``axis_names[a]`` is the mesh axis name for physical axis a (None if the
    axis is unsharded).  Global-boundary faces of non-periodic axes still
    receive the wrapped payload from the ring; callers mask them using
    :meth:`is_global_boundary`.
    """

    def __init__(self, g: Grid, axis_names=(None, None, None)):
        self.g = g
        self.axis_names = axis_names

    def _shards(self, ax: int) -> int:
        return (self.g.gpx, self.g.gpy, self.g.gpz)[ax]

    def joined(self, face: int) -> bool:
        ax = FACE_AXIS[face]
        if self._shards(ax) > 1:
            return True
        return self.g.fbc[face] == PERIODIC_FIELDS

    def is_global_boundary(self, face: int):
        """Traced bool: this shard's face is on the global domain boundary
        of a non-periodic axis (=> local BC applies instead of the recv).
        Faces wired by join_domain are fully interior everywhere."""
        if self.g.join[face] is not None:
            return False
        ax = FACE_AXIS[face]
        n = self._shards(ax)
        if self.g.fbc[face] == PERIODIC_FIELDS:
            return False
        name = self.axis_names[ax]
        if name is None or n == 1:
            return True
        idx = lax.axis_index(name)
        return (idx == 0) if FACE_DIR[face] < 0 else (idx == n - 1)

    def exchange(self, payloads: dict) -> dict:
        recv = {}
        for f, payload in payloads.items():
            if not self.joined(f):
                recv[f] = None
                continue
            ax = FACE_AXIS[f]
            n = self._shards(ax)
            name = self.axis_names[ax]
            if n == 1 or name is None:
                recv[f] = payloads[OPP[f]]
                continue
            join = self.g.join[f]
            if join is not None:
                # join_domain wiring (vpic.hxx:313-331): shard s receives
                # from join[s] (its neighbor through face f), which sends
                # its face-OPP[f] payload
                perm = [(join[s], s) for s in range(n)]
            # recv[f] must come from our neighbor at face f, who sends its
            # payloads[OPP[f]].  Data therefore flows opposite to the face
            # direction: for a high face, shard s receives from s+1.
            elif FACE_DIR[f] > 0:
                perm = [(s, (s - 1) % n) for s in range(n)]
            else:
                perm = [(s, (s + 1) % n) for s in range(n)]
            recv[f] = lax.ppermute(payloads[OPP[f]], name, perm)
        return recv

    def allsum(self, x):
        names = tuple(n for n in self.axis_names if n is not None)
        if not names:
            return x
        return lax.psum(x, names)
