"""Multi-chip SPMD engine: the whole advance() under shard_map over a
('z','y','x') device mesh.

Re-design of the reference's 3D "superhexahedral" domain decomposition
(src/grid/partition.c:36-85 + the mp/MPI layer): every shard runs the same
per-shard program; field halos and particle migration ride
``lax.ppermute`` rings between devices (comm/facecomm.ShardComm), and reductions
are ``lax.psum``.

Distributed state layout: every SimState leaf gains three leading shard axes
(pz, py, px) and is sharded over the mesh; inside shard_map the block of
shape (1,1,1, ...) is squeezed back to the per-shard shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..comm.facecomm import ShardComm
from ..core.types import Grid, SimState
from .step import StepOptions, make_advance


AXIS_NAMES = ("z", "y", "x")  # mesh axis order (z outermost)


def make_mesh(g: Grid, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = g.gpx * g.gpy * g.gpz
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    dev = np.asarray(devices[:n]).reshape(g.gpz, g.gpy, g.gpx)
    return Mesh(dev, AXIS_NAMES)


def _axis_names_for(g: Grid):
    """Physical axis -> mesh axis name (None when unsharded)."""
    return (
        "x" if g.gpx > 1 else None,
        "y" if g.gpy > 1 else None,
        "z" if g.gpz > 1 else None,
    )


def stack_shards(per_shard_states, g: Grid):
    """Stack a [pz][py][px] nested list of per-shard SimStates into one
    distributed state with leading (pz,py,px) axes on every leaf."""
    flat = [s for plane in per_shard_states for row in plane for s in row]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs).reshape(
        (g.gpz, g.gpy, g.gpx) + xs[0].shape), *flat)
    return stacked


def shard_state(state, mesh: Mesh):
    """Place a stacked distributed state onto the mesh."""
    sharding = NamedSharding(mesh, P(*AXIS_NAMES))
    return jax.tree.map(
        lambda a: jax.device_put(a, sharding), state)


def make_distributed_advance(g: Grid, mesh: Mesh,
                             opts: StepOptions = StepOptions(), **hooks):
    """Build the jitted multi-shard advance: distributed SimState ->
    distributed SimState."""
    names = _axis_names_for(g)
    comm = ShardComm(g, axis_names=names)
    adv = make_advance(g, comm, pcomm=comm, opts=opts, **hooks)

    def per_shard(state):
        state = jax.tree.map(lambda a: a.reshape(a.shape[3:]), state)
        state = adv(state)
        return jax.tree.map(lambda a: a.reshape((1, 1, 1) + a.shape), state)

    spec = P(*AXIS_NAMES)
    fn = jax.shard_map(per_shard, mesh=mesh,
                       in_specs=spec, out_specs=spec, check_vma=False)
    return jax.jit(fn)


def make_distributed_hydro(g: Grid, mesh: Mesh, sid: int):
    """Per-shard hydro moments with shared-face synchronization over the
    mesh (the reference always merges shared faces before a hydro dump,
    sf_interface.h:156-163).  Returns (pz,py,px,nv,14)."""
    from ..particles import aux as paux
    from ..sf import hydro as sfhydro

    names = _axis_names_for(g)
    comm = ShardComm(g, axis_names=names)

    def per_shard(state):
        state = jax.tree.map(lambda a: a.reshape(a.shape[3:]), state)
        hy = sfhydro.clear_hydro(g)
        hy = paux.accumulate_hydro_p(hy, state.species[sid],
                                     state.interpolator, g)
        hy = sfhydro.synchronize_hydro(hy, g, comm)
        return hy.reshape((1, 1, 1) + hy.shape)

    spec = P(*AXIS_NAMES)
    fn = jax.shard_map(per_shard, mesh=mesh,
                       in_specs=spec, out_specs=spec, check_vma=False)
    return jax.jit(fn)


def make_distributed_init(g: Grid, mesh: Mesh):
    from .init import initialize_state

    names = _axis_names_for(g)
    comm = ShardComm(g, axis_names=names)

    def per_shard(state):
        state = jax.tree.map(lambda a: a.reshape(a.shape[3:]), state)
        state = initialize_state(state, g, comm)
        return jax.tree.map(lambda a: a.reshape((1, 1, 1) + a.shape), state)

    spec = P(*AXIS_NAMES)
    fn = jax.shard_map(per_shard, mesh=mesh,
                       in_specs=spec, out_specs=spec, check_vma=False)
    return jax.jit(fn)
