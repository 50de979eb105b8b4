"""Checkpoint / restart.

Replaces the reference's full-binary-state restart dump
(src/vpic/dump.cxx:333-822 — which serialized raw structs *including a
function-pointer table*, repaired offline by utilities/restart_remap.cxx)
with a versioned pytree checkpoint: every SimState leaf as an npz entry +
a JSON sidecar holding the static Grid/species metadata.  Keeps the deck
workflow semantics: two-slot rotation (restart1/restart2 ping-pong with
rtoggle, decks/trecon-part/turbulence.cxx:1148-1247) and quota-triggered
final dump.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import jax
import numpy as np

from ..core.types import Grid, SimState

# v2: load_checkpoint validates leaf shapes and pads 1-D particle leaves
# up to a larger template capacity (define_species rounds max_np to a
# 1024 multiple since r3; older checkpoints carry unaligned capacities).
# v3: GridArrays carried a second static table; v4 holds the neighbor
# table alone, so v3 checkpoints fail the leaf-count check with a clear
# error (rebuild from the deck).
FORMAT_VERSION = 4


def _flatten(state: SimState):
    leaves, treedef = jax.tree.flatten(state)
    return leaves, treedef


def save_checkpoint(path, state: SimState, g: Grid, extra: dict = None):
    """Write one checkpoint file (npz + json header)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = _flatten(state)
    arrays = {}
    for k, leaf in enumerate(leaves):
        if jax.dtypes.issubdtype(getattr(leaf, "dtype", None),
                                 jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
            arrays[f"key_{k}"] = np.asarray(leaf)
        else:
            arrays[f"leaf_{k}"] = np.asarray(leaf)
    np.savez(str(path) + ".npz", **arrays)
    meta = dict(
        version=FORMAT_VERSION,
        grid=dataclasses.asdict(g),
        species=[dict(name=sp.name, sid=sp.sid, max_np=sp.max_np,
                      sort_interval=sp.sort_interval)
                 for sp in state.species],
        n_leaves=len(leaves),
        time=time.time(),
        extra=extra or {},
    )
    with open(str(path) + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_checkpoint(path, template: SimState):
    """Load a checkpoint into the structure of ``template`` (a freshly
    built SimState with identical configuration).

    Leaf shapes are validated against the template (the reference restart
    reader ABORTs on every size/dim mismatch, dump.cxx:566-797).  One
    mismatch is repaired instead of rejected: a 1-D leaf SHORTER than the
    template's (a particle column saved before/after a max_np capacity
    change, e.g. the r3 1024-alignment of define_species) is zero-padded
    at the tail — dead slots are exactly q=0/i=0, and ``np`` (a saved
    scalar leaf) still bounds the live range."""
    data = np.load(str(path) + ".npz")
    leaves, treedef = _flatten(template)
    n_saved = sum(1 for k in data.files)
    if n_saved != len(leaves):
        raise ValueError(
            f"checkpoint {path} has {n_saved} leaves but the deck builds "
            f"{len(leaves)} — the configuration (species/fields/handlers) "
            "does not match the one that wrote it")
    out = []
    for k, leaf in enumerate(leaves):
        if f"key_{k}" in data:
            out.append(jax.random.wrap_key_data(data[f"key_{k}"]))
            continue
        arr = data[f"leaf_{k}"]
        want = tuple(getattr(leaf, "shape", ()) or ())
        have = tuple(arr.shape)
        if have != want:
            if (len(have) == 1 and len(want) == 1 and have[0] < want[0]):
                arr = np.concatenate(
                    [arr, np.zeros((want[0] - have[0],), arr.dtype)])
            else:
                raise ValueError(
                    f"checkpoint {path} leaf {k}: saved shape {have} vs "
                    f"deck shape {want} — capacity or grid mismatch "
                    "(rebuild the deck with the saved metadata: "
                    "see load_meta())")
        out.append(jax.numpy.asarray(arr))
    return jax.tree.unflatten(treedef, out)


def load_meta(path):
    with open(str(path) + ".json") as f:
        return json.load(f)


class RotatingCheckpointer:
    """Two-slot rotating restart sets + wall-clock quota self-termination
    (the deck-side defensive checkpoint pattern,
    turbulence.cxx:1148-1247)."""

    def __init__(self, base_dir, quota_hours: float = None):
        self.base = Path(base_dir)
        self.rtoggle = 0
        self.t0 = time.time()
        self.quota = quota_hours * 3600.0 if quota_hours else None

    def save(self, state: SimState, g: Grid, extra=None):
        slot = self.base / f"restart{self.rtoggle + 1}" / "restart"
        save_checkpoint(slot, state, g, extra)
        self.rtoggle ^= 1
        return slot

    def over_quota(self) -> bool:
        return self.quota is not None and (time.time() - self.t0) > self.quota

    def latest(self):
        cands = []
        for slot in (self.base / "restart1", self.base / "restart2"):
            j = slot / "restart.json"
            if j.exists():
                cands.append((j.stat().st_mtime, slot / "restart"))
        if not cands:
            return None
        return max(cands)[1]
