"""vpic_tpu — a JAX/XLA relativistic electromagnetic particle-in-cell
framework with the capabilities of VPIC 3.1.2.1 (pdlfs/old-vpic).

This is a from-scratch re-design, not a port: the compute path is jitted
JAX over SoA pytrees, domain decomposition is a `jax.sharding.Mesh` +
`shard_map` with collectives between devices, and the deck DSL is a Python
configuration API with the same vocabulary as the reference's compile-time
decks (reference: src/vpic/vpic.hxx:126-555).

Physics per step (reference: src/vpic/advance.cxx:13-244):
  clear accumulators -> sort -> collisions -> advance_p (Boris push +
  charge-conserving current deposition) -> boundary/migration rounds ->
  unload currents -> advance_b(1/2) -> advance_e -> advance_b(1/2) ->
  periodic Marder divergence cleaning + shared-face sync -> load
  interpolator -> diagnostics.
"""

import os as _os

import jax as _jax

# fp64 is required for the reference's double-precision reductions
# (src/species_advance/standard/energy_p.cxx:113-116) and init-time
# coordinate math (src/vpic/misc.cxx:47-75).  All bulk state remains fp32;
# every array constructor in this package passes an explicit dtype.
_jax.config.update("jax_enable_x64", True)


def configure_compile_cache(environ=_os.environ):
    """Keep compiled executables across processes (the advance graph takes
    minutes to compile).  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
    reads it itself and nothing is set here; otherwise the cache lives at
    the fixed path ``<checkout>/.jax_cache``.  Returns the directory set,
    or None."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    path = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")
    _jax.config.update("jax_compilation_cache_dir", path)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return path


configure_compile_cache()

__version__ = "0.1.0"

from .core.types import (  # noqa: E402
    Grid,
    FieldState,
    SpeciesState,
    MaterialTable,
    SimState,
)
from .deck.api import Simulation  # noqa: E402

__all__ = [
    "Grid",
    "FieldState",
    "SpeciesState",
    "MaterialTable",
    "SimState",
    "Simulation",
]
