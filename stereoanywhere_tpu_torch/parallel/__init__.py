"""High-resolution inference: row tiles on one card (`tiles`, with their
presets and the non-Lambertian mask) and exact row sharding over the ranks
of a mesh (`mesh`, `halo`, `spatial`, and the ring correlation,
`ring_corr`); training over several processes (`multihost`)."""

_LAZY = {
    "TileParallelInference": "tiles",
    "RowShardedInference": "spatial",
    "make_mesh": "mesh",
    "halo_exchange": "halo",
}


def __getattr__(name):
    # lazily: the model imports `multihost` and `halo`, and `tiles` imports
    # the model
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
