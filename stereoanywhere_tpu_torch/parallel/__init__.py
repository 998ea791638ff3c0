"""High-resolution inference on one card (row tiles, their presets and the
non-Lambertian mask) and training over several processes (`multihost`).
The JAX package's row-sharded parts (`halo`, `spatial`, `ring_corr` and the
tile axis of `mesh`) are not ported yet."""


def __getattr__(name):
    # lazily: the model imports `multihost`, and `tiles` imports the model
    if name == "TileParallelInference":
        from stereoanywhere_tpu_torch.parallel.tiles import TileParallelInference
        return TileParallelInference
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
