"""High-resolution inference on one card: row tiles, their presets and the
non-Lambertian mask.  The JAX package's multi-device parts (`mesh`, `halo`,
`spatial`, `ring_corr`, `multihost`) are not ported yet."""
from stereoanywhere_tpu_torch.parallel.tiles import TileParallelInference  # noqa: F401
