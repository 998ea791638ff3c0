"""Plain PyTorch numerics of the stereo pipeline; `ops/cuda/` holds the
hand-written kernels."""
