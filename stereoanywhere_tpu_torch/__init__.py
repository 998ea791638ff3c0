"""StereoAnywhere in PyTorch for NVIDIA Hopper.

The port of the JAX package `stereoanywhere_tpu`, which stays the reference.
Plain tensor code is PyTorch; the functions the JAX package computes with
Pallas TPU kernels are CUDA kernels written for sm_90a (`csrc/`, bound in
`ops/cuda/`).  Layouts: NCHW inside the modules, NHWC at the public entry
points, as in the JAX package.
"""
from stereoanywhere_tpu_torch.config import MonoConfig, StereoAnywhereConfig  # noqa: F401
