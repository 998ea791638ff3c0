"""Weights carried across: reference PyTorch checkpoints (`torch_checkpoint`),
the JAX package's variable trees (`from_jax`) and flax's msgpack files
(`msgpack`)."""
