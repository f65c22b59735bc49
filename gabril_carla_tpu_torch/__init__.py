"""PyTorch/CUDA port of gabril_carla_tpu.

Mirrors the JAX package module for module (env, ops, models, train, eval)
and imports nothing of it, nor of JAX. Everything is batched over a leading
world axis; the camera renderer runs a hand-written CUDA kernel
(csrc/render.cu) on CUDA tensors and its plain PyTorch version on CPU ones.
"""
