"""PyTorch/CUDA port of gabril_carla_tpu.

Mirrors the JAX package module for module (env, ops, models, train, eval,
data) and imports nothing of it, nor of JAX. The simulator is batched over a
leading world axis; the camera renderer runs a hand-written CUDA kernel
(csrc/render.cu) on CUDA tensors and its plain PyTorch version on CPU ones.
BC training (train/) runs all 8 gaze x 4 dropout methods with cuDNN and
cuBLAS doing the convolutions and matmuls; the gaze predictor (AutoEncoder
or UNet) trains beside it and feeds heat to the closed-loop evaluation
(eval/), which writes stats.json per route and seed (cli/eval_routes.py).
"""
