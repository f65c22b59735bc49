"""Frozen copies of the port's modules that the plain reference needs.

Each file here is the port's module of the same path
(``gabril_carla_tpu_torch/<path>``) as it stood when the benchmark was
written, with its relative imports kept and every CUDA kernel path taken
out: ``ops/render_kernel.py`` holds only the render kernel's plain version
and ``data/vendored.py`` reads the repository's raw route files by path.
Nothing here imports the port, so a later change to the port is held
against the code it replaced. Run in float32 with TF32 off.
"""
