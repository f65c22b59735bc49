"""The plain reference that decides ``correct``: PyTorch and NumPy only.

It imports neither JAX nor the JAX package nor anything of the port
(``gabril_carla_tpu_torch``). Where it needs one of the port's functions it
uses a frozen copy under ``frozen/``. It takes the inputs the benchmark made
(weights, batches, worlds, keys) and re-derives everything the port derived
from them; it reads the port's outputs only to judge them.
"""
