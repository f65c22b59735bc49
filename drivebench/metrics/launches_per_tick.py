"""Kernels launched a tick in the traced ticks."""


def read(r):
    if r.rate_metric != "env_steps_per_s" or not r.trace.kernels:
        return None
    return len(r.trace.kernels) / r.trace.units
