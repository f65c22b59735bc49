"""Device ms a tick of the kernels launched inside the harness's
``drivebench.heat`` span (drivers/rollout.py Taps), over the traced
ticks."""


def read(r):
    s = r.trace.span_s.get("heat")
    if r.rate_metric != "env_steps_per_s" or not s:
        return None
    return 1e3 * s / r.trace.units
