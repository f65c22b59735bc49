"""Device ms a tick of the kernels launched inside the harness's
``drivebench.env_step`` span (drivers/rollout.py Taps), over the traced
ticks."""


def read(r):
    s = r.trace.span_s.get("env_step")
    if r.rate_metric != "env_steps_per_s" or not s:
        return None
    return 1e3 * s / r.trace.units
