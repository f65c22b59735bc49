"""The share of the traced labeled ticks in which no operation runs on the
device."""


def read(r):
    if r.rate_metric != "env_steps_per_s":
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
