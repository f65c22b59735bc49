"""The share of the traced train steps in which no operation runs on the
device."""


def read(r):
    if r.rate_metric != "train_samples_per_s":
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
