"""The render kernel K1's share of its roofline: the least time for the
traced launches' work (counts/k1_bound.py, on each launch's operands) over
their device time."""


def read(r):
    n, t = r.trace.kernel_time("render_kernel")
    if r.rate_metric != "env_steps_per_s" or not n or not t or r.k1 is None:
        return None
    bound, launches = r.k1
    return 100.0 * (bound / launches) / (t / n)
