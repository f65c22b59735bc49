"""The closed-loop tick's share of the card's peak: the policy's (and the
UNet's, where it gives the heat) convolution and matrix FLOPs
(counts/flops.py), each at the published peak of the precision it runs in,
over the measured time a tick of the window."""


def read(r):
    if r.rate_metric != "env_steps_per_s":
        return None
    return 100.0 * sum(f / r.peaks[p] for p, f in r.flops.items()) / r.unit_s
