"""The train step's share of the card's peak: its convolution and matrix
FLOPs (counts/flops.py), each at the published peak of the precision it
runs in, over the measured time a step of the window."""


def read(r):
    if r.rate_metric != "train_samples_per_s":
        return None
    return 100.0 * sum(f / r.peaks[p] for p, f in r.flops.items()) / r.unit_s
