"""The labeled collection tick's share of the card's peak: the VLM's
matrix and attention FLOPs (tower, projector, prefill and decode;
drivebench/counts/kimi_vl.py, on the window's prompt lengths) at the bf16
peak, over the measured time a tick of the window."""


def read(r):
    if r.rate_metric != "env_steps_per_s":
        return None
    return 100.0 * sum(f / r.peaks[p] for p, f in r.flops.items()) / r.unit_s
