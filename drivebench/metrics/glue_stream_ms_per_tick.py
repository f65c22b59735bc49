"""Stream ms a tick of the port's tick glue: its ``rollout.ring`` and
``rollout.noop`` spans and ``rollout.tick``'s self time, the card's stream
time between the spans' CUDA events that no stage span covers (the ring's
cat, the no-op where, and the device idle that waits on their launches),
over the whole ticks of the traced stretch
(gabril_carla_tpu_torch/utils/profiling.py ``span_summary``). None where
the program keeps no span record, and on the CPU."""


def read(r):
    if r.rate_metric != "env_steps_per_s":
        return None
    try:
        from gabril_carla_tpu_torch.utils.profiling import span_summary
    except ImportError:
        return None
    spans = span_summary()["spans"]
    tick = spans.get("rollout.tick")
    ring, noop = spans.get("rollout.ring"), spans.get("rollout.noop")
    if not tick or not ring or not noop or tick["stream_self_ms"] is None:
        return None
    return (ring["stream_ms"] + noop["stream_ms"] + tick["stream_self_ms"]) / tick["count"]
