"""Stream ms a tick of the port's ``rollout.heat`` spans: the card's stream
time between each span's two CUDA events (the gaze predictor, its clamp
and repeat, and the device idle that waits on their launches), over the
whole ticks of the traced stretch
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
    stage = spans.get("rollout.heat")
    if not tick or not stage or stage["stream_ms"] is None:
        return None
    return stage["stream_ms"] / tick["count"]
