"""Stream ms a step of the port's ``train.backward`` spans: the card's
stream time between each span's two CUDA events (autograd's backward,
and the device idle that waits on their launches), over the traced train
steps (gabril_carla_tpu_torch/utils/profiling.py ``span_summary``). None
where the program keeps no span record, and on the CPU."""


def read(r):
    if r.rate_metric != "train_samples_per_s":
        return None
    try:
        from gabril_carla_tpu_torch.utils.profiling import span_summary
    except ImportError:
        return None
    spans = span_summary()["spans"]
    step, stage = spans.get("train.step"), spans.get("train.backward")
    if not step or not stage or stage["stream_ms"] is None:
        return None
    return stage["stream_ms"] / step["count"]
