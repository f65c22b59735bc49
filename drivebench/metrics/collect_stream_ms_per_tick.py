"""Stream ms a tick of the collection loop around the VLM labeler: its
``collect.render``, ``collect.expert`` and ``collect.env_step`` spans and
``collect.tick``'s self time (analytic gaze, scene boxes, the prompt's
assembly and the answer's parse), the card's stream time between the
spans' CUDA events that no labeler span covers, over the whole ticks of the
traced stretch (gabril_carla_tpu_torch/utils/profiling.py
``span_summary``). With vision_, prefill_ and decode_stream_ms_per_tick it
sums to the tick. None where the program keeps no such span, and on the
CPU."""


def read(r):
    if r.rate_metric != "env_steps_per_s":
        return None
    try:
        from gabril_carla_tpu_torch.utils.profiling import span_summary
    except ImportError:
        return None
    spans = span_summary()["spans"]
    tick = spans.get("collect.tick")
    parts = [spans.get(f"collect.{s}") for s in ("render", "expert", "env_step")]
    if not tick or not all(parts) or tick["stream_self_ms"] is None:
        return None
    return (sum(p["stream_ms"] for p in parts) + tick["stream_self_ms"]) / tick["count"]
