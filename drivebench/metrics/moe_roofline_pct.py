"""The routed experts' grouped products' share of their roofline: the least
time of the traced ticks' products (drivebench/counts/kimi_vl.py
``moe_bound_s``, from the program's ``moe_pairs``,
``label_prefill_tokens`` and ``moe_experts_hit`` counters: each product the
larger of its FLOPs at the bf16 peak and its bytes at the HBM rate, the
weights of the experts it reaches read once) over the device time of the
kernels launched inside the harness's ``drivebench.moe_prefill`` and
``drivebench.moe_decode`` spans around them. None without the counters."""


def read(r):
    bound = getattr(r.trace, "moe_bound_s", None)
    t = r.trace.span_s.get("moe_prefill", 0.0) + r.trace.span_s.get("moe_decode", 0.0)
    if r.rate_metric != "env_steps_per_s" or bound is None or not t:
        return None
    return 100.0 * bound / t
