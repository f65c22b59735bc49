"""Traffic-light state as a pure function of sim time.

Port of gabril_carla_tpu/env/traffic_lights.py: phase(t) = (t + offset) mod
cycle over (green, yellow, red) windows, so a world carries no light state.
"""

from __future__ import annotations

import torch

GREEN, YELLOW, RED = 0, 1, 2


def light_state(t_seconds, offset, green_s, yellow_s, red_s):
    """Color index per light; ``t_seconds`` [B] against per-light [B, K]
    offsets and windows."""
    cycle = green_s + yellow_s + red_s
    phase = torch.remainder(t_seconds[:, None] + offset, cycle)  # floor mod, as jnp.mod
    return torch.where(phase < green_s, GREEN, torch.where(phase < green_s + yellow_s, YELLOW, RED))


def red_light_crossing(tl_stop_s, tl_offset, n_tl, prev_route_idx, new_route_idx, t_seconds,
                       green_s, yellow_s, red_s):
    """[B] bool: the ego crossed a stop line this tick while its light is red
    (RunningRedLightTest semantics)."""
    k = tl_stop_s.shape[1]
    active = torch.arange(k, device=tl_stop_s.device)[None] < n_tl[:, None]
    s0 = prev_route_idx.float()[:, None]
    s1 = new_route_idx.float()[:, None]
    crossed = (s0 < tl_stop_s) & (s1 >= tl_stop_s)
    is_red = light_state(t_seconds, tl_offset, green_s, yellow_s, red_s) == RED
    return (active & crossed & is_red).any(-1)
