"""stats.json emission and sweep aggregation (a copy of
gabril_carla_tpu/eval/stats.py: the same JSON for the same score dict).

Schema parity with StatisticsManager's per-route records (leaderboard
utils/statistics_manager.py:69-163: scores dict, infractions lists, meta
durations, status string) and with the sweep aggregator
(eval/calc_scores.py:8-60: mean and spread of score_composed over routes x
seeds read from a stats.json tree).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

ROUND = 3

# score-dict key -> stats.json infraction key (PENALTY_NAME_DICT,
# statistics_manager.py:39-...: static collisions are 'collisions_layout')
_INFRACTION_KEYS = [
    ("collisions_pedestrian", "collisions_pedestrian", "Agent collided against a pedestrian"),
    ("collisions_vehicle", "collisions_vehicle", "Agent collided against a vehicle"),
    ("collisions_static", "collisions_layout", "Agent collided against a static object"),
    ("red_light", "red_light", "Agent ran a red light"),
    ("stop_infraction", "stop_infraction", "Agent ran a stop sign"),
]


def route_record(route_id: int, seed: int, score: dict, duration_game: float,
                 duration_system: float = -1.0, route_length: float = 0.0,
                 duration_system_mode: str = "wall") -> dict:
    """One stats.json record from one world's compute_score() values
    (numbers, or 0-d tensors or arrays).

    duration_system_mode records what duration_system means: "wall" for a
    single timed run, "batch_amortized" when many routes ran in one batch
    and its wall time is spread evenly over them.
    """
    s = {k: float(v) for k, v in score.items()}
    infractions = {}
    for score_key, json_key, msg in _INFRACTION_KEYS:
        n = int(s.get(score_key, 0))
        infractions[json_key] = [msg] * n
    infractions["outside_route_lanes"] = (
        [f"Agent went outside its route lanes for {s['outside_route_lanes_pct']:.2f}% of the route"]
        if s.get("outside_route_lanes_pct", 0) > 0.5
        else []
    )
    infractions["route_timeout"] = []
    infractions["route_dev"] = ["Agent deviated from the route"] if s.get("deviated") else []
    infractions["vehicle_blocked"] = ["Agent got blocked"] if s.get("blocked") else []
    infractions["scenario_timeouts"] = (
        ["Scenario timed out"] * int(s.get("scenario_timeout", 0)))
    infractions["yield_emergency_vehicle"] = (
        ["Agent failed to yield to an emergency vehicle"] if s.get("yield_emergency") else []
    )
    msp = s.get("min_speed_penalty", 1.0)
    infractions["min_speed_infractions"] = (
        [f"Average speed below the surrounding traffic's (penalty {msp:.3f})"]
        if msp < 0.999 else []
    )

    completed = s["score_route"] >= 100.0
    num_inf = sum(len(v) for v in infractions.values())
    if completed:
        status = "Perfect" if num_inf == 0 else "Completed"
    elif s.get("deviated"):
        status = "Failed - Agent deviated from the route"
    elif s.get("blocked"):
        status = "Failed - Agent got blocked"
    else:
        status = "Failed"

    scores = {
        "score_route": round(s["score_route"], ROUND),
        "score_penalty": round(s["score_penalty"], ROUND),
        "score_composed": round(s["score_composed"], ROUND),
    }
    record = {
        "route_id": f"RouteScenario_{route_id}",
        "seed": seed,
        "index": 0,
        "status": status,
        "num_infractions": num_inf,
        "infractions": infractions,
        "scores": scores,
        "meta": {
            "route_length": round(route_length, ROUND),
            "duration_game": round(duration_game, ROUND),
            "duration_system": round(duration_system, ROUND),
            "duration_system_mode": duration_system_mode,
        },
    }
    # _checkpoint wrapper so the reference's eval/calc_scores.py:77 reads
    # this stats.json unchanged; infractions become per-km rates over the
    # driven distance (compute_global_statistics, statistics_manager.py:
    # 418-536, for one route)
    km = max(route_length * s["score_route"] / 100.0 / 1000.0, 1e-3)
    per_km = {k: round(len(v) / km, ROUND) for k, v in infractions.items()}
    per_km["yield_emergency_vehicle_infractions"] = per_km.pop("yield_emergency_vehicle")
    record["_checkpoint"] = {
        "global_record": {
            "index": -1,
            "route_id": -1,
            "status": status,
            "infractions": per_km,
            "scores_mean": scores,
            "scores_std_dev": {k: 0 for k in scores},
            "meta": {
                "total_length": round(route_length, ROUND),
                "duration_game": round(duration_game, ROUND),
                "duration_system": round(duration_system, ROUND),
                "exceptions": [],
            },
        },
        "progress": [1, 1],
        "records": [dict(record)],
    }
    return record


def write_stats_json(out_dir: str | Path, record: dict) -> Path:
    """Dataset layout: <out>/route_<id>/seed_<seed>/stats.json."""
    rid = record["route_id"].split("_")[-1]
    path = Path(out_dir) / f"route_{rid}" / f"seed_{record['seed']}" / "stats.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2))
    return path


def aggregate_scores(records: list[dict]) -> dict:
    """calc_scores.py parity: mean/std of score_composed over routes x seeds."""
    by_route: dict[str, list[float]] = {}
    for r in records:
        by_route.setdefault(r["route_id"], []).append(r["scores"]["score_composed"])
    per_route = {k: float(np.mean(v)) for k, v in by_route.items()}
    allv = [r["scores"]["score_composed"] for r in records]
    return {
        "mean": float(np.mean(allv)) if allv else 0.0,
        "std": float(np.std(allv)) if allv else 0.0,
        "n": len(allv),
        "per_route": per_route,
    }
