"""Vendored benchmark data, read by path.

The route table, the parked-vehicle tables and the xosc examples live as
data files in the JAX package's tree (``gabril_carla_tpu/data/benchmark/``);
the port reads them from there and imports nothing of that package.

* ``routes220.json.gz`` — the 220 Bench2Drive routes (town, waypoint
  keypoints, scenario instances with trigger points and parameters, weather
  keyframes) in the raw-route schema ``env/world.py: build_world_spec`` reads.
* ``parked_vehicles.npz`` — per-town ``[K, 3] (x, y, yaw_rad)`` parked slots.
* ``xosc/*.xosc`` — three OpenSCENARIO examples (ScenarioRunner's
  ``srunner/examples/``) for env/xosc.py.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

import numpy as np

BENCHMARK_DIR = Path(__file__).resolve().parents[2] / "gabril_carla_tpu" / "data" / "benchmark"

XOSC_EXAMPLES = ("CyclistCrossing.xosc", "PedestrianCrossingFront.xosc",
                 "FollowLeadingVehicle.xosc")


def routes_path() -> Path:
    return BENCHMARK_DIR / "routes220.json.gz"


def parked_tables_path() -> Path:
    return BENCHMARK_DIR / "parked_vehicles.npz"


def xosc_example(name: str) -> Path:
    return BENCHMARK_DIR / "xosc" / name


def load_routes_json(path: str | Path, route_ids=None) -> dict[int, dict]:
    """Load the compiled route table into the raw-route schema."""
    with gzip.open(path, "rt") as f:
        raw = json.load(f)
    out = {}
    for rec in raw:
        rid = int(rec["id"])
        if route_ids is not None and rid not in route_ids:
            continue
        scenarios = []
        for s in rec["scenarios"]:
            s = dict(s)
            for k, v in s.items():
                if isinstance(v, list):  # trigger / (from,to) / (x,y) params
                    s[k] = tuple(v)
            scenarios.append(s)
        out[rid] = {
            "id": rid,
            "town": rec["town"],
            "waypoints": np.asarray(rec["waypoints"], np.float32),
            "scenarios": scenarios,
            "weather": list(rec["weather"]),
            "weather_keys": [list(w) for w in rec["weather_keys"]],
        }
    return out


def load_parked_npz(path: str | Path) -> dict[str, np.ndarray]:
    z = np.load(path)
    return {t: np.asarray(z[t], np.float32) for t in z.files}
