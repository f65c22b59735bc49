"""Bench2Drive task registry: task name -> (route_id, seed) splits.

Data contract from vlm_gaze/data_utils/utils.py:13-62: ten single-scenario
tasks with 20 train demos each (seeds 200-219), a seen-test split (seed 400 on
the training route) and an unseen-test split (seed 400 on a sibling route);
'Mixed_' is the union of all ten (200 train episodes).
"""

from __future__ import annotations

_TASK_ROUTES = {
    "ParkingCutIn_": (24759, 18305),
    "AccidentTwoWays_": (25857, 1852),
    "DynamicObjectCrossing_": (24211, 24224),
    "CrossingBicycleFlow_": (3100, 3099),
    "VanillaNonSignalizedTurnEncounterStopsign_": (2416, 3184),
    "VehicleOpensDoorTwoWays_": (3472, 3464),
    "PedestrianCrossing_": (25863, 27529),
    "MergerIntoSlowTrafficV2_": (26408, 26401),
    "BlockedIntersection_": (27494, 2215),
    "HazardAtSideLaneTwoWays_": (24258, 25951),
}

TRAIN_SEEDS = range(200, 220)
TEST_SEED = 400


def _splits(route: int, unseen: int) -> dict:
    return {
        "train": [(route, s) for s in TRAIN_SEEDS],
        "test": [(route, TEST_SEED)],
        "test_unseen": [(unseen, TEST_SEED)],
    }


TASK_TO_ROUTE: dict[str, dict] = {name: _splits(r, u) for name, (r, u) in _TASK_ROUTES.items()}
TASK_TO_ROUTE["Mixed_"] = {
    "train": [(r, s) for r, _ in _TASK_ROUTES.values() for s in TRAIN_SEEDS],
    "test": [(r, TEST_SEED) for r, _ in sorted(_TASK_ROUTES.values())],
    "test_unseen": [(u, TEST_SEED) for _, u in sorted(_TASK_ROUTES.values(), key=lambda x: x[1])],
}

MAX_EPISODES = {k: len(v["train"]) for k, v in TASK_TO_ROUTE.items()}


def seen_routes() -> list[int]:
    """The 10 seen eval routes (eval/calc_scores.py:14-22)."""
    return sorted(r for r, _ in _TASK_ROUTES.values())


def unseen_routes() -> list[int]:
    return sorted(u for _, u in _TASK_ROUTES.values())
