"""WorldSpec: static per-route data compiled from the Bench2Drive route table.

A copy of the JAX package's numpy compile (gabril_carla_tpu/env/world.py),
with a plain dataclass in place of ``flax.struct``: ``build_world_spec``
emits numpy arrays, ``stack_specs`` stacks them along a leading world axis,
and ``to_torch`` moves a stacked spec onto a device as tensors.

Replaces RouteScenario's on-line construction (leaderboard
scenarios/route_scenario.py:63-107: GlobalRoutePlanner interpolation, scenario
instantiation, parked-prop spawning) with an offline numpy compile producing
fixed-shape arrays a vmapped step function can consume. One WorldSpec per
(route); batches of specs are stacked leaf-wise and vmapped.

Route interpolation: the reference densifies keypoints at 1 m along OpenDRIVE
roads (leaderboard utils/route_manipulation.py:136-161). The XML keypoints are
already ~2 m apart, so arc-length linear resampling at 1 m is a faithful
approximation without the (external) map files.

Scenario layouts use the behavioral constants of the srunner classes, e.g.
parking_cut_in.py:41-44 (cut-in at 35 m, 13 m/s), route_obstacles.py:69-85
(accident prop train 10+6 m, lane offset 0.6*lw/2, scenario timeout 240 s),
object_crash_vehicle.py:168 (walker at 2 m/s), pedestrian_crossing.py:63-66,
blocked_intersection.py:63-67, cross_bicycle_flow.py:83-85.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import xml.etree.ElementTree as ET
from dataclasses import field

import numpy as np
import torch

from . import constants as C

# Scenario type enum (per-world branch index in scenarios.scenario_step). All 44 types appearing in
# bench2drive220.xml are covered; most map onto a shared family builder:
#   0 passive (layout/signals/criteria only)   1 cut-in family
#   2 lane-obstacle family                     3 blocker + crossing walker
#   4 junction crossing-flow family            5 opened door
#   6 pedestrian crossing                      7 merge-into-flow family
#   8 blocked intersection                     9 side-lane hazard
#  10 junction adversary (crosses/turns through the ego's path)
#  11 yield-to-emergency-vehicle              12 hard-braking lead
#  13 control loss (steering perturbation)
SCENARIO_TYPES = {
    "None": 0,
    "VanillaNonSignalizedTurnEncounterStopsign": 0,  # no scenario class in the
    # reference either: build_scenarios skips it (route_scenario.py:341-347);
    # the stop sign itself is compiled below
    "VanillaNonSignalizedTurn": 0,
    "VanillaSignalizedTurnEncounterGreenLight": 0,
    "VanillaSignalizedTurnEncounterRedLight": 0,
    "T_Junction": 0,
    "SequentialLaneChange": 0,
    "ParkingExit": 0,
    "InvadingTurn": 0,
    "ParkingCutIn": 1,
    "StaticCutIn": 1,
    "HighwayCutIn": 1,
    "AccidentTwoWays": 2,
    "Accident": 2,
    "ParkedObstacle": 2,
    "ParkedObstacleTwoWays": 2,
    "ConstructionObstacle": 2,
    "ConstructionObstacleTwoWays": 2,
    "DynamicObjectCrossing": 3,
    "ParkingCrossingPedestrian": 3,
    "CrossingBicycleFlow": 4,
    "SignalizedJunctionLeftTurn": 4,
    "SignalizedJunctionRightTurn": 4,
    "NonSignalizedJunctionLeftTurn": 4,
    "NonSignalizedJunctionRightTurn": 4,
    "SignalizedJunctionLeftTurnEnterFlow": 4,
    "NonSignalizedJunctionLeftTurnEnterFlow": 4,
    "VehicleOpensDoorTwoWays": 5,
    "PedestrianCrossing": 6,
    "MergerIntoSlowTrafficV2": 7,
    "MergerIntoSlowTraffic": 7,
    "EnterActorFlow": 7,
    "HighwayExit": 7,
    "InterurbanActorFlow": 7,
    "InterurbanAdvancedActorFlow": 7,
    "BlockedIntersection": 8,
    "HazardAtSideLaneTwoWays": 9,
    "HazardAtSideLane": 9,
    "OppositeVehicleRunningRedLight": 10,
    "OppositeVehicleTakingPriority": 10,
    "VehicleTurningRoute": 10,
    "VehicleTurningRoutePedestrian": 10,
    "YieldToEmergencyVehicle": 11,
    "HardBreakRoute": 12,
    "ControlLoss": 13,
}

N_FLOWS = 2  # slot 0: explicit/source flow; slot 1: oncoming ("TwoWays") flow
N_TRAFFIC_LIGHTS = 4
N_WEATHER_KEYS = 4  # bench2drive220 routes carry 2 (0% and 100%)

CAR_EXTENT = (2.4, 0.95)
BIKE_EXTENT = (0.9, 0.4)


@dataclasses.dataclass
class WorldSpec:
    """Static world description; all arrays fixed-shape and stackable.

    Holds numpy arrays from ``build_world_spec`` (one route), numpy arrays
    with a leading world axis from ``stack_specs``, or tensors on a device
    from ``to_torch``.
    """

    route_xy: np.ndarray  # [M, 2]
    route_dir: np.ndarray  # [M, 2] unit tangents
    n_route: np.ndarray  # () int32 valid points
    route_len: np.ndarray  # () f32 meters
    spawn_pos: np.ndarray  # [2]
    spawn_yaw: np.ndarray  # ()
    # K scenario slots per route (RouteScenario drives several smaller
    # scenarios along one route, route_scenario.py:55-56). K is a per-build
    # static shape — max(1, len(route["scenarios"])) unless the loader pads
    # to a common K for stacking — so bench routes (1 scenario each) compile
    # the same single-machine program as before.
    scenario_type: np.ndarray  # [K] int32
    trigger_s: np.ndarray  # [K] f32 arclength of each scenario trigger
    # flow slots
    flow_xy: np.ndarray  # [N_FLOWS, F, 2]
    flow_dir: np.ndarray  # [N_FLOWS, F, 2]
    flow_len: np.ndarray  # [N_FLOWS] f32
    flow_speed: np.ndarray  # [N_FLOWS]
    flow_gap_lo: np.ndarray  # [N_FLOWS] meters
    flow_gap_hi: np.ndarray  # [N_FLOWS]
    flow_enabled: np.ndarray  # [N_FLOWS] bool
    flow_kind: np.ndarray  # [N_FLOWS] int32 0=car 1=bike
    # pre-placed pools (copied into SceneState at reset)
    statics_pos: np.ndarray  # [S, 2]
    statics_yaw: np.ndarray  # [S]
    statics_extent: np.ndarray  # [S, 2]
    statics_alive: np.ndarray  # [S] bool
    veh_pos: np.ndarray  # [V, 2] scripted vehicles (cut-in, blockers, hazards)
    veh_yaw: np.ndarray  # [V]
    veh_kind: np.ndarray  # [V] int32
    veh_extent: np.ndarray  # [V, 2]
    veh_alive: np.ndarray  # [V] bool
    veh_target_speed: np.ndarray  # [V]
    # walker spawn specs (activated at trigger)
    walk_pos: np.ndarray  # [W, 2]
    walk_vel: np.ndarray  # [W, 2]
    walk_ttl: np.ndarray  # [W]
    # per-scenario resource windows and anchors
    scen_pos: np.ndarray  # [K, 2] scenario anchor (blocker/adversary position)
    scen_aux: np.ndarray  # [K, 4] type-specific floats
    scen_veh_base: np.ndarray  # [K] int32 first scripted-vehicle slot owned
    # by slot k (scripted block is [0, dynamics.FLOW0_START))
    scen_walk_base: np.ndarray  # [K] int32 first walker slot owned by slot k
    scen_walk_n: np.ndarray  # [K] int32 walkers owned by slot k
    route_id: np.ndarray = field(default_factory=lambda: np.int32(0))
    weather: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    # traffic lights: stop-line arclengths, phase offsets and per-light cycle
    # windows (green/yellow/red seconds). A "frozen" profile is a cycle with
    # one huge window — CrossingBicycleFlow's red-for-5s-then-green contract
    # (cross_bicycle_flow.py:82,148-176: ego light red for green_light_delay=5
    # while the flow populates, then frozen green) is red_s=5, green_s=1e6.
    tl_stop_s: np.ndarray = field(default_factory=lambda: np.zeros(N_TRAFFIC_LIGHTS, np.float32))
    tl_offset: np.ndarray = field(default_factory=lambda: np.zeros(N_TRAFFIC_LIGHTS, np.float32))
    n_tl: np.ndarray = field(default_factory=lambda: np.int32(0))
    tl_green_s: np.ndarray = field(default_factory=lambda: np.full(N_TRAFFIC_LIGHTS, C.TL_GREEN_S, np.float32))
    tl_yellow_s: np.ndarray = field(default_factory=lambda: np.full(N_TRAFFIC_LIGHTS, C.TL_YELLOW_S, np.float32))
    tl_red_s: np.ndarray = field(default_factory=lambda: np.full(N_TRAFFIC_LIGHTS, C.TL_RED_S, np.float32))
    # stop signs: stop-line arclengths (generalized RunningStopTest,
    # atomic_criteria.py:1799 — one latched full stop required per sign)
    stop_s: np.ndarray = field(default_factory=lambda: np.zeros(C.N_STOPS, np.float32))
    n_stop: np.ndarray = field(default_factory=lambda: np.int32(0))
    # ambient background traffic (BackgroundBehavior-lite, env/ambient.py):
    # keep-clear windows in route arclength are the mask-update analogue of
    # the reference's scenario-driven background interventions
    # (tools/background_manager.py:18-254 — LeaveSpaceInFront, RemoveRoadLane,
    # HandleJunctionScenario clear_junction/clear_ego_entry)
    amb_enabled: np.ndarray = field(default_factory=lambda: np.bool_(True))
    amb_speed: np.ndarray = field(default_factory=lambda: np.float32(7.0))
    # one [lo, hi) keep-clear window per scenario slot (empty = hi <= lo)
    amb_clear: np.ndarray = field(default_factory=lambda: np.zeros((1, 2), np.float32))  # [K, 2] same-dir
    amb_opp_clear: np.ndarray = field(default_factory=lambda: np.zeros((1, 2), np.float32))  # [K, 2] opposite lane
    # route-s windows where using the opposite lane is legitimate (TwoWays
    # scenarios invite an overtake around their obstruction; the reference
    # scopes lane-invasion forgiveness to the scenario's activation window,
    # route_obstacles.py behaviors — not to the whole route)
    lane_allow: np.ndarray = field(default_factory=lambda: np.zeros((1, 2), np.float32))  # [K, 2]
    # weather keyframes (RouteWeatherBehavior contract, weather_sim.py:169+:
    # keyframes at route percentages, linearly interpolated as the ego
    # advances, clamped at 0/100%). Columns: route_pct, cloudiness,
    # precipitation, fog_density, sun_altitude_angle, wetness.
    weather_keys: np.ndarray = field(
        default_factory=lambda: np.zeros((N_WEATHER_KEYS, 6), np.float32))
    n_weather: np.ndarray = field(default_factory=lambda: np.int32(0))
    # per-route-point validity of the opposite lane: offsetting by a lane
    # width with local normals self-intersects on tight curves (the offset
    # path cuts the corner INTO the ego lane), so ambient opposite traffic
    # only runs where the offset point really is a lane away from the route
    opp_ok: np.ndarray = field(
        default_factory=lambda: np.ones(C.MAX_ROUTE_POINTS, bool))
    # ambient JUNCTION traffic (BackgroundBehavior's junction sources,
    # background_activity.py:165+ — the reference populates every junction
    # near the ego with background actors entering from the crossing roads).
    # When a route's flow slot 0 is not scenario-owned and the route turns at
    # a junction, the builder synthesizes the crossing road as an ambient
    # source->sink flow riding the ordinary flow machinery (spawning,
    # sinking, rendering as a crossing road all come for free). jct_flow
    # marks slot 0 as ambient; crossing actors then obey the junction's
    # signal (go while the ego's light is red) or yield to a nearby ego when
    # unsignalized (env/ambient.py: junction hold rule).
    jct_flow: np.ndarray = field(default_factory=lambda: np.bool_(False))
    jct_cross_s: np.ndarray = field(default_factory=lambda: np.float32(0.0))  # ego-route arclength of the crossing
    jct_hold_s: np.ndarray = field(default_factory=lambda: np.float32(0.0))  # flow arclength of the hold line
    jct_signal: np.ndarray = field(default_factory=lambda: np.int32(-1))  # governing ego light, -1 = unsignalized


def _left(d: np.ndarray) -> np.ndarray:
    """Unit normal pointing to the vehicle's left in CARLA's y-south frame."""
    return np.stack([d[..., 1], -d[..., 0]], axis=-1)


def resample_polyline(pts: np.ndarray, spacing: float = 1.0) -> np.ndarray:
    """Arc-length resample at fixed spacing (route_manipulation 1 m hop)."""
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    si = np.arange(0.0, total + 1e-6, spacing)
    x = np.interp(si, s, pts[:, 0])
    y = np.interp(si, s, pts[:, 1])
    return np.stack([x, y], axis=1).astype(np.float32)


def _tangents(xy: np.ndarray) -> np.ndarray:
    d = np.gradient(xy, axis=0)
    n = np.linalg.norm(d, axis=1, keepdims=True)
    return (d / np.maximum(n, 1e-6)).astype(np.float32)


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    """Pad along axis 0 by repeating the last row (keeps geometry sane)."""
    if len(a) >= n:
        return a[:n]
    reps = np.repeat(a[-1:], n - len(a), axis=0)
    return np.concatenate([a, reps], axis=0)


_PARKED_LINE = re.compile(r"'location':\(([-0-9.e+]+), ([-0-9.e+]+),[^)]*\), 'rotation':\([^,]+, ([-0-9.e+]+),")
_PARKED_TOWN = re.compile(r"^(\w+) = \[")


def load_parked_tables(path) -> dict[str, np.ndarray]:
    """Parked-vehicle tables as {town: [K, 3] (x, y, yaw_rad)} arrays:
    either the vendored compiled .npz or a parse of the reference's
    coordinate literals (leaderboard utils/parked_vehicles.py: per-town
    lists of {'location', 'rotation', 'mesh'} slots)."""
    if str(path).endswith(".npz"):
        from ..data.vendored import load_parked_npz

        return load_parked_npz(path)
    towns: dict[str, list] = {}
    cur = None
    with open(path) as f:
        for line in f:
            m = _PARKED_TOWN.match(line)
            if m:
                cur = towns.setdefault(m.group(1), [])
                continue
            m = _PARKED_LINE.search(line)
            if m and cur is not None:
                x, y, yaw = float(m.group(1)), float(m.group(2)), float(m.group(3))
                cur.append((x, y, math.radians(yaw)))
    return {t: np.asarray(v, np.float32) for t, v in towns.items() if v}


def select_parked_near_route(parked: np.ndarray, xy: np.ndarray, dirs: np.ndarray,
                             max_slots: int, lane_width: float = C.LANE_WIDTH) -> np.ndarray:
    """Parked slots within sight of the route but outside the driving lanes
    (RouteScenario's parking-slot filtering, route_scenario.py:163-203)."""
    if parked is None or not len(parked):
        return np.zeros((0, 3), np.float32)
    d = np.linalg.norm(parked[:, None, :2] - xy[None, :, :], axis=-1)  # [K, M]
    j = d.argmin(axis=1)
    dist = d[np.arange(len(parked)), j]
    rel = parked[:, :2] - xy[j]
    lat = -(dirs[j, 0] * rel[:, 1] - dirs[j, 1] * rel[:, 0])
    keep = (dist < 16.0) & ((lat < -0.7 * lane_width) | (lat > 1.8 * lane_width))
    sel = parked[keep]
    order = np.argsort(dist[keep])
    return sel[order[:max_slots]]


def parse_routes_xml(path, route_ids=None) -> dict[int, dict]:
    """Parse the reference's bench2drive220.xml -> {route_id: raw route}."""
    root = ET.parse(path).getroot()
    out = {}
    for r in root.iter("route"):
        rid = int(r.get("id"))
        if route_ids is not None and rid not in route_ids:
            continue
        wps = np.array(
            [[float(p.get("x")), float(p.get("y"))] for p in r.find("waypoints").findall("position")],
            dtype=np.float32,
        )
        scenarios = []
        for s in r.find("scenarios").findall("scenario"):
            rec = {"type": s.get("type")}
            for child in s:
                if child.tag == "trigger_point":
                    rec["trigger"] = (float(child.get("x")), float(child.get("y")), float(child.get("yaw")))
                elif "value" in child.attrib:
                    rec[child.tag] = _maybe_float(child.get("value"))
                elif "from" in child.attrib:
                    rec[child.tag] = (float(child.get("from")), float(child.get("to")))
                elif "x" in child.attrib:
                    rec[child.tag] = (float(child.get("x")), float(child.get("y")))
            scenarios.append(rec)
        weather = [0.0, 0.0, 0.0, 90.0]
        weather_keys = []
        wnode = r.find("weathers")
        if wnode is not None and len(wnode):
            for w in wnode:
                weather_keys.append([
                    float(w.get("route_percentage", 0)),
                    float(w.get("cloudiness", 0)), float(w.get("precipitation", 0)),
                    float(w.get("fog_density", 0)), float(w.get("sun_altitude_angle", 90)),
                    float(w.get("wetness", 0)),
                ])
            w0 = weather_keys[0]
            weather = [w0[1], w0[2], w0[3], w0[4]]
        out[rid] = {"id": rid, "town": r.get("town"), "waypoints": wps,
                    "scenarios": scenarios, "weather": weather,
                    "weather_keys": weather_keys}
    return out


def _maybe_float(v: str):
    try:
        return float(v)
    except ValueError:
        return v


def parse_routes(path, route_ids=None) -> dict[int, dict]:
    """Route-table dispatch on the file name: the compiled routes220.json.gz
    or the reference's bench2drive220.xml, the same raw-route schema either
    way."""
    if str(path).endswith(".json.gz"):
        from ..data.vendored import load_routes_json

        return load_routes_json(path, route_ids)
    return parse_routes_xml(path, route_ids)


def _project_s(route_xy: np.ndarray, p: np.ndarray) -> float:
    """Arclength of the nearest route point (1 m spacing -> index = s)."""
    i = int(np.argmin(np.linalg.norm(route_xy - p[None], axis=1)))
    return float(i)


def _point_at(route_xy, route_dir, s: float):
    i = int(np.clip(round(s), 0, len(route_xy) - 1))
    return route_xy[i], route_dir[i]


def detect_junctions(xy: np.ndarray, dirs: np.ndarray,
                     min_turn_deg: float = 50.0, window_m: int = 30,
                     min_entry: float = 15.0) -> list[float]:
    """Junction-entry arclengths from route curvature.

    Without the OpenDRIVE maps (external CARLA assets), a junction is
    inferred where the route heading changes by >= min_turn_deg within a
    window_m window — i.e. a turn at an intersection, which is where the
    reference's ego encounters junction traffic lights / stop signs
    (carla_data_provider.py:317-455 annotates lights per junction). The
    entry point is placed at the start of the turn. Gentle curves (highway
    bends) stay below the threshold.
    """
    n = len(xy)
    if n < window_m + 2:
        return []
    yaw = np.unwrap(np.arctan2(dirs[:, 1], dirs[:, 0]))
    dyaw = np.abs(yaw[window_m:] - yaw[:-window_m])  # [n - window_m]
    hot = dyaw > math.radians(min_turn_deg)
    entries: list[float] = []
    i = 0
    while i < len(hot):
        if hot[i]:
            j = i
            while j < len(hot) and hot[j]:
                j += 1
            entry = float(i)  # turn starts here; the window looks forward
            if entry > min_entry and entry < n - 10.0:  # skip spawn / goal edges
                entries.append(entry)
            i = j + window_m  # one junction per turn cluster
        else:
            i += 1
    return entries


# Ambient junction traffic default. Kept as a module switch so suites can be
# re-anchored across the flip (VERDICT r4 item 5: report the score delta).
JUNCTION_TRAFFIC_DEFAULT = False


def build_world_spec(route: dict, parked: np.ndarray | None = None,
                     ambient: bool = True, n_scen: int | None = None,
                     junction_traffic: bool | None = None) -> WorldSpec:
    """Compile one parsed route into a WorldSpec.

    ``parked``: optional [P, 3] (x, y, yaw) town parked-vehicle slots
    (data/vendored.py: load_parked_npz); nearby off-lane slots fill statics pool slots 8+.
    ``ambient``: enable BackgroundBehavior-lite ambient traffic (ambient.py).
    ``n_scen``: pad the route's scenario list to K slots (noop scenarios) so
    specs with different scenario counts stack into one batch; default K =
    max(1, len(route["scenarios"])).
    ``junction_traffic``: populate one scenario-free junction with ambient
    crossing traffic via flow slot 0 (BackgroundBehavior's junction sources,
    background_activity.py:165+); None = JUNCTION_TRAFFIC_DEFAULT.
    """
    if junction_traffic is None:
        junction_traffic = JUNCTION_TRAFFIC_DEFAULT
    xy = resample_polyline(route["waypoints"], 1.0)
    dirs = _tangents(xy)
    n = len(xy)
    m = C.MAX_ROUTE_POINTS

    statics_pos = np.zeros((C.N_STATICS, 2), np.float32)
    statics_yaw = np.zeros(C.N_STATICS, np.float32)
    statics_extent = np.full((C.N_STATICS, 2), 0.5, np.float32)
    statics_alive = np.zeros(C.N_STATICS, bool)
    veh_pos = np.zeros((C.N_VEHICLES, 2), np.float32)
    veh_yaw = np.zeros(C.N_VEHICLES, np.float32)
    veh_kind = np.zeros(C.N_VEHICLES, np.int32)
    veh_extent = np.full((C.N_VEHICLES, 2), 1.0, np.float32)
    veh_alive = np.zeros(C.N_VEHICLES, bool)
    veh_tspeed = np.zeros(C.N_VEHICLES, np.float32)
    walk_pos = np.zeros((C.N_WALKERS, 2), np.float32)
    walk_vel = np.zeros((C.N_WALKERS, 2), np.float32)
    walk_ttl = np.zeros(C.N_WALKERS, np.float32)
    flow_xy = np.zeros((N_FLOWS, C.MAX_FLOW_POINTS, 2), np.float32)
    flow_dir = np.zeros((N_FLOWS, C.MAX_FLOW_POINTS, 2), np.float32)
    flow_dir[..., 0] = 1.0
    flow_len = np.zeros(N_FLOWS, np.float32)
    flow_speed = np.zeros(N_FLOWS, np.float32)
    flow_gap = np.zeros((N_FLOWS, 2), np.float32)
    flow_enabled = np.zeros(N_FLOWS, bool)
    flow_kind = np.zeros(N_FLOWS, np.int32)

    tl_stop_s = np.zeros(N_TRAFFIC_LIGHTS, np.float32)
    tl_offset = np.zeros(N_TRAFFIC_LIGHTS, np.float32)
    tl_green = np.full(N_TRAFFIC_LIGHTS, C.TL_GREEN_S, np.float32)
    tl_yellow = np.full(N_TRAFFIC_LIGHTS, C.TL_YELLOW_S, np.float32)
    tl_red = np.full(N_TRAFFIC_LIGHTS, C.TL_RED_S, np.float32)
    n_tl = 0
    stop_s = np.zeros(C.N_STOPS, np.float32)
    n_stop = 0

    # ---- K scenario slots (the reference's RouteScenario drives *several*
    # smaller scenarios along one route, route_scenario.py:55-56). K is a
    # build-time static — max(1, len(scenarios)), or the caller's n_scen pad
    # for cross-route stacking — so bench2drive220 routes (one scenario each)
    # compile the same single-machine program as before. Fixed pools are
    # partitioned by cursor: scripted vehicles [0, dynamics.FLOW0_START),
    # scenario statics [0, N_SCENARIO_STATICS), walkers [0, N_WALKERS), and
    # flow slots by ownership — capacity overflows fail loudly at build time.
    from .dynamics import FLOW0_START as _SCRIPTED_SLOTS

    scen_list = list(route["scenarios"] or []) or [{"type": "None"}]
    if n_scen is not None:
        if len(scen_list) > n_scen:
            raise ValueError(
                f"route {route.get('id')}: {len(scen_list)} scenarios > n_scen={n_scen}")
        scen_list = scen_list + [{"type": "None"}] * (n_scen - len(scen_list))

    K = len(scen_list)
    stypes = np.zeros(K, np.int32)
    trig_ss = np.zeros(K, np.float32)
    scen_pos_arr = np.zeros((K, 2), np.float32)
    scen_aux_arr = np.zeros((K, 4), np.float32)
    scen_veh_base = np.zeros(K, np.int32)
    scen_walk_base = np.zeros(K, np.int32)
    scen_walk_n = np.zeros(K, np.int32)
    amb_clear = np.zeros((K, 2), np.float32)
    amb_opp_clear = np.zeros((K, 2), np.float32)
    lane_allow = np.zeros((K, 2), np.float32)

    # resource cursors + per-scenario usage; the add_* helpers write through
    # _cur so each scenario's assets land in its own pool window
    _cur = {"si": 0, "vb": 0, "sb": 0, "wb": 0, "veh": 0, "stat": 0, "walk": 0}
    flow_owner: list = [None, None]
    spawn_override = None
    encounter_reqs = []  # (name, trig_s): light phasing after the global fill
    nonsig_trigs = []  # trigger arclengths of nonsignalized-junction scenarios
    stop_win_slots = []  # amb-window rows that only guard a stop-sign junction

    def set_flow(slot, pts, speed, gap, kind=0):
        if flow_owner[slot] is not None and flow_owner[slot] != _cur["si"]:
            raise ValueError(
                f"route {route.get('id')}: flow slot {slot} already owned by "
                f"scenario #{flow_owner[slot]} — one flow-using scenario per "
                f"slot per route (fixed-capacity WorldSpec)")
        flow_owner[slot] = _cur["si"]
        f = resample_polyline(np.asarray(pts, np.float32), 1.0)
        fl = min(len(f), C.MAX_FLOW_POINTS)
        flow_xy[slot] = _pad(f, C.MAX_FLOW_POINTS)
        flow_dir[slot] = _pad(_tangents(f), C.MAX_FLOW_POINTS)
        flow_len[slot] = float(fl - 1)
        flow_speed[slot] = speed
        flow_gap[slot] = gap
        flow_enabled[slot] = True
        flow_kind[slot] = kind

    def oncoming_flow(s_from: float, s_to: float, speed=8.0, gap=(25.0, 50.0),
                      lat: float = C.LANE_WIDTH):
        """Slot-1 flow on the opposite lane, running from s_to down to s_from.

        Pointwise lane offsetting cuts corners on curves (the offset point
        lands inside the ego lane), so the flow is cropped to its longest
        stretch where the offset really is a lane away from the route —
        oncoming traffic matters in the overtake window, which the scenarios
        place on straight road. ``lat`` < LANE_WIDTH makes the oncoming
        traffic invade toward the ego lane (InvadingTurn).

        One oncoming segment per route (slot-1 capacity): a second TwoWays
        scenario keeps its obstruction + lane-allow window but shares the
        first scenario's oncoming stream rather than overwriting it."""
        if flow_owner[1] is not None and flow_owner[1] != _cur["si"]:
            return
        i0, i1 = int(max(0, s_from)), int(min(n - 1, s_to))
        seg = xy[i0 : i1 + 1] + lat * _left(dirs[i0 : i1 + 1])
        dmin = np.linalg.norm(seg[:, None, :] - xy[None, :, :], axis=-1).min(axis=1)
        ok = dmin > 0.75 * lat
        if not ok.any():
            return
        # longest contiguous valid run
        best_a = best_b = a = 0
        while a < len(ok):
            if ok[a]:
                b = a
                while b < len(ok) and ok[b]:
                    b += 1
                if b - a > best_b - best_a:
                    best_a, best_b = a, b
                a = b
            else:
                a += 1
        if best_b - best_a < 12:
            return
        set_flow(1, seg[best_a:best_b][::-1], speed, gap)

    def add_static(i, pos, yaw, extent):
        idx = _cur["sb"] + i
        if idx >= C.N_SCENARIO_STATICS:
            raise ValueError(
                f"route {route.get('id')}: scenario statics overflow "
                f"({idx} >= {C.N_SCENARIO_STATICS})")
        statics_pos[idx], statics_yaw[idx], statics_extent[idx], statics_alive[idx] = pos, yaw, extent, True
        _cur["stat"] = max(_cur["stat"], i + 1)

    def add_vehicle(i, pos, yaw, kind, extent, tspeed=0.0):
        idx = _cur["vb"] + i
        if idx >= _SCRIPTED_SLOTS:
            raise ValueError(
                f"route {route.get('id')}: scripted vehicle slots overflow "
                f"({idx} >= {_SCRIPTED_SLOTS})")
        veh_pos[idx], veh_yaw[idx], veh_kind[idx] = pos, yaw, kind
        veh_extent[idx], veh_alive[idx], veh_tspeed[idx] = extent, True, tspeed
        _cur["veh"] = max(_cur["veh"], i + 1)

    def add_walker(i, pos, vel, ttl):
        idx = _cur["wb"] + i
        if idx >= C.N_WALKERS:
            raise ValueError(f"route {route.get('id')}: walker slots overflow")
        walk_pos[idx], walk_vel[idx], walk_ttl[idx] = pos, vel, ttl
        _cur["walk"] = max(_cur["walk"], i + 1)

    lw = C.LANE_WIDTH

    for si, scen in enumerate(scen_list):
        _cur.update(si=si, veh=0, stat=0, walk=0)
        name = str(scen["type"])
        stype = SCENARIO_TYPES.get(name, 0)
        trig_s = _project_s(xy, np.array(scen["trigger"][:2], np.float32)) if "trigger" in scen else 0.0
        scen_aux = scen_aux_arr[si]  # view — writes land in the [K, 4] table
        # scenarios whose junction carries no working traffic light
        nonsignalized = ("NonSignalized" in name) or name in (
            "OppositeVehicleTakingPriority", "VehicleTurningRoute",
            "VehicleTurningRoutePedestrian", "T_Junction")
        if nonsignalized:
            nonsig_trigs.append(trig_s)
        added_stop = False
        if nonsignalized and "Stopsign" in name:
            # VanillaNonSignalizedTurnEncounterStopsign: stop sign at the trigger
            if n_stop >= C.N_STOPS:
                raise ValueError(
                    f"route {route.get('id')}: scenario slot {si} ({name}) "
                    f"exceeds stop-sign capacity N_STOPS={C.N_STOPS}")
            stop_s[n_stop] = trig_s
            n_stop += 1
            added_stop = True

        twoways = name.endswith("TwoWays")
        cross_s = -1.0

        if stype == 1:  # cut-in family: parked/waiting car pulls out ahead
            # ParkingCutIn: fixed 35 m (parking_cut_in.py:41-44); StaticCutIn: at
            # its 'distance' param; HighwayCutIn: merges from an explicit on-ramp
            # location at highway speed (highway_cut_in.py semantics)
            if name == "HighwayCutIn" and "other_actor_location" in scen:
                loc = np.asarray(scen["other_actor_location"][:2], np.float32)
                s_cut = _project_s(xy, loc)
                cut_speed = 16.0
            else:
                s_cut = trig_s + float(scen.get("distance", 35.0))
                cut_speed = 13.0
            p, d = _point_at(xy, dirs, s_cut)
            right = -_left(d)
            add_vehicle(0, p + right * (lw * 0.8), math.atan2(d[1], d[0]), 0, CAR_EXTENT, cut_speed)
            scen_pos_arr[si] = (p + right * (lw * 0.8)).astype(np.float32)
            scen_aux[0] = s_cut
            scen_aux[1] = cut_speed

        elif stype == 2:  # lane-obstacle family: props at distance; TwoWays
            # variants add oncoming traffic into the overtake window
            dist = float(scen.get("distance", 120.0))
            s0 = trig_s + dist
            if "Construction" in name:  # cone train (route_obstacles.py construction layout)
                layout = [(0.0, (0.4, 0.4)), (4.0, (0.4, 0.4)), (8.0, (0.4, 0.4)),
                          (12.0, (1.0, 0.6))]
            elif "ParkedObstacle" in name:  # one parked vehicle
                layout = [(0.0, CAR_EXTENT)]
            else:  # Accident: crashed-car train at wp, +10, +16
                layout = [(0.0, CAR_EXTENT), (10.0, CAR_EXTENT), (16.0, CAR_EXTENT)]
            for k, (ds, ext) in enumerate(layout):
                p, d = _point_at(xy, dirs, s0 + ds)
                off = -_left(d) * (0.6 * lw / 2)
                add_static(k, p + off, math.atan2(d[1], d[0]), ext)
            if twoways:
                freq = scen.get("frequency", (32.0, 110.0))
                oncoming_flow(trig_s - 10, min(n - 2, s0 + 60), speed=7.0, gap=tuple(freq))
            scen_aux[0] = s0

        elif stype == 3:  # blocker + crossing walker (DynamicObjectCrossing /
            # ParkingCrossingPedestrian — there the blocker is a parked car)
            dist = float(scen.get("distance", 12.0))
            s0 = trig_s + dist
            p, d = _point_at(xy, dirs, s0)
            right = -_left(d)
            blocker = p + right * (lw * 0.9)
            blk_ext = CAR_EXTENT if "Parking" in name else (1.2, 1.2)
            add_static(0, blocker, math.atan2(d[1], d[0]), blk_ext)
            ang = math.radians(float(scen.get("crossing_angle", 0.0)))
            cross_dir = _left(d)  # walks right -> left across the lane
            ca, sa = math.cos(ang), math.sin(ang)
            rot = np.array([[ca, -sa], [sa, ca]], np.float32)
            # 2 m/s default (object_crash_vehicle.py:168); xosc storyboards
            # carry the adversary's declared SpeedAction speed
            wspd = float(scen.get("speed", 2.0))
            v = rot @ cross_dir * wspd
            add_walker(0, blocker + right * 1.0, v, (2.5 * lw) / max(wspd, 0.5))
            scen_pos_arr[si] = blocker
            scen_aux[0] = s0

        elif stype == 4:  # junction crossing-flow family. CrossingBicycleFlow
            # carries explicit flow endpoints; the junction-turn scenarios
            # (Signalized/NonSignalizedJunction{Left,Right}Turn[EnterFlow]) leave
            # the flow on the crossing road implicit — synthesize it through the
            # junction the route turns at, perpendicular to the approach heading.
            gap = scen.get("source_dist_interval", (20.0, 50.0))
            if "start_actor_flow" in scen:
                pts = [scen["start_actor_flow"], scen["end_actor_flow"]]
            else:
                entries = [e for e in detect_junctions(xy, dirs) if e >= trig_s - 40.0]
                j = entries[0] if entries else trig_s + 10.0
                p_c, _ = _point_at(xy, dirs, j + 18.0)
                d_in = dirs[int(np.clip(j - 5.0, 0, n - 1))]
                perp = _left(d_in)
                if "Right" in name:
                    perp = -perp
                pts = [p_c + perp * 45.0, p_c - perp * 45.0]
            kind = 1 if "Bicycle" in name else 0
            set_flow(0, pts, float(scen.get("flow_speed", 10.0)), gap, kind=kind)
            # crossing arclength on the ego route (nearest route point to the
            # flow polyline): the junction wait clock (scenarios._junction_wait)
            # and the expert's hold-line logic anchor on it
            fpoly = resample_polyline(np.asarray(pts, np.float32), 1.0)
            d_rf = np.linalg.norm(xy[:, None, :] - fpoly[None, :, :], axis=-1).min(axis=1)
            scen_aux[0] = float(np.argmin(d_rf))

        elif stype == 5:  # VehicleOpensDoorTwoWays
            dist = float(scen.get("distance", 50.0))
            s0 = trig_s + dist
            p, d = _point_at(xy, dirs, s0)
            right = -_left(d)
            car = p + right * (lw * 0.55)
            add_static(0, car, math.atan2(d[1], d[0]), CAR_EXTENT)
            # opened door pokes into the ego lane
            add_static(1, car + _left(d) * 1.4 + d * 1.0, math.atan2(d[1], d[0]), (0.7, 0.25))
            freq = scen.get("frequency", (36.0, 90.0))
            oncoming_flow(trig_s - 10, min(n - 2, s0 + 60), speed=7.0, gap=tuple(freq))
            scen_aux[0] = s0

        elif stype == 6:  # PedestrianCrossing: 3 walkers over a crosswalk ahead
            s0 = trig_s + 12.0
            p, d = _point_at(xy, dirs, s0)
            right = -_left(d)
            wbase = float(scen.get("speed", 1.3))  # xosc SpeedAction override
            for k in range(3):
                start = p + right * (lw * 0.9) + d * (1.0 * k)
                wspd = wbase + 0.35 * k  # pedestrian_crossing.py speed spread
                add_walker(k, start, _left(d) * wspd, (2.3 * lw) / wspd)
            scen_pos_arr[si] = p
            scen_aux[0] = s0

        elif stype == 7:  # MergerIntoSlowTrafficV2
            pts = [scen["start_actor_flow"], scen["end_actor_flow"]]
            gap = scen.get("source_dist_interval", (20.0, 50.0))
            set_flow(0, pts, float(scen.get("flow_speed", 10.0)), gap, kind=0)

        elif stype == 8:  # BlockedIntersection: blocker 5 m past trigger
            s0 = trig_s + 5.0
            p, d = _point_at(xy, dirs, s0)
            add_vehicle(0, p, math.atan2(d[1], d[0]), 0, CAR_EXTENT, 8.0)
            scen_pos_arr[si] = p.astype(np.float32)
            scen_aux[0] = s0
            scen_aux[1] = 13.0  # trigger distance (blocked_intersection.py:64)

        elif stype == 9:  # HazardAtSideLane[TwoWays]: two bicycles at lane edge
            dist = float(scen.get("distance", 100.0))
            bspeed = float(scen.get("bicycle_speed", 8.0))
            bdist = float(scen.get("bicycle_drive_distance", 100.0))
            freq = float(scen.get("frequency", 75.0)) if not isinstance(scen.get("frequency"), tuple) else 75.0
            s0 = trig_s + dist
            for k in range(2):
                p, d = _point_at(xy, dirs, s0 + 8.0 * k)
                off = -_left(d) * (0.55 * lw / 2)
                add_vehicle(k, p + off, math.atan2(d[1], d[0]), 1, BIKE_EXTENT, bspeed)
            if twoways:
                oncoming_flow(trig_s - 10, min(n - 2, s0 + bdist + 30), speed=7.0, gap=(freq / 2, freq))
            scen_aux[0] = s0
            scen_aux[1] = bdist

        elif stype == 10:  # junction adversary: a vehicle crosses/turns through
            # the ego's junction path (OppositeVehicleRunningRedLight /
            # OppositeVehicleTakingPriority / VehicleTurningRoute[Pedestrian]).
            # The crossing line rides flow slot 0 but spawning is one-shot,
            # scenario-triggered (flow_enabled stays False).
            entries = [e for e in detect_junctions(xy, dirs) if e >= trig_s - 30.0]
            conflict_s = (entries[0] + 15.0) if entries else trig_s + 20.0
            conflict_s = min(conflict_s, n - 5.0)
            p_c, _ = _point_at(xy, dirs, conflict_s)
            d_in = dirs[int(np.clip(conflict_s - 15.0, 0, n - 1))]
            perp = _left(d_in)
            if str(scen.get("direction", "left")) == "right":
                perp = -perp
            adv_speed = 10.0 if "RunningRedLight" in name else 8.0
            set_flow(0, [p_c + perp * 40.0, p_c - perp * 40.0], adv_speed,
                     (1e6, 1e6), kind=0)
            flow_enabled[0] = False  # one-shot spawn by the phase machine
            start = p_c + perp * 40.0
            dyaw = math.atan2(-perp[1], -perp[0])
            add_vehicle(0, start, dyaw, 0, CAR_EXTENT, 0.0)
            if "Pedestrian" in name:
                add_walker(0, p_c + perp * (lw * 1.2), -perp * 1.6, (2.4 * lw) / 1.6)
            if "RunningRedLight" in name and conflict_s > 14.0:
                # signalized junction; the ego faces a working (green) light while
                # the adversary runs the red from the crossing road
                if n_tl >= N_TRAFFIC_LIGHTS:
                    raise ValueError(
                        f"route {route.get('id')}: scenario slot {si} ({name}) "
                        f"exceeds traffic-light capacity N_TRAFFIC_LIGHTS={N_TRAFFIC_LIGHTS}")
                tl_stop_s[n_tl] = conflict_s - 8.0
                tl_green[n_tl] = 1e6
                tl_yellow[n_tl] = 0.0
                tl_red[n_tl] = 0.0
                n_tl += 1
            scen_pos_arr[si] = p_c.astype(np.float32)
            scen_aux[0] = conflict_s
            scen_aux[1] = adv_speed

        elif stype == 11:  # YieldToEmergencyVehicle: EV approaches from behind
            scen_aux[0] = trig_s
            scen_aux[1] = float(scen.get("distance", 30.0))  # spawn gap behind ego
            scen_aux[2] = 14.0  # EV speed

        elif stype == 12:  # HardBreakRoute: lead brakes hard in front of the ego
            scen_aux[0] = trig_s
            # lead cruise speed: 7 m/s default; xosc leads declare theirs
            scen_aux[1] = float(scen.get("speed", 7.0))

        elif stype == 13:  # ControlLoss: transient steering perturbation
            scen_aux[0] = trig_s

        if name == "ParkingExit":
            # ego starts in a parking slot beside the lane, hemmed in by parked
            # vehicles 'front/behind_vehicle_distance' away (parking_exit.py)
            right0 = -_left(dirs[0])
            fwd0 = dirs[0]
            slot = xy[0] + right0 * (lw * 0.8)
            fdist = float(scen.get("front_vehicle_distance", 9.0))
            bdist_p = float(scen.get("behind_vehicle_distance", 9.0))
            yaw0 = math.atan2(dirs[0][1], dirs[0][0])
            add_static(0, slot + fwd0 * fdist, yaw0, CAR_EXTENT)
            add_static(1, slot - fwd0 * bdist_p, yaw0, CAR_EXTENT)
            spawn_override = slot.astype(np.float32)
            scen_aux[3] = 1.0  # ParkingExit marker (expert suppresses the
            # parked-row hazard while pulling out)

        if name == "InvadingTurn":
            # oncoming traffic cuts the corner, invading toward the ego lane by
            # 'offset' lane-fractions over the turn (invading_turn.py)
            dist = float(scen.get("distance", 60.0))
            invade = float(scen.get("offset", 0.25))
            oncoming_flow(trig_s - 5, min(n - 2, trig_s + dist + 30), speed=7.0,
                          gap=(30.0, 60.0), lat=(1.0 - invade) * lw)

        # VanillaSignalizedTurnEncounter{Red,Green}Light promises a light
        # state at arrival — phased after the global junction fill below
        if "EncounterRedLight" in name or "EncounterGreenLight" in name:
            encounter_reqs.append((name, trig_s))

        if stype == 4:
            # CrossingBicycleFlow: signalized junction at the flow crossing; ego
            # light red for green_light_delay=5 s, then frozen green
            # (cross_bicycle_flow.py:82,167-172)
            fl = flow_xy[0][: max(int(flow_len[0]), 2)]
            d2 = np.linalg.norm(xy[:, None, :] - fl[None, :, :], axis=-1).min(axis=1)
            cross_s = float(np.argmin(d2))
            if d2.min() < 6.0 and cross_s > 8.0 and not nonsignalized:
                if n_tl >= N_TRAFFIC_LIGHTS:
                    raise ValueError(
                        f"route {route.get('id')}: scenario slot {si} ({name}) "
                        f"exceeds traffic-light capacity N_TRAFFIC_LIGHTS={N_TRAFFIC_LIGHTS}")
                tl_stop_s[n_tl] = cross_s - 6.0
                tl_green[n_tl] = 1e6
                tl_yellow[n_tl] = 0.0
                tl_red[n_tl] = 5.0
                tl_offset[n_tl] = 1e6  # t=0 lands in the red window
                n_tl += 1

        # ---- ambient keep-clear windows (background_manager.py analogues):
        # same-direction traffic stays out of the scenario's working zone
        # (LeaveSpaceInFront / clear_ego_entry); the opposite lane is ceded to
        # the scenario's oncoming flow on TwoWays routes (RemoveRoadLane).
        # One [lo, hi) window per scenario slot; consumers OR over slots.
        s0 = float(scen_aux[0])
        if stype in (2, 5):  # Accident / VehicleOpensDoor TwoWays
            amb_clear[si] = (trig_s - 5.0, s0 + 25.0)
            amb_opp_clear[si] = (trig_s - 15.0, s0 + 70.0)
            lane_allow[si] = (trig_s - 15.0, s0 + 30.0)
        elif stype == 9:  # HazardAtSideLaneTwoWays
            bdist = float(scen_aux[1])
            amb_clear[si] = (trig_s - 5.0, s0 + bdist + 10.0)
            amb_opp_clear[si] = (trig_s - 15.0, s0 + bdist + 40.0)
            lane_allow[si] = (trig_s - 15.0, s0 + bdist + 20.0)
        elif stype == 1:  # ParkingCutIn: room for the pull-out
            amb_clear[si] = (trig_s - 5.0, s0 + 35.0)
        elif stype in (3, 6):  # walker crossings: keep the crossing open
            amb_clear[si] = (s0 - 20.0, s0 + 15.0)
        elif stype == 4 and cross_s > 0:  # junction clear (HandleJunctionScenario)
            amb_clear[si] = (cross_s - 30.0, cross_s + 30.0)
            amb_opp_clear[si] = (cross_s - 30.0, cross_s + 30.0)
        elif stype == 7:  # merger: the slow flow owns the merge section
            amb_clear[si] = (trig_s - 5.0, trig_s + 70.0)
        elif stype == 8:  # blocked intersection
            amb_clear[si] = (trig_s - 5.0, s0 + 35.0)
            amb_opp_clear[si] = (trig_s - 5.0, s0 + 35.0)
        elif stype == 10:  # junction adversary owns the junction
            amb_clear[si] = (s0 - 35.0, s0 + 35.0)
            amb_opp_clear[si] = (s0 - 35.0, s0 + 35.0)
        elif stype == 11:  # the emergency vehicle needs a free lane behind the ego
            amb_clear[si] = (max(0.0, trig_s - 60.0), trig_s + 150.0)
        elif stype == 12:  # the braking lead owns the stretch past the trigger
            amb_clear[si] = (trig_s - 25.0, trig_s + 70.0)
        if name == "InvadingTurn":  # invading oncoming flow owns the opposite lane
            amb_opp_clear[si] = (trig_s - 15.0, trig_s + float(scen.get("distance", 60.0)) + 40.0)
        if name == "ParkingExit":  # pulling out of the slot crosses the lane edge
            lane_allow[si] = (0.0, 25.0)
            amb_clear[si] = (0.0, 40.0)
        if added_stop:  # stop-sign junction: keep it open in both directions
            amb_clear[si] = (trig_s - 15.0, trig_s + 25.0)
            amb_opp_clear[si] = (trig_s - 15.0, trig_s + 25.0)
            # ...open for LANE traffic; crossing-road junction traffic is
            # exactly what the reference provides at stop-sign junctions
            stop_win_slots.append(si)

        # EV / hard-brake machines spawn their vehicle at runtime — reserve
        # one scripted slot for them even though nothing is placed at build
        if stype in (11, 12):
            _cur["veh"] = max(_cur["veh"], 1)

        stypes[si] = stype
        trig_ss[si] = trig_s
        scen_veh_base[si] = _cur["vb"]
        scen_walk_base[si] = _cur["wb"]
        scen_walk_n[si] = _cur["walk"]
        _cur["vb"] += _cur["veh"]
        _cur["sb"] += _cur["stat"]
        _cur["wb"] += _cur["walk"]

    sel = select_parked_near_route(parked, xy, dirs, C.N_STATICS - C.N_SCENARIO_STATICS)
    for k, (px, py, pyaw) in enumerate(sel):
        i = C.N_SCENARIO_STATICS + k
        statics_pos[i], statics_yaw[i] = (px, py), pyaw
        statics_extent[i], statics_alive[i] = CAR_EXTENT, True

    # ---- traffic signals (RunningRedLightTest / RunningStopTest parity,
    # atomic_criteria.py:1620,1799 — the reference checks every signal the
    # ego encounters, not just scenario-owned ones)
    rng_tl = np.random.default_rng(int(route["id"]))
    for entry in detect_junctions(xy, dirs):
        if n_tl >= N_TRAFFIC_LIGHTS:
            break
        if any(abs(entry - t) < 60.0 for t in nonsig_trigs):
            continue  # a scenario says this junction has no lights
        if any(abs(entry - tl_stop_s[k]) < 30.0 for k in range(n_tl)):
            continue
        if n_stop and any(abs(entry - s) < 30.0 for s in stop_s[:n_stop]):
            continue
        tl_stop_s[n_tl] = entry
        cycle = C.TL_GREEN_S + C.TL_YELLOW_S + C.TL_RED_S
        tl_offset[n_tl] = float(rng_tl.uniform(0.0, cycle))
        n_tl += 1

    # VanillaSignalizedTurnEncounter{Red,Green}Light: the scenario promises a
    # specific light state when the ego reaches its junction — phase the
    # nearest light to be red (resp. green) at the estimated arrival time
    # (ambient cruise ~6 m/s).
    for enc_name, enc_trig in encounter_reqs:
        cycle = C.TL_GREEN_S + C.TL_YELLOW_S + C.TL_RED_S
        cand = [k for k in range(n_tl) if abs(tl_stop_s[k] - enc_trig) < 80.0]
        if not cand and n_tl < N_TRAFFIC_LIGHTS:
            tl_stop_s[n_tl] = max(enc_trig, 10.0)
            cand = [n_tl]
            n_tl += 1
        if cand:
            k = min(cand, key=lambda k: abs(tl_stop_s[k] - enc_trig))
            arrival = float(tl_stop_s[k]) / 6.0
            if "RedLight" in enc_name:
                # phase time at arrival lands mid-red
                target = C.TL_GREEN_S + C.TL_YELLOW_S + 0.4 * C.TL_RED_S
            else:
                target = 0.3 * C.TL_GREEN_S
            tl_offset[k] = (target - arrival) % cycle

    # ---- ambient junction traffic (BackgroundBehavior's junction sources,
    # background_activity.py:165+). If flow slot 0 is not scenario-owned,
    # populate the first scenario-free junction with a crossing-road ambient
    # flow. The crossing line sits just BEFORE the turn cluster (the approach
    # is straight there; the post-turn exit road runs parallel to the line a
    # turn-radius away, so crossing traffic never rides the ego's exit lane).
    jct_flow = False
    jct_cross_s = 0.0
    jct_hold_s = 0.0
    jct_signal = -1
    if ambient and junction_traffic and flow_owner[0] is None:
        def _window_hit(s, windows, pad=10.0):
            return any(lo - pad <= s <= hi + pad
                       for k, (lo, hi) in enumerate(windows)
                       if hi > lo and k not in stop_win_slots)

        # active scenarios keep their working zone junction-free; passive
        # (Vanilla*) scenarios are exactly the ones the reference serves with
        # background junction traffic, so they don't block it — nor do
        # stop-sign windows (crossing traffic is what makes the sign real)
        anchors = [float(t) for t, st in zip(trig_ss, stypes) if st != 0]
        anchors += [float(a[0]) for a, st in zip(scen_aux_arr, stypes) if st != 0]
        # bench2drive220 routes often spawn the ego right before (or inside)
        # their junction — the Vanilla stop-sign routes' turn clusters start
        # at s=0 — so detection runs all the way to the spawn
        for entry in detect_junctions(xy, dirs, min_entry=-1.0):
            # the ego's light/stop line sits at `entry` (global junction fill
            # above); the crossing road runs just past it, before the route's
            # heading has rotated (exit-lane overlap is impossible there)
            s_x = entry + 8.0
            if not (6.0 <= s_x <= n - 18.0):
                continue
            if _window_hit(s_x, amb_clear) or _window_hit(s_x, amb_opp_clear):
                continue
            if any(abs(s_x - a) < 35.0 for a in anchors):
                continue
            p_x, _dx = _point_at(xy, dirs, s_x)
            d_in = dirs[int(np.clip(s_x - 4.0, 0, n - 1))]
            perp = _left(d_in)
            if int(route["id"]) % 2:  # vary approach side across routes
                perp = -perp
            pts = [p_x + perp * 55.0, p_x - perp * 55.0]
            f = resample_polyline(np.asarray(pts, np.float32), 1.0)
            fl = min(len(f), C.MAX_FLOW_POINTS)
            flow_xy[0] = _pad(f, C.MAX_FLOW_POINTS)
            flow_dir[0] = _pad(_tangents(f), C.MAX_FLOW_POINTS)
            flow_len[0] = float(fl - 1)
            flow_speed[0] = 7.0  # amb_speed
            flow_gap[0] = (28.0, 55.0)
            flow_enabled[0] = True
            flow_kind[0] = 0
            # hold line: flow arclength where the ego corridor begins
            d_rf = np.linalg.norm(f[: fl, None, :] - xy[None, :, :], axis=-1).min(axis=1)
            cross_f = float(np.argmin(d_rf))
            jct_flow = True
            jct_cross_s = float(s_x)
            jct_hold_s = cross_f - 9.0
            sig = [k for k in range(n_tl) if abs(float(tl_stop_s[k]) - s_x) < 25.0]
            if sig:
                jct_signal = min(sig, key=lambda k: abs(float(tl_stop_s[k]) - s_x))
            break

    # ---- weather keyframes: pad/clamp to the fixed-slot table; a route
    # without <weathers> gets one clear-noon row (the legacy default)
    wk = route.get("weather_keys") or [[0.0] + list(route["weather"]) + [0.0]]
    wk = sorted(wk, key=lambda r: r[0])[:N_WEATHER_KEYS]
    weather_keys = np.asarray(_pad(np.asarray(wk, np.float32), N_WEATHER_KEYS))
    n_weather = len(wk)

    # ---- opposite-lane validity: the left-offset point must be a full lane
    # from EVERY route point (not just its own) or the lane cuts the corner
    off_pts = xy + C.LANE_WIDTH * _left(dirs)
    d_all = np.linalg.norm(off_pts[:, None, :] - xy[None, :, :], axis=-1)  # [n, n]
    opp_ok_route = d_all.min(axis=1) > 0.75 * C.LANE_WIDTH
    opp_ok = np.zeros(C.MAX_ROUTE_POINTS, bool)
    m2 = min(n, C.MAX_ROUTE_POINTS)
    opp_ok[:m2] = opp_ok_route[:m2]

    return WorldSpec(
        route_xy=_pad(xy, m),
        route_dir=_pad(dirs, m),
        n_route=np.int32(n),
        route_len=np.float32(n - 1),
        spawn_pos=spawn_override if spawn_override is not None else xy[0],
        spawn_yaw=np.float32(math.atan2(dirs[0][1], dirs[0][0])),
        scenario_type=stypes,
        trigger_s=trig_ss,
        flow_xy=flow_xy,
        flow_dir=flow_dir,
        flow_len=flow_len,
        flow_speed=flow_speed,
        flow_gap_lo=flow_gap[:, 0],
        flow_gap_hi=flow_gap[:, 1],
        flow_enabled=flow_enabled,
        flow_kind=flow_kind,
        statics_pos=statics_pos,
        statics_yaw=statics_yaw,
        statics_extent=statics_extent,
        statics_alive=statics_alive,
        veh_pos=veh_pos,
        veh_yaw=veh_yaw,
        veh_kind=veh_kind,
        veh_extent=veh_extent,
        veh_alive=veh_alive,
        veh_target_speed=veh_tspeed,
        walk_pos=walk_pos,
        walk_vel=walk_vel,
        walk_ttl=walk_ttl,
        scen_pos=scen_pos_arr,
        scen_aux=scen_aux_arr,
        scen_veh_base=scen_veh_base,
        scen_walk_base=scen_walk_base,
        scen_walk_n=scen_walk_n,
        route_id=np.int32(route["id"]),
        weather=np.asarray(route["weather"], np.float32),
        tl_stop_s=tl_stop_s,
        tl_offset=tl_offset,
        n_tl=np.int32(n_tl),
        tl_green_s=tl_green,
        tl_yellow_s=tl_yellow,
        tl_red_s=tl_red,
        stop_s=stop_s,
        n_stop=np.int32(n_stop),
        amb_enabled=np.bool_(ambient),
        amb_speed=np.float32(7.0),
        amb_clear=amb_clear,
        amb_opp_clear=amb_opp_clear,
        lane_allow=lane_allow,
        weather_keys=weather_keys,
        n_weather=np.int32(n_weather),
        opp_ok=opp_ok,
        jct_flow=np.bool_(jct_flow),
        jct_cross_s=np.float32(jct_cross_s),
        jct_hold_s=np.float32(jct_hold_s),
        jct_signal=np.int32(jct_signal),
    )


def stack_specs(specs: list[WorldSpec]) -> WorldSpec:
    """Leaf-wise stack into a batched WorldSpec (leading world axis)."""
    return WorldSpec(**{f.name: np.stack([getattr(sp, f.name) for sp in specs])
                        for f in dataclasses.fields(WorldSpec)})


def spec_rows(spec: WorldSpec, rows) -> WorldSpec:
    """The worlds ``rows`` (an index array, repeats allowed) of a stacked
    numpy WorldSpec."""
    return WorldSpec(**{f.name: getattr(spec, f.name)[rows] for f in dataclasses.fields(WorldSpec)})


def to_torch(spec: WorldSpec, device="cuda") -> WorldSpec:
    """A stacked numpy WorldSpec as tensors on ``device`` (dtypes kept:
    float32, int32, bool)."""
    return WorldSpec(**{f.name: torch.tensor(np.asarray(getattr(spec, f.name)), device=device)
                        for f in dataclasses.fields(WorldSpec)})


def load_benchmark_specs(route_ids, junction_traffic: bool | None = None,
                         routes_file=None, parked_tables_path="auto") -> WorldSpec:
    """Stacked WorldSpec of the benchmark routes ``route_ids`` from
    ``routes_file``: the compiled routes220.json.gz (the default, vendored)
    or the reference's bench2drive220.xml. ``parked_tables_path`` is a
    parked-vehicle table (.npz, or the reference's parked_vehicles.py
    literals), None for none, or "auto": the vendored .npz, else
    ../leaderboard/utils/parked_vehicles.py beside the route file (the JAX
    package's ``load_benchmark_specs``)."""
    from ..data.vendored import parked_tables_path as vendored_parked, routes_path

    if not route_ids:
        raise ValueError("load_benchmark_specs: route_ids must name at least "
                         "one route (e.g. [3100])")
    routes_file = str(routes_file or routes_path())
    routes = parse_routes(routes_file, list(route_ids))
    if parked_tables_path == "auto":
        cand = os.path.join(os.path.dirname(routes_file), "..", "leaderboard", "utils",
                            "parked_vehicles.py")
        found = vendored_parked()
        parked_tables_path = (str(found) if found.exists()
                              else cand if os.path.exists(cand) else None)
    tables = load_parked_tables(parked_tables_path) if parked_tables_path else {}
    # pad every route to the batch's max scenario count so the specs stack
    # (bench2drive220 routes all carry exactly one -> K=1)
    k = max(1, max(len(routes[r]["scenarios"] or []) for r in route_ids))
    return stack_specs(
        [build_world_spec(routes[r], parked=tables.get(routes[r]["town"]), n_scen=k,
                          junction_traffic=junction_traffic)
         for r in route_ids]
    )
