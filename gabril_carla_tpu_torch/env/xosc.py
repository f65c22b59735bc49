"""OpenSCENARIO (.xosc) ingestion: compile a storyboard into a route dict (a
copy of gabril_carla_tpu/env/xosc.py: numpy and the standard library only).

The reference runs .xosc files through ScenarioRunner's interpreter
(eval/srunner/tools/openscenario_parser.py, ~2k lines building py_trees
behaviors per storyboard action, driven against the live CARLA server).
This framework compiles worlds ahead of time (env/world.py:build_world_spec),
so the xosc path does the same thing it does for route XML: statically
translate the scenario *setup* — entities, init placements, environment,
and the adversary's triggered maneuver — into a route dict whose scenario
record one of the existing phase machines executes inside the env step.

Supported (the subset the reference's examples/ actually exercise with
world coordinates):
  * ParameterDeclarations + ``$name`` substitution
    (openscenario_parser.py's ParameterRef handling)
  * Entities: Vehicle (car/bicycle category) and Pedestrian objects
  * Init: TeleportAction with WorldPosition; RelativeWorldPosition /
    RelativeRoadPosition resolved against already-placed entities
  * EnvironmentAction: Sun elevation, Fog visualRange, Precipitation,
    cloudState -> the 4-slot weather vector (env/world.py weather order)
  * Storyboard events: the adversary's first SpeedAction plus its
    RelativeDistanceCondition / TimeHeadwayCondition trigger distance
  * Ego route: hero teleport heading, extended straight for ``route_len``
    meters (srunner xosc scenarios have no ego route; the criteria run on
    driven distance — openscenario_configuration.py)

Not supported (needs the OpenDRIVE map srunner queries the server for):
RoadPosition / LanePosition placements and Catalog references — both
raise ValueError naming the construct, so callers can fall back.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

__all__ = ["load_xosc"]


def _params(root: ET.Element) -> dict[str, str]:
    out = {}
    decls = root.find("ParameterDeclarations")
    if decls is not None:
        for d in decls.findall("ParameterDeclaration"):
            out[d.get("name")] = d.get("value", "")
    return out


def _sub(value: str | None, params: dict[str, str]):
    if value is None:
        return None
    if value.startswith("$"):
        name = value[1:]
        if name not in params:
            raise ValueError(f"xosc: undeclared parameter ${name}")
        return params[name]
    return value


def _f(value, params, default=0.0) -> float:
    v = _sub(value, params)
    return float(v) if v not in (None, "") else default


def _resolve_position(pos: ET.Element, placed: dict[str, dict], params) -> tuple[float, float, float]:
    """-> (x, y, yaw_radians). ``placed`` holds already-teleported entities."""
    wp = pos.find("WorldPosition")
    if wp is not None:
        return (_f(wp.get("x"), params), _f(wp.get("y"), params), _f(wp.get("h"), params))
    def _ref(name):
        if name not in placed:
            raise ValueError(
                f"xosc: Relative*Position references entity '{name}' before "
                "its own TeleportAction (Init blocks resolve in document "
                "order); reorder the Init Private actions")
        return placed[name]

    rel = pos.find("RelativeWorldPosition")
    if rel is not None:
        ref = _ref(rel.get("entityRef"))
        return (ref["x"] + _f(rel.get("dx"), params),
                ref["y"] + _f(rel.get("dy"), params), ref["yaw"])
    rrp = pos.find("RelativeRoadPosition")
    if rrp is not None:
        # ds along the referenced entity's heading, dt to its left — the
        # straight-road approximation of the srunner road-frame transform
        ref = _ref(rrp.get("entityRef"))
        ds, dt = _f(rrp.get("ds"), params), _f(rrp.get("dt"), params)
        c, s = math.cos(ref["yaw"]), math.sin(ref["yaw"])
        return (ref["x"] + ds * c - dt * s, ref["y"] + ds * s + dt * c, ref["yaw"])
    for tag in ("RoadPosition", "LanePosition"):
        if pos.find(tag) is not None:
            raise ValueError(
                f"xosc: {tag} needs the OpenDRIVE road network (srunner asks the "
                "CARLA server); use WorldPosition or a Relative*Position")
    raise ValueError(f"xosc: unsupported Position variant {[c.tag for c in pos]}")


def _entity_kinds(root: ET.Element) -> dict[str, str]:
    """name -> 'car' | 'bicycle' | 'pedestrian'."""
    kinds = {}
    for obj in root.iter("ScenarioObject"):
        name = obj.get("name")
        if obj.find("CatalogReference") is not None:
            raise ValueError("xosc: CatalogReference entities are not supported")
        veh, ped = obj.find("Vehicle"), obj.find("Pedestrian")
        if ped is not None:
            kinds[name] = "pedestrian"
        elif veh is not None:
            cat = veh.get("vehicleCategory", "car")
            kinds[name] = "bicycle" if cat == "bicycle" else "car"
    return kinds


def _weather(root: ET.Element, params) -> list[float]:
    """[cloudiness, precipitation, fog_density, sun_altitude_deg]."""
    out = [0.0, 0.0, 0.0, 90.0]
    env = root.find(".//EnvironmentAction/Environment")
    if env is None:
        return out
    w = env.find("Weather")
    if w is None:
        return out
    cloud = {"free": 0.0, "cloudy": 60.0, "overcast": 85.0, "rainy": 90.0}
    out[0] = cloud.get(w.get("cloudState", "free"), 0.0)
    prec = w.find("Precipitation")
    if prec is not None and prec.get("precipitationType", "dry") != "dry":
        out[1] = 100.0 * _f(prec.get("intensity"), params)
    fog = w.find("Fog")
    if fog is not None:
        vr = _f(fog.get("visualRange"), params, default=1e5)
        # CARLA fog_density 0-100 vs visual range in m: reference towns use
        # density ~ (1 - range/300)*100 below ~300 m, clear above
        out[2] = float(np.clip((1.0 - vr / 300.0) * 100.0, 0.0, 100.0))
    sun = w.find("Sun")
    if sun is not None:
        out[3] = math.degrees(_f(sun.get("elevation"), params, default=math.pi / 2))
    return out


def _adversary_event(root: ET.Element, params,
                     entity: str | None = None) -> tuple[float | None, float]:
    """First triggered SpeedAction -> (trigger_distance_m | None, target_speed).

    With ``entity`` given, the search is scoped to the ManeuverGroups whose
    **Actors block** references that entity (per-adversary events on
    multi-adversary storyboards) — StartTrigger EntityRefs don't count, a
    group that starts *on a condition about* the pedestrian isn't the
    pedestrian's maneuver. An entity with no group of its own (Init-teleport
    props) gets no event; the whole-document fallback applies only to legacy
    docs with no Actors-scoped groups anywhere.
    """
    roots: list[ET.Element] = []
    scoped_any = False
    for g in root.iter("ManeuverGroup"):
        actors = g.find("Actors")
        refs = [] if actors is None else [
            r.get("entityRef") for r in actors.iter("EntityRef")]
        scoped_any = scoped_any or bool(refs)
        if entity is not None and entity in refs:
            roots.append(g)
    if entity is not None and not roots and scoped_any:
        return None, 0.0
    for event in (e for r in (roots or [root]) for e in r.iter("Event")):
        speed = event.find(".//SpeedAction/SpeedActionTarget/AbsoluteTargetSpeed")
        if speed is None:
            continue
        v = _f(speed.get("value"), params)
        if v <= 0.0:
            continue  # stop events sequence after the start event
        dist = None
        for cond in event.iter("Condition"):
            rd = cond.find(".//RelativeDistanceCondition")
            if rd is not None:
                dist = _f(rd.get("value"), params)
                break
            th = cond.find(".//TimeHeadwayCondition")
            if th is not None:
                dist = _f(th.get("value"), params) * max(v, 5.0)
                break
        return dist, v
    return None, 0.0


def load_xosc(path: str | Path, route_len: float = 150.0) -> dict:
    """Parse one .xosc file -> route dict for build_world_spec.

    route_len: meters of straight ego route synthesized along the hero's
    init heading (xosc scenarios carry no ego route).
    """
    path = Path(path)
    root = ET.parse(path).getroot()
    params = _params(root)
    kinds = _entity_kinds(root)
    if "hero" not in kinds:
        raise ValueError("xosc: no 'hero' ScenarioObject (ego_vehicle)")

    town_node = root.find("RoadNetwork/LogicFile")
    town = town_node.get("filepath", "Town") if town_node is not None else "Town"

    # Init teleports, in document order so Relative*Position can chain
    placed: dict[str, dict] = {}
    for private in root.findall(".//Init/Actions/Private"):
        ref = private.get("entityRef")
        tp = private.find(".//TeleportAction/Position")
        if tp is None:
            continue
        x, y, yaw = _resolve_position(tp, placed, params)
        placed[ref] = {"x": x, "y": y, "yaw": yaw, "kind": kinds.get(ref, "car")}
    if "hero" not in placed:
        raise ValueError("xosc: hero has no TeleportAction in Init")

    hero = placed["hero"]
    hx, hy, hyaw = hero["x"], hero["y"], hero["yaw"]
    fwd = np.array([math.cos(hyaw), math.sin(hyaw)], np.float32)
    waypoints = np.stack([
        np.array([hx, hy], np.float32) + fwd * s
        for s in np.arange(0.0, route_len, 2.0)
    ])

    # Adversaries -> one scenario record each on the synthesized route
    # (WorldSpec carries K scenario slots; pool overflows fail loudly at
    # build time, which is the designed capacity contract)
    scenarios = []
    adversaries = [(n, e) for n, e in placed.items() if n != "hero"]
    for name, adv in adversaries:
        trig_dist, speed = _adversary_event(root, params, entity=name)
        s_adv = float(np.clip(fwd @ (np.array([adv["x"], adv["y"]]) - [hx, hy]),
                              5.0, route_len - 10.0))
        arm = 12.0 if trig_dist is None else trig_dist
        s_trig = max(0.0, s_adv - arm)
        p_trig = np.array([hx, hy]) + fwd * s_trig
        rec_type = {"pedestrian": "PedestrianCrossing",
                    "bicycle": "DynamicObjectCrossing",
                    "car": "HardBreakRoute"}[adv["kind"]]
        if adv["kind"] == "car" and speed <= 0.0:
            # Init-teleport-only vehicle with no maneuver of its own: a
            # parked prop (static blocker), not a braking lead
            rec_type = "ParkedObstacle"
        rec = {"type": rec_type,
               "trigger": (float(p_trig[0]), float(p_trig[1]), math.degrees(hyaw)),
               "distance": float(arm)}
        if speed > 0.0:
            rec["speed"] = float(speed)
        scenarios.append(rec)

    # WorldSpec carries route_id as int32 (seeds the traffic-light offsets);
    # derive a stable one from the scenario name
    rid = int.from_bytes(path.stem.encode()[:8].ljust(8, b"\0"), "big") % (2**31 - 1)
    return {
        "id": rid,
        "name": path.stem,
        "town": town,
        "waypoints": waypoints,
        "scenarios": scenarios,
        "weather": _weather(root, params),
        "weather_keys": [],
    }
