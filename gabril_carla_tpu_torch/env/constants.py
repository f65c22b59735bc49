"""Simulation constants (CARLA-calibrated where the reference pins them)."""

# Fixed 20 Hz synchronous stepping (eval/env_manager.py:91-92,430)
DT = 0.05
FPS = 20.0

# Ego vehicle: lincoln.mkz_2020 (leaderboard route_scenario.py:144-161)
EGO_WHEELBASE = 2.85  # m
EGO_HALF_LEN = 2.45  # m (overall length ~4.9)
EGO_HALF_WID = 0.93
EGO_MAX_STEER_DEG = 70.0  # front wheel angle at steer=1.0 (CARLA mkz ~69.99)
EGO_MAX_ACCEL = 3.0  # m/s^2 full throttle (low-speed effective)
EGO_MAX_BRAKE = 8.0  # m/s^2 full brake
EGO_DRAG = 0.08  # 1/s speed-proportional resistance
EGO_MAX_SPEED = 25.0  # m/s cap

# Fixed-capacity actor pools (vmap-friendly alive-mask pools, SURVEY §7).
# Slots [0, 4): scripted scenario vehicles; [4, 16): the two flow blocks;
# [16, 24): ambient background traffic (BackgroundBehavior-lite, see ambient.py)
N_VEHICLES = 24
N_AMBIENT_SAME = 4  # same-direction ambient slots [16, 20)
N_AMBIENT_OPP = 4  # opposite-lane ambient slots [20, 24)
N_WALKERS = 8
N_STATICS = 24  # props: accident cars, containers, doors (slots 0-7) +
# parked vehicles from the per-town tables (slots 8+, world.py)
N_SCENARIO_STATICS = 8

# Route buffers
MAX_ROUTE_POINTS = 512  # 1 m spacing, routes are <= ~300 m
MAX_FLOW_POINTS = 128  # resampled scenario flow polylines

# Lane geometry (used when OpenDRIVE data is unavailable)
LANE_WIDTH = 3.5
# mini-shoulder forgiveness between lane edge and sidewalk
# (OutsideRouteLanesTest.ALLOWED_OUT_DISTANCE, atomic_criteria.py:996)
ALLOWED_OUT_DISTANCE = 0.5

# Stop signs per route (generalized RunningStopTest, atomic_criteria.py:1799)
N_STOPS = 2

# Traffic-light default cycle (CARLA defaults: green 10 s / yellow 3 s / red
# ~ sum of the other entries' green+yellow; a 25 s cycle is representative)
TL_GREEN_S = 10.0
TL_YELLOW_S = 3.0
TL_RED_S = 12.0

# Criteria thresholds (srunner atomic_criteria.py)
BLOCKED_SPEED = 0.1  # m/s (ActorBlockedTest:417)
BLOCKED_SECONDS = 180.0
IN_ROUTE_RADIUS = 30.0  # m corridor (InRouteTest:1387)
COMPLETION_DIST = 10.0  # m-to-goal rule (RouteCompletionTest 99%/10m)
COMPLETION_PCT = 99.0
COLLISION_RADIUS = 5.0  # m: collisions within this distance of the last one
# count as one (CollisionTest.COLLISION_RADIUS, atomic_criteria.py:296)
COLLISION_MAX_ID_TIME = 5.0  # s: same-actor collisions within this window
# count as one (CollisionTest.MAX_ID_TIME, atomic_criteria.py:297)
COLLISION_EPSILON = 0.1  # m/s: below this ego speed the collision is not the
# ego's fault and is not counted (CollisionTest.EPSILON, atomic_criteria.py:298)
WALKER_RADIUS = 0.35  # m: walker body radius for the OBB-vs-circle contact test
MIN_ROUTE_TIMEOUT = 300.0  # s (timer.py:167-168)
TIMEOUT_SPEED = 10000.0 / 3600.0  # route timeout scale: 10 km/h in m/s

# Driving-score penalty table (statistics_manager.py:21-37)
PENALTY_COLLISION_PEDESTRIAN = 0.50
PENALTY_COLLISION_VEHICLE = 0.60
PENALTY_COLLISION_STATIC = 0.65
PENALTY_RED_LIGHT = 0.70
PENALTY_STOP_SIGN = 0.80
PENALTY_SCENARIO_TIMEOUT = 0.70
PENALTY_YIELD_EMERGENCY = 0.70
PENALTY_MIN_SPEED = 0.70  # per-unit, 'decreases'
