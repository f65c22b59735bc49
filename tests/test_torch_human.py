"""Port parity: human driving and the eye tracker (eval/human.py,
cli/drive.py, io/gazepoint.py).

On the same inputs the port's keyboard and joystick controllers, its four
gaze sources and its Gazepoint record parser equal the JAX package's
exactly; a GazepointClient against a loopback server sends the handshake
and holds the last valid point through invalid samples and timeouts.
HumanLoop.run of both packages runs headless (SDL_VIDEODRIVER=dummy) on a
straight route with one scripted key sequence: the observations agree to
one uint8 level on all but fewer than 1% of pixels, with a median
difference of 0 (tests/test_raster.py's render bar: the port's render
visits the TPU kernel's row sets, JAX's CPU render every row, and a near
tie of their argmins flips a pixel between road and marking), actions and
gaze are equal, the stats.json scores agree within 1e-4. The loop's core
(start, tick, save) replayed through cli/collect.collect with the same
draws gives the recorded frames bitwise and the same score; drive.main
ends on a posted QUIT event.
"""

import functools
import json
import queue
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gabril_carla_tpu.eval.human as JH
import gabril_carla_tpu.io as JIO
import gabril_carla_tpu.env.world as JW
import gabril_carla_tpu_torch.eval.human as PH
import gabril_carla_tpu_torch.io as PIO
import gabril_carla_tpu_torch.env.world as PW
from gabril_carla_tpu_torch.cli import collect as PC
from gabril_carla_tpu_torch.cli import drive
from gabril_carla_tpu_torch.env.criteria import compute_score
from gabril_carla_tpu_torch.ops.render_kernel import render_kernel
from test_torch_common import cpu_threads

STRAIGHT = {"id": 77, "town": "T", "scenarios": [], "weather": [0, 0, 0, 90],
            "waypoints": np.stack([np.arange(0.0, 60, 2.0), np.zeros(30)], 1).astype(np.float32)}
# the scripted drive: throttle, a left and a right turn, then brake
KEYS = [{"up"}] * 5 + [{"up", "left"}] * 3 + [{"up", "right"}] * 3 + [{"down"}] * 3
SCORE_TOL = 1e-4
FLOOD = '<REC FPOGX="0.9" FPOGY="0.9" FPOGV="0" />' * 14  # 14 invalid records, over 512 characters
PAYLOADS = [
    '<REC TIME="1.0" FPOGX="0.51" FPOGY="0.32" FPOGV="1" />',
    '<REC FPOGX="0.61" FPOGY="0.22" FPOGV="0" />',  # invalid: hold
    '<REC FPOGX="1.40" FPOGY="0.30" FPOGV="1" />',  # out of range: hold
    '<REC FPOGX="0.2" FPOGY="0.9" />',  # no FPOGV: valid
    '<REC FPOGX="0.3" FPOGY="0.4" FPOGV="1" /><REC FPOGX="0.7" FPOGY="0.6" FPOGV="1" />',
    '<REC TIME="3.0" />',  # no point
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_threads(1):
        yield


# --- controllers and gaze sources ----------------------------------------------------------------

def key_dicts(seq):
    keys = ("up", "down", "left", "right", "reverse")
    return [{k: k in s for k in keys} for s in seq]


def test_keyboard_controller_matches_jax():
    rng = np.random.default_rng(0)
    names = ["up", "down", "left", "right", "reverse"]
    seq = key_dicts(KEYS) + [{k: bool(v) for k, v in zip(names, rng.random(5) < 0.4)}
                             for _ in range(60)] + [{}] * 20
    for kw in ({}, {"steer_rate": 2.0, "steer_return": 1.0, "dt": 0.1}):
        j, p = JH.KeyboardController(**kw), PH.KeyboardController(**kw)
        for keys in seq:
            np.testing.assert_array_equal(p.action(keys), j.action(keys))


def test_joystick_controller_matches_jax():
    rng = np.random.default_rng(1)
    seqs = [list(rng.uniform(-1, 1, 20)) for _ in range(40)] + [[0.0, 0.3], [], [0.05] * 20]
    for kw in ({}, {"steer_axis": 0, "throttle_axis": 1, "deadzone": 0.2, "smooth": 0.9}):
        j, p = JH.JoystickController(**kw), PH.JoystickController(**kw)
        for axes in seqs:
            np.testing.assert_array_equal(p.action(axes), j.action(axes))


def test_joystick_attach_without_hardware_raises(monkeypatch):
    pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    with pytest.raises(RuntimeError, match="no joystick"):
        PH.JoystickController().attach()


class LoopbackTracker:
    """A Gazepoint server on 127.0.0.1: accepts one client, keeps its
    handshake, and sends each payload put with ``send``."""

    def __init__(self):
        self.server = socket.create_server(("127.0.0.1", 0))
        self.port = self.server.getsockname()[1]
        self.outbox = queue.Queue()
        self.handshake = b""
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.server.accept()
        with conn:
            conn.settimeout(10)
            while not self.handshake.endswith(b"\r\n") or self.handshake.count(b"\r\n") < 2:
                self.handshake += conn.recv(4096)
            while (msg := self.outbox.get(timeout=30)) is not None:
                conn.sendall(msg.encode())

    def send(self, payload: str):
        self.outbox.put(payload)

    def close(self):
        self.outbox.put(None)
        self.thread.join(timeout=10)
        self.server.close()
        assert not self.thread.is_alive()


@pytest.fixture
def trackers():
    made = []

    def make():
        made.append(LoopbackTracker())
        return made[-1]
    yield make
    for t in made:
        t.close()


@pytest.mark.parametrize("payload", PAYLOADS + ["".join(PAYLOADS), "", "<REC FPOGX=\"x\" />"])
def test_parse_gazepoint_records_matches_jax(payload):
    assert PIO.parse_gazepoint_records(payload) == JIO.parse_gazepoint_records(payload)


def test_gazepoint_client_matches_jax_and_holds_last_valid(trackers):
    """Both clients on the same stream. The client parses what is left of
    its last 512 characters with each new read, so a valid point stays
    visible until a flood of invalid records pushes it out; then, and on
    a timeout, it returns the last valid point flagged invalid."""
    runs = []
    for io in (JIO, PIO):
        tracker = trackers()
        client = io.GazepointClient(port=tracker.port, timeout=0.3)
        try:
            got = [client.poll()]  # a timeout before any sample
            for payload in PAYLOADS + [FLOOD, FLOOD]:
                tracker.send(payload)
                got.append(client.poll())
        finally:
            client.close()
        assert tracker.handshake == io.GazepointClient.ENABLE
        runs.append(got)
    assert runs[1] == runs[0]
    got = runs[1]
    assert got[0] == (0.5, 0.5, False) and got[1] == (0.51, 0.32, True)
    assert got[5] == (0.7, 0.6, True)  # the later of two valid records
    assert got[-1] == (0.7, 0.6, False)  # held through the flood


@pytest.mark.parametrize("kind", ["center", "dummy", "mouse", "gazepoint"])
def test_gaze_sources_match_jax(kind, trackers, monkeypatch):
    rng = np.random.default_rng(2)
    mouse = [tuple(rng.uniform(-0.3, 1.3, 2)) for _ in range(30)]
    sources, feeds = [], []
    for pkg, io in ((JH, JIO), (PH, PIO)):
        if kind == "gazepoint":
            tracker = trackers()
            monkeypatch.setattr(io, "GazepointClient",
                                functools.partial(io.GazepointClient, port=tracker.port, timeout=0.3))
            feeds.append(tracker)
        sources.append(pkg.GazeSource(kind, seed=3))
    steps = len(PAYLOADS) if kind == "gazepoint" else len(mouse)
    for i in range(steps):
        for t in feeds:
            t.send(PAYLOADS[i])
        want, got = (s.sample(mouse[i]) for s in sources)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (2,)
    for s in sources:
        if s.client is not None:
            s.client.close()


# --- the loop ------------------------------------------------------------------------------------

class FakePressed:
    def __init__(self, pygame, keys: set):
        names = {"up": pygame.K_UP, "down": pygame.K_DOWN, "left": pygame.K_LEFT,
                 "right": pygame.K_RIGHT, "reverse": pygame.K_r}
        self.down = {names[k] for k in keys}

    def __getitem__(self, code):
        return code in self.down


def headless_run(loop, monkeypatch, seed, ticks):
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    presses = iter([FakePressed(pygame, k) for k in KEYS])
    monkeypatch.setattr(pygame.key, "get_pressed", lambda: next(presses))
    return loop.run(seed=seed, max_steps=ticks)


def episode(ep):
    return (np.load(ep / "observations.npz")["observations"], np.load(ep / "actions.npz")["actions"],
            np.load(ep / "gaze.npz")["gaze"], json.loads((ep / "stats.json").read_text()))


@functools.lru_cache(maxsize=None)
def jax_drive(out):
    spec = jax.tree.map(jnp.asarray, JW.build_world_spec(STRAIGHT))
    with pytest.MonkeyPatch.context() as mp:
        return episode(headless_run(JH.HumanLoop(spec, out, gaze="dummy", display_scale=1),
                                    mp, 1, len(KEYS)))


def test_headless_run_matches_jax(tmp_path, tmp_path_factory, monkeypatch):
    want = jax_drive(str(tmp_path_factory.mktemp("jax_drive")))
    spec = PW.stack_specs([PW.build_world_spec(STRAIGHT)])
    before = render_kernel.launches
    ep = headless_run(PH.HumanLoop(spec, tmp_path, gaze="dummy", display_scale=1, device="cpu"),
                      monkeypatch, 1, len(KEYS))
    assert render_kernel.launches == before  # CPU tensors take the plain render
    assert ep == tmp_path / "route_77" / "seed_1"
    obs, acts, gaze, stats = episode(ep)
    jobs, jacts, jgaze, jstats = want
    assert obs.shape == jobs.shape == (len(KEYS), 180, 320, 3) and obs.dtype == np.uint8
    diff = np.abs(obs.astype(np.int16) - jobs)
    assert (diff > 1).mean() < 0.01 and np.median(diff) == 0, (diff.max(), (diff > 1).mean())
    np.testing.assert_array_equal(acts, jacts)
    np.testing.assert_array_equal(gaze, jgaze)
    assert acts[:5, 0].min() > 0 and acts[5:8, 1].max() < 0 and acts[-1, 2] == 1.0
    assert stats["route_id"] == jstats["route_id"] and stats["seed"] == jstats["seed"] == 1
    assert stats["meta"] == jstats["meta"]
    for k, v in jstats["scores"].items():
        assert abs(stats["scores"][k] - v) <= SCORE_TOL, k


def test_tick_draws_are_env_draws():
    """The loop's draws, tick by tick, are env_draws' for the reset keys."""
    from gabril_carla_tpu_torch.utils.prng import env_draws, prng_key, tick_draws

    keys = np.stack([prng_key(200), prng_key(2**40 + 7)])
    rng, got = keys, []
    for _ in range(25):
        rng, d = tick_draws(rng)
        got.append(d)
    np.testing.assert_array_equal(np.stack(got), env_draws(keys, 25))


def test_core_replays_through_collect(tmp_path):
    """start/tick/save on route 3100, then cli/collect.collect with the
    recorded actions and the seed's draws: the recorded frames bitwise,
    and the same score."""
    spec = PW.load_benchmark_specs([3100])
    loop = PH.HumanLoop(spec, tmp_path, gaze="dummy", device="cpu")
    loop.start(seed=200)
    ctrl = PH.KeyboardController()
    for keys in key_dicts(KEYS):
        frame = loop.tick(ctrl.action(keys), loop.gaze.sample())
        assert frame.shape == (180, 320) and frame.dtype == np.float32
    assert loop.ticks == len(KEYS) and not loop.done
    obs, acts, gaze, stats = episode(loop.save())
    st, frames, actions, _ = PC.collect(PW.to_torch(spec, "cpu"), len(KEYS),
                                        PC.seed_draws([200], len(KEYS), "cpu"),
                                        torch.from_numpy(acts))
    np.testing.assert_array_equal(frames[:, 0].numpy(), obs[..., 0])
    np.testing.assert_array_equal(actions[:, 0].numpy(), acts)
    assert (gaze[:, 2:] == -1).all() and (gaze[:, :2] >= 0).all()
    score = compute_score(PW.to_torch(spec, "cpu"), st)
    assert stats["route_id"] == "RouteScenario_3100" and stats["seed"] == 200
    assert stats["scores"]["score_composed"] == pytest.approx(float(score["score_composed"][0]), abs=1e-6)
    assert torch.equal(st.ego.pos, loop.state.ego.pos)


def test_loop_refuses_bad_input(tmp_path):
    with pytest.raises(ValueError, match="controller"):
        PH.HumanLoop(None, tmp_path, controller="wheel")
    with pytest.raises(ValueError, match="one world"):
        PH.HumanLoop(PW.load_benchmark_specs([3100, 1825]), tmp_path, device="cpu")
    loop = PH.HumanLoop(PW.load_benchmark_specs([3100]), tmp_path, device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        loop.tick(np.zeros(7, np.float32), (0.5, 0.5))
    loop.start(0)
    with pytest.raises(RuntimeError, match="no ticks"):
        loop.save()


def test_drive_main_ends_on_quit(tmp_path, monkeypatch):
    pygame = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    set_mode = pygame.display.set_mode

    def set_mode_then_quit(*a, **kw):  # the window opens, then the user closes it
        screen = set_mode(*a, **kw)
        pygame.event.post(pygame.event.Event(pygame.QUIT))
        return screen
    monkeypatch.setattr(pygame.display, "set_mode", set_mode_then_quit)
    assert drive.main(["--route", "3100", "--seed", "5", "--gaze", "center", "--display_scale", "1",
                       "--out", str(tmp_path)], device="cpu") == 0
    obs, acts, gaze, stats = episode(tmp_path / "route_3100" / "seed_5")
    assert len(obs) == len(acts) == len(gaze) == 1  # the tick of the QUIT event, then saved
    np.testing.assert_array_equal(gaze[0, :2], [0.5, 0.5])
    assert stats["seed"] == 5
