"""Interactive human data collection: pygame display + keyboard or joystick
driving (port of gabril_carla_tpu/eval/human.py).

Parity with HumanAgent (eval/my_agents/human_agent.py:98-372): real-time
window at the render resolution, keyboard vehicle control with incremental
steering, per-tick gaze sampling from a pluggable source ('center' fixed,
'dummy' drifting point, 'mouse' cursor-as-gaze, 'gazepoint' eye tracker via
io.gazepoint), invalid-gaze hold-last-valid, and episode saving in the
dataset layout (observations/actions/gaze .npz and stats.json).

The control mapping and gaze sources are pure. ``HumanLoop`` splits the
JAX package's one pygame loop into a pygame-free core (``start``, ``tick``,
``save``) on the card (or the CPU when asked) and the pygame shell ``run``
around it; pygame is imported only in ``run`` and
``JoystickController.attach``/``read`` (SDL_VIDEODRIVER=dummy runs them
headless).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch


class KeyboardController:
    """Incremental keyboard -> 7-action control (human_agent.py keyboard map)."""

    def __init__(self, steer_rate: float = 1.6, steer_return: float = 2.5, dt: float = 0.05):
        self.steer = 0.0
        self.steer_rate = steer_rate
        self.steer_return = steer_return
        self.dt = dt

    def action(self, keys: dict) -> np.ndarray:
        left, right = keys.get("left", False), keys.get("right", False)
        if left and not right:
            self.steer = max(-1.0, self.steer - self.steer_rate * self.dt)
        elif right and not left:
            self.steer = min(1.0, self.steer + self.steer_rate * self.dt)
        else:  # return to center
            mag = max(0.0, abs(self.steer) - self.steer_return * self.dt)
            self.steer = math.copysign(mag, self.steer)
        throttle = 0.8 if keys.get("up", False) else 0.0
        brake = 1.0 if keys.get("down", False) else 0.0
        reverse = 1.0 if keys.get("reverse", False) else 0.0
        return np.asarray([throttle, self.steer, brake, 0.0, reverse, 0.0, 0.0], np.float32)


class JoystickController:
    """Wheel/gamepad axes -> 7-action control (human_agent.py:255-309 parity).

    The reference's JoystickControl maps steering from one input and a
    signed throttle/brake input: throttle = 0.8*y for y>0, brake = -y for
    y<=0, and smooths steering with an EMA (new = 0.99*cache + 0.01*x)
    under a 0.1 deadzone. Its indices address the BUTTONS+AXES concatenated
    vector (get_current_controller_state appends buttons first, then axes),
    and ``read()`` returns the same concatenation here, so the default
    indices (16 steer, 19 inverted throttle) land on the same physical
    controls as the reference's wheel. Indices are configurable per device.
    The mapping is a pure function of the input vector; ``read()`` pulls it
    from the first pygame joystick.
    """

    def __init__(self, steer_axis: int = 16, throttle_axis: int = 19,
                 deadzone: float = 0.1, smooth: float = 0.99):
        self.steer_axis = steer_axis
        self.throttle_axis = throttle_axis
        self.deadzone = deadzone
        self.smooth = smooth
        self.steer = 0.0
        self.joystick = None

    def attach(self):
        """Init pygame joystick 0; raises RuntimeError when none is present
        (the reference exits; a loud error is kinder in a library)."""
        import pygame

        pygame.joystick.init()
        if pygame.joystick.get_count() == 0:
            raise RuntimeError("no joystick detected — use controller='keyboard'")
        self.joystick = pygame.joystick.Joystick(0)
        self.joystick.init()
        return self.joystick.get_name()

    def read(self) -> list:
        """Buttons then axes, concatenated: the reference's
        get_current_controller_state layout, which its default indices
        16/19 are calibrated against."""
        import pygame

        pygame.event.pump()
        return ([float(self.joystick.get_button(b))
                 for b in range(self.joystick.get_numbuttons())]
                + [self.joystick.get_axis(a)
                   for a in range(self.joystick.get_numaxes())])

    def action(self, axes) -> np.ndarray:
        n = max(self.steer_axis, self.throttle_axis) + 1
        axes = list(axes) + [0.0] * (n - len(axes))
        x = axes[self.steer_axis]
        y = -axes[self.throttle_axis]
        throttle = 0.8 * y if y > 0 else 0.0
        brake = -y if y <= 0 else 0.0
        self.steer = (self.smooth * self.steer + (1.0 - self.smooth) * x
                      if abs(x) > self.deadzone else 0.0)
        return np.asarray([throttle, self.steer, brake, 0.0, 0.0, 0.0, 0.0], np.float32)


class GazeSource:
    """'center' | 'dummy' | 'mouse' | 'gazepoint' -> [0,1]^2 with hold-last-valid."""

    def __init__(self, kind: str = "center", seed: int = 0):
        self.kind = kind
        self.rng = np.random.default_rng(seed)
        self.pos = np.asarray([0.5, 0.5])
        self.client = None
        if kind == "gazepoint":
            from ..io import GazepointClient

            self.client = GazepointClient()

    def sample(self, mouse_xy01=None) -> np.ndarray:
        if self.kind == "center":
            return np.asarray([0.5, 0.5])
        if self.kind == "dummy":  # drifting point (human_agent.py:180-199)
            self.pos = np.clip(self.pos + self.rng.normal(0, 0.02, 2), 0.05, 0.95)
            return self.pos.copy()
        if self.kind == "mouse" and mouse_xy01 is not None:
            x, y = mouse_xy01
            if 0.0 <= x <= 1.0 and 0.0 <= y <= 1.0:
                self.pos = np.asarray([x, y])
            return self.pos.copy()
        if self.client is not None:
            x, y, valid = self.client.poll()
            if valid:
                self.pos = np.asarray([x, y])
            return self.pos.copy()
        return self.pos.copy()


class HumanLoop:
    """Real-time drive-and-record loop on one world.

    ``spec`` is a one-world stacked numpy WorldSpec (env/world.py
    ``load_benchmark_specs([route])``); the env and the render run on
    ``device``. The core: ``start(seed)`` resets the world and takes its env
    draws from JAX's key ``PRNGKey(seed)`` (utils/prng.py), tick by tick;
    ``tick(action, gaze)`` renders the frame (one render-kernel launch on
    the card), records it with the action and gaze, and steps the env;
    ``save()`` writes the episode. ``run`` is the pygame shell around them.
    """

    def __init__(self, spec, out_dir: str | Path, gaze: str = "mouse",
                 display_scale: int = 3, fps: float = 20.0, max_points: int = 5,
                 controller: str = "keyboard", device="cuda"):
        if controller not in ("keyboard", "joystick"):  # human_agent.py:120
            raise ValueError(f"controller must be 'keyboard' or 'joystick', got {controller!r}")
        if np.shape(spec.route_len) != (1,):
            raise ValueError("HumanLoop drives one world: pass a stacked WorldSpec of one route, "
                             f"got route_len of shape {np.shape(spec.route_len)}")
        self.spec = spec
        self.out = Path(out_dir)
        self.gaze = GazeSource(gaze)
        self.scale = display_scale
        self.fps = fps
        self.max_points = max_points
        self.controller = controller
        self.device = torch.device(device)
        self.state = None

    @torch.inference_mode()
    def start(self, seed: int = 0):
        """Reset the world; the env draws follow JAX's PRNGKey(seed)."""
        from ..env.env import DrivingEnv
        from ..env.world import to_torch
        from ..utils.prng import prng_key

        self.env = DrivingEnv()
        self.spec_t = to_torch(self.spec, self.device)
        self.state = self.env.reset(self.spec_t)
        self.seed = seed
        self._rng = prng_key(seed)[None]
        self.obs_log, self.act_log, self.gaze_log = [], [], []

    @property
    def ticks(self) -> int:
        return len(self.obs_log)

    @property
    def done(self) -> bool:
        return bool(self.state.done[0])

    @torch.inference_mode()
    def tick(self, action, gaze) -> np.ndarray:
        """Render the current frame, record it with ``action`` [7] and
        ``gaze`` (x, y) in [0, 1], then step the env with ``action``.
        Returns the frame, float32 [180, 320] in [0, 1]."""
        from ..ops.raster import render_frame
        from ..utils.prng import tick_draws

        if self.state is None:
            raise RuntimeError("HumanLoop.tick before start()")
        frame = render_frame(self.spec_t, self.state)
        self.obs_log.append((frame * 255).to(torch.uint8)[0].cpu().numpy())
        g = np.full((self.max_points, 2), -1.0, np.float32)
        g[0] = gaze
        self.gaze_log.append(g.reshape(-1))
        action = np.asarray(action, np.float32)
        self.act_log.append(action)
        self._rng, draws = tick_draws(self._rng)
        self.state = self.env.step(self.spec_t, self.state,
                                   torch.from_numpy(action).to(self.device)[None],
                                   torch.from_numpy(draws).to(self.device))
        return frame[0].cpu().numpy()

    def save(self) -> Path:
        """<out>/route_<id>/seed_<seed>/ observations.npz (uint8 [n, 180,
        320, 3]), actions.npz, gaze.npz, and stats.json; returns the
        episode directory."""
        from ..env.criteria import compute_score
        from .stats import route_record, write_stats_json

        if not self.obs_log:
            raise RuntimeError("HumanLoop.save: no ticks recorded")
        rid = int(self.spec.route_id[0])
        ep = self.out / f"route_{rid}" / f"seed_{self.seed}"
        ep.mkdir(parents=True, exist_ok=True)
        obs = np.stack(self.obs_log)[..., None].repeat(3, -1)
        np.savez_compressed(ep / "observations.npz", observations=obs)
        np.savez_compressed(ep / "actions.npz", actions=np.stack(self.act_log))
        np.savez_compressed(ep / "gaze.npz", gaze=np.stack(self.gaze_log))
        with torch.inference_mode():
            score = {k: v[0].cpu() for k, v in compute_score(self.spec_t, self.state).items()}
        rec = route_record(rid, self.seed, score, duration_game=self.ticks * 0.05,
                           route_length=float(self.spec.route_len[0]))
        write_stats_json(self.out, rec)
        print(f"saved {self.ticks} ticks, score {rec['scores']['score_composed']:.1f} -> {ep}")
        return ep

    def run(self, seed: int = 0, max_steps: int = 12000) -> Path:
        """Drive in a pygame window until q, the window's close, the route's
        end or ``max_steps`` ticks; then save."""
        import pygame

        self.start(seed)
        pygame.init()
        w, h = 320 * self.scale, 180 * self.scale
        screen = pygame.display.set_mode((w, h))
        pygame.display.set_caption("gabril_carla_tpu_torch — drive (arrows; q to quit+save)")
        clock = pygame.time.Clock()
        if self.controller == "joystick":
            ctrl = JoystickController()
            print(f"joystick: {ctrl.attach()}")
        else:
            ctrl = KeyboardController()

        running = True
        while running and self.ticks < max_steps and not self.done:
            for ev in pygame.event.get():
                if ev.type == pygame.QUIT or (ev.type == pygame.KEYDOWN and ev.key == pygame.K_q):
                    running = False
            mx, my = pygame.mouse.get_pos()
            gaze = self.gaze.sample((mx / max(w - 1, 1), my / max(h - 1, 1)))
            if self.controller == "joystick":
                action = ctrl.action(ctrl.read())
            else:
                pressed = pygame.key.get_pressed()
                action = ctrl.action({"up": pressed[pygame.K_UP], "down": pressed[pygame.K_DOWN],
                                      "left": pressed[pygame.K_LEFT], "right": pressed[pygame.K_RIGHT],
                                      "reverse": pressed[pygame.K_r]})
            frame = self.tick(action, gaze)

            surf = pygame.surfarray.make_surface(
                np.repeat((frame.T[:, :, None] * 255).astype(np.uint8), 3, axis=2)
            )
            screen.blit(pygame.transform.scale(surf, (w, h)), (0, 0))
            pygame.draw.circle(screen, (255, 60, 60), (int(gaze[0] * w), int(gaze[1] * h)), 6, 2)
            pygame.display.flip()
            clock.tick(self.fps)
        pygame.quit()
        return self.save()
