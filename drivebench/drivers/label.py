"""The VLM labeling cell: the port's collection loop (cli/collect.py
``collect``) with the VLM labeler (saliency/vlm_labeler.py, Kimi-VL on
models/kimi_vl.py) labeling every tick's frame and scene boxes.

The worlds are the traffic's routes compiled by the port and tiled to the
cell's world count. Each call of the window is ``ticks_per_call`` ticks
from a reset on fresh per-world keys drawn from the seed (the env draws
worked out from them on the host); calls run back to back. The model's
weights are drawn on the card from the seed (cli/collect.py
``vlm_labeler``; the router's correction bias at the configuration's
``router_bias_std``, then fitted on the first ``balance_worlds`` worlds'
reset frames by ``balance_labeler``), and so is the labeler's prompt
template.

``Taps`` wraps, without a synchronize, the collection's render (a
``drivebench.render`` span, and K1's operands while traced, for
``render_ms_per_tick`` and ``k1_roofline_pct``) and env and
the labeler's and model's steps, and copies for a sample of worlds of one
tick of each call what the output check (``check``) works out again: the
frame and its states, the scene boxes, the prompt, the image tokens, the
logits of the prompt's last position and of each decode step, the answer
and the coordinates. While traced it opens a ``drivebench.moe_prefill`` or
``drivebench.moe_decode`` span around each grouped expert product, whose
device time ``moe_roofline_pct`` reads.

The numbers (``numbers``), after the program is freed, from the plain
references on the card (reference/kimi_vl.py, one layer upcast to float32
at a time; reference/rollout.py's frozen render and env):

* ``vision_err``: the relative L2 gap, over a call's sampled worlds, of
  the projector's output from the reference tower's on the same frame;
* ``route_err``: the most that an expert the port chose for a sampled
  token (prompt and answer, every expert layer) falls below the k-th best
  of the reference's choice scores (sigmoid plus correction bias) for that
  token; infinite where a token took other than k experts;
* ``logit_err``: for the prompt's last position and each decode position,
  the relative L2 gap over the sample of the logits from the reference's
  full causal forward over the prompt and the port's answer (with its own
  image tokens, and each token routed to the experts the port chose: a
  near tie flips a choice under rounding, and one flipped expert moves a
  token by some 15%);
* ``cache_err``: for each layer, the relative L2 gap over the sample's
  prompt tokens of the latent cache (normalised latent and roped key)
  from the reference's;
* ``label_err``: exactly 0 when the prompt's ids and listed boxes are the
  reference's assembly from the scene boxes, the labeler's frame is the
  render's in uint8 and the coordinates are the reference's parse of the
  port's answer (1 for a wrong id or box, else the largest gap);
* ``frame_px``, ``state_err``: the tick's frame against the plain render of
  its state, and the reset and env step from the port's state, action and
  draws (as the eval cells read them);

each the worst over positions, layers and calls.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from unittest import mock

import numpy as np
import torch
from torch.profiler import record_function

from ..common import SPAN, host_rng, log, stream_seed, sync
from ..counts import kimi_vl as K
from ..counts.k1_bound import k1_bound_s
from ..reference import kimi_vl as R
from ..reference.frozen.env.env import DrivingEnv as RefEnv
from ..reference.frozen.env.world import load_benchmark_specs as ref_specs
from ..reference.frozen.env.world import spec_rows as ref_rows
from ..reference.frozen.env.world import to_torch as ref_to_torch
from ..reference.frozen.ops.raster import COL_BIKE, COL_CAR, COL_STATIC, COL_WALKER
from ..reference.frozen.ops.raster import render_frame as ref_render
from ..reference.lowering import Lowered, round_to
from ..reference.rollout import _off_px, _rel_l2, _round_state, as_frozen, state_gap
from ..trace import Stretch

CLASS_COLORS = (COL_CAR, COL_BIKE, COL_STATIC, COL_WALKER)  # the labeler's box classes
NUMBERS = ("vision_err", "route_err", "logit_err", "cache_err", "label_err", "frame_px", "state_err")


def take(obj, idx):
    """Rows ``idx`` of a tensor or of nested dataclasses of per-world tensors."""
    if isinstance(obj, torch.Tensor):
        return obj.index_select(0, idx)
    return type(obj)(**{f.name: take(getattr(obj, f.name), idx) for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class Plan:
    draws: torch.Tensor  # [ticks, B, 4] the call's env draws
    t: int  # the tick whose stages are copied
    worlds: np.ndarray
    idx: torch.Tensor


class Taps:
    def __init__(self):
        self.tick = -1
        self.plan = None
        self.cap = None
        self.on_tick = None
        self.lengths = []  # every labeled tick's prompt lengths
        self.phase = None  # "prefill" or "decode" while traced
        self.traced = False
        self.k1_ops = None  # the render kernel's operands while traced

    def begin(self, plan):
        self.tick, self.plan = -1, plan
        self.cap = None if plan is None else {"worlds": plan.worlds, "t": plan.t}

    def _now(self):
        return self.plan is not None and self.tick == self.plan.t

    def _put(self, **kw):
        if self._now():
            self.cap.update({k: take(v, self.plan.idx) for k, v in kw.items()})

    def render(self, fn):
        def render(spec, state, **kw):
            self.tick += 1
            if self.on_tick is not None:
                self.on_tick(self.tick)
            with record_function(SPAN + "render"):
                frame = fn(spec, state, **kw)
            self._put(frame_t=frame)
            return frame

        return render

    def k1(self, fn):
        def render_from_operands(cam, rows, boxes, **kw):
            if self.k1_ops is not None:
                self.k1_ops.append((cam, rows.shape[1], boxes))
            return fn(cam, rows, boxes, **kw)

        return render_from_operands

    def env(self, base):
        taps = self

        class Env(base):
            def reset(self, spec):
                out = super().reset(spec)
                if taps.plan is not None:
                    taps.cap["state0"] = take(out, taps.plan.idx)
                return out

            def step(self, spec, state, action, draws):
                out = super().step(spec, state, action, draws)
                taps._put(state_t=state, action=action, draws=draws, state_t1=out)
                return out

        return Env

    def label(self, fn):
        def label(frames, boxes):
            self._put(frame_u8=frames, boxes=boxes)
            coords = fn(frames, boxes)
            self._put(coords=coords)
            if self._now():
                self.cap["routes"] = self.routes()
            return coords

        return label

    def prompt(self, fn):
        def prompt(boxes):
            p = fn(boxes)
            self.lengths.append(p.lengths)
            if self._now():
                idx = self.plan.idx.tolist()
                starts = np.cumsum([0] + p.lengths)
                self.cap["prompt"] = [p.ids[starts[b]:starts[b + 1]].clone() for b in idx]
                self._put(listed=p.boxes, count=p.count)
                self.sample_len = [p.lengths[b] for b in idx]
                self.sample_tok = torch.cat([torch.arange(starts[b], starts[b + 1]) for b in idx]).to(p.ids.device)
                self.routed = {"prefill": [], "decode": []}
            return p

        return prompt

    def route(self, router, args, out):
        """A router's forward hook: the sampled tokens' experts."""
        if self._now():
            tok = self.sample_tok if self.phase == "prefill" else self.plan.idx
            self.routed[self.phase].append(out[0].index_select(0, tok))

    def routes(self):
        """Each sampled world's experts of each expert layer, [prompt +
        decode steps, k]: the prefill's rows, then one a decode step."""
        pre, dec = self.routed["prefill"], self.routed["decode"]
        layers = len(pre)
        steps = [dec[s * layers:(s + 1) * layers] for s in range(len(dec) // layers)]
        starts = np.cumsum([0] + self.sample_len)
        return [[torch.cat([pre[m][starts[j]:starts[j + 1]]] + [st[m][j:j + 1] for st in steps])
                 for m in range(layers)] for j in range(len(self.sample_len))]

    def generate(self, fn):
        def generate(frames, prompt):
            out = fn(frames, prompt)
            self._put(generated=out)
            return out

        return generate

    def encode_images(self, fn):
        def encode_images(pixels):
            out = fn(pixels)
            self._put(image=out)
            return out

        return encode_images

    def prefill(self, fn):
        def prefill(*args):
            self.phase = "prefill"
            logits, cache = fn(*args)
            self.phase = "decode"
            if self._now():
                self.cap["logits"] = [take(logits, self.plan.idx)]
                self.cap["cache"] = [take(kv, self.plan.idx) for kv in cache.kv]
            return logits, cache

        return prefill

    def decode(self, fn):
        def decode(ids, cache):
            logits = fn(ids, cache)
            if self._now():
                self.cap["logits"].append(take(logits, self.plan.idx))
            return logits

        return decode

    def grouped(self, fn):
        def grouped_mm(*args, **kw):
            if not self.traced:
                return fn(*args, **kw)
            with record_function(f"{SPAN}moe_{self.phase}"):
                return fn(*args, **kw)

        return grouped_mm


class Cell:
    rate_metric = "env_steps_per_s"

    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.worlds, self.ticks = t["worlds"], t["ticks_per_call"]
        self.per_unit = self.worlds  # a unit of the rate is a world-tick
        conf = copy.deepcopy(ctx.config)
        for k, v in t.get("model", {}).items():  # sizes the harness's CPU tests put in the traffic
            conf[k] = {**conf[k], **v} if isinstance(v, dict) else v
        self.conf = conf
        self.units_done = 0
        self.calls = 0
        self.caps = []
        self.window_lengths = []
        self.patches = contextlib.ExitStack()

    def setup(self):
        from gabril_carla_tpu_torch.cli import collect as C
        from gabril_carla_tpu_torch.env.world import load_benchmark_specs, spec_rows, to_torch
        from gabril_carla_tpu_torch.models.kimi_vl import KimiVLConfig, Router
        from gabril_carla_tpu_torch.ops import raster
        from gabril_carla_tpu_torch.saliency.vlm_labeler import LabelerConfig

        ctx, dev = self.ctx, self.ctx.device
        routes = ctx.traffic["routes"]
        specs = load_benchmark_specs(routes)
        self.spec = to_torch(spec_rows(specs, np.arange(self.worlds) % len(routes)), dev)
        a = self.conf["assumed"]
        self.mcfg = KimiVLConfig.from_dict(self.conf)
        lab = dict(a["labeler"])
        fit = min(lab.pop("balance_worlds"), self.worlds)
        self.lcfg = LabelerConfig(seed=stream_seed(ctx.seed, "template"), **{**lab, "pad_hw": tuple(lab["pad_hw"])})
        labeler = C.vlm_labeler(stream_seed(ctx.seed, "weights"), self.lcfg, dev, self.mcfg,
                                getattr(torch, a["weights"]["dtype"]))
        model = labeler.model
        loads = C.balance_labeler(labeler, to_torch(spec_rows(specs, np.arange(fit) % len(routes)), dev))
        log(f"routers fitted on {fit} worlds' first frames: heaviest expert over the mean load a layer "
            f"{min(loads):.3f}-{max(loads):.3f}")
        self.taps = taps = Taps()
        p = self.patches
        p.enter_context(mock.patch.object(C, "render_frame", taps.render(C.render_frame)))
        p.enter_context(mock.patch.object(C, "DrivingEnv", taps.env(C.DrivingEnv)))
        p.enter_context(mock.patch.object(raster, "render_from_operands", taps.k1(raster.render_from_operands)))
        for obj, names in ((labeler, ("label", "prompt", "generate")),
                           (model, ("encode_images", "prefill", "decode"))):
            for name in names:
                p.enter_context(mock.patch.object(obj, name, getattr(taps, name)(getattr(obj, name))))
        p.enter_context(mock.patch.object(torch, "_grouped_mm", taps.grouped(torch._grouped_mm)))
        for m in model.modules():
            if isinstance(m, Router):
                p.callback(m.register_forward_hook(taps.route).remove)
        self.model, self.labeler, self.collect = model, labeler, C.collect
        self._call(self._plan("warm-up", sample=False))
        sync(dev)
        taps.lengths = []

    def _plan(self, call, sample: bool = True) -> Plan:
        from gabril_carla_tpu_torch.utils.prng import env_draws

        rng = host_rng(self.ctx.seed, "call", call)
        keys = rng.integers(0, 2**32, size=(self.worlds, 2), dtype=np.uint32)
        t = int(rng.integers(0, self.ticks))
        n = min(self.ctx.traffic["sample_worlds"], self.worlds) if sample else 0
        worlds = np.sort(rng.choice(self.worlds, size=n, replace=False))
        draws = torch.from_numpy(env_draws(keys, self.ticks)).to(self.ctx.device)
        return Plan(draws, t, worlds, torch.from_numpy(worlds).to(self.ctx.device))

    def _call(self, plan: Plan, capture: bool = False):
        self.taps.begin(plan if capture else None)
        self.collect(self.spec, self.ticks, plan.draws, labeler=self.labeler)
        return self.taps.cap

    def run_unit(self):
        self.caps.append(self._call(self._plan(self.calls), capture=True))
        self.calls += 1
        self.units_done += self.worlds * self.ticks

    def trace(self):
        t = self.ctx.traffic
        k0, n = t["trace_from_tick"], t["trace_ticks"]
        stretch = Stretch(self.ctx.device, n)
        self.window_lengths, self.taps.lengths = self.taps.lengths, []

        def on_tick(tick):
            if tick == k0:
                stretch.start()
                self.taps.traced, self.taps.lengths, self.taps.k1_ops = True, [], []
            elif tick == k0 + n:
                stretch.stop()
                self.taps.traced = False
                self.k1_ops, self.taps.k1_ops = self.taps.k1_ops, None

        self.taps.on_tick = on_tick
        self._call(self._plan("traced", sample=False))
        self.taps.on_tick = None
        reading = stretch.read()
        from gabril_carla_tpu_torch.utils.profiling import span_summary

        c = span_summary()["counters"]
        if "moe_pairs" in c:
            bound = K.moe_bound_s(dataclasses.asdict(self.mcfg), c["label_prefill_tokens"], c["moe_pairs"],
                                  c["moe_experts_hit"], n, self.lcfg.decode_steps)
            reading.moe_bound_s = bound["all"]
            pre, dec = reading.span_s.get("moe_prefill", 0.0), reading.span_s.get("moe_decode", 0.0)
            log(f"grouped products, traced: prefill {pre * 1e3:.3f} ms (bound {bound['prefill'] * 1e3:.3f}), "
                f"decode {dec * 1e3:.3f} ms (bound {bound['decode'] * 1e3:.3f}); "
                f"heaviest expert over the mean load a layer "
                f"{c['moe_max_load'] * self.mcfg.n_routed_experts / c['moe_pairs']:.3f}")
        return reading

    def flops_per_unit(self) -> dict:
        """Per tick: the tower, the prefill of the window's prompts and the
        decode steps, averaged over the window's ticks."""
        ticks = self.window_lengths or self.taps.lengths
        cfg = dataclasses.asdict(self.mcfg)
        h, w = self.lcfg.pad_hw
        total = sum(self.worlds * K.vision_flops(cfg, h, w) + K.prefill_flops(cfg, L)
                    + K.decode_flops(cfg, L, self.lcfg.decode_steps) for L in ticks)
        return {"bf16": total / max(len(ticks), 1)}

    def k1_bound(self) -> tuple[float, int] | None:
        """(the least seconds for the traced K1 launches' work, launches)."""
        ops = getattr(self, "k1_ops", None)
        return (sum(k1_bound_s(c, n, b)[0] for c, n, b in ops), len(ops)) if ops else None

    def free_program(self):
        self.patches.close()
        self.weights = self.model.state_dict()
        self.layout = dataclasses.asdict(self.labeler.layout)
        self.template, self.n_image = self.labeler.template, self.labeler.n_image
        self.model = self.labeler = self.taps = self.spec = self.collect = None

    # ------------------------------------------------------------ the check

    def check(self) -> dict:
        return numbers(self, self.caps)


def numbers(cell, caps, fmt: str | None = None, fault: str | None = None) -> dict:
    """The output check's numbers of ``caps`` (Cell.check's), or with
    ``fmt`` the control (the reference one precision lower in the port's
    place), or with ``fault`` the reference with that fault in the port's
    place."""
    dev = cell.ctx.device
    cfg = dataclasses.asdict(cell.mcfg)
    lc = cell.lcfg
    routes = cell.ctx.traffic["routes"]
    need = {"frame_t", "state0", "state_t", "state_t1", "frame_u8", "prompt", "generated", "image", "logits",
            "coords", "routes"}
    if not caps or any(c is None or not need <= c.keys() for c in caps):
        return dict.fromkeys(NUMBERS, float("inf"))
    low = (lambda: Lowered(fmt)) if fmt else contextlib.nullcontext
    specs = ref_specs(routes)
    env = RefEnv()
    out = dict.fromkeys(NUMBERS, 0.0)
    seqs, images, cache_ref = [], [], []
    for cap in caps:
        spec = ref_to_torch(ref_rows(specs, cap["worlds"] % len(routes)), dev)
        st = as_frozen(cap["state_t"])
        frame = ref_render(spec, st)
        ref0 = env.reset(spec)
        ref1 = env.step(spec, st, cap["action"], cap["draws"])
        if fmt:
            prog = (round_to(frame, "bf16"), _round_state(ref0, "bf16"),
                    _round_state(env.step(spec, _round_state(st, "bf16"), cap["action"], cap["draws"]), "bf16"))
        else:
            prog = (cap["frame_t"], as_frozen(cap["state0"]), as_frozen(cap["state_t1"]))
        out["frame_px"] = max(out["frame_px"], _off_px(prog[0], frame))
        out["state_err"] = max(out["state_err"], state_gap(prog[1], ref0), state_gap(prog[2], ref1))
        glue = float((cap["frame_u8"] != (cap["frame_t"] * 255).to(torch.uint8)).any())
        for j in range(len(cap["worlds"])):
            ids, listed = R.prompt_ids(cell.template, lc.image_at, cell.n_image, cap["boxes"][j], cell.layout,
                                       lc.frame_hw, lc.max_boxes, lc.max_depth, CLASS_COLORS)
            port_ids = cap["prompt"][j]
            n = int(cap["count"][j])
            glue = max(glue, float(not torch.equal(ids, port_ids)),
                       float(not torch.equal(listed, cap["listed"][j][:n])))
            gen = cap["generated"][j]
            want = R.parse_coords(gen.cpu().numpy(), listed.cpu().numpy(), cell.layout["box0"], lc.frame_hw,
                                  lc.gaze_points)
            glue = max(glue, float(np.abs(cap["coords"][j].cpu().numpy() - want).max()))
            images.append(R.pixels(cap["frame_u8"][j], lc.pad_hw))
            L = len(ids)
            seqs.append([torch.cat([ids, gen[:-1]]), None, lc.image_at, torch.arange(L - 1, L + lc.decode_steps)])
        out["label_err"] = max(out["label_err"], glue)
    ref_img = R.vision(cell.weights, cfg, images)
    port_img = [c["image"][j].float() for c in caps for j in range(len(c["worlds"]))]
    port_logits = [torch.stack(c["logits"], 1)[j].float() for c in caps for j in range(len(c["worlds"]))]
    port_cache = [[kv[j].float() for kv in c["cache"]] for c in caps for j in range(len(c["worlds"]))]
    port_routes = [r for c in caps for r in c["routes"]]
    if fmt or fault:  # the stand-in: its own image tokens feed its decoder, its own routing
        port_cache, kept = [], []
        with low():
            port_img = R.vision(cell.weights, cfg, images, fault=fault)
            port_logits = R.logits(cell.weights, cfg, [(s[0], img, s[2], s[3]) for s, img in zip(seqs, port_img)],
                                   fault=fault, keep_cache=port_cache, keep_routes=kept)
        port_routes = [[idx for idx, _ in seq] for seq in kept]
    for s, img in zip(seqs, ref_img):
        s[1] = img
    ref_routes = []
    ref_logits = R.logits(cell.weights, cfg, [tuple(s) for s in seqs], keep_cache=cache_ref, routes=port_routes,
                          keep_routes=ref_routes)
    out["route_err"] = max(R.route_shortfall(r, cell.mcfg.num_experts_per_tok) for r in ref_routes)
    calls = np.cumsum([0] + [len(c["worlds"]) for c in caps])
    prompt = [len(s[0]) - lc.decode_steps for s in seqs]
    for a, b in zip(calls[:-1], calls[1:]):  # each call's sample of worlds
        out["vision_err"] = max(out["vision_err"], _rel_l2(torch.stack(port_img[a:b]), torch.stack(ref_img[a:b])))
        for i in range(lc.decode_steps + 1):
            out["logit_err"] = max(out["logit_err"], _rel_l2(torch.stack([x[i] for x in port_logits[a:b]]),
                                                             torch.stack([x[i] for x in ref_logits[a:b]])))
        for layer in range(len(cache_ref[a])):
            got = torch.cat([port_cache[j][layer][:prompt[j]] for j in range(a, b)])
            want = torch.cat([cache_ref[j][layer][:prompt[j]] for j in range(a, b)])
            out["cache_err"] = max(out["cache_err"], _rel_l2(got, want))
    return {k: out[k] if out[k] == out[k] else float("inf") for k in NUMBERS}
