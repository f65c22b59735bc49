"""The full protocol: expert data -> gaze predictor, VQ-VAE and every
method's BC -> closed-loop seen/unseen eval -> report.json (port of
examples/full_benchmark.py).

    python -m gabril_carla_tpu_torch.cli.full_benchmark --out results/ --methods None Reg@0.3

Reproduces the reference's experimental protocol (BASELINE.md) on one card:
collect expert demonstrations on the 10 seen routes (every (route, train
seed) pair a world of one batched collection, each drawing JAX's numbers
for the key PRNGKey(seed * 1000 + route)), turn the analytic gaze into eye-tracker-like
gaze (data/gaze_stats.py), optionally bake the confounding overlay into the
frames, put one copy of the dataset on the card for every trainer, then per
training seed: the frozen gaze predictor when a method needs heat, the
VQ-VAE when one uses Oreo, and for each method spec its BC training and its
closed-loop eval on the seen and unseen splits (each pair's draws JAX's
for PRNGKey(seed * 100003 + route)). stats.json trees go under
eval_<tag>_<split>/, and report.json is rewritten after every finished
cell, so a rerun skips the cells already in it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
from pathlib import Path

import numpy as np

from ..data.dataset import BCDataset, EpisodeStore
from ..data.gaze_stats import humanize_gaze_coords, misperceive_gaze_coords, sparsify_gaze_coords
from ..data.tasks import seen_routes, unseen_routes
from ..env.criteria import compute_score
from ..env.world import load_benchmark_specs, spec_rows, to_torch
from ..eval.rollout import make_rollout_fn, needs_heat
from ..eval.stats import aggregate_scores, route_record, write_stats_json
from ..train.bc import make_bc_policy_fn
from ..train.device_data import DeviceData
from ..train.gaze_predictor import make_gaze_predictor_apply
from ..train.loop import Trainer
from ..utils.config import default_bc_config, default_gaze_config
from .collect import collect, seed_draws
from .eval_routes import pair_draws


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One ``--methods`` entry, ``Method[:Dropout][@lambda][%ratio][!notemporal]``
    (e.g. Reg@1.0, None:GMD, Reg%0.5 for table 3, Reg!notemporal for table 4)."""

    spec: str
    method: str
    dropout: str = "None"
    lam: float | None = None
    ratio: float | None = None
    temporal: bool = True

    @property
    def tag(self) -> str:
        """The spec as a directory name: eval_<tag>_<split>."""
        return (self.spec.replace(":", "-").replace("@", "-l")
                .replace("%", "-r").replace("!", "-"))


def parse_method_spec(spec: str) -> MethodSpec:
    method, lam, dropout, ratio, temporal = spec, None, "None", None, True
    if "!notemporal" in method:
        method = method.replace("!notemporal", "")
        temporal = False
    if "%" in method:
        method, ratio = method.split("%")
        ratio = float(ratio)
    if "@" in method:
        method, lam = method.split("@")
        lam = float(lam)
    if ":" in method:
        method, dropout = method.split(":")
    return MethodSpec(spec, method, dropout, lam, ratio, temporal)


def method_config(ms: MethodSpec, args, train_seed: int, vqvae_path: str, out: Path):
    """The BC config of one method spec (full_benchmark.py:341-361)."""
    cfg = default_bc_config()
    cfg["data"].update(batch_size=args.batch_size, task="Mixed_")
    cfg["gaze"]["method"] = ms.method
    cfg["dropout"]["method"] = ms.dropout
    if ms.dropout == "Oreo":
        cfg["dropout"]["vqvae_path"] = vqvae_path
    if ms.lam is not None:
        cfg["gaze"]["lambda_weight"] = ms.lam
    if ms.ratio is not None:
        cfg["gaze"]["ratio"] = ms.ratio
    cfg["gaze"]["temporal_flag"] = ms.temporal
    if args.clip_norm is not None:
        cfg["optimizer"]["clip_norm"] = args.clip_norm
    cfg["training"].update(epochs=args.epochs, save_interval=args.epochs, seed=train_seed)
    cfg["logging"]["log_dir"] = str(out / "runs")
    return cfg


def collect_expert(specs, idx_of: dict, routes, seeds, steps: int, curvature_gaze: bool,
                   device) -> tuple[EpisodeStore, list[dict]]:
    """Every (route, seed) pair, route-major, as one world of one collection
    of ``steps`` ticks; pair (r, s) draws JAX's numbers for the key
    PRNGKey(s * 1000 + r) (examples/full_benchmark.py:145). Each episode
    is cut at its world's own tick count, the frames kept as grayscale
    [n, H, W, 1]. Returns the store and the
    expert's stats.json records."""
    pairs = [(r, s) for r in routes for s in seeds]
    rows = np.asarray([idx_of[r] for r, _ in pairs])
    spec = to_torch(spec_rows(specs, rows), device)
    draws = seed_draws([s * 1000 + r for r, s in pairs], steps, device)
    state, frames, actions, gazes = collect(spec, steps, draws, curvature_gaze=curvature_gaze)
    n_ticks = state.t.cpu().numpy()
    score = {k: v.cpu() for k, v in compute_score(spec, state).items()}
    frames, actions, gazes = frames.cpu().numpy(), actions.cpu().numpy(), gazes.cpu().numpy()
    store, records = EpisodeStore(), []
    for i, (r, s) in enumerate(pairs):
        n = int(n_ticks[i])
        store.add(frames[:n, i, :, :, None], gazes[:n, i], actions[:n, i])
        records.append(route_record(r, s, {k: v[i] for k, v in score.items()},
                                    duration_game=n * 0.05,
                                    route_length=float(specs.route_len[idx_of[r]])))
    return store, records


def save_cache(path: Path, store: EpisodeStore, records: list[dict]):
    """The collected episodes as the JAX protocol caches them (flat streams,
    episode lengths, expert records), so either package loads the other's."""
    store.finalize()
    np.savez(path, images=store.flat_images, gazes=store.flat_gazes,
             actions=store.flat_actions, lengths=store.lengths,
             records=np.asarray(records, dtype=object))


def load_cache(path: Path) -> tuple[EpisodeStore, list[dict]]:
    z = np.load(path, allow_pickle=True)  # written by save_cache: expert records
    bounds = np.cumsum(z["lengths"])[:-1]
    store = EpisodeStore()
    for img, gz, ac in zip(np.split(z["images"], bounds), np.split(z["gazes"], bounds),
                           np.split(z["actions"], bounds)):
        store.add(img, gz, ac)
    return store, (list(z["records"]) if "records" in z else [])


def apply_gaze_variant(store: EpisodeStore, args):
    """Rewrite the store's gaze in place: misperceive beats sparse beats
    human (the two explicit flags win over the default-on one), the mask
    seeded with the first training seed."""
    if not (args.sparse_gaze or args.human_gaze or args.misperceive_gaze):
        return
    store.finalize()
    seed = args.train_seed[0]
    if args.misperceive_gaze:
        g = misperceive_gaze_coords(store.flat_gazes, lengths=store.lengths, seed=seed)
        tag = "misperceive_gaze"
    elif args.sparse_gaze:
        g = sparsify_gaze_coords(store.flat_gazes, seed=seed)
        tag = "sparse_gaze"
    else:
        g = humanize_gaze_coords(store.flat_gazes, lengths=store.lengths, seed=seed)
        tag = "human_gaze"
    print(f"[{tag}] {100 * (g[:, 0] >= 0).mean():.0f}% of frames keep one fixation "
          f"(mask seed {seed})", flush=True)


def confound_store(store: EpisodeStore):
    """Bake each frame's recorded action into it, in place on the uint8
    store (ops/raster.confounded_overlay's brake dot, 255, where brake > 0.8,
    and steering bar, 242), on the host: the frames never cross to the card
    twice."""
    store.finalize()
    img = store.flat_images[..., 0]  # a view: [T, H, W] uint8
    acts = store.flat_actions
    hh, ww = img.shape[1], img.shape[2]
    vv = np.arange(hh, dtype=np.float32)[:, None]
    uu = np.arange(ww, dtype=np.float32)[None, :]
    dv, du = np.nonzero(((uu - 0.92 * ww) ** 2 + (vv - 0.85 * hh) ** 2) < (0.03 * ww) ** 2)
    img[np.flatnonzero(acts[:, 2] > 0.8)[:, None], dv, du] = 255
    rows = np.flatnonzero(np.abs(vv[:, 0] - 0.92 * hh) < 0.015 * hh)
    cxp = 0.5 * ww + np.clip(acts[:, 1], -1.0, 1.0) * 0.2 * ww
    bar = (uu > np.minimum(cxp, 0.5 * ww)[:, None]) & (uu < np.maximum(cxp, 0.5 * ww)[:, None])
    img[:, rows, :] = np.where(bar[:, None, :], np.uint8(242), img[:, rows, :])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--routes_xml", default=None,
                   help="route table in the compiled routes220.json.gz format "
                        "(default: the vendored one)")
    p.add_argument("--junction_traffic", action=argparse.BooleanOptionalAction, default=True,
                   help="ambient junction crossing traffic in collection AND eval worlds; "
                        "--no-junction_traffic restores the junction-free env")
    p.add_argument("--train_seeds", type=int, nargs="*", default=list(range(200, 212)))
    p.add_argument("--eval_seeds", type=int, nargs="*", default=[400, 401])
    p.add_argument("--collect_steps", type=int, default=900)
    p.add_argument("--eval_steps", type=int, default=1600)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--methods", nargs="*", default=["None", "Reg"],
                   help="gaze methods; append :dropout and @lambda, e.g. Reg@1.0 None:GMD")
    p.add_argument("--out", default="results")
    p.add_argument("--train_seed", type=int, nargs="+", default=[42],
                   help="training seeds (init + batch order); multiple seeds run in one "
                        "process, sharing the dataset's one copy on the card")
    p.add_argument("--store_cache", default=None,
                   help="npz path to save/load collected episodes")
    p.add_argument("--confounded", action="store_true",
                   help="bake expert-action overlays into training frames and evaluate with "
                        "the two-pass confounded protocol (build_confunded_obs.py + "
                        "bc_agent.py:321-352)")
    p.add_argument("--sparse_gaze", action="store_true",
                   help="table-3 control: one top-hazard fixation, no road point, ~35%% of "
                        "frames dropped (eye-tracker validity statistics)")
    p.add_argument("--human_gaze", action=argparse.BooleanOptionalAction, default=True,
                   help="eye-tracker-statistics gaze (gaze_stats.humanize_gaze_coords), "
                        "default on; --no-human_gaze keeps the dense analytic gaze")
    p.add_argument("--misperceive_gaze", action="store_true",
                   help="the eye-tracker statistics of --human_gaze plus misperception: "
                        "attention lapses and wrong-actor fixations "
                        "(gaze_stats.misperceive_gaze_coords)")
    p.add_argument("--curvature_gaze", action=argparse.BooleanOptionalAction, default=True,
                   help="collect analytic gaze with curvature-anticipating (tangent-point) "
                        "road fixations instead of the fixed 15 m preview; only a fresh "
                        "collection: a loaded --store_cache keeps its recorded gaze")
    p.add_argument("--gp_arch", default="unet", choices=["autoencoder", "unet"],
                   help="gaze-predictor backbone for heat-needing methods")
    p.add_argument("--clip_norm", type=float, default=None,
                   help="override optimizer.clip_norm (0 disables)")
    return p


def main(argv=None, device="cuda"):
    args = build_parser().parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    seen, unseen = seen_routes(), unseen_routes()
    specs = load_benchmark_specs(seen + unseen, junction_traffic=args.junction_traffic,
                                 routes_file=args.routes_xml)
    idx_of = {r: i for i, r in enumerate(seen + unseen)}

    # ---------- 1. expert data on the seen routes
    t0 = time.time()
    cache = Path(args.store_cache) if args.store_cache else None
    if cache is not None and cache.exists():
        store, expert_records = load_cache(cache)
        print(f"[collect] loaded {store.n_demos} episodes from {cache}", flush=True)
    else:
        store, expert_records = collect_expert(specs, idx_of, seen, args.train_seeds,
                                               args.collect_steps, args.curvature_gaze, device)
        for r in seen:
            done = [rec["scores"]["score_composed"] for rec in expert_records
                    if rec["route_id"] == f"RouteScenario_{r}"]
            print(f"[collect] route {r}: {len(done)} seeds, expert score {np.mean(done):.1f}",
                  flush=True)
    n_frames = int(sum(len(x) for x in store.images))
    expert_agg = aggregate_scores(expert_records) if expert_records else {"mean": -1.0}
    dt = time.time() - t0
    print(f"[collect] {n_frames} frames over {store.n_demos} episodes in {dt:.1f} s "
          f"({n_frames / dt:.1f} frames/s); expert mean {expert_agg['mean']:.2f}", flush=True)
    if cache is not None and not cache.exists():
        save_cache(cache, store, expert_records)
        print(f"[collect] cached to {cache}", flush=True)

    # ---------- 1a. gaze variant, then the confounding overlay, both in place
    # on the host store and before its copy on the card is made
    apply_gaze_variant(store, args)
    if args.confounded:
        t0 = time.time()
        confound_store(store)
        print(f"[confound] overlaid {n_frames} frames in {time.time() - t0:.1f} s", flush=True)

    # one copy of the dataset on the card, shared by every trainer and seed
    base_cfg = default_bc_config()
    shared_dd = DeviceData(store, frame_stack=base_cfg.data["frame_stack"],
                           grayscale_store=base_cfg.model["grayscale"], device=device)
    splits = {}
    for split, routes in (("seen", seen), ("unseen", unseen)):
        pairs = [(r, s) for r in routes for s in args.eval_seeds]
        rows = np.asarray([idx_of[r] for r, _ in pairs])
        splits[split] = (pairs, to_torch(spec_rows(specs, rows), device))

    for train_seed in args.train_seed:
        run_seed(train_seed, args, out / f"seed{train_seed}" if len(args.train_seed) > 1 else out,
                 store, shared_dd, expert_agg, n_frames, splits, device)
    return 0


def train_aux(mode: str, args, train_seed: int, store, shared_dd, out: Path, device):
    """The gaze predictor (mode "gaze") or the VQ-VAE (mode "vqvae") at
    max(10, epochs // 2) epochs on the shared dataset: the trained Trainer."""
    if mode == "gaze":
        cfg = default_gaze_config()
        cfg["data"].update(batch_size=args.batch_size, task="GazePred")
        cfg["model"]["arch"] = args.gp_arch
        save_interval = 999
    else:
        cfg = default_bc_config()
        cfg["data"].update(batch_size=args.batch_size, task="VQVAE")
        save_interval = 10**6
    cfg["training"].update(epochs=max(10, args.epochs // 2), save_interval=save_interval,
                           seed=train_seed)
    cfg["scheduler"]["type"] = "none"
    cfg["logging"]["log_dir"] = str(out / "runs")
    t0 = time.time()
    tr = Trainer(cfg, BCDataset(store, frame_stack=cfg.data["frame_stack"]), mode=mode,
                 device=device, device_data=shared_dd)
    metrics = tr.train()
    dt = time.time() - t0
    n = tr.steps_per_epoch * args.batch_size * cfg.training["epochs"]
    print(f"[train:{'gaze_predictor' if mode == 'gaze' else mode}] {dt:.1f} s, "
          f"{n / dt:.1f} samples/s: {metrics}", flush=True)
    return tr


def run_seed(train_seed, args, out, store, shared_dd, expert_agg, n_frames, splits, device):
    """Train and evaluate every method spec at one training seed."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"expert_seen_mean": expert_agg["mean"], "n_frames": n_frames,
              "confounded": args.confounded, "train_seed": train_seed, "methods": {}}

    # resume: a cell is in report.json once its training and both eval
    # splits finished, so a rerun skips it
    report_path = out / "report.json"
    if report_path.exists():
        old = json.loads(report_path.read_text())
        if old.get("confounded") == args.confounded and old.get("train_seed") == train_seed:
            report["methods"].update(old.get("methods", {}))
            done = [m for m in args.methods if m in report["methods"]]
            if done:
                print(f"[resume] skipping finished cells: {done}", flush=True)
    todo = [parse_method_spec(m) for m in args.methods if m not in report["methods"]]

    # ---------- 1b. the frozen gaze predictor for heat-needing methods
    gp_apply, gp_params = None, None
    if any(needs_heat(method_config(ms, args, train_seed, "", out)) for ms in todo):
        gtr = train_aux("gaze", args, train_seed, store, shared_dd, out, device)
        gp_params, gp_apply = gtr.state.params, make_gaze_predictor_apply(gtr.model)
        del gtr
        gc.collect()

    # ---------- 1c. the VQ-VAE when a method uses Oreo
    vqvae_path = ""
    if any(ms.dropout == "Oreo" for ms in todo):
        vtr = train_aux("vqvae", args, train_seed, store, shared_dd, out, device)
        vtr.save(epoch=0)
        vqvae_path = str(vtr.logger.ckpt_dir / "ep0")
        del vtr
        gc.collect()

    # ---------- 2+3. train each method, evaluate on both splits
    for ms in todo:
        cfg = method_config(ms, args, train_seed, vqvae_path, out)
        trainer = Trainer(cfg, BCDataset(store, frame_stack=cfg.data["frame_stack"]), mode="bc",
                          device=device, device_data=shared_dd)
        t0 = time.time()
        metrics = trainer.train()
        train_s = time.time() - t0
        n = trainer.steps_per_epoch * args.batch_size * args.epochs
        print(f"[train:{ms.method}] {args.epochs} epochs in {train_s:.1f} s, "
              f"{n / train_s:.1f} samples/s: {metrics}", flush=True)

        # heat at eval: the frozen gaze predictor when trained, else the
        # analytic scene-graph gaze
        roll = make_rollout_fn(make_bc_policy_fn(trainer.models, cfg), cfg,
                               steps=args.eval_steps, use_analytic_gaze=True,
                               gaze_predictor_apply=gp_apply, confounded=args.confounded)
        eval_params = dict(trainer.state.params)
        if gp_params is not None:
            eval_params["gaze_predictor"] = gp_params
        results = {}
        for split, (pairs, spec) in splits.items():
            t0 = time.time()
            states, _ = roll(spec, eval_params, draws=pair_draws(pairs, args.eval_steps, device))
            score = {k: v.cpu() for k, v in compute_score(spec, states).items()}
            t_done = states.t.cpu()
            recs = []
            for i, (r, s) in enumerate(pairs):
                rec = route_record(r, s, {k: v[i] for k, v in score.items()},
                                   duration_game=float(t_done[i]) * 0.05,
                                   route_length=float(spec.route_len[i]))
                write_stats_json(out / f"eval_{ms.tag}_{split}", rec)
                recs.append(rec)
            results[split] = aggregate_scores(recs)
            print(f"[eval:{ms.spec}:{split}] mean {results[split]['mean']:.2f} ± "
                  f"{results[split]['std']:.2f} ({time.time() - t0:.1f} s, {len(pairs)} rollouts "
                  f"of {args.eval_steps} ticks)", flush=True)
        # free this method's models and optimizer state before the next one
        trainer = roll = eval_params = None
        gc.collect()
        report["methods"][ms.spec] = {
            "train_seconds": round(train_s, 1),
            "final_loss": metrics,
            "seen": results["seen"]["mean"],
            "unseen": results["unseen"]["mean"],
            "per_route_seen": results["seen"]["per_route"],
            "per_route_unseen": results["unseen"]["per_route"],
        }
        report_path.write_text(json.dumps(report, indent=2))

    print(f"[done seed {train_seed}]",
          json.dumps({m: {k: v for k, v in d.items() if k in ("seen", "unseen")}
                      for m, d in report["methods"].items()}), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
