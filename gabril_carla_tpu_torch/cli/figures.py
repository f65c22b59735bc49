"""Paper-figure generation from benchmark reports (draw_plot parity; the
port's copy of gabril_carla_tpu/cli/figures.py: matplotlib only, no device).

The reference ships matplotlib scripts that turn driving-score CSVs into the
paper's bar/curve figures (draw_plot/CARLA_bar.py, CARLA_curve.py over
draw_plot/data/*.csv). Here the inputs are the report.json files written by
cli/full_benchmark.py (one per training seed); multiple seeds become
error bars.

    python -m gabril_carla_tpu_torch.cli.figures --reports results_r2/seed*/report.json --out figs/

Produces:
    methods_bar.png   seen/unseen driving score per method (mean ± std over seeds)
    ratio_curve.png   gaze-ratio ablation (table3 parity) when Reg%r specs exist
    lambda_curve.png  lambda sweep when Reg@l specs exist
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

import numpy as np

# validated categorical palette (dataviz default instance; fixed slot order)
SERIES = {"seen": "#2a78d6", "unseen": "#eb6834"}
PAIR = {"clean": "#2a78d6", "confounded": "#8a63c9"}
# ordinal single-hue ramp (blue steps 250/400/550 — the documented
# light-surface ordinal range; the rungs are ordered, not categorical)
LADDER = {"dense analytic": "#86b6ef", "+ spatial sparsity": "#3987e5",
          "+ temporal statistics": "#1c5cab", "+ semantic error": "#0d3a73"}
INK, MUTED, GRID = "#1a1a19", "#6b6a60", "#e8e7df"


def _style(ax):
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)
    ax.tick_params(colors=MUTED, labelsize=9)
    ax.yaxis.grid(True, color=GRID, linewidth=0.8)
    ax.set_axisbelow(True)


def _collect(report_paths: list[str]) -> dict[str, dict[str, list[float]]]:
    """{method_spec: {'seen': [per-seed means], 'unseen': [...]}}"""
    out: dict[str, dict[str, list[float]]] = defaultdict(lambda: {"seen": [], "unseen": []})
    for p in report_paths:
        rep = json.loads(Path(p).read_text())
        for m, d in rep.get("methods", {}).items():
            out[m]["seen"].append(float(d["seen"]))
            out[m]["unseen"].append(float(d["unseen"]))
    return dict(out)


def methods_bar(data: dict, out: Path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # core methods only (ablation specs get their own curves)
    core = {m: v for m, v in data.items() if "%" not in m and "!" not in m}
    names = sorted(core, key=lambda m: -np.mean(core[m]["seen"]))
    x = np.arange(len(names))
    w = 0.38
    fig, ax = plt.subplots(figsize=(max(6.4, 0.9 * len(names) + 2), 3.6), dpi=150)
    for i, split in enumerate(("seen", "unseen")):
        means = [float(np.mean(core[m][split])) for m in names]
        stds = [float(np.std(core[m][split])) for m in names]
        n_seeds = max(len(core[m][split]) for m in names)
        seed_tag = f"{n_seeds} seed" + ("s" if n_seeds != 1 else "")
        bars = ax.bar(x + (i - 0.5) * w, means, w - 0.04, color=SERIES[split],
                      label=f"{split} ({seed_tag})",
                      yerr=stds if n_seeds > 1 else None,
                      error_kw={"ecolor": MUTED, "capsize": 2, "elinewidth": 1})
        for xi, v in zip(x + (i - 0.5) * w, means):
            ax.text(xi, v + 1.2, f"{v:.0f}", ha="center", va="bottom",
                    fontsize=8, color=INK)
    ax.set_xticks(x, names, rotation=20, ha="right", color=INK)
    ax.set_ylabel("driving score", color=INK, fontsize=10)
    ax.set_ylim(0, 105)
    _style(ax)
    ax.legend(frameon=False, fontsize=9, loc="upper right", labelcolor=INK)
    fig.tight_layout()
    fig.savefig(out / "methods_bar.png")
    plt.close(fig)


def confounded_bar(clean: dict, conf: dict, out: Path):
    """Clean vs confounded seen-score per method — the robustness figure
    behind draw_plot/data/Confounded.csv (gaze regularization resists
    causal confusion: BC 47.8->32.8 vs GABRIL 62.4->44.7)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = [m for m in sorted(clean, key=lambda m: -np.mean(clean[m]["seen"]))
             if m in conf and "%" not in m and "!" not in m]
    if not names:
        return
    x = np.arange(len(names))
    w = 0.38
    fig, ax = plt.subplots(figsize=(max(6.4, 0.9 * len(names) + 2), 3.6), dpi=150)
    for i, (label, data) in enumerate((("clean", clean), ("confounded", conf))):
        means = [float(np.mean(data[m]["seen"])) for m in names]
        stds = [float(np.std(data[m]["seen"])) for m in names]
        n_seeds = max(len(data[m]["seen"]) for m in names)
        ax.bar(x + (i - 0.5) * w, means, w - 0.04, color=PAIR[label],
               label=f"{label} ({n_seeds} seed" + ("s)" if n_seeds != 1 else ")"),
               yerr=stds if n_seeds > 1 else None,
               error_kw={"ecolor": MUTED, "capsize": 2, "elinewidth": 1})
        for xi, v in zip(x + (i - 0.5) * w, means):
            ax.text(xi, v + 1.2, f"{v:.0f}", ha="center", va="bottom",
                    fontsize=8, color=INK)
    ax.set_xticks(x, names, rotation=20, ha="right", color=INK)
    ax.set_ylabel("driving score (seen)", color=INK, fontsize=10)
    ax.set_ylim(0, 105)
    _style(ax)
    ax.legend(frameon=False, fontsize=9, loc="upper right", labelcolor=INK)
    fig.tight_layout()
    fig.savefig(out / "confounded_bar.png")
    plt.close(fig)


def _curve(data: dict, token: str, xlabel: str, fname: str, out: Path,
           base_method: str = "Reg"):
    """Ablation curve over a numeric token (%ratio or @lambda)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = []
    for m, v in data.items():
        core = m.replace("!notemporal", "")
        if token not in core or not core.startswith(base_method):
            continue
        if token == "@" and ("%" in core or "!" in m):
            continue  # ratio/temporal ablations pin lambda; not lambda points
        try:
            val = float(core.split(token)[-1].split("@")[0].split("%")[0].split(":")[0])
        except ValueError:
            continue
        pts.append((val, v))
    if len(pts) < 2:
        return
    pts.sort()
    fig, ax = plt.subplots(figsize=(4.8, 3.2), dpi=150)
    for split in ("seen", "unseen"):
        xs = [p for p, _ in pts]
        ys = [float(np.mean(v[split])) for _, v in pts]
        es = [float(np.std(v[split])) for _, v in pts]
        ax.errorbar(xs, ys, yerr=es, color=SERIES[split], label=split,
                    linewidth=2, marker="o", markersize=5, capsize=2)
    if token == "@":
        ax.set_xscale("log")
    ax.set_xlabel(xlabel, color=INK, fontsize=10)
    ax.set_ylabel("driving score", color=INK, fontsize=10)
    _style(ax)
    ax.legend(frameon=False, fontsize=9, labelcolor=INK)
    fig.tight_layout()
    fig.savefig(out / fname)
    plt.close(fig)


def ladder_bar(rungs: dict[str, dict], refs: dict[str, float],
               bc_anchor: float | None, out: Path):
    """Gaze-statistics ladder (round-4 headline): each gaze-consuming
    method's seen score as the analytic gaze is progressively matched to
    human eye-tracker statistics. Rungs are ordinal -> one-hue ramp;
    reference (VLM) values are tick markers; the gaze-free BC anchor is a
    dashed rule shared by every rung."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # fixed method order (worst-case first mirrors RESULTS.md's table)
    methods = [m for m in ("GRIL", "None:GMD", "Reg@0.3")
               if all(m in d and d[m]["seen"] for d in rungs.values())]
    if not methods:
        return
    labels = {"GRIL": "GRIL", "None:GMD": "GMD", "Reg@0.3": "GABRIL"}
    x = np.arange(len(methods))
    w = 0.78 / len(rungs)
    mid = (len(rungs) - 1) / 2.0
    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=150)
    for i, (rung, data) in enumerate(rungs.items()):
        means = [float(np.mean(data[m]["seen"])) for m in methods]
        stds = [float(np.std(data[m]["seen"])) for m in methods]
        n = max(len(data[m]["seen"]) for m in methods)
        ax.bar(x + (i - mid) * w, means, w - 0.03, color=LADDER[rung],
               label=f"{rung} ({n} seed{'s' if n != 1 else ''})",
               yerr=stds, error_kw={"ecolor": MUTED, "capsize": 2, "elinewidth": 1})
        for xi, v in zip(x + (i - mid) * w, means):
            ax.text(xi, v + 1.2, f"{v:.0f}", ha="center", va="bottom",
                    fontsize=8, color=INK)
    ref_xs = [xi for xi, m in enumerate(methods) if labels[m] in refs]
    ax.scatter(ref_xs, [refs[labels[methods[xi]]] for xi in ref_xs],
               marker="_", s=700, color=INK, linewidth=1.6, zorder=5,
               label="reference (VLM gaze)")
    if bc_anchor is not None:
        ax.axhline(bc_anchor, color=MUTED, linestyle="--", linewidth=1.2)
        ax.text(len(methods) - 0.52, bc_anchor + 1.0, f"BC (gaze-free) {bc_anchor:.0f}",
                ha="right", fontsize=8, color=MUTED)
    ax.set_xticks(x, [labels[m] for m in methods], color=INK)
    ax.set_ylabel("driving score (seen)", color=INK, fontsize=10)
    ax.set_ylim(0, 105)
    _style(ax)
    ax.legend(frameon=False, fontsize=8, loc="upper left", labelcolor=INK, ncols=2)
    fig.tight_layout()
    fig.savefig(out / "ladder_bar.png")
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--reports", nargs="+", required=True, help="report.json paths (one per seed)")
    p.add_argument("--conf_reports", nargs="*", default=[],
                   help="confounded-eval report.json paths; adds confounded_bar.png")
    p.add_argument("--ladder_dense", nargs="*", default=[],
                   help="dense-analytic-rung report.json paths; defaults to --reports "
                        "(override when the headline anchor is not the dense rung, e.g. round 5)")
    p.add_argument("--ladder_sparse", nargs="*", default=[],
                   help="spatial-sparsity-rung report.json paths (results_r4/sparse_core)")
    p.add_argument("--ladder_human", nargs="*", default=[],
                   help="eye-tracker-statistics-rung report.json paths (results_r4/human_core)")
    p.add_argument("--ladder_misperceive", nargs="*", default=[],
                   help="semantic-gaze-error-rung report.json paths (results_r5/misperceive); "
                        "pair with --ladder_human pointed at the same-cache statistics rung")
    p.add_argument("--out", default="figs")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    data = _collect(args.reports)
    if not data:
        print("no method results found")
        return 1
    methods_bar(data, out)
    if args.conf_reports:
        confounded_bar(data, _collect(args.conf_reports), out)
    if args.ladder_sparse and args.ladder_human:
        bc = data.get("None", {}).get("seen", [])
        rungs = {"dense analytic": _collect(args.ladder_dense) if args.ladder_dense else data,
                 "+ spatial sparsity": _collect(args.ladder_sparse),
                 "+ temporal statistics": _collect(args.ladder_human)}
        if args.ladder_misperceive:
            rungs["+ semantic error"] = _collect(args.ladder_misperceive)
        ladder_bar(
            rungs,
            refs={"GRIL": 50.1, "GMD": 43.0, "GABRIL": 62.4},  # Original.csv VLM columns
            bc_anchor=float(np.mean(bc)) if bc else None, out=out)
    _curve(data, "%", "gaze ratio (table 3)", "ratio_curve.png", out)
    _curve(data, "@", "lambda (reg weight)", "lambda_curve.png", out)
    made = [f.name for f in out.glob("*.png")]
    print(f"wrote {made} to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
