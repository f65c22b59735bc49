"""The port's protocol at real size against JAX's round-5 anchor.

results_torch_r5/anchor/seed{42,43,44}/report.json and
results_torch_r5/anchor.log come from the port's ``cli.full_benchmark`` on
one H100 with examples/run_suites_r5a.sh:23-29's arguments (200 expert
episodes of seeds 200-219, 30 epochs, batch 128, eval seeds 400-403,
junction traffic, curvature and human gaze, the UNet predictor)
(results_torch_r5/run_anchor.sh). The JAX anchor is
results_r5/anchor/seed{42,43,44}/report.json and results_r5/anchor.log.
Both runs draw the same env and training numbers (JAX's keys), so what is
left between them is the arithmetic: cuDNN bf16 against XLA on the TPU.

Of the anchor's six methods (``METHODS``) the port's reports hold four:
None:IGMD and Mask (``OPEN``, 4 of the 12 cells) are not run yet, and
test_open_cells_are_not_run names them until their reports come; then
they leave ``OPEN`` and their cells join the bars below.

Bars:
- the expert: the frame count within 1% of JAX's, its mean within 0.5, and
  each seen route's mean over its 20 episodes within 2.0 of JAX's (one
  chaotic episode of 20 moves a route's mean by up to 5);
- each (method, split) cell run, 8 of the 12: with a JAX's three seed
  means and b the port's, d = mean(b) - mean(a) and se = sqrt(var(a) / 3
  + var(b) / 3) (ddof 1), |d| <= 5 se. A correct port passes all 12 cells
  together about 91% of the time under seed noise; the three-seed range
  bar would pass them 0.4% of the time;
- the pooled bias over the n cells run (8 now, 12 when all are run): D =
  mean(d), SE = sqrt(sum se^2) / n, |D| <= 3 SE (over 12 cells about 99.6%
  when correct; it still catches a shift of one seed sd in 89% of cases).
CPU only: the test reads JSON and the two logs.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PORT, JAX = REPO / "results_torch_r5", REPO / "results_r5"
SEEDS = (42, 43, 44)
METHODS = ("None", "Reg@0.3", "None:GMD", "None:IGMD", "None:Oreo", "Mask")
OPEN = ("None:IGMD", "Mask")  # not run yet: ROADMAP "Next" item 2
RUN = tuple(m for m in METHODS if m not in OPEN)
SPLITS = ("seen", "unseen")
CELL_SE, POOLED_SE = 5.0, 3.0
FRAMES_REL, MEAN_ABS, ROUTE_ABS = 0.01, 0.5, 2.0
ROUTE_LINE = re.compile(r"^\[collect\] route (\d+): 20 seeds, expert score ([\d.]+)$", re.M)


def reports(root: Path) -> list[dict]:
    return [json.loads((root / "anchor" / f"seed{s}" / "report.json").read_text()) for s in SEEDS]


def route_scores(log: Path) -> dict[int, list[float]]:
    out = {}
    for r, v in ROUTE_LINE.findall(log.read_text()):
        out.setdefault(int(r), []).append(float(v))
    return out


def cell(method: str, split: str) -> tuple[float, float]:
    """(d, se) of one (method, split) cell."""
    a = np.array([r["methods"][method][split] for r in reports(JAX)])
    b = np.array([r["methods"][method][split] for r in reports(PORT)])
    return b.mean() - a.mean(), float(np.sqrt(a.var(ddof=1) / 3 + b.var(ddof=1) / 3))


def test_reports_are_the_anchor_runs():
    """Each report is its seed's, unconfounded, with the methods run and
    both splits' per-route means over the 10 seen and 10 unseen routes."""
    for s, rj, rp in zip(SEEDS, reports(JAX), reports(PORT)):
        assert rp["train_seed"] == rj["train_seed"] == s
        assert rp["confounded"] is rj["confounded"] is False
        for m in RUN:
            for split in SPLITS:
                routes = rp["methods"][m][f"per_route_{split}"]
                assert set(routes) == set(rj["methods"][m][f"per_route_{split}"])
                assert len(routes) == 10
                assert rp["methods"][m][split] == pytest.approx(np.mean(list(routes.values())))


def test_run_is_unshrunk():
    """The log shows the anchor's size: 200 expert episodes, every BC run
    30 epochs, every eval 40 rollouts of 1,600 ticks, for every cell."""
    log = (PORT / "anchor.log").read_text()
    assert re.search(r"^\[collect\] \d+ frames over 200 episodes", log, re.M)
    epochs = re.findall(r"^\[train:[^\]]+\] (\d+) epochs", log, re.M)
    assert len(epochs) >= len(RUN) * len(SEEDS) and set(epochs) == {"30"}
    evals = re.findall(r"^\[eval:(.+):(seen|unseen)\] mean .*\([\d.]+ s, (\d+) rollouts of (\d+) ticks",
                       log, re.M)
    assert {(m, s) for m, s, _, _ in evals} == {(m, s) for m in RUN for s in SPLITS}
    assert len(evals) >= len(RUN) * len(SPLITS) * len(SEEDS)
    assert {(n, t) for _, _, n, t in evals} == {("40", "1600")}


def test_expert_frames():
    for rj, rp in zip(reports(JAX), reports(PORT)):
        assert rj["n_frames"] == 92407
        assert abs(rp["n_frames"] - rj["n_frames"]) <= FRAMES_REL * rj["n_frames"]


def test_expert_mean():
    for rj, rp in zip(reports(JAX), reports(PORT)):
        assert abs(rp["expert_seen_mean"] - rj["expert_seen_mean"]) <= MEAN_ABS


def test_expert_per_route():
    """Each route's score in every collection of the port's log against its
    first line in JAX's (results_r5/anchor.log:2-11)."""
    want = {r: v[0] for r, v in route_scores(JAX / "anchor.log").items()}
    got = route_scores(PORT / "anchor.log")
    assert len(want) == 10 and set(got) == set(want)
    for r, w in want.items():
        assert all(abs(g - w) <= ROUTE_ABS for g in got[r]), (r, w, got[r])


def test_open_cells_are_not_run():
    """The anchor's cells the port has not run yet: every JAX report has
    them and no port report does. A report that gains one fails here, so
    it leaves ``OPEN`` and its cells join the Welch bars."""
    for rj, rp in zip(reports(JAX), reports(PORT)):
        assert set(METHODS) <= set(rj["methods"])
        assert set(rp["methods"]) == set(RUN) and not set(OPEN) & set(rp["methods"])


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("method", RUN)
def test_cell_within_welch_bar(method, split):
    d, se = cell(method, split)
    assert abs(d) <= CELL_SE * se, (method, split, d, se)


def test_pooled_bias():
    """|D| <= 3 SE over the cells run (8 of the 12)."""
    ds, ses = zip(*(cell(m, s) for m in RUN for s in SPLITS))
    big_d = float(np.mean(ds))
    big_se = float(np.sqrt(np.sum(np.square(ses)))) / len(ds)
    assert abs(big_d) <= POOLED_SE * big_se, (big_d, big_se)


if __name__ == "__main__":
    # the comparison as a markdown table: python tests/test_torch_anchor.py
    rows = []
    for m in METHODS:
        for split in SPLITS:
            a = [r["methods"][m][split] for r in reports(JAX)]
            if m in OPEN:
                print(f"| {m} | {split} | {np.mean(a):.2f} | not run | | | | |")
                continue
            b = [r["methods"][m][split] for r in reports(PORT)]
            d, se = cell(m, split)
            rows.append((d, se))
            print(f"| {m} | {split} | {np.mean(a):.2f} | {np.mean(b):.2f} "
                  f"({' / '.join(f'{x:.2f}' for x in b)}) | {d:+.2f} | {se:.2f} | "
                  f"{abs(d) / se:.2f} | {'pass' if abs(d) <= CELL_SE * se else 'FAIL'} |")
    ds, ses = zip(*rows)
    big_d, big_se = float(np.mean(ds)), float(np.sqrt(np.sum(np.square(ses)))) / len(ds)
    print(f"pooled over {len(rows)} cells: D {big_d:+.3f}, SE {big_se:.3f}, |D| / SE {abs(big_d) / big_se:.2f}: "
          f"{'pass' if abs(big_d) <= POOLED_SE * big_se else 'FAIL'}")
    for r, w in route_scores(JAX / "anchor.log").items():
        print(f"route {r}: JAX {w[0]:.1f}, port {route_scores(PORT / 'anchor.log').get(r)}")
