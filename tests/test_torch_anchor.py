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

The anchor has eleven methods (``METHODS``, run_suites_r5a.sh:28's order),
22 (method, split) cells. JAX's Contrastive cells are not the anchor
run's first, collapsed ones (results_r5/anchor.log:410-411, 859-860, kept
in report_prefix_contrastive.json): examples/run_suites_r5f.sh refit
Contrastive under the blank-gaze gate (JAX train/bc.py:183-196), and its
eval lines (anchor.log:1020-1021, 1055-1056, 1388-1389) are the reports'
Contrastive cells (test_contrastive_is_the_gated_refit). That gated code
is what the port ported. Methods the port has not run yet are ``OPEN``:
test_open_cells_are_not_run names them until their reports come; then
they leave ``OPEN`` and their cells join the bars below. All eleven have
run, so ``OPEN`` is empty and all 22 cells are held.

Bars:
- the expert: the frame count within 1% of JAX's, its mean within 0.5, and
  each seen route's mean over its 20 episodes within 2.0 of JAX's (one
  chaotic episode of 20 moves a route's mean by up to 5);
- each (method, split) cell run: with a JAX's three seed means and b the
  port's, d = mean(b) - mean(a) and se = sqrt(var(a) / 3 + var(b) / 3)
  (ddof 1), |d| <= 5 se. Its error rate: under a correct port (3 + 3
  normal seed means) d / se is Student's t with 4 degrees of freedom, so
  a cell fails with probability 0.0075 (``cell_false_fail_rate``; 400,000
  numpy draws agree, test_cell_bar_error_rate), and all 18 cells pass
  together about 87% of the time, all 22 about 85%. That holds when the
  two sides' seed variances are equal. When they are not, d / se has a
  heavier tail: at ViSaRL unseen's variance ratio (port 1.71^2 over JAX's
  0.76^2, about 5.1) a correct port fails the bar about 1.2% of the time
  and reaches that cell's 7.14 se about 0.35% of the time
  (test_cell_bar_error_rate_at_unequal_variances, 400,000 draws);
- the pooled bias over the n cells run: D = mean(d), SE = sqrt(sum se^2) /
  n, |D| <= 3 SE (it still catches a shift of one seed sd in most cases).
CPU only: the test reads JSON and the two logs. ``python
tests/test_torch_anchor.py`` prints the comparison and the final training
losses of both logs side by side (a diagnostic, not a bar).
"""

import ast
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PORT, JAX = REPO / "results_torch_r5", REPO / "results_r5"
SEEDS = (42, 43, 44)
METHODS = ("None", "Reg@0.3", "GRIL", "None:GMD", "Reg:GMD", "ViSaRL", "AGIL", "None:IGMD",
           "Mask", "None:Oreo", "Contrastive")
OPEN = ()  # every method has run
RUN = tuple(m for m in METHODS if m not in OPEN)
SPLITS = ("seen", "unseen")
CELL_SE, POOLED_SE = 5.0, 3.0
FRAMES_REL, MEAN_ABS, ROUTE_ABS = 0.01, 0.5, 2.0
ROUTE_LINE = re.compile(r"^\[collect\] route (\d+): 20 seeds, expert score ([\d.]+)$", re.M)
# a training run's name on its epoch lines: <date>_s<seed>_..._gaze<M>[_dp<D>]
RUN_LINE = re.compile(r"^\[\d{4}_\d\d_\d\d_\d\d_\d\d_\d\d_s(\d+)_\S*?(?:_gaze(\w+?)(?:_dp(\w+))?)?\] epoch ")
TRAIN_LINE = re.compile(r"^\[train:[^\]]+\] \d+ epochs in .*?: (\{.*\})$")  # BC runs only
EVAL_LINE = re.compile(r"^\[eval:(.+):(seen|unseen)\] mean (-?[\d.]+) ")


def reports(root: Path) -> list[dict]:
    return [json.loads((root / "anchor" / f"seed{s}" / "report.json").read_text()) for s in SEEDS]


def route_scores(log: Path) -> dict[int, list[float]]:
    out = {}
    for r, v in ROUTE_LINE.findall(log.read_text()):
        out.setdefault(int(r), []).append(float(v))
    return out


def run_spec(gaze: str, dropout: str | None) -> str:
    """The anchor's method spec of a BC run named gaze<gaze>[_dp<dropout>]
    (the run name does not carry lambda: the anchor's one plain Reg is
    Reg@0.3)."""
    if dropout:
        return f"{gaze}:{dropout}"
    return "Reg@0.3" if gaze == "Reg" else gaze


def log_runs(log: Path) -> tuple[dict, dict]:
    """({(seed, spec): final metrics}, {(seed, spec, split): eval mean}) of
    a protocol log, each from the last line for its key, the seed and spec
    from the run name on the epoch lines above it (so JAX's gated
    Contrastive refit replaces its collapsed run)."""
    losses, evals, key = {}, {}, None
    for line in log.read_text().splitlines():
        if m := RUN_LINE.match(line):
            key = (int(m[1]), run_spec(m[2], m[3])) if m[2] else None
        elif (m := TRAIN_LINE.match(line)) and key is not None:
            losses[key] = ast.literal_eval(m[1])
        elif (m := EVAL_LINE.match(line)) and key is not None:
            evals[(key[0], m[1], m[2])] = float(m[3])
    return losses, evals


def cell(method: str, split: str) -> tuple[float, float]:
    """(d, se) of one (method, split) cell."""
    a = np.array([r["methods"][method][split] for r in reports(JAX)])
    b = np.array([r["methods"][method][split] for r in reports(PORT)])
    return b.mean() - a.mean(), float(np.sqrt(a.var(ddof=1) / 3 + b.var(ddof=1) / 3))


def cell_false_fail_rate(bar: float = CELL_SE) -> float:
    """P(|d| > bar se) for a correct port: with three seeds a side and equal
    variances d / se is Student's t with 4 degrees of freedom, whose CDF is
    1/2 + (3/4) u (1 - u^2 / 3), u = t / sqrt(t^2 + 4)."""
    u = bar / math.sqrt(bar * bar + 4)
    return 1.0 - 1.5 * u * (1.0 - u * u / 3.0)


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
        assert set(rj["methods"]) == set(METHODS)
        assert set(rp["methods"]) == set(RUN) and not set(OPEN) & set(rp["methods"])


def test_contrastive_is_the_gated_refit():
    """JAX's Contrastive cells are its gated refit's (examples/run_suites_r5f.sh):
    each report's cell equals, to the log's two decimals, the last
    Contrastive eval line of its seed in results_r5/anchor.log, whose run
    trained with loss_reg 0; the first, collapsed run's lines (seen 13.47,
    13.52) are the ones report_prefix_contrastive.json keeps."""
    lines = (JAX / "anchor.log").read_text().splitlines()
    losses, evals = log_runs(JAX / "anchor.log")
    first = {}
    for s in SEEDS:
        prefix = JAX / "anchor" / f"seed{s}" / "report_prefix_contrastive.json"
        if prefix.exists():
            first[s] = json.loads(prefix.read_text())["Contrastive"]
    assert set(first) == {42, 43}
    for s, rj in zip(SEEDS, reports(JAX)):
        c = rj["methods"]["Contrastive"]
        for split in SPLITS:
            assert round(c[split], 2) == evals[(s, "Contrastive", split)], (s, split)
            if s in first:
                assert abs(first[s][split] - c[split]) > 5.0
        assert losses[(s, "Contrastive")]["loss_reg"] == c["final_loss"]["loss_reg"] == 0.0
    contrastive = [i + 1 for i, x in enumerate(lines) if x.startswith("[eval:Contrastive:")]
    assert contrastive == [410, 411, 859, 860, 1020, 1021, 1055, 1056, 1388, 1389]
    for n, s in ((410, 42), (859, 43)):
        assert [float(EVAL_LINE.match(lines[n - 1 + k])[3]) for k in (0, 1)] == \
            [round(first[s][split], 2) for split in SPLITS]


def test_cell_bar_error_rate():
    """The Welch bar's false-fail rate under a correct port, as the module
    docstring states it: 0.0075 a cell from the t(4) tail, and 400,000
    numpy draws of 3 + 3 normal seed means within 4 binomial standard
    errors of it; 87% for all 18 cells to pass, 85% for all 22."""
    p = cell_false_fail_rate()
    assert round(p, 4) == 0.0075
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 400_000, 3))
    d = b.mean(1) - a.mean(1)
    se = np.sqrt(a.var(1, ddof=1) / 3 + b.var(1, ddof=1) / 3)
    sim = float(np.mean(np.abs(d) > CELL_SE * se))
    assert abs(sim - p) <= 4 * math.sqrt(p * (1 - p) / 400_000), (sim, p)
    assert round((1 - p) ** 18, 2) == 0.87 and round((1 - p) ** 22, 2) == 0.85


def test_cell_bar_error_rate_at_unequal_variances():
    """t(4) is the law of d / se when both sides' seed variances are equal.
    At ViSaRL unseen's ratio (the port's seed variance over JAX's, 5.1)
    400,000 numpy draws of a correct port give a false-fail rate of about
    1.2% at the 5-se bar (against 0.75% at equal variances), and reach
    the cell's measured 7.14 se about 0.35% of the time."""
    a = np.array([r["methods"]["ViSaRL"]["unseen"] for r in reports(JAX)])
    b = np.array([r["methods"]["ViSaRL"]["unseen"] for r in reports(PORT)])
    ratio = b.var(ddof=1) / a.var(ddof=1)
    assert round(ratio, 1) == 5.1
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400_000, 3))
    y = rng.standard_normal((400_000, 3)) * math.sqrt(ratio)
    t = np.abs(y.mean(1) - x.mean(1)) / np.sqrt(x.var(1, ddof=1) / 3 + y.var(1, ddof=1) / 3)
    d, se = cell("ViSaRL", "unseen")
    assert round(abs(d) / se, 2) == 7.14
    fail, reach = float(np.mean(t > CELL_SE)), float(np.mean(t >= abs(d) / se))
    assert round(fail, 3) == 0.012 and fail > cell_false_fail_rate(), fail
    assert round(reach, 4) == 0.0035, reach


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("method", RUN)
def test_cell_within_welch_bar(method, split):
    d, se = cell(method, split)
    assert abs(d) <= CELL_SE * se, (method, split, d, se)


def test_pooled_bias():
    """|D| <= 3 SE over every cell run."""
    ds, ses = zip(*(cell(m, s) for m in RUN for s in SPLITS))
    big_d = float(np.mean(ds))
    big_se = float(np.sqrt(np.sum(np.square(ses)))) / len(ds)
    assert abs(big_d) <= POOLED_SE * big_se, (big_d, big_se)


def print_losses():
    """The final training losses of both logs, a row per method with seeds
    42 / 43 / 44: loss, and loss_reg where either log's is not 0."""
    port, _ = log_runs(PORT / "anchor.log")
    jax, _ = log_runs(JAX / "anchor.log")

    def seeds(runs, m, k):
        return " / ".join(f"{runs[(s, m)][k]:.4g}" if (s, m) in runs else "not run" for s in SEEDS)

    print("| Method | loss, port | loss, JAX | loss_reg, port | loss_reg, JAX |")
    print("| --- | --- | --- | --- | --- |")
    for m in METHODS:
        reg = any(runs[(s, m)]["loss_reg"] for runs in (port, jax) for s in SEEDS if (s, m) in runs)
        tail = f"{seeds(port, m, 'loss_reg')} | {seeds(jax, m, 'loss_reg')}" if reg else " | "
        print(f"| {m} | {seeds(port, m, 'loss')} | {seeds(jax, m, 'loss')} | {tail} |")


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
    print_losses()
