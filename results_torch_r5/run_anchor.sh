#!/bin/bash
# The port's protocol at the size of JAX's round-5 anchor
# (examples/run_suites_r5a.sh:23-29: 200 expert episodes, 30 epochs, batch
# 128, 40 rollouts a split, training seeds 42, 43 and 44 in one process) on
# one card, for the methods given.
#
#   results_torch_r5/run_anchor.sh OUT SECONDS METHOD...
#
# The run is stopped after SECONDS. Each seed resumes from the finished cells
# in results_torch_r5/anchor/seed<s>/report.json and from a gaze predictor
# an earlier run left in _anchor/seed<s>/gaze_predictor.pt; its report.json,
# its gaze predictor and the log go to OUT.
set -u
cd "$(dirname "$0")/.."
OUT=$1
SECONDS_LEFT=$2
shift 2
WORK=_anchor
mkdir -p "$OUT"
for s in 42 43 44; do
  mkdir -p "$WORK/seed$s" "$OUT/seed$s"
  if [ -f "results_torch_r5/anchor/seed$s/report.json" ]; then
    cp "results_torch_r5/anchor/seed$s/report.json" "$WORK/seed$s/"
  fi
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/anchor.log"
timeout -s INT "$SECONDS_LEFT" python -u -m gabril_carla_tpu_torch.cli.full_benchmark \
  --train_seeds $(seq 200 219) --epochs 30 --batch_size 128 \
  --eval_seeds 400 401 402 403 \
  --junction_traffic --curvature_gaze --human_gaze --gp_arch unet \
  --train_seed 42 43 44 --out "$WORK" --methods "$@" >> "$OUT/anchor.log" 2>&1
rc=$?
for s in 42 43 44; do
  for f in report.json gaze_predictor.pt; do
    if [ -f "$WORK/seed$s/$f" ]; then
      cp "$WORK/seed$s/$f" "$OUT/seed$s/"
    fi
  done
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a "$OUT/anchor.log"
exit $rc
