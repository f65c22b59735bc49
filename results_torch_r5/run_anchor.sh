#!/bin/bash
# The port's protocol at the size of JAX's round-5 anchor
# (examples/run_suites_r5a.sh:23-29: 200 expert episodes, 30 epochs, batch
# 128, 40 rollouts a split, training seeds 42, 43 and 44 in one process) on
# one card, for the methods given.
#
#   results_torch_r5/run_anchor.sh OUT SECONDS LANE...
#
# A LANE is a list of methods; ";" splits it into processes run one after
# another ("None:IGMD;Mask AGIL" runs None:IGMD for every seed, then Mask
# and AGIL). The lanes run side by side on the card, each in its own work
# directory _anchor/lane<i>, so the host-bound eval of one lane overlaps the
# training of another. Every process runs the anchor's one command
# (--train_seed 42 43 44) and the whole run is stopped after SECONDS.
#
# Each seed resumes from the finished cells in
# results_torch_r5/anchor/seed<s>/report.json and from a gaze predictor an
# earlier run left in _anchor/seed<s>/gaze_predictor.pt. Lane 1 trains and
# saves the predictors that are missing; a process of a later lane whose
# methods take heat (Mask, ViSaRL, AGIL, :GMD, :IGMD) first waits until
# every seed has one, so no predictor is trained twice. OUT gets each seed's
# report.json (the cells of every lane), the predictors and one log a lane.
set -u
shopt -s nullglob
cd "$(dirname "$0")/.."
OUT=$1
END=$(( $(date +%s) + $2 ))
shift 2
WORK=_anchor
mkdir -p "$OUT"

HEAT='(^| )(Mask|ViSaRL|AGIL)|:I?GMD'

wait_for_predictors() {  # wait_for_predictors DIR: copy lane 1's into DIR
  local s p
  for s in 42 43 44; do
    p=$WORK/lane1/seed$s/gaze_predictor.pt
    until [ -f "$1/seed$s/gaze_predictor.pt" ]; do
      # a minute old: torch.save has finished writing it
      if [ -f "$p" ] && [ $(( $(date +%s) - $(stat -c %Y "$p") )) -ge 60 ]; then
        cp "$p" "$1/seed$s/"
      elif [ "$(date +%s)" -ge "$END" ]; then
        return 1
      else
        sleep 20
      fi
    done
  done
}

run_lane() {  # run_lane INDEX "METHODS[;METHODS...]"
  local dir=$WORK/lane$1 log=$OUT/lane$1.log rc=0 s left methods
  for s in 42 43 44; do
    mkdir -p "$dir/seed$s"
    for f in results_torch_r5/anchor/seed$s/report.json $WORK/seed$s/gaze_predictor.pt; do
      if [ -f "$f" ]; then cp "$f" "$dir/seed$s/"; fi
    done
  done
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$log"
  IFS=';' read -ra procs <<< "$2"
  for methods in "${procs[@]}"; do
    if [ "$1" -gt 1 ] && [[ " $methods" =~ $HEAT ]]; then
      echo "### lane $1: waiting for lane 1's gaze predictors" >> "$log"
      wait_for_predictors "$dir" || { rc=124; break; }
    fi
    left=$(( END - $(date +%s) ))
    # under ten minutes no cell can finish
    if [ "$left" -le 600 ]; then rc=124; break; fi
    echo "### lane $1: --methods $methods (${left} s left)" >> "$log"
    # shellcheck disable=SC2086  # the methods are words
    timeout -s INT -k 60 "$left" python -u -m gabril_carla_tpu_torch.cli.full_benchmark \
      --train_seeds $(seq 200 219) --epochs 30 --batch_size 128 \
      --eval_seeds 400 401 402 403 \
      --junction_traffic --curvature_gaze --human_gaze --gp_arch unet \
      --train_seed 42 43 44 --out "$dir" --methods $methods >> "$log" 2>&1 || rc=$?
  done
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader >> "$log"
  return $rc
}

i=0
pids=()
for lane in "$@"; do
  i=$((i + 1))
  run_lane "$i" "$lane" &
  pids+=($!)
done
rc=0
for p in "${pids[@]}"; do wait "$p" || rc=$?; done

# every lane's cells in one report a seed; a predictor from any lane
for s in 42 43 44; do
  mkdir -p "$OUT/seed$s"
  python3 - "$OUT/seed$s/report.json" $WORK/lane*/seed$s/report.json <<'EOF'
import json, sys
merged = None
for path in sys.argv[2:]:
    with open(path) as f:
        report = json.load(f)
    if merged is None:
        merged = report
    else:
        merged["methods"].update(report["methods"])
if merged is not None:
    with open(sys.argv[1], "w") as f:
        json.dump(merged, f, indent=2)
EOF
  for p in $WORK/lane*/seed$s/gaze_predictor.pt; do
    if [ -f "$p" ]; then cp "$p" "$OUT/seed$s/"; fi
  done
done
exit $rc
