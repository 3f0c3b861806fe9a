#!/bin/bash
# Config 12 through the port's entry point with the JAX package's config-12
# flags (RESULTS.md: process backend, batch 128, 50,000 rows, learn_start
# 5,000, double DQN, max_replay_ratio 8, an evaluation every 60 s), the
# bf16 kernel torso, on the card.  Run from the root of a checkout:
#
#   bash pytorch_distributed_tpu_torch/measure_paced.sh sweep OUT \
#       [PREFIX --set k=v ...]
#       2, 3 and 6 actors x 16 envs, and 2 actors with compute_dtype
#       float32, 4,000 updates each (seed 100), the run names prefixed
#       with PREFIX and the --set values added (e.g. "batched --set
#       actor_backend=batched", or "anakin --set actor_backend=anakin
#       --set rollout_ratio=16": the co-located loop ignores
#       max_replay_ratio and keeps 16 frames an update, the reference's
#       replay ratio 8 at batch 128);
#   bash pytorch_distributed_tpu_torch/measure_paced.sh northstar OUT NAME \
#       SEED MAX_SECONDS [--set k=v ...]
#       time to +18: 2 actors x 16 envs, 250,000 updates or MAX_SECONDS,
#       then tools/northstar_report.py on its log (the same --set values
#       as sweep select the backend).
#
# Writes OUT/NAME.log (the run's output; its last line is the summary),
# OUT/NAME.phases.json (the actors' timer phases), OUT/NAME_evals.jsonl
# (the evaluator's rows) and, for northstar, OUT/NAME_report.json.
set -u
mode=$1 OUT=$2
shift 2
mkdir -p "$OUT"
ROOT=$(mktemp -d "${TMPDIR:-/tmp}/measure_XXXX")
trap 'rm -rf "$ROOT"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"

run() {  # NAME SEED [main args...]
  local name=$1 seed=$2
  shift 2
  python -m pytorch_distributed_tpu_torch.main --config 12 --backend process \
    --device cuda --batch-size 128 --memory-size 50000 --seed "$seed" \
    --set learn_start=5000 --set enable_double=true \
    --set max_replay_ratio=8.0 --set evaluator_freq=60 \
    --set learner_freq=500 --set pallas_torso=true --set root_dir="$ROOT" \
    --set refs="$name" "$@" > "$OUT/$name.log" 2>&1
  echo "$name rc=$?"
  tail -n 1 "$OUT/$name.log"
  python -m pytorch_distributed_tpu_torch.utils.metrics "$ROOT/logs/$name" \
    > "$OUT/$name.phases.json" 2>&1
  grep -h '"tag": "evaluator/avg_reward"' "$ROOT/logs/$name/scalars.jsonl" \
    > "$OUT/${name}_evals.jsonl"
}

case $mode in
  sweep)
    pre=${1:-}
    [ $# -gt 0 ] && shift
    for n in 2 3 6; do
      run "${pre}sweep_a$n" 100 --num-actors "$n" --num-envs-per-actor 16 \
        --steps 4000 "$@"
    done
    run "${pre}sweep_a2_fp32" 100 --num-actors 2 --num-envs-per-actor 16 \
      --steps 4000 --set compute_dtype=float32 "$@"
    ;;
  northstar)
    name=$1 seed=$2 secs=$3
    shift 3
    run "$name" "$seed" --num-actors 2 --num-envs-per-actor 16 \
      --steps 250000 --set max_seconds="$secs" "$@"
    python tools/northstar_report.py "$ROOT/logs/$name" \
      --out "$OUT/${name}_report.json" > "$OUT/${name}_report.txt" 2>&1
    echo "report rc=$?"
    tail -c 1500 "$OUT/${name}_report.txt"
    ;;
  *)
    echo "usage: $0 sweep OUT [PREFIX ...] | northstar OUT NAME SEED" \
      "MAX_SECONDS [...]" >&2
    exit 2
    ;;
esac
