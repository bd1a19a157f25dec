#!/usr/bin/env bash
# Speed/stability sweep (reference: experiments/toy_models/speed_and_stability.sh):
# wall-time + RMSE over n = 2^12..2^15, Matern32/52 + RBF(order 6, balance 10),
# float64, all three model classes.  Device placement: the reference pins
# PSSGP->/gpu, SSGP->/cpu, GP->/gpu; here --platform plays that role
# (default: the accelerator, in float32 and float64 alike; --split-devices
# sends SSGP to the host CPU).
set -euo pipefail
cd "$(dirname "$0")/.."
py=parallel_gps_tpu.experiments.toy_models.speed_and_stability
common=(--rbf-order 6 --rbf-balance-iter 10 --qp-order 6 --data-model sine
        --noise-variance 0.1 --n-seeds "${N_SEEDS:-21}"
        --log2-sizes ${LOG2_SIZES:-12 13 14 15} --out-dir "${OUT_DIR:-results/toy_sas}")

for cov in Matern32 Matern52 RBF; do
  for model in ssgp pssgp gp; do
    python -m $py --model=$model --cov=$cov --dtype="${DTYPE:-float64}" "${common[@]}"
  done
done
