#!/bin/bash
# Learning parity over seeds: scripts/torch_large_batch_recipe.sh's fixture,
# then for each seed of SEEDS and each arm (control, large) its train and
# eval, with the recipe's knobs passed through (K, DS, SUMMARY, ROOT).
# Each run's output goes to $LOGS/<arm>_s<seed>.{train,eval}.log (LOGS
# defaults to the recipe's ROOT/logs); one line a run,
#   parity <arm> seed <n>: mAP <m> (<class>: <AP>, ...) train <s> s
# is printed and appended to $LOGS/summary.txt, then the mean val mAP of
# each arm over SEEDS.  GEN=0 skips writing the fixture (already there).
# Usage, from anywhere (on the card):
#   K=8 DS=1 SEEDS="4 5 6 7" bash scripts/torch_parity_seeds.sh
set -e
cd "$(dirname "$0")/.."
LOGS=${LOGS:-${ROOT:-${TMPDIR:-/tmp}/lb_torch}/logs}
SEEDS=${SEEDS:-4 5 6 7}
RECIPE=scripts/torch_large_batch_recipe.sh
mkdir -p "$LOGS"
if [ "${GEN:-1}" != 0 ]; then bash $RECIPE gen > "$LOGS/gen.log" 2>&1; fi
for seed in $SEEDS; do
  for arm in control large; do
    base="$LOGS/${arm}_s$seed"
    t0=$(date +%s)
    ARM=$arm SEED=$seed bash $RECIPE train > "$base.train.log" 2>&1
    t1=$(date +%s)
    ARM=$arm SEED=$seed bash $RECIPE eval > "$base.eval.log" 2>&1
    aps=$(sed -n '/Average precisions:/,/Mean average precision/p' \
      "$base.eval.log" | sed '1d;$d' | sed 's/^ *//' | paste -sd, - \
      | sed 's/,/, /g')
    map=$(sed -n 's/.*Mean average precision: //p' "$base.eval.log")
    echo "parity $arm seed $seed: mAP $map ($aps) train $((t1 - t0)) s" \
      | tee -a "$LOGS/summary.txt"
  done
done
for arm in control large; do
  awk -v arm="$arm" '$2 == arm { s += $6; n++ }
    END { if (n) printf "parity %s mean over %d seeds: %.4f\n", arm, n, s / n }' \
    "$LOGS/summary.txt" | tee -a "$LOGS/summary.txt"
done
