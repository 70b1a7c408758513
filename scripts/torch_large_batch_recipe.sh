#!/bin/bash
# The large-batch learning-parity recipe through the PyTorch port's CLIs
# (the port's counterpart of scripts/large_batch_recipe.sh, same fixture,
# arms and flags): train squeezeDet from scratch at 1248x384 in bf16 on a
# class-correlated synthetic KITTI split and score it on a held-out one.
#
#   ARM=control  -> batch 16, lr 0.001, 3000 steps, checkpoint every 1000
#   ARM=large    -> batch 128 via --recipe_batch 128 (lr 0.008, decay
#                   1250, conf_pos 600, 10% warmup), 375 steps
#
# gen writes 256 train images (seed 1) and 75 val images (seed 7,
# numbered from 1000) with the port's own generator
# (squeezedet_torch.data.synth.make_synth_kitti, the pixels and labels of
# tests/synth_kitti.py).  Both arms train with --device_assign
# --uint8_ingest --image_cache_mb 768 --seed $SEED; eval scores the
# arm's last checkpoint with --run_once --eval_batch_size 25 in bf16.
#
# Knobs: SEED=n (default 0; train dirs get _s<n> for n > 0), DS=1 adds
# --device_dataset (dirs get _ds), K=n adds --steps_per_dispatch n (dirs
# get _k<n>), SUMMARY=n sets --summary_step (default 10; a summary step
# writes scalars and detection images and changes nothing the run
# learns), ROOT=dir (default $TMPDIR/lb_torch) holds the data and runs.
# Usage, from anywhere:
#   bash scripts/torch_large_batch_recipe.sh gen
#   ARM=large [DS=1] [K=8] [SEED=n] bash scripts/torch_large_batch_recipe.sh train
#   ARM=large [DS=1] [K=8] [SEED=n] bash scripts/torch_large_batch_recipe.sh eval
set -e
cd "$(dirname "$0")/.."
ROOT=${ROOT:-${TMPDIR:-/tmp}/lb_torch}
DATA=$ROOT/kitti
ARM=${ARM:-large}
SEED=${SEED:-0}
W=1248; H=384

SUFFIX=""
EXTRA=""
if [ -n "$DS" ]; then EXTRA="$EXTRA --device_dataset"; SUFFIX="_ds"; fi
if [ -n "$K" ]; then
  EXTRA="$EXTRA --steps_per_dispatch $K"; SUFFIX="${SUFFIX}_k$K"
fi
if [ "$SEED" != 0 ]; then SUFFIX="${SUFFIX}_s$SEED"; fi

case "$1" in
gen)
  python3 - <<PY
from squeezedet_torch.data.synth import make_synth_kitti
make_synth_kitti('$DATA', num_images=256, width=$W, height=$H,
                 image_set='train', seed=1, start_index=0)
make_synth_kitti('$DATA', num_images=75, width=$W, height=$H,
                 image_set='val', seed=7, start_index=1000)
PY
  ;;
train)
  if [ "$ARM" = control ]; then
    STEPS=3000; CKPT=1000; RECIPE=""
  elif [ "$ARM" = large ]; then
    STEPS=375; CKPT=125; RECIPE="--recipe_batch 128"
  else
    echo "ARM must be control or large"; exit 1
  fi
  python3 -m squeezedet_torch.train --data_path "$DATA" \
    --image_set train --train_dir "$ROOT/train_$ARM$SUFFIX" \
    --image_width $W --image_height $H --batch_size 16 \
    --learning_rate 0.001 --max_steps $STEPS --checkpoint_step $CKPT \
    --summary_step "${SUMMARY:-10}" --device_assign --uint8_ingest \
    --compute_dtype bfloat16 --image_cache_mb 768 --seed "$SEED" \
    $RECIPE $EXTRA
  ;;
eval)
  python3 -m squeezedet_torch.eval --data_path "$DATA" \
    --image_set val --eval_dir "$ROOT/eval_$ARM$SUFFIX" \
    --checkpoint_path "$ROOT/train_$ARM$SUFFIX" --run_once \
    --eval_batch_size 25 --image_width $W --image_height $H \
    --compute_dtype bfloat16
  ;;
*)
  echo "usage: $0 {gen|train|eval}  [ARM=control|large] [SEED=n] [DS=1] [K=n]"
  exit 1
  ;;
esac
