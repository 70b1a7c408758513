#!/bin/bash
# Eval-daemon launcher of the PyTorch port (the port's counterpart of
# scripts/eval.sh, same flags plus -device): an eval job polling the
# checkpoint directory.  Run from anywhere; it runs from the repository
# root.

NET="squeezeDet"
EVAL_DIR="${TMPDIR:-/tmp}/squeezedet_torch/logs/eval"
CKPT_DIR="${TMPDIR:-/tmp}/squeezedet_torch/logs/train/train"
DATA_PATH="./data/KITTI"
IMAGE_SET="val"
DEVICE="cuda"

usage="Usage: $0 [-net net] [-device (cuda|cpu)] [-eval_dir path]
       [-ckpt_dir path] [-data_path path] [-image_set set]"

while [[ $# -gt 1 ]]; do
  case "$1" in
    -net) NET="$2"; shift;;
    -device) DEVICE="$2"; shift;;
    -eval_dir) EVAL_DIR="$2"; shift;;
    -ckpt_dir) CKPT_DIR="$2"; shift;;
    -data_path) DATA_PATH="$2"; shift;;
    -image_set) IMAGE_SET="$2"; shift;;
    *) echo "$usage"; exit 1;;
  esac
  shift
done
if [[ $# -gt 0 ]]; then echo "$usage"; exit 1; fi

DATA_PATH=$(realpath -m "$DATA_PATH")
EVAL_DIR=$(realpath -m "$EVAL_DIR")
CKPT_DIR=$(realpath -m "$CKPT_DIR")
cd "$(dirname "$0")/.."
exec python3 -m squeezedet_torch.eval \
  --dataset=KITTI \
  --net="$NET" \
  --device="$DEVICE" \
  --data_path="$DATA_PATH" \
  --image_set="$IMAGE_SET" \
  --eval_dir="$EVAL_DIR/$IMAGE_SET" \
  --checkpoint_path="$CKPT_DIR"
