#!/bin/bash
# Training launcher of the PyTorch port (the port's counterpart of
# scripts/train.sh, same flags plus -device): composes the
# squeezedet_torch.train invocation from -net/-train_dir/-data_path/
# -image_set flags.  Run from anywhere; it runs from the repository root.

NET="squeezeDet"
TRAIN_DIR="${TMPDIR:-/tmp}/squeezedet_torch/logs/train"
DATA_PATH="./data/KITTI"
IMAGE_SET="train"
PRETRAINED=""
MAX_STEPS=1000000
DEVICE="cuda"

usage="Usage: $0 [-net (squeezeDet|squeezeDet+|vgg16|resnet50)]
       [-device (cuda|cpu)] [-train_dir path] [-data_path path]
       [-image_set set] [-pretrained path] [-max_steps n]"

while [[ $# -gt 1 ]]; do
  case "$1" in
    -net) NET="$2"; shift;;
    -device) DEVICE="$2"; shift;;
    -train_dir) TRAIN_DIR="$2"; shift;;
    -data_path) DATA_PATH="$2"; shift;;
    -image_set) IMAGE_SET="$2"; shift;;
    -pretrained) PRETRAINED="$2"; shift;;
    -max_steps) MAX_STEPS="$2"; shift;;
    *) echo "$usage"; exit 1;;
  esac
  shift
done
if [[ $# -gt 0 ]]; then echo "$usage"; exit 1; fi

DATA_PATH=$(realpath -m "$DATA_PATH")
TRAIN_DIR=$(realpath -m "$TRAIN_DIR")
cd "$(dirname "$0")/.."
exec python3 -m squeezedet_torch.train \
  --dataset=KITTI \
  --net="$NET" \
  --device="$DEVICE" \
  --data_path="$DATA_PATH" \
  --image_set="$IMAGE_SET" \
  --train_dir="$TRAIN_DIR/train" \
  --pretrained_model_path="$PRETRAINED" \
  --max_steps="$MAX_STEPS" \
  --summary_step=100 \
  --checkpoint_step=500
