#!/usr/bin/env bash
# Real-KITTI parity harness of the PyTorch port (the port's counterpart
# of scripts/parity_vs_reference.sh):
#
#   1. import the checkpoint into the port's format (squeezedet-torch-import,
#      which reads the reference's TF1 model.ckpt-87000 without TensorFlow);
#   2. demo parity: the detection overlay of the sample image, for a
#      visual diff against the reference README's published output;
#   3. mAP parity: eval-once on the KITTI val split, then the mAP against
#      a recorded reference value (tolerance 0.005, mAP in [0, 1]).
#
# Usage, from anywhere:
#   scripts/torch_parity_vs_reference.sh <KITTI_ROOT> <CHECKPOINT> [REF_MAP]
#
#   KITTI_ROOT  KITTI object-detection root: training/{image_2,label_2}
#               and ImageSets/val.txt
#   CHECKPOINT  the released TF1 checkpoint (model.ckpt-87000), a caffe
#               pickle, or a port train_dir (model.ckpt-<step> dirs)
#   REF_MAP     optional reference mAP; when given, the script exits
#               non-zero if |ours - ref| > 0.005
#
# Environment overrides:
#   NET     backbone (default squeezeDet)
#   DEVICE  cuda (default) or cpu
#   SAMPLE  demo image (default ./data/sample.png)
#   WORK    scratch dir (default $TMPDIR/squeezedet_torch_parity)
#   EXTRA   extra flags for the demo and eval CLIs (e.g. an image size)
#
# The stages run the console scripts' modules (python3 -m
# squeezedet_torch.tools.import_checkpoint is squeezedet-torch-import),
# so a checkout runs it without an install.

set -euo pipefail

KITTI_ROOT=$(realpath -m "${1:?usage: torch_parity_vs_reference.sh <kitti_root> <checkpoint> [ref_map]}")
CHECKPOINT=$(realpath -m "${2:?usage: torch_parity_vs_reference.sh <kitti_root> <checkpoint> [ref_map]}")
REF_MAP=${3:-}
NET=${NET:-squeezeDet}
DEVICE=${DEVICE:-cuda}
SAMPLE=$(realpath -m "${SAMPLE:-./data/sample.png}")
WORK=$(realpath -m "${WORK:-${TMPDIR:-/tmp}/squeezedet_torch_parity}")
read -r -a EXTRA_FLAGS <<< "${EXTRA:-}"

cd "$(dirname "$0")/.."
mkdir -p "$WORK"

echo "== [1/3] importing checkpoint -> port format =="
if [ -d "$CHECKPOINT" ] && ls "$CHECKPOINT"/model.ckpt-* >/dev/null 2>&1
then
    CKPT_DIR="$CHECKPOINT"
    echo "already in the port's format: $CKPT_DIR"
else
    CKPT_DIR="$WORK/ckpt"
    python3 -m squeezedet_torch.tools.import_checkpoint \
        --checkpoint "$CHECKPOINT" --out_dir "$CKPT_DIR" --net "$NET" \
        --step 87000
fi

echo "== [2/3] demo on the sample image (visual parity artifact) =="
if [ -f "$SAMPLE" ]; then
    python3 -m squeezedet_torch.demo --input_path "$SAMPLE" \
        --out_dir "$WORK/demo" --checkpoint "$CKPT_DIR" --demo_net "$NET" \
        --device "$DEVICE" "${EXTRA_FLAGS[@]}"
    echo "wrote $WORK/demo/out_$(basename "$SAMPLE"); diff it visually" \
         "against the reference README's sample output"
else
    echo "sample image $SAMPLE not found; skipping the demo stage"
fi

echo "== [3/3] eval-once on KITTI val (mAP parity) =="
python3 -m squeezedet_torch.eval --data_path "$KITTI_ROOT" --image_set val \
    --eval_dir "$WORK/eval" --checkpoint_path "$CKPT_DIR" --run_once \
    --net "$NET" --device "$DEVICE" --skip_analysis "${EXTRA_FLAGS[@]}" \
    | tee "$WORK/eval.log"

MAP=$(grep "Mean average precision:" "$WORK/eval.log" | tail -1 \
      | awk '{print $NF}')
echo ""
echo "measured mAP: $MAP"
if [ -n "$REF_MAP" ]; then
    python3 - "$MAP" "$REF_MAP" <<'PY'
import sys
ours, ref = float(sys.argv[1]), float(sys.argv[2])
delta = abs(ours - ref)
print("reference mAP: {:.4f}   delta: {:.4f}".format(ref, delta))
if delta > 0.005:
    print("FAIL: outside the 0.5-mAP parity bar")
    sys.exit(1)
print("PASS: within the 0.5-mAP parity bar")
PY
else
    echo "(no REF_MAP given: record the reference eval's mAP on this"
    echo " split and re-run with it as the third argument to enforce"
    echo " the parity bar)"
fi
