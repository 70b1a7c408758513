"""Randomly split KITTI's trainval.txt into train.txt and val.txt, half
each (counterpart of ``squeezedet_tpu/tools/random_split_train_val.py``;
the same ``RandomState`` draw, so one seed gives the same split).

    python -m squeezedet_torch.tools.random_split_train_val \\
        <kitti-root>/ImageSets [--seed N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def split(image_set_dir: str, trainval_file: str = "trainval.txt",
          train_file: str = "train.txt", val_file: str = "val.txt",
          seed: int | None = None) -> None:
    with open(os.path.join(image_set_dir, trainval_file)) as f:
        lines = [line.strip() for line in f if line.strip()]
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(lines))
    half = len(lines) // 2
    with open(os.path.join(image_set_dir, train_file), "w") as f:
        f.write("\n".join(lines[i] for i in sorted(idx[:half])) + "\n")
    with open(os.path.join(image_set_dir, val_file), "w") as f:
        f.write("\n".join(lines[i] for i in sorted(idx[half:])) + "\n")
    print("Wrote {} train / {} val indices".format(half,
                                                   len(lines) - half))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("image_set_dir",
                   help="KITTI ImageSets dir containing trainval.txt")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    split(args.image_set_dir, seed=args.seed)


if __name__ == "__main__":
    main()
