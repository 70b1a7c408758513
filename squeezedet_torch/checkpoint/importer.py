"""Legacy weight import (counterpart of
``squeezedet_tpu/checkpoint/importer.py``): the caffe-derived joblib
pickle, ``{layer_name: [kernel OIHW, bias, ...]}``, which
``Detector.load_pretrained`` maps onto the backbone.

A TF1 ``model.ckpt-*`` checkpoint needs TensorFlow to read; its reader is
not part of the port (ROADMAP Queue 1 item 18).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


class TrackedWeights(dict):
    """Pretrained-weight dict that records which entries were read, so a
    cold start can warn about entries that matched no model layer."""

    def __init__(self, data):
        super().__init__(data)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)

    def unconsumed(self):
        return sorted(set(self.keys()) - self.consumed)


def warn_unconsumed(weights) -> List[str]:
    """Print (and return) the entries of a TrackedWeights that no layer
    read: typically a --net mismatch or a naming gap."""
    if not isinstance(weights, TrackedWeights):
        return []
    leftover = weights.unconsumed()
    if leftover:
        print('WARNING: {} pretrained entries matched no model layer and '
              'were ignored: {}'.format(len(leftover), ', '.join(leftover)))
    return leftover


def load_pretrained(path: str) -> Dict[str, List[np.ndarray]]:
    """Load a joblib pickle in the caffe layout ({name: [kernel OIHW,
    bias]}).  A TF1 checkpoint path raises ``NotImplementedError``."""
    if not path:
        raise ValueError("empty pretrained model path")
    if os.path.exists(path + ".index") or path.endswith(".ckpt") or \
            ".ckpt-" in os.path.basename(path):
        return load_tf1_checkpoint(path)
    try:
        import joblib
        weights = joblib.load(path)
    except ImportError:  # a plain pickle reads without joblib
        import pickle
        with open(path, "rb") as f:
            weights = pickle.load(f)
    return {k: [np.asarray(b) for b in blobs] for k, blobs in weights.items()}


def load_tf1_checkpoint(path: str):
    raise NotImplementedError(
        "{}: reading a TF1 checkpoint needs TensorFlow, which the port "
        "does not use (ROADMAP Queue 1 item 18); convert it to the caffe "
        "pickle layout with the JAX package first".format(path))
