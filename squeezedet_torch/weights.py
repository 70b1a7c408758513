"""Weight bridge between the JAX package's parameter tree and the port.

The JAX tree nests layer names (``conv1``, ``fire2/squeeze1x1``, ...,
``conv12``) down to ``{"kernel": HWIO, "bias": [O]}`` leaves; the port's
backbone ``state_dict`` names the same layers with dots and holds OIHW
``weight`` and ``bias`` tensors.  Both directions only transpose, so a
round trip JAX -> torch -> JAX is bit-identical.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_TO_TORCH = {"kernel": "weight", "bias": "bias"}
_TO_JAX = {v: k for k, v in _TO_TORCH.items()}


def _flatten(tree, prefix=()):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def from_jax_params(tree) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (HWIO kernels) -> backbone state_dict
    (OIHW weights), on the CPU."""
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
        key = ".".join(path[:-1] + (_TO_TORCH[path[-1]],))
        state[key] = torch.tensor(np.ascontiguousarray(arr))
    return state


def to_jax_params(state_dict) -> dict:
    """Backbone state_dict -> nested dict of numpy arrays in the JAX
    package's layout (HWIO kernels)."""
    tree: dict = {}
    for key, value in state_dict.items():
        *layers, leaf = key.split(".")
        arr = value.detach().cpu().numpy()
        if leaf == "weight":
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        node = tree
        for name in layers:
            node = node.setdefault(name, {})
        node[_TO_JAX[leaf]] = arr
    return tree
