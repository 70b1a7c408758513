"""Weight bridge between the JAX package's parameter tree and the port.

The JAX tree nests layer names (``conv1``, ``fire2/squeeze1x1``, ...,
``conv12``; ResNet's ``res2a/branch2/branch2a``) down to ``{"kernel":
HWIO, "bias": [O]}`` leaves, plus ``gamma``, ``beta``, ``mean`` and
``var`` [O] for a conv + batch norm; the port's backbone ``state_dict``
names the same layers with dots and holds OIHW ``weight`` tensors and
the other leaves under their JAX names (``mean`` and ``var`` as
buffers).  Both directions only transpose, so a round trip JAX -> torch
-> JAX is bit-identical.  The optimizer state
maps the same way: the optax chain's momentum ``trace`` tree and step
``count`` to and from ``optim.Momentum.state_dict()``.  Two more views
hold the train loop against the JAX package's: the caffe-pickle layout
(``{layer: [kernel OIHW, bias]}``) that both packages' pretrained-weight
paths consume, and a port checkpoint as a JAX ``TrainState`` tree.
:func:`from_jax_qparams` builds the int8 detector of a JAX quantized
tree (``quant.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_TO_TORCH = {"kernel": "weight", "bias": "bias", "gamma": "gamma",
             "beta": "beta", "mean": "mean", "var": "var"}
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


def _chain_field(opt_state, name: str):
    """The one entry of an optax chain state tuple that has ``name``."""
    found = [part for part in opt_state
             if name in getattr(part, "_fields", ())]
    if len(found) != 1:
        raise ValueError("expected one '{}' in the optax chain state, found "
                         "{}".format(name, len(found)))
    return found[0]


def from_jax_opt_state(opt_state, trainable: Dict[str, bool]) -> dict:
    """The JAX package's optimizer state (the ``build_optimizer`` chain:
    its ``trace`` tree and schedule ``count``) -> ``Momentum.state_dict()``
    of the port: OIHW momentum buffers of the trainable parameters, and
    the step.  ``trainable`` is ``Detector.trainable_mask()``, which
    names every state_dict entry and holds the batch-norm statistics as
    frozen; a frozen leaf's trace must be zero, as the chain keeps it."""
    trace = from_jax_params(_chain_field(opt_state, "trace").trace)
    if set(trace) != set(trainable):
        raise ValueError("trace names {} do not match the parameters "
                         "{}".format(sorted(trace), sorted(trainable)))
    for name, t in trace.items():
        if not trainable[name] and bool(t.any()):
            raise ValueError("frozen {} has a non-zero trace".format(name))
    return {"step": int(np.asarray(_chain_field(opt_state, "count").count)),
            "momentum": {n: t for n, t in trace.items() if trainable[n]}}


def to_jax_opt_state(state: dict, params: Dict[str, torch.Tensor], like):
    """``Momentum.state_dict()`` -> the JAX package's chain state,
    shaped like ``like`` (a state of the same chain): the trace tree
    holds the momentum buffers (HWIO) and zeros at the frozen leaves of
    ``params`` (the backbone state_dict), and ``count`` the step."""
    full = {name: state["momentum"].get(name, torch.zeros_like(p))
            for name, p in params.items()}
    tree = to_jax_params(full)
    parts = []
    for part in like:
        fields = getattr(part, "_fields", ())
        if "trace" in fields:
            part = part._replace(trace=tree)
        elif "count" in fields:
            part = part._replace(count=np.asarray(
                state["step"], np.asarray(part.count).dtype))
        parts.append(part)
    return tuple(parts)


def pickle_from_jax_params(tree) -> Dict[str, list]:
    """JAX params -> the caffe-pickle layout: {layer: [kernel OIHW, bias]},
    layer names as the JAX tree nests them ('fire2/squeeze1x1'); a conv +
    batch norm (ResNet) gives its caffe entries instead (``resnet50.
    caffe_names``): {conv: [kernel (, bias)], bn: [mean, var], scale:
    [gamma, beta]}."""
    from squeezedet_torch.models.resnet50 import caffe_names
    layers: dict = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        layers.setdefault(path[:-1], {})[path[-1]] = arr
    out = {}
    for path, leaves in layers.items():
        if "gamma" not in leaves:
            out["/".join(path)] = [leaves["kernel"], leaves["bias"]]
            continue
        conv, bn, scale = caffe_names(".".join(path))
        out[conv] = [leaves["kernel"]] + (
            [leaves["bias"]] if "bias" in leaves else [])
        out[bn] = [leaves["mean"], leaves["var"]]
        out[scale] = [leaves["gamma"], leaves["beta"]]
    return out


def checkpoint_to_jax_tree(tree: dict, like_opt_state) -> dict:
    """A port checkpoint tree ({"params", "opt_state", "step"}, as
    ``CheckpointManager.restore`` returns it) -> the JAX package's
    ``TrainState.as_tree()`` layout; ``like_opt_state`` is a state of the
    JAX optimizer chain, whose structure the opt state takes."""
    return {"params": to_jax_params(tree["params"]),
            "opt_state": to_jax_opt_state(tree["opt_state"], tree["params"],
                                          like_opt_state),
            "step": np.asarray(int(tree["step"]), np.int64)}


def from_jax_qparams(det, tree):
    """A quantized tree in the JAX package's layout (numpy leaves: int8
    HWIO kernels with ``mult``, ``bias`` and maybe ``in_scale``; float
    layers as in :func:`from_jax_params`; ResNet blocks' ``out_scale`` and
    ``shortcut_scale``; ``__input_scale__`` in whole-net mode) -> a new
    int8 ``Detector``: a copy of the float ``det`` whose quantized convs
    are ``layers.QConv``, whose block scales are buffers of their blocks
    and whose input scale is the buffer ``input_scale``.  ``det`` is left
    as it was; the copy lives on its device and is in eval mode."""
    import copy

    from squeezedet_torch.quant import INPUT_SCALE_KEY
    qdet = copy.deepcopy(det).eval()
    device = det.anchors.device
    for name, node in tree.items():
        if name == INPUT_SCALE_KEY:
            qdet.register_buffer("input_scale", torch.tensor(
                float(node), dtype=torch.float32, device=device))
        else:
            _load_quantized(qdet.backbone, name, node, device)
    return qdet


def _load_quantized(parent, name: str, node, device) -> None:
    """Put JAX-layout ``node`` into ``parent``'s submodule ``name``: a
    QConv in place of a quantized conv, float leaves copied into a float
    one, block scales as buffers, and sub-trees recursively."""
    from squeezedet_torch.models.layers import QConv
    module = getattr(parent, name)
    if "mult" in node:
        kernel = np.asarray(node["kernel"])
        if kernel.dtype != np.int8:
            raise TypeError("{}: quantized kernel must be int8, got "
                            "{}".format(name, kernel.dtype))
        in_scale = node.get("in_scale")
        setattr(parent, name, QConv(
            torch.tensor(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)),
                         device=device),
            torch.tensor(np.asarray(node["mult"], np.float32)),
            torch.tensor(np.asarray(node["bias"], np.float32)),
            in_scale=None if in_scale is None else float(in_scale),
            name=getattr(module, "name", name)))
        return
    if "kernel" in node:
        module.load_state_dict({k: v.to(device) for k, v in
                                from_jax_params(node).items()})
        return
    for key, value in node.items():
        if key in ("out_scale", "shortcut_scale"):
            module.register_buffer(key, torch.tensor(
                float(value), dtype=torch.float32, device=device))
        else:
            _load_quantized(module, key, value, device)
