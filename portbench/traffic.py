"""The general traffic generator: everything a cell feeds the program is
drawn here from ``--seed`` and the mix's parameters (a data file under
``portbench/traffic/``).  The same seed gives the same inputs; another
seed gives the same amount of work in other values and order."""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, inputs, dropout)."""
    digest = hashlib.sha256("{}:{}".format(int(seed), tag).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def device_generator(seed: int, tag: str, device):
    import torch
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def uint8_images(seed: int, tag: str, shape, device):
    """uint8 BGR frames of ``shape`` drawn on ``device`` in one call."""
    import torch
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                         device=device,
                         generator=device_generator(seed, tag, device))


def normal_parts(seed: int, tag: str, shapes: dict, device):
    """{name: float32 tensor} for ``shapes`` ({name: shape}): one standard
    normal draw on ``device`` under ``tag``, cut into the shapes in
    order."""
    import torch
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, device=device,
                       generator=device_generator(seed, tag, device))
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        out[name] = flat[at:at + n].reshape(shape)
        at += n
    return out


def he_weights(seed: int, shapes: dict, init: dict, device):
    """{name: float32 tensor} for ``shapes`` ({name: shape}) drawn on
    ``device`` in one normal draw (:func:`normal_parts` under
    ``"weights"``): conv kernels at He's standard deviation
    sqrt(2 / fan_in) times ``init["gain"][layer]`` (1 where not given), or
    at ``init["std"][layer]``; biases at 0.01 of their kernel's."""
    out = normal_parts(seed, "weights", shapes, device)
    for name in shapes:
        layer = name.rsplit(".", 1)[0]
        fan_in = int(np.prod(shapes[layer + ".weight"][1:]))
        std = init["std"].get(layer, (2.0 / fan_in) ** 0.5 *
                              init["gain"].get(layer, 1.0))
        if name.endswith(".bias"):
            std *= 0.01
        out[name] = out[name] * std
    return out


def model_weights(seed: int, cfg: dict, device):
    """The configuration's weights and buffers from the seed (its
    reference network's ``draw``), the head's kernel and bias then scaled
    so that the reference's head outputs on a frame drawn from the seed
    have the root mean square ``cfg["init"]["head_rms"]``: the depth's
    random gains would otherwise spread the head's scale over seeds by ten
    times, and a head that saturates its softmax and sigmoid hides a
    precision's errors."""
    import torch
    from portbench.reference import network
    net = network(cfg)
    weights = net.draw(seed, cfg, device)
    frame = uint8_images(seed, "probe_frame", (1, cfg["image_height"],
                                                 cfg["image_width"], 3),
                         device).float()
    means = torch.tensor(cfg["bgr_means"], device=device)
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.allow_tf32
    cudnn.deterministic, cudnn.allow_tf32 = True, False
    try:
        with torch.no_grad():
            head = net.forward(cfg, weights, frame - means)
    finally:
        cudnn.deterministic, cudnn.allow_tf32 = saved
    rms = float(head.double().pow(2).mean().sqrt())
    # three digits: the probe's own rounding does not reach the weights
    gain = float("{:.3g}".format(cfg["init"]["head_rms"] / rms))
    last = net.head(cfg)
    for name in (last + ".weight", last + ".bias"):
        weights[name] = weights[name] * gain
    return weights


def _objects(rng, mix, w0, h0):
    """One image's ground truth in its own pixels: (boxes [n, 4] center
    format, labels [n]), at least one object, ``mix["objects_mean"]`` on
    average, at most ``mix["max_gt"]``."""
    n = min(1 + rng.poisson(mix["objects_mean"] - 1.0), mix["max_gt"])
    labels = rng.choice(len(mix["class_share"]), size=n,
                        p=np.asarray(mix["class_share"]) /
                        np.sum(mix["class_share"]))
    aspect = np.asarray(mix["class_aspect"])[labels] * \
        np.exp(rng.normal(0.0, 0.2, n))
    w = np.exp(rng.uniform(np.log(mix["box_min"]), np.log(mix["box_max"]),
                           n))
    h = np.minimum(w * aspect, 0.8 * h0)
    w = np.minimum(w, 0.8 * w0)
    cx = rng.uniform(w / 2 + 1, w0 - w / 2 - 2)
    cy = rng.uniform(h / 2 + 1, h0 - h / 2 - 2)
    return np.stack([cx, cy, w, h], 1), labels


def train_feed(seed: int, cfg: dict, mix: dict, dispatches: int):
    """``dispatches`` train dispatches of ``mix["steps_per_dispatch"]``
    steps of ``mix["batch"]`` rows, as the recipe's sampler draws them:
    dataset rows without repeats (a permutation, cycled), the drift
    ``dy`` then ``dx`` (bounded so every box stays in the image) and the
    flip, the boxes moved, mirrored and scaled to the model's size as
    the data layer moves them.  Returns a list of dicts of numpy arrays:
    ``pos`` [K, B] int32, ``aug`` [K, B, 5] float32 (dx, dy, flip, ow',
    oh'), ``gt_boxes`` [K, B, G, 4] float32, ``gt_labels`` [K, B, G]
    int32, ``num_gt`` [K, B] int32."""
    rng = np.random.default_rng(sub_seed(seed, "train_feed"))
    k, b, g = mix["steps_per_dispatch"], mix["batch"], mix["max_gt"]
    h0, w0 = mix["canvas"]
    r = cfg["recipe"]
    order = rng.permutation(mix["dataset_images"])
    out, at = [], 0
    for _ in range(dispatches):
        d = {"pos": np.zeros((k, b), np.int32),
             "aug": np.zeros((k, b, 5), np.float32),
             "gt_boxes": np.zeros((k, b, g, 4), np.float32),
             "gt_labels": np.zeros((k, b, g), np.int32),
             "num_gt": np.zeros((k, b), np.int32)}
        for s in range(k):
            for i in range(b):
                d["pos"][s, i] = order[at % len(order)]
                at += 1
                boxes, labels = _objects(rng, mix, w0, h0)
                max_dx = int(np.floor(np.min(boxes[:, 0] - boxes[:, 2] / 2
                                             + 1)))
                max_dy = int(np.floor(np.min(boxes[:, 1] - boxes[:, 3] / 2
                                             + 1)))
                dy = int(rng.integers(-r["drift_y"],
                                      min(r["drift_y"] + 1, max_dy)))
                dx = int(rng.integers(-r["drift_x"],
                                      min(r["drift_x"] + 1, max_dx)))
                flip = int(rng.integers(2))
                boxes[:, 0] -= dx
                boxes[:, 1] -= dy
                ow, oh = float(w0 - dx), float(h0 - dy)
                if flip:
                    boxes[:, 0] = ow - 1 - boxes[:, 0]
                boxes[:, 0::2] *= cfg["image_width"] / ow
                boxes[:, 1::2] *= cfg["image_height"] / oh
                n = len(labels)
                d["aug"][s, i] = (dx, dy, flip, ow, oh)
                d["gt_boxes"][s, i, :n] = boxes
                d["gt_labels"][s, i, :n] = labels
                d["num_gt"][s, i] = n
        out.append(d)
    return out


class Stages:
    """Seconds of each named stage of a set-up, printed to standard error
    as they end (the record of where set-up goes)."""

    def __init__(self, what):
        self.what, self.t = what, time.perf_counter()

    def __call__(self, stage):
        now = time.perf_counter()
        print("{} set-up: {} {:.3f} s".format(self.what, stage, now - self.t),
              file=sys.stderr, flush=True)
        self.t = now
