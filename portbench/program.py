"""The one place where the benchmark reaches into the program
(``squeezedet_torch``): its detector and config, built as its entry
points build them, given the benchmark's weights, and held to the
configuration file."""

from __future__ import annotations

import numpy as np

from portbench.reference import detect


def program_config(cfg, batch):
    """The program's config for the net at ``batch`` in the file's
    compute dtype (at another size than the net's own, the program's
    config for that size), after checking that every number the file
    states is the program's."""
    from squeezedet_torch.config import config_for_net
    from squeezedet_torch.config.kitti import custom_kitti_config
    pcfg = config_for_net(cfg["net"])
    if (pcfg.image_width, pcfg.image_height) != (cfg["image_width"],
                                                 cfg["image_height"]):
        pcfg = custom_kitti_config(cfg["net"], cfg["image_width"],
                                   cfg["image_height"])
    pcfg = pcfg.replace(
        batch_size=batch, load_pretrained_model=False,
        compute_dtype=cfg["compute_dtype"])
    r = cfg["recipe"]
    want = {"image_width": cfg["image_width"],
            "image_height": cfg["image_height"],
            "classes": cfg["classes"],
            "anchor_per_grid": cfg["anchor_per_grid"],
            "keep_prob": cfg["keep_prob"], "exp_thresh": cfg["exp_thresh"],
            "top_n_detection": cfg["top_n_detection"],
            "nms_thresh": cfg["nms_thresh"],
            "prob_thresh": cfg["prob_thresh"],
            "bgr_means": tuple(cfg["bgr_means"])}
    want.update((k, r[k]) for k in r if k != "batch_size")
    got = {k: getattr(pcfg, k) for k in want}
    if got != want:
        raise ValueError("the program's config differs from {}: {}".format(
            cfg["name"], {k: (got[k], want[k]) for k in want
                          if got[k] != want[k]}))
    ref = detect.anchors(cfg, "cpu").double().numpy()
    if not np.allclose(np.asarray(pcfg.anchor_box), ref, rtol=0,
                       atol=1e-4):
        raise ValueError("the program's anchors differ from " + cfg["name"])
    return pcfg


def detector(cfg, batch, weights, device):
    """The program's Detector for ``cfg`` at ``batch``, its parameters
    overwritten by ``weights`` ({name: tensor}, the reference's names,
    which are the backbone's)."""
    from squeezedet_torch.models import get_model
    det = get_model(cfg["net"], program_config(cfg, batch), device=device)
    load(det, weights)
    return det


def load(det, weights):
    import torch
    params = dict(det.backbone.named_parameters())
    if set(params) != set(weights):
        raise ValueError("parameter names differ: program {}, file {}".format(
            sorted(set(params) - set(weights)),
            sorted(set(weights) - set(params))))
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError("{}: program shape {}, file {}".format(
                    name, tuple(p.shape), tuple(weights[name].shape)))
            p.copy_(weights[name])

