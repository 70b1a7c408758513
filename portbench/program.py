"""The one place where the benchmark reaches into the program
(``squeezedet_torch``): its detector and config, built as its entry
points build them, given the benchmark's weights and buffers, and held
to the configuration file; and the program's span markers, loaded
before a traced window."""

from __future__ import annotations

import numpy as np

from portbench.reference import detect, network


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
    and the buffers the reference network names overwritten by
    ``weights`` ({name: tensor}, the reference's names, which are the
    backbone's)."""
    from squeezedet_torch.models import get_model
    det = get_model(cfg["net"], program_config(cfg, batch), device=device)
    load(det, weights, network(cfg).buffer_shapes(cfg))
    return det


def load(det, tensors, buffers=()):
    """Copy ``tensors`` into ``det``'s backbone: every parameter, named
    as the backbone names it, and each buffer that ``buffers`` names.
    The parameters' names have to be the backbone's, no more and no
    fewer; each named buffer has to be in the backbone.  Shapes have to
    agree.  Nothing is copied where one does not."""
    import torch
    buffers = sorted(buffers)
    params = dict(det.backbone.named_parameters())
    held = dict(det.backbone.named_buffers())
    weights = {n: t for n, t in tensors.items() if n not in buffers}
    if set(params) != set(weights):
        raise ValueError("parameter names differ: program {}, file {}".format(
            sorted(set(params) - set(weights)),
            sorted(set(weights) - set(params))))
    missing = [n for n in buffers if n not in tensors or n not in held]
    if missing:
        raise ValueError("buffers not drawn or not in the program's "
                         "backbone: {}".format(missing))
    pairs = {n: (params[n], weights[n]) for n in params}
    pairs.update((n, (held[n], tensors[n])) for n in buffers)
    for name, (mine, theirs) in pairs.items():
        if tuple(mine.shape) != tuple(theirs.shape):
            raise ValueError("{}: program shape {}, file {}".format(
                name, tuple(mine.shape), tuple(theirs.shape)))
    with torch.no_grad():
        for mine, theirs in pairs.values():
            mine.copy_(theirs)


def load_markers(device):
    """Load the program's span markers into ``device``'s context (built
    if need be), so that no traced window holds their first load."""
    import torch
    from squeezedet_torch.utils.profiling import load_markers
    load_markers(torch.device(device))
