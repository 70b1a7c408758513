"""Cells at a size a CPU test run holds: the benchmark's own
configurations and mixes at 128 x 64 frames (the program's config for
that size: anchor shapes and drifts scaled), few images and short
windows."""

from __future__ import annotations

import copy

from portbench import run

WIDTH, HEIGHT = 128, 64


def tiny_config(cfg):
    from squeezedet_torch.config.kitti import custom_kitti_config
    pcfg = custom_kitti_config(cfg["net"], WIDTH, HEIGHT)
    cfg = copy.deepcopy(cfg)
    cfg["image_width"], cfg["image_height"] = WIDTH, HEIGHT
    cfg["anchor_shapes"] = [[a * WIDTH / 1248.0, b * HEIGHT / 384.0]
                            for a, b in cfg["anchor_shapes"]]
    cfg["recipe"]["drift_x"] = pcfg.drift_x
    cfg["recipe"]["drift_y"] = pcfg.drift_y
    return cfg


def cell(name, **mix):
    """The cell ``name`` at the tiny size, ``mix`` overriding its mix."""
    spec = run.cell_spec(run.load_json("BENCHMARK.json"), name)
    spec["cfg"] = tiny_config(spec["cfg"])
    spec["mix"] = dict(spec["mix"], **mix)
    return spec


SCORE = dict(batch=4, pool=2, check_block=4, trace_seconds=0.05)
TRAIN = dict(batch=2, steps_per_dispatch=2, dataset_images=12,
             canvas=[62, 124], max_gt=6, feed_dispatches=4,
             box_min=4.0, box_max=40.0, trace_seconds=0.05)
