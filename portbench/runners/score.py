"""Bulk scoring: back-to-back batches of uint8 frames through the
program's whole uint8 -> detections path
(``Detector.predict_raw_postprocessed``), a closed loop of one caller.

Mix parameters: ``batch``, ``pool`` (distinct batches, made on the
device from the seed and sent in turn), ``check_block`` (images a
reference block)."""

from __future__ import annotations

import time

import torch

from portbench import program, traffic
from portbench.reference import compare, detect, network, precision


def reference_detections(cfg, weights, images_u8, block, quant=None):
    """The reference's interpretation of uint8 frames, image-aligned, in
    blocks of ``block`` images; ``quant`` puts the control in its place."""
    anchor_box = detect.anchors(cfg, images_u8.device)
    net = network(cfg)
    means = torch.tensor(cfg["bgr_means"], device=images_u8.device)
    parts = []
    for s in range(0, images_u8.shape[0], block):
        x = images_u8[s:s + block].float() - means
        parts.append(detect.interpret(
            cfg, net.forward(cfg, weights, x, quant=quant), anchor_box))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def reference_mode():
    """float32 convolutions and products with TF32 off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Runner:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)

    def setup(self):
        cfg, mix = self.cfg, self.mix
        stage = traffic.Stages("score")
        self.weights = traffic.model_weights(self.seed, cfg, self.device)
        self.det = program.detector(cfg, mix["batch"], self.weights,
                                    self.device)
        stage("weights and program")
        self.pool = traffic.uint8_images(
            self.seed, "score_pool",
            (mix["pool"], mix["batch"], cfg["image_height"],
             cfg["image_width"], 3), self.device)
        stage("frames")
        for i in range(2):  # builds K1, plans cuDNN's convs
            self.det.predict_raw_postprocessed(self.pool[i % len(self.pool)])
            self._sync()
            stage("warm call {}".format(i + 1))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds):
        det, pool = self.det, self.pool
        last = {}
        calls = 0
        t0 = time.perf_counter()
        while True:
            i = calls % len(pool)
            last[i] = det.predict_raw_postprocessed(pool[i])
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        self.last = last
        return {"seconds": time.perf_counter() - t0, "calls": calls,
                "images": calls * self.mix["batch"], "steps": calls,
                "attempted": calls, "failed": 0}

    def end_to_end(self, win):
        return {"score_img_s": win["images"] / win["seconds"]}

    def release(self):
        del self.det

    def judged(self):
        """(program outputs, frames) of the window's last call on each
        pool batch, image-aligned."""
        idx = sorted(self.last)
        outs = [torch.cat([self.last[i][j] for i in idx])
                for j in range(4)]
        return outs, torch.cat([self.pool[i] for i in idx])

    def check(self, quant=None):
        outs, frames = self.judged()
        return judge_detections(self.cfg, self.weights, frames, outs,
                                self.mix["check_block"], self, quant)


def judge_detections(cfg, weights, frames, outs, block, holder, quant=None):
    """{head_gap_x_bf16, nms_flips} of ``outs`` (or of the reference in
    ``quant`` put in their place) against the reference on ``frames``:
    the head gap (:func:`compare.detection_gaps`) over the head gap of
    the reference computed with bfloat16 operands, the configuration's
    precision, on the same frames: the weights of one seed carry
    rounding further than another's, by up to three times, and this
    ratio holds the program to what bfloat16 itself gives.  The parts
    of both go to ``holder.detail``."""
    reference_mode()
    anchor_box = detect.anchors(cfg, frames.device)
    if quant is not None:  # the control in the program's place
        outs = detect.filter_top(cfg, reference_detections(
            cfg, weights, frames, block, quant))
    ref = reference_detections(cfg, weights, frames, block)
    own = detect.filter_top(cfg, reference_detections(
        cfg, weights, frames, block, precision.bf16))
    numbers, detail = compare.detection_gaps(cfg, outs, ref, anchor_box)
    base, base_detail = compare.detection_gaps(cfg, own, ref, anchor_box)
    holder.detail = dict(detail, head_gap=numbers["head_gap"],
                         bf16_head_gap=base["head_gap"],
                         **{"bf16_" + k: v for k, v in base_detail.items()})
    return {"head_gap_x_bf16": numbers["head_gap"] / base["head_gap"],
            "nms_flips": numbers["nms_flips"]}
