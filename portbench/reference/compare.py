"""The numbers that decide ``correct`` for detections: the program's
fixed-shape outputs (boxes [N, K, 4], probs [N, K], classes [N, K],
keep [N, K]) judged against the reference's interpretation of the same
images (:func:`portbench.reference.detect.interpret`).

Each program candidate is matched to the reference anchor nearest to it
in box and in its class's score (a candidate does not name its anchor).

* ``head_gap``: how far the head's outputs behind the candidates lie
  from the reference's, relative to the head's own scale: the widest of
  (a) the mean over candidates of the widest box-coordinate gap to the
  matched anchor's box in units of that anchor's width or height (the
  box deltas' units), (b) the summed score gaps over the summed
  gradients of the matched anchors' scores with respect to their class
  and confidence logits (the logits' units), and (c) the summed gaps
  between the program's k-th probability and the reference's k-th
  largest anchor score over the summed gradients at those anchors, each
  over the root mean square of the reference's head outputs.  A score
  gap is the wider of the candidate's probability's gap to the anchor's
  score of the candidate's class and the amount by which that score
  lies below the anchor's best, so a candidate of the wrong class reads
  as wrong; (c) reads a top-K filter that kept the wrong anchors (a k-th
  largest value moves no more than the values do, so near-ties that
  swap two anchors do not read as errors).
* ``nms_flips``: candidates whose keep flag differs from the published
  filter run on the program's own candidates in float64; where an IoU
  lies within ``NMS_MARGIN`` of the threshold either answer stands.

The gaps are means in the head's units: the widest gap over some 65,000
values is the tail of bfloat16's rounding, and probabilities saturate
by amounts that differ from seed to seed, so neither separates bfloat16
from float8 on every seed (readings in ``PERF.md``).
"""

from __future__ import annotations

import torch

from portbench.reference.detect import suppressed

# pixels per unit of probability when matching a candidate to an anchor
MATCH_PX_PER_PROB = 1000.0
# the float32 rounding of an IoU, well inside
NMS_MARGIN = 1e-5


def _score_grad(ref):
    """[n, A] norm of the gradient of each anchor's best score with
    respect to its class logits and its confidence logit."""
    q, s = ref["class_probs"].float(), ref["conf"].float()
    qm, m = q.max(-1)
    onehot = torch.nn.functional.one_hot(m, q.shape[-1]).float()
    dl = (s * qm)[..., None] * (onehot - q)
    dz = qm * s * (1 - s)
    return torch.sqrt(dz ** 2 + (dl ** 2).sum(-1))


def head_rms(ref):
    """Root mean square of the reference's head outputs."""
    parts = [ref["class_logits"], ref["conf_logits"][..., None],
             ref["deltas"]]
    total = sum(float(p.double().pow(2).sum()) for p in parts)
    return (total / sum(p.numel() for p in parts)) ** 0.5


def detection_gaps(cfg, outputs, ref, anchor_box, chunk=8):
    """(numbers, detail) over all images; ``outputs`` and ``ref``
    (``interpret``'s dict) on one device, image-aligned, ``anchor_box``
    the reference's [A, 4] anchors."""
    boxes, probs, classes, keep = outputs
    boxes, probs = boxes.float(), probs.float()
    n, k = probs.shape
    box_sum = score_sum = grad_sum = top_sum = top_grad = 0.0
    flips = 0
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        rb, rs = ref["boxes"][sl].float(), ref["scores"][sl].float()
        best = rs.amax(-1)
        cls = classes[sl].long()
        sc = torch.gather(rs.permute(0, 2, 1), 1,
                          cls[..., None].expand(-1, -1, rs.shape[1]))
        dbox = (boxes[sl][:, :, None, :] - rb[:, None, :, :]).abs()
        cost = dbox.amax(-1) + MATCH_PX_PER_PROB * (probs[sl][..., None]
                                                    - sc).abs()
        a = cost.argmin(dim=-1)
        anc = anchor_box[a]
        units = torch.stack([anc[..., 2], anc[..., 3]] * 2, -1)
        gap = torch.gather(dbox, 2, a[..., None, None].expand(
            -1, -1, 1, 4))[:, :, 0] / units
        box_sum += float(gap.amax(-1).double().sum())
        own = torch.gather(sc, 2, a[..., None])[..., 0]
        top = torch.gather(best, 1, a)
        score_sum += float(torch.maximum((probs[sl] - own).abs(),
                                         top - own).double().sum())
        grad = _score_grad({key: ref[key][sl]
                            for key in ("class_probs", "conf")})
        grad_sum += float(torch.gather(grad, 1, a).double().sum())
        kth, order = torch.sort(best, dim=1, descending=True)
        top_sum += float((probs[sl] - kth[:, :k]).abs().double().sum())
        top_grad += float(torch.gather(grad, 1, order[:, :k]).double().sum())
        args = (boxes[sl], probs[sl], classes[sl], cfg["nms_thresh"])
        sure = suppressed(*args, margin=NMS_MARGIN)
        maybe = suppressed(*args, margin=-NMS_MARGIN)
        if k >= rs.shape[1]:
            above = probs[sl] > cfg["prob_thresh"]
            sure, maybe = sure | ~above, maybe | ~above
        kp = keep[sl].bool()
        flips += int(((kp & sure) | (~kp & ~maybe)).sum())
    rms = head_rms(ref)
    parts = {"box_part": box_sum / (n * k) / rms,
             "score_part": score_sum / max(grad_sum, 1e-30) / rms,
             "topk_part": top_sum / max(top_grad, 1e-30) / rms}
    return ({"head_gap": max(parts.values()), "nms_flips": flips},
            dict(parts, head_rms=rms))
