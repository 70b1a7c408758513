"""The recipe's training step from its equations: the drift crop, flip
and bilinear resize of the data layer (BichenWuUCB/squeezeDet
``src/dataset/imdb.py`` ``read_batch`` with ``cv2.resize``), the greedy
anchor assignment of the same function, the three-term loss of
``src/nn_skeleton.py`` (``_add_loss_graph``) with L2 weight decay on the
trainable kernels, and momentum SGD with each gradient clipped to
``max_grad_norm`` by its own norm (``_add_train_graph``), at the
staircase rate ``lr * factor ** floor(step / decay_steps)``.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import detect, network


def augment(cfg, canvas, aug):
    """uint8 canvases [B, H0, W0, 3] (each image filling it from the top
    left) and rows (dx, dy, flip, ow', oh') -> mean-subtracted float32
    [B, H, W, 3]: the image shifted by the drift (zero where it was
    padded), mirrored when ``flip``, and resized bilinearly to the
    model's size with cv2's half-pixel sample positions and edge
    clamping."""
    b, h0, w0, _ = canvas.shape
    dev = canvas.device
    out_h, out_w = cfg["image_height"], cfg["image_width"]
    means = torch.tensor(cfg["bgr_means"], dtype=torch.float32, device=dev)
    # one zero row and column past the end stand for the drift's padding
    img = torch.zeros((b, h0 + 1, w0 + 1, 3), dtype=torch.float32,
                      device=dev)
    img[:, :h0, :w0] = canvas.float() - means
    dx, dy, flip, ow, oh = (aug[:, i].float() for i in range(5))

    def taps(n_out, extent, shift, limit, mirror=None):
        s = (torch.arange(n_out, device=dev, dtype=torch.float32)[None]
             + 0.5) * extent[:, None] / n_out - 0.5
        s = torch.minimum(s.clamp(min=0.0), extent[:, None] - 1.0)
        if mirror is not None:
            s = torch.where(mirror[:, None] > 0, extent[:, None] - 1.0 - s, s)
        i0 = torch.floor(s)
        frac = s - i0
        out = []
        for i, wgt in ((i0, 1.0 - frac), (i0 + 1.0, frac)):
            src = (i + shift[:, None]).long()
            ok = (src >= 0) & (src < (extent + shift)[:, None].long())
            out.append((torch.where(ok, src, limit), wgt))
        return out

    rows = taps(out_h, oh, dy, h0)
    cols = taps(out_w, ow, dx, w0, flip)
    bi = torch.arange(b, device=dev)[:, None, None]
    res = 0.0
    for r, wr in rows:
        for c, wc in cols:
            px = img[bi, r[:, :, None], c[:, None, :]]
            res = res + (wr[:, :, None] * wc[:, None, :])[..., None] * px
    return res


def iou_center(anchor_box, box):
    """[A, 4] anchors against one center box per image [B, 4] -> [B, A]
    (``util.batch_iou``: no epsilon)."""
    ax1 = anchor_box[:, 0] - anchor_box[:, 2] / 2
    ax2 = anchor_box[:, 0] + anchor_box[:, 2] / 2
    ay1 = anchor_box[:, 1] - anchor_box[:, 3] / 2
    ay2 = anchor_box[:, 1] + anchor_box[:, 3] / 2
    bx1 = (box[:, 0] - box[:, 2] / 2)[:, None]
    bx2 = (box[:, 0] + box[:, 2] / 2)[:, None]
    by1 = (box[:, 1] - box[:, 3] / 2)[:, None]
    by2 = (box[:, 1] + box[:, 3] / 2)[:, None]
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp(min=0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp(min=0)
    inter = iw * ih
    union = anchor_box[:, 2] * anchor_box[:, 3] + (box[:, 2] * box[:, 3])[
        :, None] - inter
    return inter / union


def assign(cfg, anchor_box, gt_boxes, gt_labels, num_gt):
    """Greedy assignment, box by box in order: the unclaimed anchor of
    largest IoU if that IoU is positive (the larger index on ties), else
    the unclaimed anchor nearest in squared (cx, cy, w, h) distance (the
    smaller index on ties).  Returns dense targets: mask [B, A], deltas
    [B, A, 4] ((dx, dy, log dw, log dh)), boxes [B, A, 4], labels
    [B, A, C]."""
    b = gt_boxes.shape[0]
    a = anchor_box.shape[0]
    dev = anchor_box.device
    rows = torch.arange(b, device=dev)
    idx_desc = torch.arange(a, device=dev, dtype=torch.float32)
    claimed = torch.zeros((b, a), dtype=torch.bool, device=dev)
    mask = torch.zeros((b, a), device=dev)
    deltas = torch.zeros((b, a, 4), device=dev)
    boxes = torch.zeros((b, a, 4), device=dev)
    labels = torch.zeros((b, a, cfg["classes"]), device=dev)
    for slot in range(int(num_gt.max())):
        valid = slot < num_gt
        box = gt_boxes[:, slot].float()
        iou = torch.where(claimed, -1.0, iou_center(anchor_box, box))
        top = iou.amax(dim=1, keepdim=True)
        # the larger index among the best
        by_iou = torch.where(iou == top, idx_desc, -1.0).argmax(dim=1)
        dist = ((box[:, None] - anchor_box[None]) ** 2).sum(-1)
        dist = torch.where(claimed, math.inf, dist)
        by_dist = dist.argmin(dim=1)
        idx = torch.where(top[:, 0] > 0, by_iou, by_dist)
        anc = anchor_box[idx]
        d = torch.stack([(box[:, 0] - anc[:, 0]) / anc[:, 2],
                         (box[:, 1] - anc[:, 1]) / anc[:, 3],
                         torch.log(box[:, 2] / anc[:, 2]),
                         torch.log(box[:, 3] / anc[:, 3])], dim=1)
        r, i = rows[valid], idx[valid]
        claimed[r, i] = True
        mask[r, i] = 1.0
        deltas[r, i] = d[valid]
        boxes[r, i] = box[valid]
        labels[r, i] = torch.nn.functional.one_hot(
            gt_labels[:, slot].long(), cfg["classes"]).float()[valid]
    return mask, deltas, boxes, labels


def _corners(boxes):
    cx, cy, w, h = boxes.unbind(-1)
    return cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2


def loss(cfg, interp, targets, params, trainable):
    """The recipe's loss: class cross-entropy over the assigned anchors,
    confidence regression to the (constant) IoU with the assigned box,
    box-delta regression, and L2 decay of the trainable kernels."""
    r = cfg["recipe"]
    mask, deltas, gt, labels = targets
    eps = r["epsilon"]
    n_obj = mask.sum()
    p = interp["class_probs"]
    class_loss = torch.sum((labels * -torch.log(p + eps)
                            + (1 - labels) * -torch.log(1 - p + eps))
                           * mask[..., None] * r["loss_coef_class"]) / n_obj
    b1, b2 = _corners(interp["boxes"]), _corners(gt)
    iw = (torch.minimum(b1[2], b2[2]) - torch.maximum(b1[0], b2[0])).clamp(0)
    ih = (torch.minimum(b1[3], b2[3]) - torch.maximum(b1[1], b2[1])).clamp(0)
    inter = iw * ih
    union = ((b1[2] - b1[0]) * (b1[3] - b1[1])
             + (b2[2] - b2[0]) * (b2[3] - b2[1]) - inter)
    ious = (inter / (union + eps) * mask).detach()
    a = mask.shape[1]
    weight = (mask * r["loss_coef_conf_pos"] / n_obj
              + (1 - mask) * r["loss_coef_conf_neg"] / (a - n_obj))
    conf_loss = torch.mean(torch.sum((ious - interp["conf"]) ** 2 * weight,
                                     dim=1))
    bbox_loss = torch.sum(r["loss_coef_bbox"] * (
        mask[..., None] * (interp["deltas"] - deltas)) ** 2) / n_obj
    decay = sum(r["weight_decay"] * 0.5 * torch.sum(params[n] ** 2)
                for n in trainable if n.endswith(".weight"))
    return class_loss + conf_loss + bbox_loss + decay


def draw_masks(cfg, generator, batch):
    """The dropout keep masks of one step, one a dropout layer in order
    (NHWC bool over the layer's whole input), drawn from ``generator`` as
    the benchmark hands it to the program: one uint8 per element, kept
    below ``keep_prob * 256``, for each channel part of the layer's input
    in turn (the network's ``dropout_parts``), joined on channels."""
    q = round(cfg["keep_prob"] * 256)
    masks = []
    for h, w, parts in network(cfg).dropout_parts(cfg):
        drawn = []
        for c in parts:
            bits = torch.randint(0, 256, (batch, h, w, c), dtype=torch.uint8,
                                 device=generator.device, generator=generator)
            drawn.append(bits < q)
        masks.append(torch.cat(drawn, dim=-1))
    return masks


def lr_at(cfg, step):
    r = cfg["recipe"]
    return r["learning_rate"] * r["lr_decay_factor"] ** (
        step // r["decay_steps"])


def run_steps(cfg, params, dataset, feed, generator, quant=None,
              rows=None, first_grads=None, momentum=None, start_step=0,
              step_masks=None):
    """Train from ``params`` (float32, copied; the network's buffers
    among them, which do not train) with ``momentum`` (zero when None),
    the first step being ``start_step`` of the schedule, through every
    step of ``feed`` (dicts of ``pos`` [K, B], ``aug`` [K, B, 5],
    ``gt_boxes`` [K, B, G, 4], ``gt_labels``, ``num_gt``), dropout drawn
    from ``generator``.  ``rows``: a slice of each batch to train on in
    place of all of it (a planted fault).  ``first_grads``: a dict that
    receives the first step's unclipped gradients.  ``step_masks``: each
    step's dropout masks in order, in place of drawing them.  Returns
    (losses, momentum, params) after the last step."""
    net = network(cfg)
    shapes, frozen = net.param_shapes(cfg), net.frozen_params(cfg)
    trainable = [n for n in params if n in shapes and n not in frozen]
    params = {n: t.detach().clone() for n, t in params.items()}
    momentum = {n: torch.zeros_like(params[n]) if momentum is None
                else momentum[n].clone() for n in trainable}
    anchor_box = detect.anchors(cfg, dataset.device)
    r = cfg["recipe"]
    losses, step = [], start_step
    for disp in feed:
        for i in range(disp["pos"].shape[0]):
            pick = (lambda t: t) if rows is None else (lambda t: t[rows])
            pos = disp["pos"][i].to(dataset.device).long()
            b = pos.shape[0]
            masks = draw_masks(cfg, generator, b) if step_masks is None \
                else step_masks[step - start_step]
            canvas = torch.index_select(dataset, 0, pick(pos))
            images = augment(cfg, canvas, pick(disp["aug"][i].to(
                dataset.device)))
            targets = assign(cfg, anchor_box, *(pick(disp[k][i].to(
                dataset.device)) for k in ("gt_boxes", "gt_labels",
                                           "num_gt")))
            for n in trainable:
                params[n].requires_grad_(True)
            preds = net.forward(cfg, params, images,
                                  [pick(m) for m in masks], quant)
            total = loss(cfg, detect.interpret(cfg, preds, anchor_box),
                         targets, params, trainable)
            grads = torch.autograd.grad(total, [params[n] for n in trainable])
            losses.append(float(total.detach()))
            if first_grads is not None and not first_grads:
                first_grads.update(zip(trainable, grads))
            lr = lr_at(cfg, step)
            with torch.no_grad():
                for n, g in zip(trainable, grads):
                    p = params[n]
                    p.requires_grad_(False)
                    norm = torch.sqrt(torch.sum(g * g))
                    g = g * (r["max_grad_norm"] / torch.clamp(
                        norm, min=r["max_grad_norm"]))
                    momentum[n].mul_(r["momentum"]).add_(g)
                    p.sub_(lr * momentum[n])
            step += 1
    return losses, momentum, params
