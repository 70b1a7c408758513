"""K3, the greedy anchor matcher in one launch (``ops/anchor_match.py``,
``csrc/anchor_match.cu``).

On the CPU: its launch plan at the backbones' anchor counts, its
refusals, the routing of a CPU call to the plain version (no launch),
the launch counter under capture, and a walk of the kernel's algorithm
in torch (slices, packed keys, rounds, claims, epilogue) against the
plain version.  On the card (``cuda``-marked): the kernel against the
plain version bit for bit at the train mix's boxes, planted ties and in
a replayed CUDA graph, and the order in which torch sums four squares,
which the kernel copies.  No JAX here: the card runs this file.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import squeezedet_torch as st
from squeezedet_torch.data import device_pipeline as dp
from squeezedet_torch.ops import _cuda
from squeezedet_torch.ops import anchor_match as am
from squeezedet_torch.ops.boxes import batch_iou
from torch_threads import one_thread  # noqa: F401

B, G = 20, 48
ROOT = Path(__file__).resolve().parent.parent


def _anchors(net):
    cfg = st.tiny_test_config() if net == "tiny" else st.config_for_net(net)
    return torch.tensor(np.asarray(cfg.anchor_box), dtype=torch.float32), cfg


def _inputs(net, seed, num_gt=(0, 1, 5, 48)):
    """B images of G slots with boxes drawn as the train cell's mix draws
    them (``portbench/traffic/train_recipe.json``; its feed's boxes are
    in the model's pixels, scaled here to ``net``'s frame), the first
    images' counts set to ``num_gt``; the padded slots hold boxes too."""
    from portbench.traffic import train_feed
    anchors, cfg = _anchors(net)
    mix = json.loads((ROOT / "portbench/traffic/train_recipe.json")
                     .read_text())
    model = json.loads((ROOT / "portbench/configs/squeezedet_kitti.json")
                       .read_text())
    feed = train_feed(seed, model, dict(mix, steps_per_dispatch=1,
                                        batch=B), 1)[0]
    boxes = feed["gt_boxes"][0].copy()
    boxes[..., 0::2] *= cfg.image_width / model["image_width"]
    boxes[..., 1::2] *= cfg.image_height / model["image_height"]
    rs = np.random.RandomState(seed)
    pad = np.arange(G)[None] >= feed["num_gt"][0][:, None]
    boxes[pad] = rs.uniform(10, 60, (int(pad.sum()), 4))
    counts = feed["num_gt"][0].copy()
    counts[:len(num_gt)] = num_gt
    for i, n in enumerate(num_gt):  # fill the slots a count opens
        more = np.arange(G) >= feed["num_gt"][0][i]
        boxes[i, more, 0] = rs.uniform(20, cfg.image_width - 20, more.sum())
        boxes[i, more, 1] = rs.uniform(20, cfg.image_height - 20, more.sum())
        boxes[i, more, 2:] = rs.uniform(12, 200, (more.sum(), 2))
    labels = feed["gt_labels"][0].copy()
    labels[pad] = rs.randint(0, cfg.classes, int(pad.sum()))
    return (anchors, torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(labels.astype(np.int32)),
            torch.from_numpy(counts.astype(np.int32)), cfg.classes)


# ---- the launch plan -------------------------------------------------------

@pytest.mark.parametrize("net,cluster,size", [
    ("squeezeDet", 8, 2106), ("squeezeDet+", 8, 1881), ("vgg16", 8, 2106),
    ("resnet50", 8, 2106), ("tiny", 1, 324)])
def test_plan_at_the_backbones_anchor_counts(net, cluster, size):
    """A cluster of up to 8 CTAs an image from A alone; its slices cover
    every anchor once, none is empty, and a thread takes at most a few
    anchors a round."""
    a = _anchors(net)[0].shape[0]
    p = am.plan(B, G, a)
    assert (p.cluster, p.slice) == (cluster, size)
    starts = [r * p.slice for r in range(p.cluster)]
    covered = sum((list(range(s, min(s + p.slice, a))) for s in starts), [])
    assert covered == list(range(a))
    assert all(s < a for s in starts)
    assert math.ceil(p.slice / am.THREADS) <= am.ANCHORS_PER_THREAD + 1
    assert am.plan(1, 1, a) == p == am.plan(128, 7, a)


@pytest.mark.parametrize("a", [1, 5, 2048, 2049, 16384, 16385, 100000,
                               am.MAX_CLUSTER * (am.SMEM_LIMIT // 2)])
def test_plan_covers_any_anchor_count(a):
    p = am.plan(3, 2, a)
    assert p.cluster * p.slice >= a > (p.cluster - 1) * p.slice
    assert 1 <= p.cluster <= am.MAX_CLUSTER
    assert 2 * p.slice <= am.SMEM_LIMIT
    if a <= am.MAX_CLUSTER * am.THREADS * am.ANCHORS_PER_THREAD:
        assert p.slice <= am.THREADS * am.ANCHORS_PER_THREAD


@pytest.mark.parametrize("b,g,a", [(0, 48, 100), (2, 0, 100), (2, 48, 0),
                                   (2, am.NO_SLOT, 100),
                                   (2, 48, am.MAX_CLUSTER * am.SMEM_LIMIT)])
def test_plan_refuses_what_the_kernel_cannot_take(b, g, a):
    with pytest.raises(ValueError):
        am.plan(b, g, a)


# ---- refusals, routing and the counter ------------------------------------

def _good():
    anchors, boxes, labels, num_gt, classes = _inputs("tiny", 0)
    return [anchors, boxes, labels, num_gt, classes]


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("arg,bad,error", [
    (0, lambda t: t.double(), TypeError),
    (1, lambda t: t.half(), TypeError),
    (2, lambda t: t.to(torch.int16), TypeError),
    (3, lambda t: t.float(), TypeError),
    (0, lambda t: t[:, :3], ValueError),
    (1, lambda t: t[:, :-1], ValueError),
    (2, lambda t: t[:-1], ValueError),
    (3, lambda t: t[:-1], ValueError),
    (1, lambda t: t.transpose(0, 1).contiguous().transpose(0, 1), ValueError),
    (2, lambda t: t.t().contiguous().t(), ValueError),
    (0, _misaligned, ValueError),
    (1, _misaligned, ValueError),
    (3, lambda t: t.to("meta"), ValueError),
    (4, lambda c: 0, ValueError),
], ids=["anchors-f64", "boxes-f16", "labels-i16", "counts-f32",
        "anchors-shape", "boxes-shape", "labels-shape", "counts-shape",
        "boxes-strided", "labels-strided", "anchors-unaligned",
        "boxes-unaligned", "counts-device", "no-class"])
def test_k3_refuses_what_it_does_not_take(arg, bad, error):
    args = _good()
    am.check_inputs(*args)
    args[arg] = bad(args[arg])
    with pytest.raises(error):
        am.check_inputs(*args)


def test_k3_runs_on_cuda_only_and_the_wrapper_on_cpu_or_cuda():
    args = _good()
    with pytest.raises(ValueError, match="CUDA"):
        am.anchor_match(*args)
    meta = [t.to("meta") for t in args[:4]] + [args[4]]
    with pytest.raises(ValueError, match="cpu or cuda"):
        dp.assign_anchors_device(*meta)


@pytest.mark.parametrize("net", ["tiny", "squeezeDet"])
def test_cpu_call_takes_the_plain_version_without_a_launch(net):
    args = _inputs(net, 3)
    before = am.LAUNCHES
    got = dp.assign_anchors_device(*args)
    want = dp.assign_anchors_reference(*args)
    assert am.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_captured_launches_count_k3_at_each_replay():
    """Under stream capture K3's launch only enters the graph: the capture
    takes it back off ``LAUNCHES`` and each replay adds it again."""
    before = am.LAUNCHES
    with _cuda.CapturedLaunches() as captured:
        am.LAUNCHES += 8  # a K=8 dispatch's matchers
    assert am.LAUNCHES == before
    for replays in (1, 2):
        captured.replayed()
        assert am.LAUNCHES == before + 8 * replays
    am.LAUNCHES = before


# ---- the kernel's algorithm, walked in torch ------------------------------

def _ordered(v, nan):
    """csrc/anchor_match.cu ordered(): f32 bits to an unsigned order as
    int64, -0 as +0, NaN at ``nan``."""
    u = torch.where(v == 0, torch.zeros_like(v), v).view(torch.int32)
    u = u.to(torch.int64) & 0xFFFFFFFF
    o = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(torch.isnan(v), torch.full_like(o, nan), o)


def _best(order, idx, largest):
    """The packed key's winner: the extreme order, then the extreme
    index (order, index)."""
    top = order.max() if largest else order.min()
    pick = idx[order == top]
    return top, (pick.max() if largest else pick.min())


def _walk(anchors, boxes, labels, num_gt, classes):
    """The kernel, CTA by CTA of each image's cluster: per round each
    slice's best keys, the cluster's winner from the slices' pairs, the
    claim (a later slot takes a claimed anchor over), then the
    epilogue's dense rows."""
    b, g = labels.shape
    a = anchors.shape[0]
    p = am.plan(b, g, a)
    idx = torch.arange(a)
    mask = torch.zeros(b, a)
    deltas, box_out = torch.zeros(b, a, 4), torch.zeros(b, a, 4)
    onehot = torch.zeros(b, a, classes)
    for i in range(b):
        owner = torch.full((a,), -1)
        for slot in range(min(max(int(num_gt[i]), 0), g)):
            box = boxes[i, slot]
            claimed = owner >= 0
            iou = torch.where(claimed, -1.0, batch_iou(anchors, box))
            dist = torch.where(claimed, math.inf, torch.sum(
                torch.square(box[None] - anchors), dim=1))
            pairs = []
            for r in range(p.cluster):
                s = slice(r * p.slice, min((r + 1) * p.slice, a))
                pairs.append((_best(_ordered(iou[s], 0xFFFFFFFF), idx[s],
                                    True),
                              _best(_ordered(dist[s], 0), idx[s], False)))
            best_iou = max(k for k, _ in pairs)
            best_dist = min(k for _, k in pairs)
            positive = 0x80000000 < best_iou[0] < 0xFFFFFFFF
            owner[(best_iou if positive else best_dist)[1]] = slot
        for j in (owner >= 0).nonzero()[:, 0].tolist():
            box, anc = boxes[i, owner[j]], anchors[j]
            mask[i, j] = 1.0
            deltas[i, j] = torch.stack([(box[0] - anc[0]) / anc[2],
                                        (box[1] - anc[1]) / anc[3],
                                        torch.log(box[2] / anc[2]),
                                        torch.log(box[3] / anc[3])])
            box_out[i, j] = box
            label = int(labels[i, owner[j]])
            if 0 <= label < classes:
                onehot[i, j, label] = 1.0
    return mask, deltas, box_out, onehot


NAMES = ("input_mask", "box_delta_input", "box_input", "labels")


def _bits_equal(got, want):
    for name, x, y in zip(NAMES, got, want):
        assert x.shape == y.shape, name
        assert torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32)), name


def _walk_equal(got, want):
    """The walk against the plain version on the CPU: the rest bit for
    bit, the deltas to 1e-6 (NaN in both at a zero-area anchor), since
    torch's CPU log rounds a row's vectorised part and its tail on other
    paths, an ulp apart, and the walk takes its logs one by one."""
    _bits_equal([got[0], want[1], got[2], got[3]], want)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6,
                               equal_nan=True)


def _planted(a_real):
    """Anchors and one image's slots with planted ties: a box repeated
    three times (IoU ties among equal anchors, then the next unclaimed),
    boxes holding several anchors of one shape whole (equal IoU), boxes
    overlapping no anchor (the distance rule) and two equidistant ones,
    a zero-area box on zero-area anchors (a NaN IoU), and a label out of
    the classes' range, and a pair of anchors whose order by distance
    turns on the order in which the four squares are summed."""
    anchors = a_real.clone()
    anchors[10:14] = torch.tensor([30.0, 30.0, 20.0, 20.0])  # four equal
    anchors[20:23] = torch.tensor([50.0, 50.0, 0.0, 0.0])    # zero area
    anchors[40] = torch.tensor([500.0, 500.0, 8.0, 8.0])     # far corner
    anchors[41] = torch.tensor([500.0, 520.0, 8.0, 8.0])
    # two anchors 64 px beside a box far outside the frame: squares (4096,
    # 2^-12, 0, 2^-12) and (4096, 0, 0, 0) sum to 4096 + 2^-11 and 4096
    # in K3's order (and torch's on the card), a tie in other orders
    anchors[50] = torch.tensor([-5064.0, -5000.0 - 2 ** -6, 8.0,
                                8.0 - 2 ** -6])
    anchors[51] = torch.tensor([-5064.0, -5000.0, 8.0, 8.0])
    slots = torch.tensor([
        [30.0, 30.0, 20.0, 20.0], [30.0, 30.0, 20.0, 20.0],
        [30.0, 30.0, 20.0, 20.0], [50.0, 50.0, 0.0, 0.0],
        [50.0, 50.0, 0.0, 0.0], [500.0, 510.0, 8.0, 8.0],
        [500.0, 510.0, 8.0, 8.0], [-900.0, -900.0, 4.0, 4.0],
        [-900.0, -900.0, 4.0, 4.0], [48.0, 40.0, 96.0, 80.0],
        [2000.0, 2000.0, 1.0, 1.0], [-5000.0, -5000.0, 8.0, 8.0]])
    return anchors, slots


def _planted_inputs(net):
    a_real, cfg = _anchors(net)
    anchors, slots = _planted(a_real)
    k = slots.shape[0]
    boxes = torch.zeros(2, k + 2, 4)
    boxes[:, :k] = slots
    boxes[1, :k] = slots.flip(0)
    boxes[:, k:] = torch.tensor([40.0, 40.0, 30.0, 30.0])
    labels = torch.arange(2 * (k + 2), dtype=torch.int64).view(2, k + 2) % 4
    num_gt = torch.tensor([k, k + 2], dtype=torch.int64)
    return anchors, boxes, labels, num_gt, cfg.classes


@pytest.mark.parametrize("net", ["tiny", "squeezeDet+"])
def test_walk_of_the_kernel_equals_plain(net):
    """The packed keys, the slices and the skipped rounds give the plain
    version's targets bit for bit, at the train mix's boxes with counts
    0, 1, 5 and 48 (three images of them at squeezeDet+'s size)."""
    args = list(_inputs(net, 7))
    if net != "tiny":
        args = [args[0]] + [t[:3] for t in args[1:4]] + [args[4]]
    _walk_equal(_walk(*args), dp.assign_anchors_reference(*args))


@pytest.mark.parametrize("net", ["tiny", "squeezeDet"])
def test_walk_of_the_kernel_equals_plain_on_planted_ties(net):
    args = _planted_inputs(net)
    got, want = _walk(*args), dp.assign_anchors_reference(*args)
    _walk_equal(got, want)
    # the repeated box took three of the four equal anchors, the largest
    # indices first; the zero-area box fell back to the distance rule
    assert got[0][0, 11:14].tolist() == [1.0, 1.0, 1.0]
    assert got[0][0, 10] == 0.0


def test_walk_with_every_anchor_claimed_keeps_the_last_slot():
    """More valid slots than anchors: a slot with nothing unclaimed picks
    a claimed anchor (IoU -1, distance +inf: the smallest index) and
    takes it over, as the plain version's scatter keeps its last write
    (deterministic mode sorts it stably)."""
    anchors = torch.tensor([[10.0, 10.0, 8.0, 8.0], [30.0, 10.0, 8.0, 8.0],
                            [50.0, 10.0, 8.0, 8.0]])
    boxes = torch.tensor([[[10.0, 10.0, 8.0, 8.0], [30.0, 12.0, 8.0, 8.0],
                           [50.0, 10.0, 6.0, 6.0], [20.0, 10.0, 8.0, 8.0],
                           [40.0, 10.0, 4.0, 4.0]]])
    labels = torch.tensor([[0, 1, 2, 1, 2]])
    num_gt = torch.tensor([5])
    got = _walk(anchors, boxes, labels, num_gt, 3)
    assert got[2][0, 0].tolist() == boxes[0, 4].tolist()
    with _deterministic():
        want = dp.assign_anchors_reference(anchors, boxes, labels, num_gt, 3)
    _walk_equal(got, want)


def _deterministic():
    from squeezedet_torch.trainer import deterministic
    return deterministic()


# ---- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")


def _cuda_args(args, labels_dtype=torch.int32):
    anchors, boxes, labels, num_gt, classes = args
    return (anchors.cuda(), boxes.cuda(), labels.to("cuda", labels_dtype),
            num_gt.cuda(), classes)


def _slot_labels(args):
    """The same call with each slot's index as its label over G classes:
    the one-hot rows then name the slot that claimed each anchor."""
    anchors, boxes, labels, num_gt, _ = args
    slots = torch.arange(labels.shape[1], device=labels.device)
    return anchors, boxes, slots.expand_as(labels).contiguous().to(
        labels.dtype), num_gt, labels.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize("labels_dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("net", ["squeezeDet", "squeezeDet+", "tiny"])
def test_cuda_k3_equals_plain_at_the_train_mix(net, labels_dtype):
    """B=20, G=48, counts 0, 1, 5 and 48 and the train mix's, two seeds:
    the four targets bit for bit, and each slot's anchor (the labels
    over G classes), in one launch a call."""
    _card()
    for seed in (11, 3000000419):
        args = _cuda_args(_inputs(net, seed), labels_dtype)
        for call in (args, _slot_labels(args)):
            before = am.LAUNCHES
            got = dp.assign_anchors_device(*call)
            assert am.LAUNCHES == before + 1
            _bits_equal(got, dp.assign_anchors_reference(*call))


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["squeezeDet", "tiny"])
def test_cuda_k3_equals_plain_on_planted_ties(net):
    _card()
    args = _cuda_args(_planted_inputs(net), torch.int64)
    _bits_equal(dp.assign_anchors_device(*args),
                dp.assign_anchors_reference(*args))
    with _deterministic():
        for call in (args, _slot_labels(args)):
            _bits_equal(dp.assign_anchors_device(*call),
                        dp.assign_anchors_reference(*call))


@pytest.mark.cuda
def test_cuda_k3_with_every_anchor_claimed():
    _card()
    anchors = torch.tensor([[10.0, 10.0, 8.0, 8.0], [30.0, 10.0, 8.0, 8.0],
                            [50.0, 10.0, 8.0, 8.0]])
    boxes = torch.tensor([[[10.0, 10.0, 8.0, 8.0], [30.0, 12.0, 8.0, 8.0],
                           [50.0, 10.0, 6.0, 6.0], [20.0, 10.0, 8.0, 8.0],
                           [40.0, 10.0, 4.0, 4.0]]])
    args = _cuda_args((anchors, boxes, torch.tensor([[0, 1, 2, 1, 2]]),
                       torch.tensor([5]), 3))
    with _deterministic():
        _bits_equal(dp.assign_anchors_device(*args),
                    dp.assign_anchors_reference(*args))


@pytest.mark.cuda
def test_cuda_k3_in_a_captured_graph_replayed_on_new_inputs():
    """One capture, two replays on new boxes and counts copied into the
    captured inputs: each replay equals the plain version on its inputs,
    and ``LAUNCHES`` counts one launch a replay through
    ``CapturedLaunches``."""
    _card()
    static = _cuda_args(_inputs("squeezeDet", 21))
    dp.assign_anchors_device(*static)  # build and load before capturing
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with _cuda.CapturedLaunches() as captured:
        with torch.cuda.graph(graph):
            out = dp.assign_anchors_device(*static)
    assert captured.per_replay[_cuda._counters().index(
        (am, "LAUNCHES"))] == 1
    for seed in (22, 23):
        new = _cuda_args(_inputs("squeezeDet", seed, num_gt=(48, 2, 0)))
        for buf, x in zip(static[1:4], new[1:4]):
            buf.copy_(x)
        before = am.LAUNCHES
        graph.replay()
        captured.replayed()
        assert am.LAUNCHES == before + 1
        _bits_equal(out, dp.assign_anchors_reference(*new))


@pytest.mark.cuda
def test_cuda_torch_sums_four_squares_as_k3_does():
    """The order K3 copies: on the card, torch.sum over a row of four
    squares (the matcher's distance at [20, 16848, 4]) is (s0 + s2) +
    (s1 + s3), and neither (s0 + s1) + (s2 + s3) nor a sum left to right,
    on random rows where the three differ."""
    _card()
    s = torch.square(torch.randn(B, 16848, 4, device="cuda"))
    got = torch.sum(s, dim=2)
    orders = {"k3": (s[..., 0] + s[..., 2]) + (s[..., 1] + s[..., 3]),
              "pairs": (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3]),
              "in order": ((s[..., 0] + s[..., 1]) + s[..., 2]) + s[..., 3]}
    assert {name: torch.equal(got, o) for name, o in orders.items()} == {
        "k3": True, "pairs": False, "in order": False}


@pytest.mark.cuda
def test_cuda_k3_refuses_mixed_devices_and_types():
    _card()
    args = list(_cuda_args(_good()))
    for arg, bad, error in ((3, lambda t: t.cpu(), ValueError),
                            (1, lambda t: t.double(), TypeError),
                            (1, lambda t: t.transpose(0, 1).contiguous()
                             .transpose(0, 1), ValueError)):
        call = list(args)
        call[arg] = bad(call[arg])
        with pytest.raises(error):
            dp.assign_anchors_device(*call)


@pytest.mark.cuda
def test_cuda_train_step_launches_k3_once_a_step():
    """The device train step's matcher is K3: one launch a step."""
    _card()
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.trainer import TrainState, make_train_step_device
    det = st.get_model("squeezeDet", st.tiny_test_config(), device="cuda")
    step = make_train_step_device(TrainState(det, build_optimizer(
        det.cfg, det)), uint8_ingest=True)
    u8 = torch.zeros((2, 96, 96, 3), dtype=torch.uint8, device="cuda")
    boxes = torch.tensor([[[40.0, 40.0, 20.0, 30.0]]] * 2, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = am.LAUNCHES
    for _ in range(2):
        step(u8, boxes, torch.zeros(2, 1, dtype=torch.long, device="cuda"),
             torch.tensor([1, 1], device="cuda"), generator=gen)
    assert am.LAUNCHES == before + 2


@pytest.mark.cuda
def test_cuda_train_step_with_k3_equals_the_plain_matchers(monkeypatch):
    """squeezeDet's device train step at 1248x384 (B=4: counts 0, 1, 5
    and 48 of the train mix's boxes), in deterministic mode, from the
    same weights, generator and batch: with K3 and with the plain
    matcher, the loss terms, every parameter and every momentum leaf bit
    for bit (K3's targets are contiguous where the plain version's are
    views of a padded buffer, and no reduction sees the difference)."""
    _card()
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.trainer import (TrainState, deterministic,
                                          make_train_step_device)
    anchors, boxes, labels, num_gt, _ = _cuda_args(_inputs("squeezeDet", 5))
    cfg = st.config_for_net("squeezeDet")
    u8 = torch.randint(0, 256, (4, cfg.image_height, cfg.image_width, 3),
                       dtype=torch.uint8, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(1))
    weights = st.get_model("squeezeDet", cfg,
                           device="cuda").backbone.state_dict()

    def step(matcher):
        monkeypatch.setattr(dp, "assign_anchors_device", matcher)
        det = st.get_model("squeezeDet", cfg, device="cuda")
        det.backbone.load_state_dict(weights)
        state = TrainState(det, build_optimizer(cfg, det))
        launches = am.LAUNCHES
        with deterministic():
            lb = make_train_step_device(state, uint8_ingest=True)(
                u8, boxes[:4], labels[:4], num_gt[:4],
                generator=torch.Generator("cuda").manual_seed(2))
        return (lb, det.backbone.state_dict(), state.opt.trace,
                am.LAUNCHES - launches)

    k3 = step(dp.assign_anchors_device)
    plain = step(dp.assign_anchors_reference)
    assert (k3[3], plain[3]) == (1, 0)
    assert all(torch.equal(a, b) for a, b in zip(k3[0], plain[0]))
    for got, want in zip(k3[1:3], plain[1:3]):
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], want[name]), name
