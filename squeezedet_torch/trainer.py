"""The single-device train step and the train loop (counterpart of
``squeezedet_tpu/trainer.py``).

One step is forward (dropout on) + interpretation + loss + backward +
the optimizer chain, on the detector's device.  PyTorch updates in
place: the step changes the detector's parameters and the optimizer's
momentum buffers and step count, which :class:`TrainState` bundles, and
returns the (detached) loss terms.  The weight gradients of eligible
convs come from K2 when ``layers.set_filter_grad`` routes them there.

:func:`train` is the loop of the train CLI: prefetched batches, the log,
summary and checkpoint cadences with the NaN gate, checkpoints with the
input-stream snapshot for exact resume, ``model_metrics.txt``, and the
summary-step histograms and detection images.

Data parallelism (``dp``, a ``parallel.distributed.DataParallel``):
one process per device, each training on its rows of the global batch.
The JAX step computes the loss of the global batch, whose terms do not
split into per-rank means, so each rank computes its *part* of the
global loss (the all-reduced object count and the global batch as
normalisers, weight decay on rank 0 only, dropout drawn for the global
batch and sliced: ``layers.BatchRows``), the gradients are summed over
the ranks, and every rank then clips and updates identically.  The D-rank
step equals the one-device step at the same global batch.

Spatial partitioning (``spatial``, a ``models.halo.Tiling``, e.g.
``make_mesh_2d(D, S, device).tiling(rank)``): the step's forward runs
over the tiling's height x width tiles with halo exchanges, the head
gathered on the detector's device (``Detector.run_backbone``).  The
tiles' weight gradients land in the detector's parameters (a copy on
another device sums its gradient back), so they are summed before a
data-parallel rank's all-reduce, and the update is the unsharded
step's.  The data x spatial step is ``dp`` and ``spatial`` together:
each rank holds its tiles in one process.  The train CLI builds no
spatial mesh (the JAX CLI builds 1-D meshes only); the step is a
library entry point, as in the JAX package.

K steps per dispatch (``--steps_per_dispatch``,
:func:`make_train_step_device_scan`): on the CPU the K steps run one
after another; on the card the host stacks K batches, copies them into
the buffers of one captured CUDA graph that holds all K steps (K1 and K2
launches, the dropout draws and, on an NCCL rank, the all-reduces
included) and replays it once.  A gloo rank's all-reduce stages its
tensor through the host, which no graph can hold, so there the K steps
are captured as a chain of graphs split at the all-reduces, replayed in
order with each all-reduce between its two graphs.  ``rng_impl`` stays
out (ROADMAP Queue 1 item 14).

Determinism: :func:`train` runs under :func:`deterministic` (cuDNN's
deterministic algorithms, no autotuning, and
``torch.use_deterministic_algorithms``), so a run resumed from a
checkpoint equals a straight run bit for bit on the card as on the CPU,
as the JAX package's resume does; an op with no deterministic CUDA
implementation raises instead of drifting.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass
from datetime import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from squeezedet_torch.data.device_pipeline import ingest_and_assign
from squeezedet_torch.models import Detector
from squeezedet_torch.models import layers as L
from squeezedet_torch.models.skeleton import LossBreakdown, Targets
from squeezedet_torch.optim import Momentum, build_optimizer, learning_rate_at

# cuBLAS' fixed workspace for deterministic results, set before the first
# cuBLAS handle (``train.main`` sets it when the environment does not)
CUBLAS_WORKSPACE_CONFIG = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """Run the enclosed work with deterministic kernels: cuDNN's
    deterministic algorithms without autotuning, and
    ``torch.use_deterministic_algorithms(True)``, under which an op with
    no deterministic implementation raises.  The previous settings come
    back on exit.  On the card cuBLAS also needs ``CUBLAS_WORKSPACE_CONFIG``
    in the environment before its first handle, or its first call raises.
    Usable as a decorator."""
    cudnn = torch.backends.cudnn
    prev = (cudnn.deterministic, cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev[:2]
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])


# the largest uint8 canvas stack --device_dataset keeps on the device
DEVICE_DATASET_MAX_GIB = 12.0


@dataclass
class TrainState:
    """What a train step updates in place: ``det``'s parameters and
    ``opt``'s momentum buffers and step count."""

    det: Detector
    opt: Momentum

    @property
    def step(self) -> int:
        return self.opt.step

    def as_tree(self) -> dict:
        """The checkpointed tree (live tensors; the checkpoint manager
        copies them to the CPU)."""
        return {"params": self.det.backbone.state_dict(),
                "opt_state": self.opt.state_dict(), "step": self.step}

    def load_tree(self, tree: dict) -> None:
        self.det.backbone.load_state_dict(tree["params"])
        self.opt.load_state_dict(tree["opt_state"])
        if int(tree["step"]) != self.opt.step:
            raise ValueError("checkpoint step {} != its optimizer step "
                             "{}".format(int(tree["step"]), self.opt.step))


def _rank_loss(det: Detector, images: torch.Tensor, targets: Targets,
               generator: Optional[torch.Generator], dp=None,
               spatial=None) -> LossBreakdown:
    """The train loss of the batch, or with ``dp`` (a ``DataParallel``)
    this rank's part of the loss of the ``cfg.batch_size`` global batch
    whose rows it holds: the all-reduced object count and the global
    batch as normalisers, weight decay on rank 0 only, and dropout drawn
    for the global batch and sliced to the rank's rows.  ``spatial``: the
    forward's tiling."""
    if dp is None:
        return det.loss(images, targets, generator, train=True,
                        spatial=spatial)
    batch = det.cfg.batch_size
    # the mask is a target (no gradient): one all-reduce of its count
    num_objects = dp.all_reduce_(targets.input_mask.sum())
    rows = None if generator is None else L.BatchRows(
        generator, batch, dp.rank * (batch // dp.world))
    return det.loss(images, targets, rows, train=True,
                    num_objects=num_objects, batch_size=batch,
                    weight_decay=dp.primary, spatial=spatial)


def _sum_over_ranks(dp, grads: Sequence[torch.Tensor]) -> list:
    """The ranks' gradients summed, leaf by leaf, in one all-reduce of
    their concatenation."""
    flat = dp.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    return [part.view_as(g) for g, part in
            zip(grads, flat.split([g.numel() for g in grads]))]


def _apply_update(state: TrainState, images: torch.Tensor, targets: Targets,
                  generator: Optional[torch.Generator],
                  dp=None, neg_lr=None, spatial=None) -> LossBreakdown:
    """Forward + backward + optimizer update, shared by every step
    builder.  Frozen parameters (``requires_grad=False``) get no
    gradient, and nothing is differentiated through them.  ``neg_lr``:
    the step's negated rate as a device tensor (``Momentum.update``).

    With ``dp`` (a ``DataParallel``) this rank's rows are part of the
    global batch: the gradients of the rank's part of the global loss
    are summed over the ranks before the update, and the returned terms
    are the global batch's (summed over the ranks).  ``spatial``: the
    forward's tiling; the tiles' gradients are already summed into the
    parameters when the ranks' all-reduce starts."""
    state.opt.zero_grad()
    lb = _rank_loss(state.det, images, targets, generator, dp, spatial)
    lb.total.backward()
    if dp is not None:
        grads = [p.grad for p in state.opt.params.values()]
        for g, total in zip(grads, _sum_over_ranks(dp, grads)):
            g.copy_(total)
    state.opt.update(neg_lr)  # clips the summed gradient, alike on every rank
    if dp is None:
        return LossBreakdown(*(t.detach() for t in lb))
    return LossBreakdown(*dp.all_reduce_(
        torch.stack([t.detach() for t in lb])).unbind())


def _warn_filter_grad(dp, spatial) -> None:
    """The JAX trainer's warning when K2 routing is on over a spatial
    mesh, of any size: every conv over a tile window is VALID, which K2
    does not take, so no weight gradient goes through K2."""
    if spatial is not None and L.filter_grad_mode():
        devices = spatial.size * (1 if dp is None else dp.world)
        print("WARNING: --pallas_grads is single-device only; ignoring it "
              "on a {}-device mesh.".format(devices))


def make_train_step(state: TrainState, dp=None, spatial=None):
    """Step on dense targets: ``(images, targets, generator) ->
    LossBreakdown``, with mean-subtracted images.  ``dp``, ``spatial``:
    as :func:`make_train_step_device`."""
    _warn_filter_grad(dp, spatial)

    def step_fn(images, targets: Targets, generator=None):
        return _apply_update(state, images, targets, generator, dp,
                             spatial=spatial)
    return step_fn


def make_train_step_device(state: TrainState, *, uint8_ingest: bool = False,
                           device_augment: bool = False,
                           device_dataset: bool = False, dp=None,
                           spatial=None):
    """Step with the anchor matcher on the device.

    Signature: ``(images, gt_boxes, gt_labels, num_gt, generator) ->
    LossBreakdown``, GT padded to G slots per image; a keyword ``neg_lr``
    (a 0-d device tensor) replaces the schedule's rate.  ``uint8_ingest``:
    images arrive as raw uint8 and are mean-subtracted on the device.
    ``device_augment``: images are a raw uint8 canvas batch and the
    signature gains ``aug`` [B, 5] after ``images``
    (``augment_resize_normalize``).  ``device_dataset``: the signature
    is ``(dataset, pos, aug, gt_boxes, gt_labels, num_gt, generator)``;
    the step gathers its canvas rows ``pos`` from the uint8 stack
    ``dataset`` [N, H0, W0, 3] on the device, then augments as above.

    ``dp``, a ``DataParallel``: the step takes this rank's rows of the
    global batch (``dp.rows``) and returns the global loss terms; under
    ``device_dataset`` over several ranks ``dataset`` is this rank's
    shard block and ``pos`` the global rows
    (``parallel.mesh.local_shard_gather``).

    ``spatial``, a ``models.halo.Tiling``: the forward runs over its
    tiles (with ``dp``, the rank's tiles: the data x spatial step).  The
    ingest, augment and matcher run on the detector's device, before
    the images are tiled.  K2 routing is ignored, with the JAX
    trainer's warning.
    """
    from squeezedet_torch.parallel.mesh import local_shard_gather
    det = state.det
    sharded = dp is not None and dp.world > 1
    _warn_filter_grad(dp, spatial)

    def update(images, targets, generator, neg_lr):
        return _apply_update(state, images, targets, generator, dp, neg_lr,
                             spatial)

    if device_dataset:
        def step_fn(dataset, pos, aug, gt_boxes, gt_labels, num_gt,
                    generator=None, neg_lr=None):
            canvas = local_shard_gather(dp.rank, dataset, pos) \
                if sharded else torch.index_select(dataset, 0, pos.long())
            images, targets = ingest_and_assign(
                det, canvas, gt_boxes, gt_labels, num_gt, uint8_ingest,
                aug=aug)
            return update(images, targets, generator, neg_lr)
    elif device_augment:
        def step_fn(images, aug, gt_boxes, gt_labels, num_gt,
                    generator=None, neg_lr=None):
            images, targets = ingest_and_assign(
                det, images, gt_boxes, gt_labels, num_gt, uint8_ingest,
                aug=aug)
            return update(images, targets, generator, neg_lr)
    else:
        def step_fn(images, gt_boxes, gt_labels, num_gt, generator=None,
                    neg_lr=None):
            images, targets = ingest_and_assign(
                det, images, gt_boxes, gt_labels, num_gt, uint8_ingest)
            return update(images, targets, generator, neg_lr)
    return step_fn


class _GraphChain:
    """The captured form of a dispatch: CUDA graphs captured one after
    another into one memory pool, split where the step calls a host
    collective (a gloo all-reduce, which stages its tensor through the
    host and so cannot be captured).  A dispatch with no host collective
    is one graph.  :meth:`replay` runs the graphs in capture order on the
    current stream, each all-reduce between the graph that wrote its
    tensor and the graph that reads it; gloo orders its copies after the
    stream's earlier work and the stream's later work after its copies.
    The tensors keep their capture-time addresses: the chain holds them,
    and graphs that share a pool may reuse each other's freed memory
    because they replay one at a time in the order they were captured.
    The dropout generator is registered with every graph, so each replay
    advances its Philox offset by that graph's draws, in the eager order.
    """

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: list = []
        self.reduced: list = []

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        graph.capture_begin(pool=self.pool)
        self.graphs.append(graph)

    @contextlib.contextmanager
    def capture(self, dev: torch.device):
        """Capture the enclosed work on a side stream, as
        ``torch.cuda.graph`` does, into the chain's first graph (and the
        next ones :meth:`split` opens)."""
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            self._begin()
            try:
                yield self
            finally:
                self.graphs[-1].capture_end()

    def split(self, tensor: torch.Tensor) -> None:
        """End the graph being captured at an all-reduce of ``tensor``,
        which the replay runs on the host, and begin the next graph."""
        self.graphs[-1].capture_end()
        self.reduced.append(tensor)
        self._begin()

    def replay(self, dp) -> None:
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(self.reduced):
                dp.all_reduce_(self.reduced[i])


class _HostCollectives:
    """A gloo rank's ``DataParallel`` as its scanned step sees it: outside
    a capture its all-reduce is the rank's; while a :class:`_GraphChain`
    captures, each all-reduce splits the chain there instead (the object
    count in ``_rank_loss``, the flat gradient in ``_sum_over_ranks``
    and the loss terms in ``_apply_update``, so no split falls inside
    autograd's graph)."""

    def __init__(self, dp):
        self.dp = dp
        self.chain: Optional[_GraphChain] = None

    def __getattr__(self, name):
        return getattr(self.dp, name)

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        if self.chain is None:
            return self.dp.all_reduce_(tensor)
        self.chain.split(tensor)
        return tensor


class _ScanStep:
    """K train steps per dispatch; see :func:`make_train_step_device_scan`.

    On the card the first dispatch runs its K steps eagerly, on a side
    stream: they are real steps, and they build and load K1 and K2, warm
    cuDNN's plans and the communicator, and make the momentum and the
    mean tensors, none of which may happen under capture.  The second
    dispatch captures the K steps over static buffers (the stacked inputs
    and the K negated rates) into a :class:`_GraphChain`: one graph, or
    on a gloo rank (``host`` a :class:`_HostCollectives`) one graph
    between each two all-reduces; every dispatch from then on copies its
    inputs into those buffers and replays the chain once.  Parameters and
    momentum are updated in place at fixed addresses; the gradients live
    in the graphs' memory pool.  A capture or a replay that fails raises.
    """

    def __init__(self, state: TrainState, k: int, step_fn, device_dataset,
                 host: Optional[_HostCollectives] = None):
        self.state, self.k, self.step_fn = state, k, step_fn
        self.device_dataset = device_dataset
        self.host = host
        self.chain = None
        self.warm = False

    def _eager(self, head, stacked, generator, neg_rates):
        lbs = [self.step_fn(*head, *(x[i] for x in stacked),
                            generator=generator, neg_lr=neg_rates[i])
               for i in range(self.k)]
        return LossBreakdown(*(torch.stack(t) for t in zip(*lbs)))

    def __call__(self, *args, generator=None) -> LossBreakdown:
        opt = self.state.opt
        dev = self.state.det.anchors.device
        head = args[:1] if self.device_dataset else ()
        stacked = args[len(head):]
        if any(x.shape[0] != self.k for x in stacked):
            raise ValueError("each input must stack {} steps, got shapes "
                             "{}".format(self.k, [tuple(x.shape)
                                                  for x in stacked]))
        neg_rates = torch.from_numpy(-opt.dispatch_rates(self.k))
        if dev.type != "cuda":
            return self._eager(head, [x.to(dev) for x in stacked], generator,
                               neg_rates.to(dev))
        if not self.warm:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                lbs = self._eager(head, [x.to(dev) for x in stacked],
                                  generator, neg_rates.to(dev))
            torch.cuda.current_stream(dev).wait_stream(side)
            self.warm = True
            return lbs
        if self.chain is None:
            self._capture(head, stacked, generator, dev)
        elif generator is not self.generator or \
                any(a is not b for a, b in zip(head, self.head)):
            raise ValueError("a captured dispatch replays with the "
                             "generator and dataset it was captured with")
        for buf, x in zip(self.inputs, stacked):
            buf.copy_(x, non_blocking=True)
        self.neg_rates.copy_(neg_rates)
        self.chain.replay(self.host)
        self.launches.replayed()
        opt.step += self.k
        return LossBreakdown(*(t.clone() for t in self.outputs))

    def _capture(self, head, stacked, generator, dev) -> None:
        from squeezedet_torch.ops._cuda import CapturedLaunches
        opt = self.state.opt
        self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in stacked]
        self.neg_rates = torch.empty(self.k, dtype=torch.float32, device=dev)
        self.generator, self.head = generator, head
        chain = _GraphChain(generator)
        step = opt.step
        if self.host is not None:
            self.host.chain = chain
        try:
            with CapturedLaunches() as self.launches, chain.capture(dev):
                self.outputs = self._eager(head, self.inputs, generator,
                                           self.neg_rates)
        finally:
            if self.host is not None:
                self.host.chain = None
        opt.step = step  # the capture ran no step
        self.chain = chain


def make_train_step_device_scan(state: TrainState, k: int, *,
                                uint8_ingest: bool = False,
                                device_augment: bool = False,
                                device_dataset: bool = False, dp=None,
                                spatial=None):
    """K device-matcher train steps per dispatch (``--steps_per_dispatch``),
    the counterpart of the JAX package's ``lax.scan`` over K steps.

    Signature: the :func:`make_train_step_device` step's inputs, each
    stacked over K steps (``images`` or canvases [K, B, ...], ``aug``
    [K, B, 5] or ``pos`` [K, B], ``gt_boxes`` [K, B, G, 4], ``gt_labels``
    [K, B, G], ``num_gt`` [K, B]; under ``device_dataset`` the unstacked
    ``dataset`` first), then ``generator`` -> ``LossBreakdown`` with [K]
    leaves in step order.  Step i runs at the schedule's rate of
    ``state.step + i``, staged on the device with the inputs.

    On the CPU the K steps run eagerly, one after another: the plain
    version of the graph.  On the card one CUDA graph of the K steps is
    captured at the second dispatch and replayed once per dispatch
    (:class:`_ScanStep`); the kernels' ``LAUNCHES`` count each replay's.
    ``dp``: as :func:`make_train_step_device`, each input stacking the
    rank's rows; an NCCL rank's all-reduces are captured with the steps,
    and a gloo rank's, which run through the host, split the capture into
    a chain of graphs, three all-reduces a step (:class:`_GraphChain`).
    ``spatial``: as :func:`make_train_step_device`; on the card its tiles
    must share the detector's card, where the halo copies are captured
    with the steps (copies between cards in a captured graph: ROADMAP
    Queue 1 item 22).
    """
    if k < 1:
        raise ValueError("steps per dispatch must be >= 1, got {}".format(k))
    home = state.det.anchors.device
    if spatial is not None and home.type == "cuda" and \
            any(torch.device(d) != home for d in spatial.devices):
        raise ValueError(_CROSS_CARD_SCAN.format(
            ", ".join(sorted({str(d) for d in spatial.devices}))))
    host = _HostCollectives(dp) if dp is not None and \
        dp.backend != "nccl" and home.type == "cuda" else None
    step_fn = make_train_step_device(state, uint8_ingest=uint8_ingest,
                                     device_augment=device_augment,
                                     device_dataset=device_dataset,
                                     dp=host or dp, spatial=spatial)
    return _ScanStep(state, k, step_fn, device_dataset, host)


_CROSS_CARD_SCAN = ("--steps_per_dispatch > 1 captures the K steps in one "
                    "card's CUDA graph, and these tiles lie on other cards "
                    "({}): copies between cards inside a captured graph are "
                    "ROADMAP Queue 1 item 22; put the tiles on the "
                    "detector's card, or run one step per dispatch")


def _sampler_ckpt_path(train_dir: str, step: int, dp=None) -> str:
    """Input-stream snapshot path of a checkpoint step: one file per rank
    (``.p<rank>``) when several ranks train, as the JAX package keeps one
    per controller."""
    suffix = "" if dp is None or dp.world == 1 else \
        ".p{}".format(dp.rank)
    return os.path.join(train_dir, "sampler.ckpt-{}{}.npz".format(step,
                                                                  suffix))


def _write_loss_summaries(summary_writer, cfg, step: int, lb) -> None:
    """Per-step scalars: the loss terms, mean IoU and learning rate."""
    summary_writer.scalar("loss/total_loss", float(lb.total), step)
    summary_writer.scalar("loss/confidence_loss", float(lb.conf_loss),
                          step)
    summary_writer.scalar("loss/bounding_box_loss", float(lb.bbox_loss),
                          step)
    summary_writer.scalar("loss/class_loss", float(lb.class_loss), step)
    summary_writer.scalar("mean_iou", float(lb.mean_iou), step)
    summary_writer.scalar("learning_rate", learning_rate_at(cfg, step),
                          step)


def _dispatch_cadences(covered, lb, *, start_time, cfg, log_every,
                       summary_step, summary_writer, checkpoint_step,
                       max_steps, force_materialize=False,
                       batch_size=None, quiet=False):
    """The log, loss-summary and checkpoint cadences over the steps
    ``covered`` by one dispatch, and the NaN gate.

    Loss values leave the device only when a cadence fires (or
    ``force_materialize``): quiet steps stay asynchronous, so host work
    overlaps the device.  Returns ``(summary_due, checkpoint_due,
    totals)``, ``totals`` the per-step losses (None when nothing fired).
    ``batch_size`` is the images a step trains on (``cfg.batch_size``
    when omitted); ``quiet`` prints no log line.
    """
    last = covered[-1]
    do_log = any(s % log_every == 0 for s in covered)
    do_summary = summary_writer is not None and summary_step > 0 and any(
        s % summary_step == 0 for s in covered)
    checkpoint_due = any(s % checkpoint_step == 0 for s in covered) \
        or last + 1 == max_steps
    totals = None
    if do_log or do_summary or checkpoint_due or force_materialize:
        terms = {name: getattr(lb, name).detach().reshape(-1).cpu().numpy()
                 for name in ("total", "conf_loss", "bbox_loss",
                              "class_loss")}
        totals = terms["total"]
        if np.isnan(totals).any():
            raise FloatingPointError(
                'Model diverged. Losses in steps [{}..{}]: total {}, conf '
                '{}, bbox {}, class {}'.format(
                    covered[0], last, totals, terms["conf_loss"],
                    terms["bbox_loss"], terms["class_loss"]))
    if do_log and not quiet:
        duration = time.time() - start_time
        k = len(covered)
        per = ('%.3f sec/batch' % duration) if k == 1 else \
            ('%.3f sec/%d-step dispatch' % (duration, k))
        print('%s: step %d, loss = %.2f (%.1f images/sec; %s)' % (
            datetime.now(), last, float(totals[-1]),
            (batch_size or cfg.batch_size) * k / duration, per))
        sys.stdout.flush()
    if do_summary:
        lb_last = LossBreakdown(*(float(t.detach().reshape(-1)[-1])
                                  for t in lb))
        _write_loss_summaries(summary_writer, cfg, last, lb_last)
    return do_summary, checkpoint_due, totals


def _save_checkpoint(ckpt, train_dir: str, imdb, loader, generator,
                     state: TrainState, *, next_step: int, max_steps: int,
                     totals, dp=None) -> None:
    """Divergence-gated checkpoint + input-stream snapshot, saved under
    the last covered step (``next_step - 1``).  The manager copies the
    state to the CPU before the background write starts (the next step
    updates it in place); only the final save blocks.

    The snapshot is the consumed batch's sampler state (carried through
    the prefetch queue with each item), so resume redraws exactly the
    batches after the last one trained on, and the dropout generator's
    state, so its draws continue too.  Under ``dp`` rank 0 writes the
    checkpoint and every rank its own snapshot (the dropout generator's
    state is the same on every rank).
    """
    totals = np.asarray(totals)
    if not np.isfinite(totals).all():
        raise FloatingPointError(
            'Model diverged (losses = {}); refusing to checkpoint at step '
            '{}'.format(totals, next_step - 1))
    if dp is None or dp.primary:
        ckpt.save(next_step - 1, state.as_tree(),
                  wait=next_step == max_steps)
    stream_state = loader.consumed_state() or imdb.sampler_state()
    np.savez(_sampler_ckpt_path(train_dir, next_step - 1, dp),
             torch_rng_state=generator.get_state().numpy(), **stream_state)


def viz_prediction_images(det: Detector, images_np, targets,
                          max_images: int = 8):
    """Draw GT (green) and filtered predictions (red) on the batch, from
    mean-subtracted BGR f32 images; returns [N, H, W, 3] uint8 RGB."""
    from squeezedet_torch.utils.util import draw_box

    cfg = det.cfg
    dev = det.anchors.device
    interp = det.predict(torch.from_numpy(np.asarray(images_np)).to(dev))
    det_boxes, det_probs, det_class = (
        t.cpu().numpy() for t in (interp.det_boxes, interp.det_probs,
                                  interp.det_class))
    mask, gt_boxes, labels = (t.cpu().numpy() for t in (
        targets.input_mask, targets.box_input, targets.labels))

    out = []
    for i in range(min(max_images, images_np.shape[0])):
        im = (images_np[i] + cfg.bgr_means_array()).clip(0, 255) \
            .astype(np.uint8).copy()
        owned = np.nonzero(mask[i] > 0)[0]
        draw_box(im, [gt_boxes[i, a] for a in owned],
                 [cfg.class_names[int(np.argmax(labels[i, a]))]
                  for a in owned], (0, 255, 0))
        boxes, probs, classes = det.filter_prediction(
            det_boxes[i], det_probs[i], det_class[i])
        keep = [k for k in range(len(probs))
                if probs[k] > cfg.plot_prob_thresh]
        draw_box(im, [boxes[k] for k in keep],
                 ['%s: (%.2f)' % (cfg.class_names[classes[k]], probs[k])
                  for k in keep], (0, 0, 255))
        out.append(im[:, :, ::-1])  # BGR -> RGB
    return np.stack(out) if out else np.zeros((0, 1, 1, 3), np.uint8)


def _summary_tag(name: str) -> str:
    """Backbone state_dict name -> the JAX package's summary tag, e.g.
    'fire2.squeeze1x1.weight' -> 'fire2/squeeze1x1/kernel'."""
    *layers, leaf = name.split(".")
    return "/".join(layers + ["kernel" if leaf == "weight" else leaf])


def write_histograms(summary_writer, params, grads, step: int) -> None:
    """Histograms of each trainable parameter and its gradient
    (``params`` and ``grads``: name -> tensor, trainable leaves only)."""
    for prefix, tree in (("params", params), ("gradients", grads)):
        for name, leaf in tree.items():
            summary_writer.histogram(
                "{}/{}".format(prefix, _summary_tag(name)),
                leaf.detach().float().cpu().numpy(), step)


def write_activation_summaries(summary_writer, det: Detector, images_np,
                               step: int) -> None:
    """Five-stat activation summaries of one eval-mode forward of the
    mean-subtracted ``images_np``: per tape entry a histogram of its
    strided sample (``activations/<layer>``) and its sparsity, mean, max
    and min (``activation_summary/<layer>/<stat>``), reduced on the
    device (``Detector.activation_stats``)."""
    dev = det.anchors.device
    stats = det.activation_stats(torch.from_numpy(np.asarray(images_np))
                                 .to(dev))
    for name, s in stats.items():
        summary_writer.histogram("activations/" + name, s["sample"], step)
        for stat in ("sparsity", "mean", "max", "min"):
            summary_writer.scalar(
                "activation_summary/{}/{}".format(name, stat),
                float(s[stat]), step)


def trainable_grads(det: Detector, images, targets: Targets, generator,
                    dp=None):
    """Gradients of the train loss at ``det``'s current parameters, for
    the trainable leaves only (frozen conv1 is not differentiated, so
    K1's CUDA path, which refuses a gradient, stays usable); ``.grad``
    fields are left alone.  With ``dp`` every rank calls it on its rows
    of the global batch, and each gets the global batch's gradient."""
    params = {n: p for n, p in det.backbone.named_parameters()
              if p.requires_grad}
    total = _rank_loss(det, images, targets, generator, dp).total
    grads = torch.autograd.grad(total, list(params.values()))
    if dp is not None:
        grads = _sum_over_ranks(dp, grads)
    return params, dict(zip(params, grads))


def _report_ranks(dp, before, forwards: int, starts, sizes) -> None:
    """Rank 0 prints, for every rank, this run's K1 and K2 launches beside
    its forwards and steps (the launch counters are per process), the
    median time a step, from the intervals between dispatch starts after
    the first two (µs; ``sizes``: the steps of each dispatch) and the
    device's peak memory (MiB)."""
    from squeezedet_torch.ops import filter_grad, fused_frontend
    gaps = (np.diff(starts) / np.asarray(sizes[:-1]))[2:]
    peak = torch.cuda.max_memory_allocated(dp.device) \
        if dp.device.type == "cuda" else 0
    rows = dp.all_gather_ints([
        fused_frontend.LAUNCHES - before[0], filter_grad.LAUNCHES - before[1],
        forwards, int(sum(sizes)),
        int(np.median(gaps) * 1e6) if gaps.size else 0, peak >> 20])
    if dp.primary:
        keys = ("k1", "k2", "forwards", "steps", "step_us", "peak_mib")
        print("data-parallel ranks " + json.dumps([
            dict(zip(keys, (int(v) for v in row))) for row in rows]),
            flush=True)


@deterministic()
def train(det: Detector, imdb, *, train_dir: str, max_steps: int,
          summary_step: int = 10, checkpoint_step: int = 1000,
          seed: int = 0, dp=None, resume: bool = True,
          summary_writer=None, log_every: int = 10,
          pretrained: Optional[dict] = None,
          viz_step: int = 0, step_tracer=None,
          device_assign: bool = False, max_gt: int = 48,
          histogram_step: int = 0,
          activation_summary: bool = False,
          uint8_ingest: bool = False,
          steps_per_dispatch: int = 1,
          rng_impl: str = "",
          pallas_grads: bool = False,
          max_to_keep: int = 5,
          device_augment: bool = False,
          device_dataset: bool = False) -> TrainState:
    """The train loop, on ``det``'s device, updating ``det`` in place,
    under :func:`deterministic` (the caller's settings come back after).

    ``pretrained`` (caffe-pickle layout) or the config's
    ``pretrained_model_path`` load before training; a checkpoint in
    ``train_dir`` then wins (auto-resume, with the input stream and the
    dropout generator restored).  ``seed`` seeds the dropout generator;
    the imdb's own RandomState drives the sampler.  ``pallas_grads``
    routes the eligible 1x1 weight gradients through K2 for this call.
    Returns the final :class:`TrainState`.

    ``dp`` (a ``DataParallel``, ``det`` on its device): this process
    is one rank of a data-parallel job.  Every rank, on one host or
    several, passes an imdb with the same seed; the loop trains on this
    rank's rows of each ``cfg.batch_size`` batch, starts every rank from
    rank 0's state, writes checkpoints, ``model_metrics.txt``, the log
    and the histograms of the global batch's gradient from rank 0 (pass
    ``summary_writer`` there only) and one sampler snapshot per rank.
    ``pallas_grads`` is ignored over several
    ranks, as the JAX package ignores it on a mesh.  A sharded
    ``device_dataset`` keeps each rank's shard of the split on its device.
    """
    from squeezedet_torch.checkpoint.manager import (CheckpointManager,
                                                     latest_step)
    from squeezedet_torch.loader import PrefetchLoader
    from squeezedet_torch.models import layers
    from squeezedet_torch.ops import filter_grad, fused_frontend
    from squeezedet_torch.parallel.mesh import local_shard_gather
    from squeezedet_torch.utils.metrics import write_model_metrics

    cfg = det.cfg
    primary = dp is None or dp.primary
    world = 1 if dp is None else dp.world
    if rng_impl:
        raise NotImplementedError(
            "rng_impl is a JAX PRNG choice and stays out of the port "
            "(ROADMAP Queue 1 item 14)")
    if uint8_ingest and not device_assign:
        raise ValueError("--uint8_ingest requires --device_assign (the "
                         "dense-target path feeds mean-subtracted f32 "
                         "images like the reference)")
    if steps_per_dispatch > 1 and not device_assign:
        raise ValueError("--steps_per_dispatch > 1 requires "
                         "--device_assign (the scanned program fuses "
                         "the anchor matcher per step)")
    if steps_per_dispatch > 1:
        skipped = [flag for flag, on in (
            ("--profile_steps", step_tracer is not None),
            ("--summary_step viz images", bool(viz_step)),
            ("--histogram_step", bool(histogram_step))) if on]
        if skipped and primary:
            print("WARNING: steps_per_dispatch={} fuses K steps into one "
                  "device program; per-step host-side summaries are not "
                  "produced on this path — ignoring: {}. Use "
                  "--steps_per_dispatch 1 to capture them.".format(
                      steps_per_dispatch, ", ".join(skipped)))
        step_tracer, viz_step, histogram_step = None, 0, 0
    if device_dataset:
        device_augment = True  # the same on-device pixel pipeline
    if device_augment and not device_assign:
        raise ValueError("--device_augment requires --device_assign (the "
                         "canvas path feeds the on-device matcher)")
    if world > 1 and pallas_grads:
        print("WARNING: --pallas_grads routes weight gradients of one "
              "device; ignoring it over {} data-parallel ranks.".format(
                  world))
        pallas_grads = False
    rows = None if dp is None else dp.rows(cfg.batch_size)
    sharded_ds = device_dataset and world > 1
    if sharded_ds:
        # before the sampler restore below: the snapshot is shard-shaped
        imdb.shard_data(world, cfg.batch_size)
    writer_on = summary_writer is not None and \
        getattr(summary_writer, "enabled", True)
    # every rank joins the histogram steps' gradient all-reduce, when
    # rank 0 writes them
    hist_on = bool(histogram_step) and (writer_on if world == 1 else bool(
        dp.all_gather_ints([writer_on])[0, 0]))
    if writer_on and viz_step:
        try:
            import cv2  # noqa: F401
        except ImportError:
            print("WARNING: the detection images of summary steps draw "
                  "with OpenCV (cv2), which is not installed; training "
                  "writes the other summaries without them.")
            viz_step = 0
    os.makedirs(train_dir, exist_ok=True)
    dev = det.anchors.device

    if pretrained is None and cfg.load_pretrained_model and \
            cfg.pretrained_model_path:
        from squeezedet_torch.checkpoint.importer import load_pretrained
        pretrained = load_pretrained(cfg.pretrained_model_path)
    if pretrained is not None:
        det.load_pretrained(pretrained)
    state = TrainState(det, build_optimizer(cfg, det))
    generator = torch.Generator(device=dev).manual_seed(seed)

    if primary:
        write_model_metrics(os.path.join(train_dir, "model_metrics.txt"),
                            det.tracer)

    ckpt = CheckpointManager(train_dir, max_to_keep=max_to_keep)
    if world > 1:
        # every rank must see the checkpoints rank 0 writes: train_dir
        # on storage all the job's hosts share
        latest = latest_step(train_dir)
        steps = dp.all_gather_ints([-1 if latest is None else latest])
        if (steps != steps[0]).any():
            raise RuntimeError(
                "ranks disagree on the latest checkpoint in {} (per rank: "
                "{}): data-parallel training needs train_dir on storage "
                "that every host shares".format(train_dir,
                                                steps[:, 0].tolist()))
    if resume:
        step, restored = ckpt.restore_latest(state.as_tree())
        if step is not None:
            state.load_tree(restored)
            print("Resumed from step {}".format(state.step))
            sampler_file = _sampler_ckpt_path(train_dir, step, dp)
            if os.path.exists(sampler_file):
                with np.load(sampler_file) as data:
                    data = dict(data)
                rng_state = data.pop("torch_rng_state", None)
                imdb.set_sampler_state(data)
                if rng_state is not None:
                    generator.set_state(torch.from_numpy(rng_state))
                print("Restored input-stream state ({})".format(
                    os.path.basename(sampler_file)))
    if world > 1:
        # every rank starts from rank 0's parameters and momentum
        dp.broadcast_(list(det.backbone.state_dict().values())
                        + list(state.opt.trace.values()))

    if device_assign:
        train_step = make_train_step_device(state, uint8_ingest=uint8_ingest,
                                            device_augment=device_augment,
                                            device_dataset=device_dataset,
                                            dp=dp)
    else:
        train_step = make_train_step(state, dp)

    dataset_dev = None
    if device_dataset:
        # the guard is computed from the headers, before any decode
        h0, w0 = imdb.canvas_size()
        n_total = imdb._shard_rows if sharded_ds else len(imdb.image_idx)
        gib = n_total * h0 * w0 * 3 / 2**30
        if gib > DEVICE_DATASET_MAX_GIB:
            raise ValueError(
                "--device_dataset: the {}-image split is {:.1f} GiB as a "
                "uint8 canvas stack, more than the {} GiB kept beside the "
                "model on the device; use --device_augment (a per-step "
                "canvas feed) instead".format(n_total, gib,
                                              DEVICE_DATASET_MAX_GIB))
        if sharded_ds:
            # this rank's shard only; its slots gather from it alone
            dataset_np = imdb.load_canvas_shards([dp.rank])
        else:
            dataset_np = imdb.load_canvas_dataset()
        dataset_dev = torch.from_numpy(dataset_np).to(dev)
        del dataset_np
        print("Device-resident dataset: {} images, {:.2f} GiB, uploaded "
              "once{}".format(n_total, dataset_dev.numel() / 2**30,
                              " (shard {} of {})".format(dp.rank, world)
                              if sharded_ds else ""))

    def to_dev(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    def summary_pixels(host_batch):
        """Mean-subtracted f32 model-resolution pixels of this batch, as
        the step saw them (under device_augment the augment program is
        replayed on the batch's canvas rows)."""
        from squeezedet_torch.data.device_pipeline import (
            augment_resize_normalize)
        if not device_augment:
            images = np.asarray(host_batch[0])
            if uint8_ingest:
                return images.astype(np.float32) - cfg.bgr_means_array()
            return images
        if sharded_ds:
            canvas = local_shard_gather(dp.rank, dataset_dev,
                                        to_dev(host_batch[0]))
        elif device_dataset:
            canvas = torch.index_select(dataset_dev, 0,
                                        to_dev(host_batch[0]).long())
        else:
            canvas = to_dev(host_batch[0])
        with torch.no_grad():
            pixels = augment_resize_normalize(
                canvas, to_dev(host_batch[1]), cfg.image_height,
                cfg.image_width, cfg.bgr_means)
        return pixels.cpu().numpy()

    def summary_targets(host_batch):
        """Dense targets of this batch for the detection images and the
        gradient recompute."""
        from squeezedet_torch.data.device_pipeline import (
            assign_anchors_device)
        if not device_assign:
            return host_batch[1]
        off = 2 if device_augment else 1
        gt, labels, num_gt = (to_dev(x) for x in host_batch[off:off + 3])
        return assign_anchors_device(det.anchors, gt.float(), labels,
                                     num_gt, cfg.classes)

    loader = PrefetchLoader(imdb, device_targets=device_assign,
                            max_gt=max_gt, uint8_images=uint8_ingest,
                            device_augment=device_augment,
                            device_dataset=device_dataset,
                            rows=rows).start()
    prev_mode = layers.filter_grad_mode()
    if pallas_grads:
        layers.set_filter_grad("1x1")
    launches = fused_frontend.LAUNCHES, filter_grad.LAUNCHES
    forwards, starts, sizes = 0, [], []
    try:
        if steps_per_dispatch > 1:
            # K steps per dispatch, the cadences over the covered steps;
            # a tail shorter than K runs as single-step dispatches, and
            # the per-step loop below then has no step left
            k = steps_per_dispatch
            scan_step = make_train_step_device_scan(
                state, k, uint8_ingest=uint8_ingest,
                device_augment=device_augment, device_dataset=device_dataset,
                dp=dp)
            head = (dataset_dev,) if device_dataset else ()
            while state.step < max_steps:
                step = state.step
                start_time = time.time()
                if step + k <= max_steps:
                    batches = [loader.get() for _ in range(k)]
                    lb = scan_step(*head, *(
                        torch.from_numpy(np.stack([b[i] for b in batches]))
                        for i in range(len(batches[0]))),
                        generator=generator)
                else:
                    lb = train_step(*head, *(to_dev(x) for x in loader.get()),
                                    generator=generator)
                covered = range(step, state.step)
                forwards += len(covered)
                starts.append(start_time)
                sizes.append(len(covered))
                _, ckpt_due, totals = _dispatch_cadences(
                    covered, lb, start_time=start_time, cfg=cfg,
                    log_every=log_every, summary_step=summary_step,
                    summary_writer=summary_writer,
                    checkpoint_step=checkpoint_step, max_steps=max_steps,
                    force_materialize=True, batch_size=cfg.batch_size,
                    quiet=not primary)
                if ckpt_due:
                    _save_checkpoint(ckpt, train_dir, imdb, loader, generator,
                                     state, next_step=state.step,
                                     max_steps=max_steps, totals=totals,
                                     dp=dp)
        for step in range(state.step, max_steps):
            if step_tracer is not None:
                step_tracer.on_step(step)
            start_time = time.time()
            hist_due = hist_on and step % histogram_step == 0
            # the histogram gradients replay this step's dropout draws
            step_rng = generator.get_state() if hist_due else None
            host_batch = loader.get()
            if device_dataset:
                lb = train_step(dataset_dev,
                                *(to_dev(x) for x in host_batch),
                                generator=generator)
            elif device_assign:
                lb = train_step(*(to_dev(x) for x in host_batch),
                                generator=generator)
            else:
                images, targets = host_batch
                lb = train_step(to_dev(images),
                                Targets(*(t.to(dev) for t in targets)),
                                generator=generator)

            forwards += 1
            starts.append(start_time)
            sizes.append(1)
            do_summary, ckpt_due, totals = _dispatch_cadences(
                range(step, step + 1), lb, start_time=start_time,
                cfg=cfg, log_every=log_every, summary_step=summary_step,
                summary_writer=summary_writer,
                checkpoint_step=checkpoint_step, max_steps=max_steps,
                batch_size=cfg.batch_size, quiet=not primary)
            viz_due = writer_on and do_summary and viz_step and \
                step % viz_step == 0
            if viz_due or hist_due:
                pixels = summary_pixels(host_batch)
                targets = summary_targets(host_batch)
            if viz_due:
                forwards += 1
                summary_writer.image(
                    "sample_detection_results",
                    viz_prediction_images(det, pixels, targets), step,
                    max_outputs=cfg.batch_size)
            if hist_due:
                forwards += 1
                # grads at the post-update params of the same batch
                params, grads = trainable_grads(
                    det, to_dev(pixels), Targets(*(t.to(dev)
                                                   for t in targets)),
                    torch.Generator(device=dev).set_state(step_rng), dp)
                if writer_on:
                    write_histograms(summary_writer, params, grads, step)
                    if activation_summary:
                        write_activation_summaries(summary_writer, det,
                                                   pixels, step)
            if ckpt_due:
                _save_checkpoint(ckpt, train_dir, imdb, loader, generator,
                                 state, next_step=step + 1,
                                 max_steps=max_steps, totals=totals,
                                 dp=dp)
        if dp is not None:
            _report_ranks(dp, launches, forwards, starts, sizes)
        return state
    finally:
        layers.set_filter_grad(prev_mode)
        if step_tracer is not None:
            step_tracer.close()
        loader.stop()
        ckpt.wait_until_finished()
