"""Training as the train CLI runs it with ``--device_dataset
--device_augment --uint8_ingest --steps_per_dispatch K --pallas_grads``
under ``trainer.deterministic()``: K steps a dispatch
(``make_train_step_device_scan``), the first dispatch eager, the second
captured and replayed, every later one replayed, over a uint8 canvas
dataset on the device.  Summaries and checkpoints are off.

Mix parameters: ``batch``, ``steps_per_dispatch``, ``dataset_images``,
``canvas`` [H0, W0], ``max_gt`` (the matcher's slots), the ground
truth's ``objects_mean``, ``class_share``, ``class_aspect``,
``box_min`` and ``box_max``, ``feed_dispatches`` (distinct dispatches
drawn, sent in turn), ``filter_grad`` (the K2 route).

The check: the reference follows the two set-up dispatches from the
same weights, rows, augment and dropout draws (the eager dispatch's
masks as the program drew them), and the window's last dispatch from
the program's state just before it (parameters, momentum, step and
dropout generator, copied on the device before every window dispatch).
The first step's gradients as the optimizer gets them, the change of
every parameter over the set-up dispatches, and the window dispatch's
first loss and its change of every parameter are compared with the
program's."""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from portbench import program, traffic
from portbench.runners.score import reference_mode
from portbench.reference import network
from portbench.reference import train as ref_train

FEED_KEYS = ("pos", "aug", "gt_boxes", "gt_labels", "num_gt")
# a leaf whose reference gradient is under this share of the median
# leaf's moves by rounding alone and is not compared
NOUGHT = 1e-3


def leaf_gaps(prog, ref, keep):
    """Each leaf's gap between the program's and the reference's norms,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double()))
             for n in keep}
    median = float(np.median(list(norms.values())))
    return [abs(float(torch.linalg.vector_norm(prog[n].double()))
                - norms[n]) / max(norms[n], median) for n in keep]


def leaf_angles(prog, ref, keep):
    """{leaf: 1 - cosine between the program's and the reference's}."""
    return {n: 1.0 - float(torch.nn.functional.cosine_similarity(
        prog[n].double().flatten(), ref[n].double().flatten(), dim=0))
        for n in keep}


def fresh_change(cfg, start, end, step, k):
    """{leaf: the part of its change over a dispatch of ``k`` steps that
    the dispatch's own gradients made}: its parameters at the ``end``
    less those at the ``start``, plus what the momentum it started from
    moved it by alone (step t of the dispatch, from 1, at the rate
    ``lr_t``, moves it by ``-lr_t * momentum ** t`` times that).
    ``start``: (parameters, momentum) of the trained leaves; ``end``:
    their parameters; ``step``: the schedule's step of the dispatch's
    first."""
    r = cfg["recipe"]
    params, mom = start
    carried = sum(ref_train.lr_at(cfg, step + t) * r["momentum"] ** (t + 1)
                  for t in range(k))
    return {n: end[n] - params[n] + carried * mom[n] for n in mom}


class Runner:
    def __init__(self, cfg, mix, seed, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        # cuBLAS' fixed workspace for deterministic results, before its
        # first handle (as the train CLI sets it)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        from squeezedet_torch.models import layers
        from squeezedet_torch.optim import build_optimizer
        from squeezedet_torch.trainer import (TrainState, deterministic,
                                              make_train_step_device_scan)
        cfg, mix, dev = self.cfg, self.mix, self.device
        stage = traffic.Stages("train")
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(deterministic())
        self.weights = traffic.model_weights(self.seed, cfg, dev)
        det = program.detector(cfg, mix["batch"], self.weights, dev)
        stage("weights and program")
        self.prev_route = layers.filter_grad_mode()
        layers.set_filter_grad(mix["filter_grad"])
        self.state = TrainState(det, build_optimizer(det.cfg, det))
        h0, w0 = mix["canvas"]
        self.dataset = traffic.uint8_images(
            self.seed, "dataset", (mix["dataset_images"], h0, w0, 3), dev)
        stage("dataset")
        self.feed = [{k: torch.from_numpy(d[k]) for k in FEED_KEYS}
                     for d in traffic.train_feed(self.seed, cfg, mix,
                                                 mix["feed_dispatches"])]
        stage("feed")
        self.generator = traffic.device_generator(self.seed, "dropout", dev)
        self.gen_state = self.generator.get_state()
        self.scan = make_train_step_device_scan(
            self.state, mix["steps_per_dispatch"], uint8_ingest=True,
            device_augment=True, device_dataset=True)
        opt = self.state.opt
        self.params = dict(det.backbone.named_parameters())
        with self._first_dispatch_read(opt, layers):
            lbs = [self._dispatch(0)]
        self._sync()
        stage("eager dispatch")
        self.mid_gen = self.generator.get_state()
        lbs.append(self._dispatch(1))
        self._sync()
        stage("capture and replay")
        self.sent = 2
        self.losses = torch.cat([lb.total for lb in lbs]).tolist()
        self.end = self._state()
        # the state each window dispatch starts from, copied on the
        # device before it (the last one's is judged)
        self.live = [self.params[n] for n in opt.params] + \
            [opt.trace[n] for n in opt.params]
        self.snap_bufs = [t.detach().clone() for t in self.live]

    @contextlib.contextmanager
    def _first_dispatch_read(self, opt, layers):
        """Reads, over the eager first dispatch, the first step's
        gradients as the optimizer gets them and each step's dropout
        masks as the program drew them (its dropout fed ones: the same
        draws, the mask read off; the activations times it are its
        output)."""
        self.first_grads, drawn = {}, []
        update, dropout = opt.update, layers.dropout

        def first_update(neg_lr=None):
            if not self.first_grads:
                self.first_grads.update((n, p.grad.detach().clone())
                                        for n, p in opt.params.items())
            return update(neg_lr)

        def read_dropout(x, keep_prob, generator, train):
            if not train or not torch.is_tensor(x):
                return dropout(x, keep_prob, generator, train)
            m = dropout(torch.ones_like(x), keep_prob, generator, train)
            drawn.append(m != 0)
            return x * m
        opt.update, layers.dropout = first_update, read_dropout
        try:
            yield
        finally:
            del opt.update
            layers.dropout = dropout
        # a step's keep masks, one a dropout layer over its whole input,
        # as the reference takes them; none read, or not the network's
        # parts: drawn again from the state
        k = self.mix["steps_per_dispatch"]
        layout = [len(p) for _, _, p in
                  network(self.cfg).dropout_parts(self.cfg)]
        per = sum(layout)
        self.first_masks = None
        if drawn and len(drawn) == k * per:
            parts = iter(drawn)
            self.first_masks = [
                [torch.cat([next(parts) for _ in range(n)], dim=-1)
                 for n in layout] for _ in range(k)]

    def _state(self):
        """(parameters that train, momentum, step) as they stand."""
        opt = self.state.opt
        return ({n: self.params[n].detach().clone() for n in opt.params},
                {n: t.clone() for n, t in opt.trace.items()}, opt.step)

    def _dispatch(self, i):
        d = self.feed[i % len(self.feed)]
        return self.scan(self.dataset, *(d[k] for k in FEED_KEYS),
                         generator=self.generator)

    def window(self, seconds):
        k = self.mix["steps_per_dispatch"]
        opt = self.state.opt
        n = 0
        t0 = time.perf_counter()
        marks = [t0]
        while True:
            with torch.no_grad():
                torch._foreach_copy_(self.snap_bufs, self.live)
            start = (self.sent, opt.step, self.generator.get_state())
            lb = self._dispatch(self.sent)
            self.sent += 1
            n += 1
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        gaps = np.diff(marks) * 1e3
        print("train window: {} dispatches, host ms between their returns "
              "p10 {:.2f} p50 {:.2f} p90 {:.2f} max {:.2f}".format(
                  n, *np.percentile(gaps, [10, 50, 90]), gaps.max()),
              file=sys.stderr)
        names = list(opt.params)
        half = len(names)
        self.last = {
            "feed": start[0] % len(self.feed), "step": start[1],
            "gen": start[2],
            "start": ({m: t.clone() for m, t in zip(names,
                                                   self.snap_bufs[:half])},
                      {m: t.clone() for m, t in zip(names,
                                                   self.snap_bufs[half:])}),
            "losses": lb.total.tolist(), "end": self._state()}
        steps = n * k
        return {"seconds": elapsed, "dispatches": n,
                "steps": steps, "images": steps * self.mix["batch"],
                "attempted": steps, "failed": 0}

    def end_to_end(self, win):
        return {"train_img_s": win["images"] / win["seconds"]}

    def release(self):
        from squeezedet_torch.models import layers
        del self.scan, self.state, self.live, self.snap_bufs
        layers.set_filter_grad(self.prev_route)
        self.stack.close()

    def _reference(self, params, gen_state, feed, **kw):
        gen = torch.Generator(device=self.device)
        gen.set_state(gen_state)
        return ref_train.run_steps(self.cfg, params, self.dataset, feed,
                                   gen, **kw)

    def _feed(self, i):
        return {k: v.to(self.device) for k, v in self.feed[i].items()}

    def reference_run(self, quant=None, rows=None, window_feed=None):
        """What the reference gives in the program's place: {``first``:
        the first step's gradients, ``setup``: (losses, parameters,
        momentum) after the set-up dispatches, ``window``: the same
        after the window's last dispatch from the program's state before
        it}.  ``quant``: its precision; ``rows``: a slice of each batch
        it trains on; ``window_feed``: the feed dispatch it takes for the
        window's last (a dispatch's inputs dropped)."""
        first = {}
        feed = [self._feed(0), self._feed(1)]
        kw = dict(quant=quant, rows=rows)
        l0, m0, p0 = self._reference(
            self.weights, self.gen_state, feed[:1], first_grads=first,
            step_masks=self.first_masks, **kw)
        l1, m1, p1 = self._reference(p0, self.mid_gen, feed[1:],
                                     momentum=m0, start_step=len(l0), **kw)
        last = self.last
        params, mom = last["start"]
        lw, mw, pw = self._reference(
            dict(self.weights, **params), last["gen"],
            [self._feed(last["feed"] if window_feed is None
                        else window_feed)],
            momentum=mom, start_step=last["step"], **kw)
        return {"first": first, "setup": (l0 + l1, p1, m1),
                "window": (lw, pw, mw)}

    def _redrawn_equal(self):
        """Whether the reference's own draw of the eager dispatch's masks
        (``draw_masks``, which the replayed dispatches take) equals what
        the program drew; None where none was read."""
        if self.first_masks is None:
            return None
        gen = torch.Generator(device=self.device)
        gen.set_state(self.gen_state)
        for masks in self.first_masks:
            drawn = ref_train.draw_masks(self.cfg, gen, self.mix["batch"])
            if len(drawn) != len(masks) or not all(
                    torch.equal(a, b) for a, b in zip(drawn, masks)):
                return False
        return True

    def program_run(self):
        """The program's own, as :meth:`reference_run` gives it."""
        params, mom, _ = self.end
        w_params, w_mom, _ = self.last["end"]
        return {"first": self.first_grads,
                "setup": (self.losses, params, mom),
                "window": (self.last["losses"], w_params, w_mom)}

    def check(self, quant=None, run=None):
        """{grad_angle, head_grad_angle, step_gap, window_loss_gap,
        window_step_gap} of ``run`` (:meth:`program_run` when None) against
        the float32 reference.

        ``grad_angle``: the median leaf's 1 - cosine between the first
        step's gradient as the optimizer gets it, the program's against
        the reference's; ``head_grad_angle`` the same over the head's
        weight and bias together, which the batch's own boxes drive.
        ``step_gap``: the median leaf's gap between the norms of its
        change over the two set-up dispatches (``leaf_gaps``).
        ``window_loss_gap``: the window's last dispatch's first loss
        against the reference's from the same state, relative.
        ``window_step_gap``: ``step_gap`` over that dispatch's change.
        ``self.detail`` adds what is read and not compared, among it
        ``window_angle``, the median leaf's 1 - cosine between the part
        of its change over that dispatch that the dispatch's own
        gradients made (``fresh_change``), the program's against the
        reference's (readings in ``PERF.md``)."""
        reference_mode()
        if getattr(self, "plain", None) is None:
            self.plain = self.reference_run()
        ref = self.plain
        if quant is not None:
            run = self.reference_run(quant=quant)
        mine = self.program_run() if run is None else run
        first = ref["first"]
        norms = {n: float(torch.linalg.vector_norm(g)) for n, g in
                 first.items()}
        median = float(np.median(list(norms.values())))
        keep = [n for n in norms if norms[n] >= NOUGHT * median]
        r_losses, r_params, r_mom = ref["setup"]
        p_losses, p_params, p_mom = mine["setup"]
        steps = leaf_gaps({n: p_params[n] - self.weights[n] for n in keep},
                          {n: r_params[n] - self.weights[n] for n in keep},
                          keep)
        gaps = [abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses)]
        angles = leaf_angles(mine["first"], first, keep)
        grads = leaf_gaps(mine["first"], first, keep)
        head = [n for n in keep if n.startswith(
            network(self.cfg).head(self.cfg) + ".")]
        head_angle = leaf_angles(
            {"head": torch.cat([mine["first"][n].flatten() for n in head])},
            {"head": torch.cat([first[n].flatten() for n in head])},
            ["head"])["head"]
        # the window's last dispatch, from the program's state before it
        k = self.mix["steps_per_dispatch"]
        start = self.last["start"]
        w_ref, w_mine = ref["window"], mine["window"]
        fresh_ref = fresh_change(self.cfg, start, w_ref[1],
                                 self.last["step"], k)
        fresh_mine = fresh_change(self.cfg, start, w_mine[1],
                                  self.last["step"], k)
        w_angles = leaf_angles(fresh_mine, fresh_ref, keep)
        w_gaps = [abs(a - b) / abs(b) for a, b in zip(w_mine[0], w_ref[0])]
        w_steps = leaf_gaps(
            {n: w_mine[1][n] - start[0][n] for n in keep},
            {n: w_ref[1][n] - start[0][n] for n in keep}, keep)
        self.detail = {
            "step_loss_gaps": gaps, "losses": r_losses,
            "first_loss_gap": gaps[0],
            "worst_step_gap": max(steps),
            "worst_momentum_gap": max(leaf_gaps(p_mom, r_mom, keep)),
            "grad_gap": max(grads), "median_grad_gap": float(np.median(grads)),
            "leaf_angles": angles,
            "left_out": sorted(set(norms) - set(keep)),
            "window_step": self.last["step"],
            "window_loss_gaps": w_gaps, "window_losses": w_ref[0],
            "window_angle": float(np.median(list(w_angles.values()))),
            "first_masks_read": self.first_masks is not None,
            "masks_redrawn_equal": self._redrawn_equal()}
        return {"grad_angle": float(np.median(list(angles.values()))),
                "head_grad_angle": head_angle,
                "step_gap": float(np.median(steps)),
                "window_loss_gap": w_gaps[0],
                "window_step_gap": float(np.median(w_steps))}
