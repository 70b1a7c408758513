"""Hermetic data-parallel dry run (counterpart of
``squeezedet_tpu/parallel/dryrun.py``).

    python -m squeezedet_torch.parallel.dryrun [N] [S]

:func:`run` takes one full data-parallel train step of the tiny config
(dropout on, on-device ingest and matching) on N gloo CPU ranks spawned
on this host, and the same step in one process at the same global
batch, from the same weights, optimizer state, batch and dropout seed:
the loss terms, the parameters and the momentum must agree.  With
``n_spatial`` S > 1 it is the data x spatial step of
``make_mesh_2d(N, S)``: each rank runs its rows' forward over S height
tiles with halo exchanges (``models/halo.py``), against the same
unsharded one-process step.  The command runs the 1-D check, then the
2-D one (S defaults to 2; 1 skips it).

The pieces serve the tests and the card's smoke as well: a *case* file
(:func:`write_case`) holds a step's start; :func:`step_on_ranks` runs it
on N spawned ranks and :func:`one_step` in this process, each giving the
updated state, the global loss terms and the step's kernel launches.  A
case written with ``ks`` stacks N steps' batches instead, and each rank
runs them from the case's start once per K in ``ks``, K steps per
dispatch (:func:`scan_steps`).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

# a D-rank step against the one-process step: loss terms to LOSS_RTOL;
# each parameter (momentum) leaf within STEP_RTOL of its largest update
# (value) plus STEP_ATOL: f32 sums taken in another order
LOSS_RTOL, STEP_RTOL, STEP_ATOL = 1e-5, 1e-4, 1e-9


def write_case(path: str, det, batch, *, opt_state: Optional[dict] = None,
               seed: int = 0, uint8_ingest: bool = True,
               device_augment: bool = False, filter_grad=False,
               device: str = "cpu", spatial: int = 1,
               ks: Optional[Sequence[int]] = None) -> None:
    """Save a train step's start: ``det``'s config, net and weights, an
    optimizer state (a fresh one when omitted), the global ``batch``
    (numpy arrays, as ``make_train_step_device`` takes them), the dropout
    seed, the step's flags, the filter-grad mode of a one-process run,
    the kind of device the ranks use and the height tiles of each
    rank's forward (``spatial``; 1 runs it whole).  With ``ks`` each
    array stacks N steps' batches ([N, B, ...]), which a rank runs once
    per K in ``ks`` (:func:`scan_steps`)."""
    torch.save({
        "cfg": det.cfg, "net": det.net,
        "weights": {k: v.cpu() for k, v in det.backbone.state_dict().items()},
        "opt_state": opt_state, "batch": [np.asarray(a) for a in batch],
        "seed": seed, "uint8_ingest": uint8_ingest,
        "device_augment": device_augment, "filter_grad": filter_grad,
        "device": device, "spatial": spatial,
        "ks": None if ks is None else list(ks)}, path)


def load_case(path: str) -> dict:
    # the case holds a ModelConfig: a file this module wrote
    return torch.load(path, weights_only=False)


def _start(case: dict, dp):
    """The case's train state, forward tiling, this rank's rows of the
    batch and a seeded dropout generator, on this process's device."""
    from squeezedet_torch.models import get_model
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.parallel.mesh import make_mesh_2d
    from squeezedet_torch.trainer import TrainState

    device = dp.device if dp is not None else torch.device(case["device"])
    if device.type == "cuda":  # f32 convs in f32, on both sides
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = case["cfg"]
    det = get_model(case["net"], cfg, device=device)
    det.backbone.load_state_dict(case["weights"])
    state = TrainState(det, build_optimizer(cfg, det))
    if case["opt_state"] is not None:
        state.opt.load_state_dict(case["opt_state"])
    spatial = None
    if case.get("spatial", 1) > 1:
        world, rank = (1, 0) if dp is None else (dp.world, dp.rank)
        spatial = make_mesh_2d(world, case["spatial"],
                               case["device"]).tiling(rank)
    rows = slice(None) if dp is None else dp.rows(cfg.batch_size)
    # stacked steps keep the step axis first
    index = (slice(None), rows) if case.get("ks") else rows
    batch = [torch.from_numpy(a[index]) for a in case["batch"]]
    generator = torch.Generator(device).manual_seed(case["seed"])
    flags = dict(uint8_ingest=case["uint8_ingest"],
                 device_augment=case["device_augment"], dp=dp,
                 spatial=spatial)
    return state, batch, generator, flags


def _run(case: dict, dp, state, generator, steps) -> dict:
    """``steps()`` (the [..., 5] loss terms) under ``trainer.deterministic``
    in the case's filter-grad mode (alone) or with K2 off (a rank of
    several); the result :func:`one_step` describes."""
    from squeezedet_torch.models import layers as L
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.trainer import deterministic

    device = state.det.anchors.device
    prev = L.filter_grad_mode()
    L.set_filter_grad(case["filter_grad"] if dp is None or dp.world == 1
                      else False)
    launches = ff.LAUNCHES, fg.LAUNCHES
    t0 = time.perf_counter()
    try:
        with deterministic():  # as the train loop runs its steps
            loss = steps()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        L.set_filter_grad(prev)
    return {"loss": loss.cpu(),
            "params": {k: v.detach().cpu()
                       for k, v in state.det.backbone.state_dict().items()},
            "momentum": {k: t.cpu() for k, t in state.opt.trace.items()},
            "step": state.step, "k1": ff.LAUNCHES - launches[0],
            "k2": fg.LAUNCHES - launches[1],
            "generator": generator.get_state(),
            "seconds": time.perf_counter() - t0,
            "backend": None if dp is None else dp.backend}


def one_step(case: dict, dp=None) -> dict:
    """The case's step on this process's device: alone (``dp`` None, in
    the case's filter-grad mode) or as rank ``dp`` on its rows.  Returns
    the global loss terms, the updated parameters and momentum (on the
    CPU), this process's K1 and K2 launches, the dropout generator's
    state, the host seconds the step took (synchronised) and the group's
    backend.  A case with ``spatial`` S > 1 runs its forward over S
    height tiles (``make_mesh_2d(world, S).tiling(rank)``).  The step
    runs under ``trainer.deterministic``."""
    from squeezedet_torch.trainer import make_train_step_device

    state, batch, generator, flags = _start(case, dp)
    step = make_train_step_device(state, **flags)
    device = state.det.anchors.device
    return _run(case, dp, state, generator, lambda: torch.stack(list(step(
        *(x.to(device) for x in batch), generator=generator))))


def scan_steps(case: dict, k: int, dp=None) -> dict:
    """The case's N stacked steps from its start, as :func:`one_step` runs
    one: K=1 steps one at a time (``make_train_step_device``), K > 1 in
    N/K dispatches of ``make_train_step_device_scan`` (on the card the
    first runs eagerly, the second captures and replays, the rest
    replay).  The loss terms are [N, 5]."""
    from squeezedet_torch.trainer import (make_train_step_device,
                                          make_train_step_device_scan)

    state, batch, generator, flags = _start(case, dp)
    n = batch[0].shape[0]
    if n % k:
        raise ValueError("{} steps do not divide into dispatches of "
                         "{}".format(n, k))
    device = state.det.anchors.device
    if k == 1:
        step = make_train_step_device(state, **flags)

        def steps():
            return torch.stack([torch.stack(list(step(
                *(x[i].to(device) for x in batch), generator=generator)))
                for i in range(n)])
    else:
        scan = make_train_step_device_scan(state, k, **flags)

        def steps():
            return torch.cat([torch.stack(list(scan(
                *(x[i:i + k] for x in batch), generator=generator)), dim=1)
                for i in range(0, n, k)])
    return _run(case, dp, state, generator, steps)


def _rank_step(case_path: str, out_prefix: str) -> None:
    from squeezedet_torch.parallel import distributed
    case = load_case(case_path)
    dp = distributed.init_data_parallel(case["device"])
    try:
        result = one_step(case, dp) if not case.get("ks") else {
            k: scan_steps(case, k, dp) for k in case["ks"]}
        torch.save(result, "{}.p{}".format(out_prefix, dp.rank))
    finally:
        distributed.shutdown()


def step_on_ranks(case_path: str, out_prefix: str, world: int) -> List[dict]:
    """The case's step on ``world`` spawned ranks; each rank's result (as
    :func:`one_step` gives it, saved at ``<out_prefix>.p<rank>``), or
    for a case with ``ks`` a dict of :func:`scan_steps` results by K."""
    from squeezedet_torch.parallel.distributed import spawn
    spawn(_rank_step, world, case_path, out_prefix)
    return [torch.load("{}.p{}".format(out_prefix, r), weights_only=True)
            for r in range(world)]


def worst_mismatch(got: dict, want: dict, start: dict) -> dict:
    """How far ``got``'s step is from ``want``'s: the loss terms' largest
    relative difference, and per leaf max|got - want| over the largest
    update (parameters, from ``start``'s weights) or value (momentum).
    Returns the worst of each with its leaf."""
    loss = ((got["loss"] - want["loss"]).abs()
            / want["loss"].abs().clamp(min=1e-30)).max().item()
    out = {"loss": loss}
    for key, ref in (("params", start), ("momentum", None)):
        worst = (0.0, None)
        for name, w in want[key].items():
            scale = (w - ref[name]).abs().max() if ref is not None \
                else w.abs().max()
            err = (got[key][name] - w).abs().max()
            ratio = float((err - STEP_ATOL).clamp(min=0) / scale) \
                if scale > 0 else float(err > STEP_ATOL)
            worst = max(worst, (ratio, name), key=lambda t: t[0])
        out[key] = worst
    return out


def agrees(mismatch: dict) -> bool:
    """Whether a :func:`worst_mismatch` is within this module's
    tolerances."""
    return mismatch["loss"] <= LOSS_RTOL and \
        mismatch["params"][0] <= STEP_RTOL and \
        mismatch["momentum"][0] <= STEP_RTOL


def tiny_case(path: str, n: int, keep_prob: float = 0.5,
              spatial: int = 1, ks: Optional[Sequence[int]] = None,
              steps: int = 2) -> dict:
    """A tiny-config case at global batch 2n: seeded weights and GT, and
    a mid-training optimizer state (step 5, a random momentum of std
    0.05), whose updates stand well above the f32 spacing of the
    weights.  ``spatial``: the height tiles of each rank's forward.
    With ``ks``, ``steps`` batches stacked, run at each K in ``ks``."""
    from squeezedet_torch.config import tiny_test_config
    from squeezedet_torch.models import get_model
    from squeezedet_torch.optim import build_optimizer
    cfg = tiny_test_config(image_width=64, image_height=64,
                           batch_size=2 * n).replace(keep_prob=keep_prob)
    det = get_model("squeezeDet", cfg, device="cpu")
    rs = np.random.RandomState(0)
    opt = build_optimizer(cfg, det).state_dict()
    opt = {"step": 5, "momentum": {
        k: torch.from_numpy(rs.randn(*t.shape).astype(np.float32) * 0.05)
        for k, t in opt["momentum"].items()}}
    b, g = 2 * n, 4

    def draw():
        boxes = np.stack([rs.uniform(10, 54, (b, g)),
                          rs.uniform(10, 54, (b, g)),
                          rs.uniform(8, 30, (b, g)),
                          rs.uniform(8, 30, (b, g))],
                         axis=-1).astype(np.float32)
        return [rs.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8), boxes,
                rs.randint(0, cfg.classes, (b, g)).astype(np.int32),
                rs.randint(1, g + 1, (b,)).astype(np.int32)]
    batch = draw() if ks is None else [
        np.stack(a) for a in zip(*(draw() for _ in range(steps)))]
    write_case(path, det, batch, opt_state=opt, seed=1, spatial=spatial,
               ks=ks)
    return load_case(path)


def run(n_ranks: int, n_spatial: int = 1) -> float:
    """One data-parallel train step on ``n_ranks`` gloo CPU ranks (each
    over ``n_spatial`` height tiles) against the unsharded one-process
    step, which runs with K2's weight gradients (its plain version on
    the CPU) off and on; returns the (finite) total loss."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.pt")
        case = tiny_case(path, n_ranks, spatial=n_spatial)
        wants = [one_step(dict(case, filter_grad=mode, spatial=1))
                 for mode in (False, True)]
        results = step_on_ranks(path, os.path.join(tmp, "out"), n_ranks)
    for mode, want in zip((False, True), wants):
        for r, got in enumerate(results):
            m = worst_mismatch(got, want, case["weights"])
            if not agrees(m):
                raise AssertionError(
                    "rank {} of {} ({} height tiles) disagrees with the "
                    "one-process step (filter-grad mode {}): {}".format(
                        r, n_ranks, n_spatial, mode, m))
    total = float(wants[0]["loss"][0])
    if not np.isfinite(total):
        raise AssertionError("the dry run's loss is not finite")
    return total


def main() -> None:
    import sys
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    s = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    print("dryrun over {} gloo CPU ranks OK: loss = {:.4f}".format(
        n, run(n)))
    if s > 1:
        print("dryrun over {} gloo CPU ranks x {} height tiles OK: loss = "
              "{:.4f}".format(n, s, run(n, s)))


if __name__ == "__main__":
    main()
