"""``squeezedet-torch-train``: the train CLI (counterpart of
``squeezedet_tpu/train.py``, same flags plus ``--device``).

    python -m squeezedet_torch.train --data_path <kitti-root> \\
        --train_dir <dir> --max_steps 1000 --device_assign --uint8_ingest \\
        --device_augment [--device cpu]

Trains on ``--device`` (``cuda`` by default, never falling back to the
CPU), auto-resumes from ``--train_dir``, writes checkpoints, sampler
snapshots, ``model_metrics.txt`` and (when ``tensorboard`` imports)
event files there.  ``--steps_per_dispatch K`` runs K steps per host
dispatch, one captured CUDA graph replay on the card;
``--activation_summary`` adds activation summaries at the histogram
steps.  ``--native_loader`` reads the f32 host-resize feed
(``--device_assign`` without ``--uint8_ingest``, ``--device_augment``
or ``--device_dataset``) through the C++ loader, built at start; the
XLA/JAX-only flags raise, naming their ROADMAP item.  Training runs
deterministically (``trainer.deterministic``), so a resumed run equals
a straight one bit for bit.

Data parallelism, one process (rank) per device:

    torchrun --nproc_per_node 4 -m squeezedet_torch.train ...  # any hosts
    squeezedet-torch-train --num_devices 4 ...   # spawns 4 ranks here

``--batch_size`` is the global batch in every layout: every rank, on
one host or several, draws the same batch from one seed and trains on
its share of it (``train_dir`` must be on storage that every host
shares).  The JAX CLI's batch is per host across hosts, so its run on H
hosts at ``--batch_size b`` is this CLI's at ``--batch_size H*b``.  With
``--num_devices 0`` (the default) the CLI takes as many of the visible
cards as divide the batch, as the JAX CLI takes its devices.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train SqueezeDet (PyTorch)")
    p.add_argument('--dataset', default='KITTI',
                   help='KITTI or VOC.')
    p.add_argument('--data_path', default='', help='Root directory of data')
    p.add_argument('--image_set', default='train',
                   help='Can be train, trainval, val, or test')
    p.add_argument('--year', default='2007',
                   help='VOC challenge year.')
    p.add_argument('--train_dir',
                   default='/tmp/squeezedet_torch/logs/train',
                   help='Directory for event logs and checkpoints.')
    p.add_argument('--max_steps', type=int, default=None,
                   help='Maximum number of batches to run (default '
                        '1000000; --recipe_batch needs it given).')
    p.add_argument('--net', default='squeezeDet',
                   help='Neural net architecture.')
    p.add_argument('--pretrained_model_path', default='',
                   help='Path to the pretrained model (caffe pickle).')
    p.add_argument('--summary_step', type=int, default=10,
                   help='Number of steps to save summary (0 = none).')
    p.add_argument('--checkpoint_step', type=int, default=1000,
                   help='Number of steps to save checkpoint.')
    p.add_argument('--max_to_keep', type=int, default=5,
                   help='Checkpoints retained in train_dir (with their '
                        'sampler snapshots); 0 keeps all.')
    p.add_argument('--num_devices', type=int, default=0,
                   help='Data-parallel ranks, one process each (0 = the '
                        'most visible devices that divide the batch; '
                        'under torchrun, its world size). More ranks '
                        'than cards share them.')
    p.add_argument('--device', default='cuda',
                   help='torch device to train on; never falls back.')
    p.add_argument('--seed', type=int, default=0,
                   help='Seeds the initial weights, the dropout generator '
                        'and the sampler.')
    p.add_argument('--compute_dtype', default='',
                   help="Override compute dtype, e.g. 'bfloat16'.")
    p.add_argument('--no_resume', action='store_true',
                   help='Do not auto-resume from train_dir checkpoints.')
    p.add_argument('--fresh_start', action='store_true',
                   help='Delete and recreate train_dir before training.')
    p.add_argument('--image_width', type=int, default=0,
                   help='Override input width (0 = model default).')
    p.add_argument('--image_height', type=int, default=0,
                   help='Override input height (0 = model default).')
    p.add_argument('--batch_size', type=int, default=0,
                   help='Override batch size (0 = model default).')
    p.add_argument('--learning_rate', type=float, default=0.0,
                   help='Override initial learning rate (0 = config).')
    p.add_argument('--lr_warmup_steps', type=int, default=None,
                   help='Linear LR warmup over the first N steps (0 = '
                        'off; unset = config default, or the derived '
                        'value under --recipe_batch).')
    p.add_argument('--decay_steps', type=int, default=None,
                   help='Override the LR staircase decay interval (unset = '
                        'config default, or the --recipe_batch value).')
    p.add_argument('--recipe_batch', type=int, default=0,
                   help='Rescale the training recipe to this batch size '
                        '(config.scale_recipe_to_batch: linear LR and '
                        'LOSS_COEF_CONF_POS, decay_steps at the same '
                        'sample count, 10%% warmup of --max_steps, which '
                        'must then be given).  Explicit --decay_steps/'
                        '--lr_warmup_steps/--loss_coef_* win.')
    p.add_argument('--loss_coef_conf_pos', type=float, default=None,
                   help='Override LOSS_COEF_CONF_POS.')
    p.add_argument('--loss_coef_conf_neg', type=float, default=None,
                   help='Override LOSS_COEF_CONF_NEG (0 is a valid '
                        'ablation).')
    p.add_argument('--loss_coef_class', type=float, default=None,
                   help='Override LOSS_COEF_CLASS.')
    p.add_argument('--loss_coef_bbox', type=float, default=None,
                   help='Override LOSS_COEF_BBOX.')
    p.add_argument('--no_augmentation', action='store_true',
                   help='Disable drift/flip data augmentation.')
    p.add_argument('--native_loader', action='store_true',
                   help='Use the C++ threaded batch loader for image IO '
                        '(builds squeezedet_torch/native/dataloader on '
                        'first use); it reads the --device_assign feed '
                        'of f32 host-resized images.')
    p.add_argument('--image_cache_mb', type=int, default=0,
                   help='Keep up to this many MiB of decoded images in a '
                        'host-RAM LRU (0 = off).')
    p.add_argument('--device_assign', action='store_true',
                   help='Run the anchor matcher on the device inside the '
                        'train step.')
    p.add_argument('--uint8_ingest', action='store_true',
                   help='Feed raw uint8 images and mean-subtract on the '
                        'device. Requires --device_assign.')
    p.add_argument('--device_augment', action='store_true',
                   help='Run drift crop, flip, resize and mean '
                        'subtraction inside the train step on raw uint8 '
                        'canvases; the host only decodes and does the GT '
                        'box math. Requires --device_assign.')
    p.add_argument('--device_dataset', action='store_true',
                   help='Keep the whole split on the device as one uint8 '
                        'canvas stack (up to 12 GiB) and gather each '
                        'batch there. Implies --device_augment; requires '
                        '--device_assign.')
    p.add_argument('--steps_per_dispatch', type=int, default=1,
                   help='Train steps per host dispatch: K > 1 stacks K '
                        'batches and runs the K steps as one captured '
                        'CUDA graph replay on the card (eagerly on the '
                        'CPU). Requires --device_assign; a data-parallel '
                        'run needs NCCL ranks.')
    p.add_argument('--compilation_cache', default='',
                   help='XLA compilation cache (stays out of the port).')
    p.add_argument('--profile_steps', default='',
                   help="Trace steps with torch.profiler, e.g. '20:25' "
                        "traces steps 20..24 into <train_dir>/profile.")
    p.add_argument('--histogram_step', type=int, default=0,
                   help='Emit per-variable and per-gradient histograms '
                        'every N steps (0 = off).')
    p.add_argument('--rng_impl', default='',
                   help='JAX PRNG implementation (stays out of the port).')
    p.add_argument('--pallas_grads', action='store_true',
                   help='Route the eligible 1x1 filter gradients through '
                        'the hand-written K2 kernel (ops/filter_grad.py).')
    p.add_argument('--activation_summary', action='store_true',
                   help='At each --histogram_step step, also write each '
                        "layer's activation histogram and its sparsity, "
                        'mean, max and min.')
    return p


def _reject_unported(args) -> None:
    """Flags of the JAX CLI that stay out of the port."""
    if args.compilation_cache or args.rng_impl:
        raise SystemExit('--compilation_cache and --rng_impl are XLA/JAX '
                         'mechanisms that stay out of the port (ROADMAP '
                         'Queue 1 item 14)')


def config_from_args(args):
    """Resolve the training ModelConfig from parsed CLI flags, as the JAX
    CLI does; ``--recipe_batch`` additionally needs ``--max_steps``,
    since its warmup is a share of the run's length."""
    from squeezedet_torch.config import (config_for_dataset,
                                         scale_recipe_to_batch)

    cfg = config_for_dataset(args.dataset, args.net, args.image_width,
                             args.image_height)
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    cfg = cfg.replace(
        is_training=True,
        pretrained_model_path=args.pretrained_model_path,
        load_pretrained_model=bool(args.pretrained_model_path))
    if args.no_augmentation:
        cfg = cfg.replace(data_augmentation=False)
    if args.learning_rate:
        cfg = cfg.replace(learning_rate=args.learning_rate)
    if args.recipe_batch:
        if args.max_steps is None:
            raise SystemExit('--recipe_batch derives its warmup from the '
                             'run length: give --max_steps too')
        cfg = scale_recipe_to_batch(cfg, args.recipe_batch,
                                    total_steps=args.max_steps)
    # None-default, so an explicit 0 still overrides a derived value
    if args.lr_warmup_steps is not None:
        cfg = cfg.replace(lr_warmup_steps=args.lr_warmup_steps)
    if args.decay_steps is not None:
        if args.decay_steps <= 0:
            raise SystemExit('--decay_steps must be a positive step '
                             'interval (omit the flag for the config '
                             'default or the --recipe_batch-derived '
                             'value)')
        cfg = cfg.replace(decay_steps=args.decay_steps)
    for coef in ('loss_coef_conf_pos', 'loss_coef_conf_neg',
                 'loss_coef_class', 'loss_coef_bbox'):
        val = getattr(args, coef)
        if val is not None:
            cfg = cfg.replace(**{coef: val})
    if args.image_cache_mb:
        cfg = cfg.replace(image_cache_mb=args.image_cache_mb)
    if args.compute_dtype:
        cfg = cfg.replace(compute_dtype=args.compute_dtype)
    if args.native_loader:
        cfg = cfg.replace(use_native_loader=True)
    return cfg


def build_native_loader(args, primary: bool = True) -> None:
    """Build (or find) the native loader for ``--native_loader``, exiting
    with the build's error where it cannot be built; warn when the feed
    the flags select is not one the loader reads."""
    from squeezedet_torch.native import dataloader
    try:
        dataloader.load()
    except RuntimeError as e:
        raise SystemExit('--native_loader: {}'.format(e))
    served = args.device_assign and not (
        args.uint8_ingest or args.device_augment or args.device_dataset)
    if not served and primary:
        print('WARNING: --native_loader reads the f32 host-resized feed of '
              '--device_assign without --uint8_ingest, --device_augment or '
              '--device_dataset; this run\'s feed is read in Python.')


def resolve_num_devices(args, batch_size: int) -> int:
    """The ranks to spawn on this host: ``--num_devices``, or with 0 the
    most visible devices that divide the batch.  The batch must divide
    over them."""
    from squeezedet_torch.parallel.mesh import data_axis_size, auto_mesh
    n = args.num_devices or data_axis_size(auto_mesh(batch_size,
                                                     args.device))
    if batch_size % n:
        raise SystemExit('--batch_size {} is not divisible by --num_devices '
                         '{}: every rank trains on an equal share of the '
                         'batch'.format(batch_size, n))
    return n


def main(argv=None):
    """Train as the flags say, deterministically (``trainer.
    deterministic``); returns the final TrainState (None when the ranks
    ran in spawned processes)."""
    import sys

    from squeezedet_torch.trainer import CUBLAS_WORKSPACE_CONFIG

    # before anything touches CUDA; spawned ranks inherit it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)

    from squeezedet_torch.parallel import distributed
    from squeezedet_torch.utils.util import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_arg_parser().parse_args(argv)
    _reject_unported(args)
    resolve_device(args.device, "training")
    if distributed.launched_by_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if args.num_devices not in (0, world):
            raise SystemExit('--num_devices {} under a launcher of {} '
                             'ranks'.format(args.num_devices, world))
        return _rank_main(argv)
    n = resolve_num_devices(args, config_from_args(args).batch_size)
    if n > 1:
        distributed.spawn(_rank_main, n, argv)
        return None
    return _train(args, None)


def _rank_main(argv):
    """One data-parallel rank: join the group, train, leave it."""
    from squeezedet_torch.parallel import distributed
    args = build_arg_parser().parse_args(argv)
    dp = distributed.init_data_parallel(args.device)
    try:
        return _train(args, dp)
    finally:
        distributed.shutdown()


def _train(args, dp):
    """The run on this process's device, as rank ``dp`` of a
    data-parallel job or alone (``dp`` None)."""
    import torch

    from squeezedet_torch.data import imdb_for_dataset
    from squeezedet_torch.models import get_model
    from squeezedet_torch.parallel import distributed
    from squeezedet_torch.summary import SummaryWriter
    from squeezedet_torch.trainer import train
    from squeezedet_torch.utils.util import resolve_device

    device = dp.device if dp is not None else \
        resolve_device(args.device, "training")
    cfg = config_from_args(args)
    if args.native_loader:
        build_native_loader(args, distributed.is_primary_process())
    max_steps = 1000000 if args.max_steps is None else args.max_steps
    det = get_model(args.net, cfg, device=device,
                    generator=torch.Generator().manual_seed(args.seed))
    # every rank, on one host or several, draws the same global batch
    # from one seed and trains on its rows of it
    imdb = imdb_for_dataset(args.dataset, args.image_set, args.data_path,
                            cfg, year=args.year,
                            rng=np.random.RandomState(args.seed))

    primary = distributed.is_primary_process()
    if args.fresh_start and os.path.isdir(args.train_dir) and primary:
        import shutil
        shutil.rmtree(args.train_dir)
    if dp is not None:
        dp.barrier()  # no rank writes while rank 0 empties the directory
    os.makedirs(args.train_dir, exist_ok=True)
    # one event file per job
    writer = SummaryWriter(args.train_dir) if primary else None

    step_tracer = None
    if args.profile_steps and primary:
        from squeezedet_torch.utils.profiling import StepTracer
        start, stop = (int(x) for x in args.profile_steps.split(':'))
        step_tracer = StepTracer(os.path.join(args.train_dir, 'profile'),
                                 start, stop)
    try:
        return train(det, imdb, train_dir=args.train_dir,
                     max_steps=max_steps, summary_step=args.summary_step,
                     checkpoint_step=args.checkpoint_step, seed=args.seed,
                     dp=dp, resume=not args.no_resume,
                     summary_writer=writer,
                     viz_step=args.summary_step, step_tracer=step_tracer,
                     device_assign=args.device_assign,
                     histogram_step=args.histogram_step,
                     activation_summary=args.activation_summary,
                     steps_per_dispatch=args.steps_per_dispatch,
                     uint8_ingest=args.uint8_ingest,
                     pallas_grads=args.pallas_grads,
                     max_to_keep=args.max_to_keep,
                     device_augment=args.device_augment,
                     device_dataset=args.device_dataset)
    finally:
        if writer is not None:
            writer.close()


if __name__ == '__main__':
    main()
