"""Convert a JAX package checkpoint into a ``squeezedet_torch`` one.

    python tools/torch_from_jax_checkpoint.py --checkpoint_dir <jax train_dir> \
        --out_dir <port train_dir> [--net squeezeDet] [--step N]

Reads the orbax ``model.ckpt-<step>`` directory (the newest one unless
``--step`` is given) that ``squeezedet_tpu``'s train loop writes, its
parameters and its optimizer state, and writes the same train state as
the port's ``model.ckpt-<step>/state.pt`` through
``squeezedet_torch.weights.from_jax_params`` / ``from_jax_opt_state``
(HWIO kernels and momentum transposed to OIHW, the schedule's count as
the step), so the port's eval, demo and serve restore it and its train
loop resumes from it.  The input-stream snapshot (``sampler.ckpt-*``)
is not carried over: a resumed port run redraws its batches from
``--seed``.

It imports jax and orbax to read the JAX checkpoint, which is why it
lives outside the port's package (the port imports neither).
"""

from __future__ import annotations

import argparse


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint_dir", required=True,
                   help="The JAX train_dir holding model.ckpt-<step>.")
    p.add_argument("--out_dir", required=True,
                   help="The port train_dir to write model.ckpt-<step> "
                        "into.")
    p.add_argument("--net", default="squeezeDet")
    p.add_argument("--step", type=int, default=None,
                   help="The step to convert (default: the newest).")
    return p


def convert(checkpoint_dir: str, out_dir: str, net: str = "squeezeDet",
            step=None) -> str:
    """Convert one step; returns the written checkpoint's path."""
    import jax
    import numpy as np

    from squeezedet_tpu.checkpoint.manager import \
        CheckpointManager as JaxManager
    from squeezedet_tpu.checkpoint.manager import latest_step
    from squeezedet_tpu.config import config_for_net as jax_config
    from squeezedet_tpu.models import get_model as jax_model
    from squeezedet_tpu.optim import build_optimizer as jax_optimizer
    from squeezedet_tpu.trainer import TrainState as JaxState
    from squeezedet_torch.checkpoint.manager import CheckpointManager
    from squeezedet_torch.config import config_for_net
    from squeezedet_torch.models import get_model
    from squeezedet_torch.weights import from_jax_opt_state, from_jax_params

    if step is None:
        step = latest_step(checkpoint_dir)
        if step is None:
            raise SystemExit("no model.ckpt-<step> in {}".format(
                checkpoint_dir))
    # the JAX train state's structure, as the JAX train loop builds it
    jdet = jax_model(net, jax_config(net).replace(load_pretrained_model=False))
    params, mask, _ = jdet.init(jax.random.key(0))
    like = JaxState(params=params, opt_state=jax_optimizer(
        jdet.cfg, mask).init(params)).as_tree()
    tree = jax.tree.map(np.asarray,
                        JaxManager(checkpoint_dir).restore(step, like))

    det = get_model(net, config_for_net(net).replace(
        load_pretrained_model=False), device="cpu")
    det.backbone.load_state_dict(from_jax_params(tree["params"]))
    opt_state = from_jax_opt_state(tree["opt_state"], det.trainable_mask())
    path = CheckpointManager(out_dir).save(int(tree["step"]), {
        "params": det.backbone.state_dict(), "opt_state": opt_state,
        "step": int(tree["step"])})
    print("Converted {} step {} -> {}".format(checkpoint_dir, step, path))
    return path


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    return convert(args.checkpoint_dir, args.out_dir, args.net, args.step)


if __name__ == "__main__":
    main()
