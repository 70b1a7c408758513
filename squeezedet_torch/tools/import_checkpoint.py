"""``squeezedet-torch-import``: convert a legacy checkpoint (a TF1
``model.ckpt-*`` of the reference, or a caffe-layout pickle) into a port
checkpoint directory that the eval daemon, demo, serve and export
restore directly (counterpart of
``squeezedet_tpu/tools/import_checkpoint.py``).

    squeezedet-torch-import --checkpoint <model.ckpt-87000 or .pkl> \\
        --out_dir <dir> [--net squeezeDet] [--step 87000]

The weights go through the importer's name and layout mapping
(``checkpoint/importer.py``; TF1 bundles are read without TensorFlow)
and ``Detector.load_pretrained`` once, on the CPU; the result is
``<out_dir>/model.ckpt-<step>/state.pt`` holding the backbone's
parameters (``checkpoint/manager.py``).  Used by
``scripts/torch_parity_vs_reference.sh``.
"""

from __future__ import annotations

import argparse


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Import a TF1/caffe checkpoint into the port's "
                    "checkpoint format.")
    p.add_argument('--checkpoint', required=True,
                   help='TF1 model.ckpt-* path or caffe pickle.')
    p.add_argument('--out_dir', required=True,
                   help='Directory to write model.ckpt-<step> into.')
    p.add_argument('--net', default='squeezeDet')
    p.add_argument('--step', type=int, default=0,
                   help='Step label for the written checkpoint '
                        '(e.g. 87000 for the released reference ckpt).')
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    from squeezedet_torch.checkpoint.manager import CheckpointManager
    from squeezedet_torch.config import config_for_net
    from squeezedet_torch.demo import load_params
    from squeezedet_torch.models import get_model

    cfg = config_for_net(args.net).replace(
        load_pretrained_model=False, batch_size=1, is_training=False)
    det = load_params(get_model(args.net, cfg, device="cpu"),
                      args.checkpoint)
    path = CheckpointManager(args.out_dir).save(
        args.step, {"params": det.backbone.state_dict()})
    print('Wrote {}'.format(path))
    return path


if __name__ == '__main__':
    main()
