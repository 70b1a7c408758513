"""``model_metrics.txt``: per-layer parameter, activation and FLOP counts
from the detector's ``NetTracer`` (counterpart of
``squeezedet_tpu/utils/metrics.py``, same text)."""

from __future__ import annotations


def write_model_metrics(path: str, tracer) -> None:
    sections = (("Number of parameter by layer:",
                 tracer.model_size_counter),
                ("\nActivation size by layer:", tracer.activation_counter),
                ("\nNumber of flops by layer:", tracer.flop_counter))
    with open(path, 'w') as f:
        for title, counter in sections:
            f.write(title + '\n')
            for name, v in counter:
                f.write('\t{}: {}\n'.format(name, v))
            f.write('\ttotal: {}\n'.format(sum(v for _, v in counter)))
    print('Model statistics saved to {}.'.format(path))
