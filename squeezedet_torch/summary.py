"""TensorBoard event files (counterpart of ``squeezedet_tpu/summary.py``):
loss and learning-rate scalars, histograms and detection images.

Writes through ``torch.utils.tensorboard`` when it imports (it needs the
``tensorboard`` package), and is otherwise a no-op, so training never
depends on it: the JAX writer's rule with TensorFlow.  ``enabled`` says
which.  Images are encoded by the port's PNG codec, so the writer needs
no PIL.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SummaryWriter:
    """Thin event-file writer: scalar(), histogram(), image(), flush(),
    close()."""

    def __init__(self, logdir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer
        except ImportError:
            return
        self._writer = _Writer(logdir)

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def scalar(self, tag: str, value: float, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def histogram(self, tag: str, values, step: int,
                  buckets: Optional[int] = None):
        if self._writer is not None:
            self._writer.add_histogram(tag, np.asarray(values), step,
                                       bins=buckets or "tensorflow")

    def image(self, tag: str, images: np.ndarray, step: int,
              max_outputs: int = 20):
        """images: [N, H, W, 3] RGB uint8/float, each written as its own
        PNG under ``<tag>/image/<i>`` (encoded by ``data/png.py``, so no
        PIL is needed)."""
        if self._writer is None:
            return
        from tensorboard.compat.proto.summary_pb2 import Summary

        from squeezedet_torch.data.png import encode_png
        arr = np.asarray(images)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        values = [Summary.Value(
            tag="{}/image/{}".format(tag, i),
            image=Summary.Image(height=im.shape[0], width=im.shape[1],
                                colorspace=3,
                                encoded_image_string=encode_png(
                                    im[:, :, ::-1], level=1)))
            for i, im in enumerate(arr[:max_outputs])]
        self._writer._get_file_writer().add_summary(Summary(value=values),
                                                    step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
