"""The plain reference: the configurations' networks written from their
published equations in plain PyTorch, in float32.  Imports nothing of
the program, of its tests, or of the JAX package.

A configuration names its network with the key ``"reference"``: a
module of this package (``portbench/reference/<name>.py``); without the
key it is the layer list, :mod:`.model`.  :func:`network` is the one way
the harness reaches it.  Such a module gives, each as a function of the
configuration dict ``cfg``:

* ``param_shapes(cfg)``: {name: shape} of the parameters, the names the
  program's backbone gives them, in the order they are drawn;
* ``buffer_shapes(cfg)``: {name: shape} of the tensors the program keeps
  as buffers (batch-norm statistics), which the benchmark gives it too;
* ``frozen_params(cfg)``: the names of the parameters that do not train;
* ``conv_shapes(cfg)``: every conv as (name, in channels, filters, size,
  stride, out height, out width, relu), for the FLOP count;
* ``head(cfg)``: the head conv's name (``<head>.weight``, ``.bias``);
* ``grid(cfg)``: (height, width) of the head's output;
* ``dropout_parts(cfg)``: for each dropout layer in order, (height,
  width, channel parts of its input in the order the program draws
  them);
* ``k2_routed(cfg)``: (size, in channels, filters, height, width) of each
  conv whose weight gradient the program's ``"1x1"`` route gives K2;
* ``draw(seed, cfg, device)``: {name: float32 tensor} of every parameter
  and buffer, drawn from the seed;
* ``forward(cfg, tensors, images, masks=None, quant=None)``: mean-
  subtracted BGR images [B, H, W, 3] -> the head's raw output [B, Hg,
  Wg, APG * (C + 5)], NHWC float32; ``masks``, one keep mask a dropout
  layer (NHWC bool over its whole input), in training.
"""

from __future__ import annotations

import importlib
import re

DEFAULT = "model"
MODULE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def network(cfg):
    """The reference network module that ``cfg`` names."""
    name = cfg.get("reference", DEFAULT)
    if not isinstance(name, str) or not MODULE.fullmatch(name):
        raise ValueError("{}: reference {!r} is not a module name".format(
            cfg.get("name"), name))
    return importlib.import_module(__name__ + "." + name)
