"""Kernels and tensor ops: box geometry, the K1 front-end kernel, and
on-device postprocessing."""
