"""The plain reference: squeezeDet and squeezeDet+ written from their
published equations in plain PyTorch, in float32.  Imports nothing of
the program, of its tests, or of the JAX package."""
