"""Checkpoints of the train state and legacy weight import."""
