"""On-device input pipeline (the serving path's mean subtraction)."""
