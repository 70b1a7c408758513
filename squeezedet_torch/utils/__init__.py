"""Host utilities: drawing, timers, model accounting, profiling."""
