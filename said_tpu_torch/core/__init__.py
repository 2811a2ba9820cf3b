"""Train-state checkpoints, metric logs and the serving path's profiler spans."""
