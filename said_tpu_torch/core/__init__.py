"""Train-state checkpoints and metric logs."""
