"""Training-run plumbing: checkpoints."""
