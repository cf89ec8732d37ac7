"""Run plumbing: checkpoints and the serving steps."""
