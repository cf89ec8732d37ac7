"""Run plumbing: checkpoints, the serving steps and the trainer."""
