"""Optimizers and learning-rate schedules, as plain functions on dicts of
tensors."""
