"""Observability: the per-edge decision record."""
