"""Synthetic datasets and the LM input specs."""
