"""Launchers: the training CLI (``python -m repro_torch.launch.train``) and
the candidate mesh it builds."""
