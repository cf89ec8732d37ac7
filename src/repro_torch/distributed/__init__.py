"""Distributed aggregation (port of ``repro.distributed``): the d-sharded
gossip round on ``torch.distributed`` (``spmd``) and the robust
all-reduce in its flat and stacked layouts (``robust_allreduce``)."""
