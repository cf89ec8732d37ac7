"""Distributed aggregation (port of ``repro.distributed``): the d-sharded
gossip round on ``torch.distributed`` (``spmd``) and the stacked robust
all-reduce (``robust_allreduce``)."""
