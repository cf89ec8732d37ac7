"""Core library: WFAgg, its trust logic, the mean baseline, attacks, topologies, metrics."""
