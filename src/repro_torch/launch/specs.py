"""Per-(architecture x input shape) configuration choices (port of
``repro.launch.specs``): the config variant a shape runs and the
trainer's mode.

The reference's ``build_dryrun`` (abstract inputs, shardings and the
jitted step for XLA's memory and cost analysis) waits with
``launch/dryrun.py``, whose content is that analysis (ROADMAP queue 1,
item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.wfagg import WFAggConfig
from repro_torch.distributed.robust_allreduce import RobustAggConfig
from repro_torch.train import trainer as tr

SLIDING_WINDOW_LONG = 8192


def arch_variant(cfg: ArchConfig, shape: InputShape) -> Optional[ArchConfig]:
    """Per-shape config adjustments; None when the (arch, shape) cell is
    skipped: the encoder-decoder at 500k target tokens.  SSM and hybrid
    models are natively sub-quadratic; the dense, MoE and VLM families run
    500k through a sliding window of ``SLIDING_WINDOW_LONG``."""
    if shape.name == "long_500k":
        if cfg.is_encoder_decoder:
            return None
        if cfg.family in ("ssm", "hybrid"):
            return cfg
        return dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_LONG)
    return cfg


def train_config(cfg: ArchConfig, multi_pod: bool,
                 layout: str = "stacked") -> tr.TrainConfig:
    """The reference's mode selection: robust-DP WFAgg everywhere except
    above 100e9 parameters (Arctic), whose K whole gradient candidates
    cannot coexist in a pod's memory: gspmd mean there.  The stacked layout
    keeps gradients TP-split through aggregation and its temporal filter
    exact; multi-billion-parameter archs FSDP their train state (stacked
    only).  Microbatching is off, as in the reference."""
    if cfg.param_count() > 100e9:
        return tr.TrainConfig(mode="gspmd", agg=RobustAggConfig(method="mean"),
                              multi_pod=multi_pod)
    use_temporal = cfg.param_count() < 40e9 or layout == "stacked"
    return tr.TrainConfig(
        mode="robust_dp",
        agg=RobustAggConfig(method="wfagg", layout=layout,
                            wfagg=WFAggConfig(f=2, use_temporal=use_temporal)),
        multi_pod=multi_pod,
        fsdp_params=(layout == "stacked" and cfg.param_count() > 2e9),
        microbatches=1,
    )
