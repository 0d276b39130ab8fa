"""The single-pair entry: `fgoicp_tpu_torch.models.goicp.register(Config,
pct, pcs)`, the reference's main path, one pair a call."""

from __future__ import annotations

import dataclasses

from ..check import Answer


@dataclasses.dataclass
class State:
    config: object     # fgoicp_tpu_torch.config.Config
    device: str


def build(config: dict, workload, device) -> State:
    from fgoicp_tpu_torch.config import Config
    from fgoicp_tpu_torch.utils import logging as log
    log.set_quiet(True)
    cfg = Config()
    cfg.params.mse_threshold = float(config["mse_threshold"])
    cfg.params.trim = bool(config["trim"])
    if cfg.params.trim:
        cfg.params.trim_fraction = float(config["trim_fraction"])
    for key, value in config.get("engine", {}).items():
        setattr(cfg.engine, key, value)
    return State(cfg, device)


def call(state: State, request) -> list:
    from fgoicp_tpu_torch.models.goicp import register
    model, R, t = register(state.config, request.target, request.sources[0],
                           device=state.device)
    gap = model.last_certified_gap
    return [Answer(R=R, t=t, sse=float(model.best_sse),
                   certified=gap is not None and gap <= model.sse_threshold)]


def counters(state: State) -> dict:
    return {}


def probes() -> list:
    """GoICP's construction (normalisation, proxy FPS, source clusters),
    its ICP phases and its inner BnB (`scripts/profile_phases`' split)."""
    from fgoicp_tpu_torch.models.goicp import GoICP
    return [(GoICP, "__init__", "construct"),
            (GoICP, "_initial_icp", "icp"),
            (GoICP, "_refine_candidates", "icp"),
            (GoICP, "_spawn_children", "icp"),
            (GoICP, "_final_icp", "icp"),
            (GoICP, "_evaluate_children", "inner_bnb")]
