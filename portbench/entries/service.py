"""The serving entry: `fgoicp_tpu_torch.models.serving.RegistrationService`,
built once over the workload's target in set-up; each request registers a
batch of sources (a ragged batch as a list of clouds)."""

from __future__ import annotations

from ..check import Answer


def build(config: dict, workload, device):
    from fgoicp_tpu_torch.config import EngineConfig
    from fgoicp_tpu_torch.models.serving import RegistrationService
    from fgoicp_tpu_torch.utils import logging as log
    log.set_quiet(True)
    return RegistrationService(
        workload.target, mse_threshold=float(config["mse_threshold"]),
        engine=EngineConfig(**config.get("engine", {})),
        trim_fraction=(float(config["trim_fraction"]) if config["trim"]
                       else 0.0),
        device=device)


def call(service, request) -> list:
    return [Answer(R=r.R, t=r.t, sse=float(r.sse), certified=bool(r.certified))
            for r in service.register(list(request.sources))]


def counters(service) -> dict:
    """ServiceStats: pairs, certified_by_seeding, fallbacks, seed_seconds,
    fallback_seconds."""
    return dict(vars(service.stats))


def probes() -> list:
    return []
