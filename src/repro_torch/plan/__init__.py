"""The declarative PrecisionPlan (counterpart of ``repro.plan``)."""
from repro_torch.plan.plan import (
    TRAFFIC_CLASSES,
    PrecisionPlan,
    SamplingParams,
    Schedule,
    policy_uses_rng,
)
from repro_torch.plan.sweep import (
    CHUNK_CANDIDATES,
    modeled_gather_time,
    pick_chunks,
    sweep_chunks,
)

__all__ = ["CHUNK_CANDIDATES", "PrecisionPlan", "SamplingParams", "Schedule",
           "TRAFFIC_CLASSES", "modeled_gather_time", "pick_chunks", "policy_uses_rng",
           "sweep_chunks"]
