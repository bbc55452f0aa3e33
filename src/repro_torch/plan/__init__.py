"""The declarative PrecisionPlan (counterpart of ``repro.plan``)."""
from repro_torch.plan.plan import (
    TRAFFIC_CLASSES,
    PrecisionPlan,
    SamplingParams,
    Schedule,
    policy_uses_rng,
)

__all__ = ["PrecisionPlan", "SamplingParams", "Schedule", "TRAFFIC_CLASSES",
           "policy_uses_rng"]
