"""The declarative PrecisionPlan (counterpart of ``repro.plan``)."""
from repro_torch.plan.plan import (
    TRAFFIC_CLASSES,
    PrecisionPlan,
    Schedule,
)

__all__ = ["PrecisionPlan", "Schedule", "TRAFFIC_CLASSES"]
