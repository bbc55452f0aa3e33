"""The compression transport (counterpart of ``repro.transport``).

Only the policy is re-exported here; the pack/unpack/quantize entry points
live in :mod:`repro_torch.transport.transport`.
"""
from repro_torch.transport.policy import (
    FP32_BYTES,
    CompressionPolicy,
    policy_for,
)

__all__ = ["FP32_BYTES", "CompressionPolicy", "policy_for"]
