"""The compression transport (counterpart of ``repro.transport``).

The policy and the fleet fabric are re-exported here; the
pack/unpack/quantize entry points live in
:mod:`repro_torch.transport.transport`.
"""
from repro_torch.transport.fabric import (
    FABRIC_CLASSES,
    FabricChannel,
    FabricError,
    KVPageParcel,
    WeightParcel,
    pack_kv_pages,
    pack_weight_parcel,
    unpack_kv_pages,
    unpack_weight_parcel,
)
from repro_torch.transport.policy import (
    FP32_BYTES,
    CompressionPolicy,
    policy_for,
)

__all__ = [
    "FABRIC_CLASSES",
    "FP32_BYTES",
    "CompressionPolicy",
    "FabricChannel",
    "FabricError",
    "KVPageParcel",
    "WeightParcel",
    "pack_kv_pages",
    "pack_weight_parcel",
    "policy_for",
    "unpack_kv_pages",
    "unpack_weight_parcel",
]
