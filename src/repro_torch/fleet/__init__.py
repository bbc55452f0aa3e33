"""The disaggregated serving tier (counterpart of ``repro.fleet``).

A host-side :class:`FleetRouter` drains a FIFO admission queue onto paged
:class:`~repro_torch.serve.engine.ServeEngine` replicas
(:class:`DecodeReplica`); dedicated :class:`PrefillWorker` roles compute
each prompt's KV pages, which migrate to the replica as byte-plane parcels
through the priced :class:`~repro_torch.transport.FabricChannel`
(``kv_migration``); a trainer's :class:`WeightPublisher` feeds live weight
refreshes (``weight_publish``), installed by idle replicas in a rolling
refresh and pinned per request at admission.

Every hop is lossless, so router streams equal a single paged engine's and
``generate_static``'s for the same requests, and the fabric's hop log
equals :func:`repro_torch.roofline.analysis.fleet_migration_bytes`. On any
mesh the serve engine runs on, every rank runs the same fleet on its TP
slice: KV parcels carry the global pages (every kv head, gathered over the
model group), weight parcels the mesh's global storage, so the hop log is
one device's and equal on every rank.
"""
from repro_torch.fleet.errors import ReplicaError, RouterError
from repro_torch.fleet.publish import WeightPublisher
from repro_torch.fleet.replica import DecodeReplica, PrefillWorker, check_fleet_arch
from repro_torch.fleet.router import FleetRouter

__all__ = [
    "DecodeReplica",
    "FleetRouter",
    "PrefillWorker",
    "ReplicaError",
    "RouterError",
    "WeightPublisher",
    "check_fleet_arch",
]
