"""Typed failures of the serving fleet (counterpart of
``repro.fleet.errors``). Fleet code raises these, never bare asserts;
engine-level failures (slot or page exhaustion, allocator misuse) keep
their serve types and propagate through."""
from __future__ import annotations


class RouterError(RuntimeError):
    """Fleet-router contract violation: no replicas or workers, duplicate
    request ids or member names, a submission before any weight publish,
    mismatched replica geometry, or a drain loop past its tick budget. The
    replicas themselves are still consistent."""


class ReplicaError(RuntimeError):
    """Replica or worker contract violation: an engine the fleet cannot
    serve (contiguous layout, a family other than pure causal attention)
    or a request or parcel that does not fit the replica's geometry. The
    replica refuses the work; the router and its peers are unaffected."""
