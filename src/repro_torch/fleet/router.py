"""Fleet request router (counterpart of ``repro.fleet.router``).

The host-side control plane of the disaggregated serving tier: an
admission queue drained in strict FIFO order onto
:class:`~repro_torch.fleet.replica.DecodeReplica` engines, prefill
delegated round-robin to
:class:`~repro_torch.fleet.replica.PrefillWorker` roles, and the pages
migrated through the priced :class:`~repro_torch.transport.FabricChannel`
(``kv_migration``).

Determinism: a request's stream is a function of its prompt, its sampling
and its weight version (slots are independent, every hop is lossless,
replicas swap weights only while idle), so router streams equal a single
paged engine's and ``generate_static``'s under arrival-order
permutations, any replica count, joins and leaves, fp32 or int8 KV and a
mid-run weight refresh.

Live refresh is versioned at admission: :meth:`FleetRouter.submit` pins a
request to the latest published version; a replica installs a newer
version only when idle and when no queued request still pins its current
one. A published version is decoded once, onto the replicas' device, and
every replica installs the same tensors; its parcel crosses the fabric
once an install (``weight_publish``).

On a mesh the router runs the same way on every rank (SPMD): the queue,
the placements, the fabric's hop log and the streams are equal on every
rank, since every rank samples from the same gathered logits. Every rank
decodes a version's parcel (the mesh's global storage) at once and keeps
its own blocks.
"""
from __future__ import annotations

import collections

from repro_torch.fleet.errors import RouterError
from repro_torch.transport import FabricChannel, pack_kv_pages, unpack_weight_parcel


def _geometry(engine) -> tuple[int, int, int]:
    return engine.page_size, engine.cache_capacity, engine.max_slots


class FleetRouter:
    """Route requests across ``replicas`` with ``workers`` for prefill.
    The replicas share one engine geometry (page size, capacity, slots),
    which the workers match."""

    def __init__(self, replicas, workers, *, fabric: FabricChannel | None = None):
        replicas, workers = list(replicas), list(workers)
        if not replicas:
            raise RouterError("a fleet needs at least one decode replica")
        if not workers:
            raise RouterError("a fleet needs at least one prefill worker")
        names = [r.name for r in replicas] + [w.name for w in workers]
        if len(set(names)) != len(names):
            raise RouterError(f"duplicate fleet member names in {names}")
        g0 = _geometry(replicas[0].engine)
        for r in replicas[1:]:
            if _geometry(r.engine) != g0:
                raise RouterError(f"replica {r.name}: geometry {_geometry(r.engine)} != {g0}")
        for w in workers:
            if (w.page_size, w.cache_capacity) != g0[:2]:
                raise RouterError(f"worker {w.name}: geometry {(w.page_size, w.cache_capacity)} "
                                  f"!= {g0[:2]}")
        self.replicas = replicas
        self.workers = workers
        self.fabric = fabric if fabric is not None else FabricChannel()
        self.plan = replicas[0].engine.plan
        self._kv_policy = self.plan.kv_migration_policy()
        self.versions: dict[int, object] = {}
        self._parcels: dict[int, object] = {}
        self.latest: int | None = None
        self.queue: collections.deque = collections.deque()
        self._rids: set[int] = set()
        self.results: dict[int, object] = {}
        self.placements: dict[int, dict] = {}
        self.migrated_pages = 0
        self._rr = 0
        self.ticks = 0

    # -- weight publishing -------------------------------------------------
    def publish(self, parcel) -> None:
        """Register a weight parcel, decoded once onto the replicas' device
        (on a mesh, this rank's blocks of it). Replicas install it on their
        next idle tick; requests submitted from now on pin it."""
        if self.latest is not None and parcel.version <= self.latest:
            raise RouterError(f"publish version {parcel.version} is not newer than "
                              f"{self.latest}")
        e = self.replicas[0].engine
        self.versions[parcel.version] = unpack_weight_parcel(
            parcel, e.storage, spec_tree=e.spec_tree, mesh_cfg=e.mesh_cfg, rank=e.rank)
        self._parcels[parcel.version] = parcel
        self.latest = parcel.version

    def _install(self, replica, version: int) -> None:
        self.fabric.send(self._parcels[version], cls="weight_publish", src="trainer",
                         dst=replica.name)
        replica.install(self.versions[version], version)

    # -- membership --------------------------------------------------------
    def add_replica(self, replica) -> None:
        """Join: the replica installs the latest version through the fabric
        before it takes traffic."""
        if self.latest is None:
            raise RouterError("publish weights before adding a replica")
        if replica.name in {r.name for r in self.replicas}:
            raise RouterError(f"duplicate replica name {replica.name!r}")
        if _geometry(replica.engine) != _geometry(self.replicas[0].engine):
            raise RouterError(f"replica {replica.name}: geometry mismatch on join")
        self.replicas.append(replica)
        self._install(replica, self.latest)

    def remove_replica(self, name: str) -> None:
        """Leave: the replica drains (no new admissions) and is dropped,
        its conservation audits run, once its requests finish."""
        match = [r for r in self.replicas if r.name == name]
        if not match:
            raise RouterError(f"unknown replica {name!r}")
        if all(r.draining or r.name == name for r in self.replicas):
            raise RouterError("cannot drain the last replica")
        match[0].draining = True

    # -- admission ---------------------------------------------------------
    def submit(self, req) -> None:
        """Queue one request, pinned to the latest published version."""
        if self.latest is None:
            raise RouterError("no weights published: submit after publish")
        if req.rid in self._rids:
            raise RouterError(f"duplicate request id {req.rid}")
        self.replicas[0].engine.validate_request(req)
        self._rids.add(req.rid)
        self.queue.append((req, self.latest))

    def _pick(self, req, version: int):
        """Placement: among the non-draining replicas at the request's
        version that can admit it, the least loaded, the lowest index on a
        tie."""
        best, best_key = None, None
        for i, r in enumerate(self.replicas):
            if r.draining or r.version != version or not r.probe(req)[0]:
                continue
            key = (r.engine.active_slots, i)
            if best is None or key < best_key:
                best, best_key = r, key
        return best

    def _dispatch(self, req, version: int, replica) -> None:
        ok, hits = replica.probe(req)
        if not ok:
            raise RouterError(f"request {req.rid}: placement picked a full replica")
        n_hits = len(hits)
        worker = self.workers[self._rr % len(self.workers)]
        self._rr += 1
        pages, first = worker.prefill(self.versions[version], req, n_hits=n_hits)
        S = len(req.prompt_ids)
        n_new = -(-S // replica.engine.page_size) - n_hits
        parcel = pack_kv_pages(pages, self._kv_policy, meta={
            "rid": req.rid, "version": version, "prompt_len": S, "n_hits": n_hits,
            "pages": n_new, "first": first})
        del pages
        self.fabric.send(parcel, cls="kv_migration", src=worker.name, dst=replica.name)
        self.migrated_pages += n_new
        replica.admit_parcel(req, parcel)
        self.placements[req.rid] = {"replica": replica.name, "worker": worker.name,
                                    "version": version}

    def _collect(self, replica) -> None:
        self.results.update(replica.engine.take_completed())

    # -- the scheduling loop -----------------------------------------------
    def tick(self) -> None:
        """One fleet step: the rolling refresh, the drained leavers'
        removal, FIFO admissions, then one decode tick a busy replica."""
        self.ticks += 1
        if self.latest is not None:
            pinned = {v for _, v in self.queue}
            for r in self.replicas:
                if (not r.draining and r.version != self.latest and r.engine.active_slots == 0
                        and (r.version is None or r.version not in pinned)):
                    self._install(r, self.latest)
        keep = []
        for r in self.replicas:
            if r.draining and not r.engine.has_work and not r.engine.pending_record:
                self._collect(r)
                r.engine.finish()
            else:
                keep.append(r)
        self.replicas = keep
        # strict FIFO: the head of the line waits for a replica at its
        # version with free residency
        while self.queue:
            req, version = self.queue[0]
            replica = self._pick(req, version)
            if replica is None:
                break
            self.queue.popleft()
            self._dispatch(req, version, replica)
        for r in self.replicas:
            if r.engine.has_work or r.engine.pending_record:
                r.tick()
            self._collect(r)

    def run(self, requests, *, max_ticks: int = 1_000_000, on_tick=None):
        """Submit ``requests`` and tick the fleet until it drains.
        ``on_tick(router)`` runs before every tick (a mid-run publish or
        follow-up traffic). Returns ``{rid: GenResult}``."""
        for req in requests:
            self.submit(req)
        while self.queue or any(r.engine.has_work or r.engine.pending_record or r.draining
                                for r in self.replicas):
            if self.ticks >= max_ticks:
                raise RouterError(
                    f"fleet stopped at max_ticks={max_ticks} with {len(self.queue)} queued and "
                    f"{sum(r.engine.active_slots for r in self.replicas)} in flight")
            if on_tick is not None:
                on_tick(self)
            self.tick()
        for r in self.replicas:
            self._collect(r)
            r.engine.finish()
        return dict(self.results)

    # -- accounting --------------------------------------------------------
    def wire_summary(self) -> dict:
        """The fabric's per-class totals and the observed quantities
        :func:`~repro_torch.roofline.analysis.fleet_migration_bytes` takes."""
        out = self.fabric.wire_summary()
        out["migrated_pages"] = self.migrated_pages
        out["publish_installs"] = out["hops"]["weight_publish"]
        out["ticks"] = self.ticks
        return out
