"""Fleet workers: dedicated prefill and decode roles (counterpart of
``repro.fleet.replica``).

A :class:`PrefillWorker` runs the engine's paged prefill for a request and
exports the prompt's freshly written KV as pool pages; a
:class:`DecodeReplica` wraps one paged
:class:`~repro_torch.serve.engine.ServeEngine` driven through its
streaming surface (``admit_pages`` / ``decode_tick``), installing the
pages that arrive through the :class:`~repro_torch.transport.FabricChannel`.

Bit-exactness: the worker runs the engine's own paged admission prefill
(the page-rounded capacity, the prompt padded to whole pages on the
device, the logits read at the true last token, the replicated layout),
samples the first id with the engine's own function, and its page export
slices the prefill caches exactly as the engine's paged insert writes the
pool, so a migrated admission is bit-equal to a local one. The fleet
serves pure causal attention models only (where padded prompts and shared
prefixes are causal-safe).

On a mesh every rank runs the same worker and replica on its TP slice
(SPMD, as the serve engine). The worker's export gathers the ranks' kv-head
slices of the pages over the model group (``comm`` traffic ``relayout``),
so a parcel carries the global pages of every kv head, as the reference's
worker exports them from its global cache, and each replica rank installs
its own heads (``ServeEngine.admit_pages``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist import comm
from repro_torch.fleet.errors import ReplicaError
from repro_torch.launch.mesh import model_group
from repro_torch.models.attention import PAGED, QUANT
from repro_torch.serve.engine import first_sampling, sample_packed
from repro_torch.serve.sampling import seed_words
from repro_torch.serve.step import global_cache_shapes, kv_heads_of, make_prefill_step
from repro_torch.transport.hostdev import pack_tokens_host, stage, unpack_tokens, unpack_tokens_host
from repro_torch.transport.fabric import unpack_kv_pages


def check_fleet_arch(cfg) -> None:
    """The fleet serves pure-attention causal token models only: the
    family where paged prompt padding, prefix sharing and therefore
    migrated prefill are causal-safe and slot-independent. Takes the
    port's configs and the reference's alike."""
    if not cfg.causal:
        raise ReplicaError(f"{cfg.name} is encoder-only: nothing to serve")
    if cfg.num_image_tokens or cfg.embed_is_input_stub:
        raise ReplicaError(f"{cfg.name}: fleet serving stages token payloads only")
    if cfg.num_experts or any(k != "attn" for k in cfg.pattern):
        raise ReplicaError(
            f"{cfg.name}: fleet serving needs a pure-attention pattern (MoE capacity "
            "dispatch and recurrent state couple positions, breaking migrated-prefill "
            "equivalence)")
    if cfg.sliding_window:
        raise ReplicaError(f"{cfg.name}: paged fleet serving keeps the full context resident — "
                           "sliding-window archs stay on the static path")


class PrefillWorker:
    """Dedicated prefill role: the engine's paged prefill for one request
    at a time, and the export of its prompt pages for migration.

    ``cache_capacity`` and ``page_size`` must be the decode fleet's (the
    export uses the same page-rounded prefill capacity and slicing as the
    engine's local insert). :attr:`step_log` records the worker's own
    host<->device staging, one record a prefill: the prompt h2d and the
    first id d2h."""

    def __init__(self, name, cfg, mesh_cfg, mesh, spec_tree, *, plan, cache_capacity: int,
                 page_size: int = 64):
        check_fleet_arch(cfg)
        self.name = str(name)
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg
        self._model_group = model_group(mesh)
        self.plan = plan.broadcast(cfg.num_groups + 1)
        self.cache_capacity = int(cache_capacity)
        self.page_size = int(page_size)
        if self.page_size < 1:
            raise ReplicaError(f"worker {self.name}: page_size must be >= 1")
        self._table_width = -(-self.cache_capacity // self.page_size)
        self.token_width = self.plan.host_device_policies()[0].token_wire_width(cfg.vocab_size)
        # the engine's paged admission prefill: the replicated layout (the
        # logits are read at "last") and a page-rounded capacity
        self._prefill = make_prefill_step(
            cfg, mesh_cfg, mesh, spec_tree,
            plan=dataclasses.replace(self.plan, seq_parallel=False),
            cache_capacity=self._table_width * self.page_size, shard_batch=False)
        # a one-page pool's shapes: the dtype of each leaf the export lands in
        self._pool_shapes = global_cache_shapes(
            cfg, mesh_cfg, 1, self.cache_capacity, self.plan.compute_dtype, shard_batch=False,
            per_slot=True, int8_kv=self.plan.int8_kv, paged_pages=1, page_size=self.page_size)
        self.step_log: list[dict] = []

    def prefill(self, storage, req, *, n_hits: int = 0):
        """One request's prefill under ``storage`` (on its device) and the
        export of its new prompt pages ``[n_hits, prompt_pages)``
        (``n_hits`` whole prefix pages are resident at the destination).
        Returns ``(pages, first)``: per group, per cache node, ``{"k",
        "v"(, "k_scale", "v_scale")}`` tensors ``(R, n_new, page, ...)`` at
        pool dtype, and the first id (the argmax for a greedy request, else
        the request's key fold at emitted index 0, as the engine's
        admission draws it)."""
        S = len(req.prompt_ids)
        page = self.page_size
        prompt_pages = -(-S // page)
        if not 0 <= int(n_hits) <= S // page:
            raise ReplicaError(f"worker {self.name}: n_hits={n_hits} outside the whole-prompt "
                               f"page range [0, {S // page}]")
        if S + req.max_new > self.cache_capacity:
            raise ReplicaError(f"worker {self.name}: request {req.rid} needs "
                               f"{S + req.max_new} positions, capacity is {self.cache_capacity}")
        seed_words(req.sampling.seed)  # a seed past uint32 raises before the prefill
        device = storage["embed"].device
        rec = {"rid": req.rid, "prompt_len": S, "host_device": 0}
        planes = pack_tokens_host(np.asarray(req.prompt_ids, np.int32)[None, :],
                                  self.token_width)  # (w, 1, S): h2d, true length
        rec["host_device"] += planes.nbytes
        tokens = unpack_tokens(stage(planes, device))
        tokens = torch.nn.functional.pad(tokens, (0, prompt_pages * page - S))  # whole pages
        logits, pcaches = self._prefill(storage, {"tokens": tokens, "last": S - 1})
        tok_planes = sample_packed(logits, self.cfg.vocab_size, self.token_width,
                                   first_sampling(req.sampling))  # (w, 1): d2h first id
        rec["host_device"] += tok_planes.nbytes
        first = int(unpack_tokens_host(tok_planes)[0])
        pages = self._export(pcaches, int(n_hits), prompt_pages - int(n_hits))
        self.step_log.append(rec)
        return pages, first

    def _export(self, pcaches, n_hits: int, n_new: int):
        """The prefill caches' positions ``[n_hits·page, (n_hits +
        n_new)·page)`` as pool pages: the engine's ``_insert_paged`` slice
        (``s[:, 0, start:start + n_new·page]`` reshaped to ``(R, n_new,
        page, ...)``) at the pool's dtype. On a mesh the ranks' kv-head
        slices (dim 3) are gathered over the model group on the host, one
        copy of each head kept where ``Kv < tp`` replicates it: the global
        pages on every rank."""
        page = self.page_size
        start, stop = n_hits * page, (n_hits + n_new) * page
        tp, kv = self.mesh_cfg.tp, self.cfg.num_kv_heads
        keep = None  # where Kv < tp the gather holds tp heads: head h's first rank's
        if kv < tp:
            firsts = [kv_heads_of(self.cfg, self.mesh_cfg, m)[0] for m in range(tp)]
            keep = torch.tensor([firsts.index(h) for h in range(kv)])
        out = []
        for pg, sg in zip(self._pool_shapes, pcaches):
            gd = {}
            for key, pn in pg.items():
                if not isinstance(pn, PAGED):
                    raise ReplicaError(f"worker {self.name}: cache node {key!r} is not a paged "
                                       "pool — fleet archs are pure-attention")
                names = ("k", "v", "k_scale", "v_scale") if isinstance(pn, QUANT) else ("k", "v")
                gd[key] = {}
                for a in names:
                    src = getattr(sg[key], a)
                    seg = src[:, 0, start:stop].reshape(
                        src.shape[0], n_new, page, *src.shape[3:]).to(getattr(pn, a).dtype)
                    if tp > 1:
                        seg = comm.all_gather(seg.cpu(), self._model_group, axis=3,
                                              traffic="relayout")
                        if keep is not None:
                            seg = seg.index_select(3, keep)
                    gd[key][a] = seg
            out.append(gd)
        return out


class DecodeReplica:
    """Decode role: one paged engine driven through its streaming surface.
    ``version`` is the installed weight-publish version (None until the
    router's first install)."""

    def __init__(self, name, engine):
        check_fleet_arch(engine.cfg)
        if not engine.paged:
            raise ReplicaError(f"replica {name}: fleet serving needs the paged engine "
                               "(paged=True)")
        self.name = str(name)
        self.engine = engine
        self.version: int | None = None
        self.draining = False
        engine.begin_stream()

    def probe(self, req):
        """Admission probe: ``(ok, resident prefix-page hits)``."""
        return self.engine.can_admit(req)

    def admit_parcel(self, req, parcel) -> None:
        """Install a migration parcel (its ``meta`` carries the skipped
        prefix pages and the worker's first id), unpacked on the host: the
        engine moves the heads its pools hold to its device."""
        self.engine.admit_pages(req, unpack_kv_pages(parcel),
                                n_hits=parcel.meta["n_hits"], first_tok=parcel.meta["first"],
                                wire_bytes=parcel.nbytes)

    def tick(self) -> None:
        self.engine.decode_tick()

    def install(self, storage, version: int) -> None:
        """Hot-swap to a published weight version; only while idle (the
        router's versioned-at-admission contract)."""
        if self.engine.active_slots:
            raise ReplicaError(f"replica {self.name}: weight install with "
                               f"{self.engine.active_slots} slots in flight")
        self.engine.swap_weights(storage)
        self.version = int(version)
