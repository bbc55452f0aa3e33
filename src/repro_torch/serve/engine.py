"""Continuous-batching serve engine (counterpart of ``repro.serve.engine``,
the contiguous slotted layout with greedy decoding).

A request queue drains through a slotted KV cache: ``max_slots`` resident
requests decode together as one fixed-shape batch, and whenever a slot
frees up the scheduler admits the next queued prompt between decode
steps. Every slot carries its own absolute position
(``init_caches(per_slot=True)``: ``(reps, slots)`` position vectors), so
mixed prompt lengths and staggered admissions share one decode step.

Prompts enter and sampled ids leave through the plan's ``host_device``
policy as lossless byte planes (:mod:`repro_torch.transport.hostdev`) at
``token_wire_width`` bytes each, and the engine logs the measured staged
bytes per step (:attr:`ServeEngine.step_log`); the analytic mirror is
:func:`repro_torch.roofline.analysis.serve_host_device_bytes`.

Determinism contract: sampling is greedy and slots are independent, so a
request's token stream is a function of its prompt alone, and equals the
static one-shot reference (:func:`generate_static`) for the same requests.

``paged=True`` swaps the contiguous slotted layout for the block-paged
KV cache: fixed-size pages in one pool (:func:`M.init_paged_caches`), a
host-side per-slot page table staged every decode step, a refcounted
:class:`PageAllocator` (the page-granular twin of :class:`SlotManager`),
shared-prefix page interning (a common prompt prefix is resident once)
and prompts padded to whole pages before prefill. Streams equal the
contiguous engine's and :func:`generate_static`'s.

Not ported (each raises ``NotImplementedError``): speculative decoding
(``draft=``), sliding windows, int8 KV (contiguous or paged), sampled
requests, and the fleet's migration admission (``admit_pages``). The
reference compiles one prefill per prompt length (per page-bucket length
when paged); PyTorch runs eagerly, so one prefill step serves every
length. The paged engine still counts bucket lengths seen before
(``prefill_hits``) and not (``prefill_misses``), as the reference counts
its compiles, so that ``wire_summary`` equals the reference's.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.spec import MeshCfg
from repro_torch.models import model as M
from repro_torch.models.attention import PagedKVCache, check_cache_geometry
from repro_torch.plan import PrecisionPlan
from repro_torch.serve.api import Request, SamplingParams, require_greedy
from repro_torch.serve.step import (
    global_cache_shapes,
    make_decode_step,
    make_place_step,
    make_prefill_step,
)
from repro_torch.transport.hostdev import (
    pack_tokens,
    pack_tokens_host,
    stage,
    unpack_tokens,
    unpack_tokens_host,
)

__all__ = [
    "AllocatorError",
    "CapacityError",
    "GenResult",
    "InvariantError",
    "PageAllocator",
    "Request",
    "SamplingParams",
    "ServeEngine",
    "SlotManager",
    "generate_static",
]


@dataclasses.dataclass
class GenResult:
    """Completed generation: emitted ids in order (eos included if hit)."""

    rid: int
    prompt_len: int
    tokens: list[int]
    admitted_step: int
    finished_step: int


@dataclasses.dataclass
class _ReqState:
    req: Request
    slot: int
    admitted_step: int
    tokens: list[int] = dataclasses.field(default_factory=list)

    def emit(self, tok: int) -> bool:
        """Record one sampled id; True when the request just finished."""
        self.tokens.append(tok)
        if self.req.eos_id is not None and tok == self.req.eos_id:
            return True
        return len(self.tokens) >= self.req.max_new


class CapacityError(RuntimeError):
    """No free slot, or the drain loop hit its step budget with requests
    still unfinished."""


class AllocatorError(RuntimeError):
    """Allocator API misuse: double allocation or release of an unowned
    slot."""


class InvariantError(AssertionError):
    """An internal conservation audit failed (slot leak, counter
    imbalance): engine state is corrupt."""


class SlotManager:
    """KV-slot allocator with leak-audit counters: ``alloc`` hands the
    lowest free slot to a request at admission, ``release`` returns it at
    retirement, :meth:`audit` checks that every slot is exactly free xor
    owned and that allocs == releases + active."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))  # pop() -> lowest first
        self._owner: dict[int, int] = {}  # slot -> rid
        self.alloc_count = 0
        self.release_count = 0

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active(self) -> dict[int, int]:
        return dict(self._owner)

    def alloc(self, rid: int) -> int:
        if not self._free:
            raise CapacityError("no free slot")
        slot = self._free.pop()
        if slot in self._owner:
            raise AllocatorError(f"slot {slot} double-allocated")
        self._owner[slot] = rid
        self.alloc_count += 1
        return slot

    def release(self, slot: int) -> None:
        if slot not in self._owner:
            raise AllocatorError(f"release of unowned slot {slot}")
        del self._owner[slot]
        self._free.append(slot)
        self.release_count += 1

    def audit(self) -> dict:
        free, owned = set(self._free), set(self._owner)
        if free & owned:
            raise InvariantError(f"slots both free and owned: {free & owned}")
        if len(self._free) != len(free):
            raise InvariantError("duplicate entries in the free list")
        if free | owned != set(range(self.n_slots)):
            raise InvariantError("slot leak: free ∪ owned != all slots")
        if self.alloc_count != self.release_count + len(owned):
            raise InvariantError("alloc/release counters out of balance")
        return {
            "free": len(free),
            "active": len(owned),
            "allocs": self.alloc_count,
            "releases": self.release_count,
        }


class PageAllocator:
    """Free-page allocator with refcounts, the page-granular twin of
    :class:`SlotManager` with the same leak-audit contract.

    ``alloc`` hands out pool rows at admission, ``retain`` adds a reference
    when a shared-prefix page is reused (shared pages are immutable by
    construction: decode only writes a slot's private tail pages),
    ``release`` drops one reference and frees the page when none is left.
    :meth:`audit` checks that every page is free xor live and that
    allocs == releases + live."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError("need at least one page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> lowest
        self._refs: dict[int, int] = {}  # page -> refcount
        self.alloc_count = 0
        self.release_count = 0
        self.peak = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise CapacityError(f"need {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            if p in self._refs:
                raise AllocatorError(f"page {p} double-allocated")
            self._refs[p] = 1
        self.alloc_count += n
        self.peak = max(self.peak, len(self._refs))
        return pages

    def retain(self, page: int) -> None:
        if page not in self._refs:
            raise AllocatorError(f"retain of dead page {page}")
        self._refs[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; True when the page was actually freed."""
        if page not in self._refs:
            raise AllocatorError(f"release of dead page {page}")
        self._refs[page] -= 1
        if self._refs[page] > 0:
            return False
        del self._refs[page]
        self._free.append(page)
        self.release_count += 1
        return True

    def audit(self) -> dict:
        free, live = set(self._free), set(self._refs)
        if free & live:
            raise InvariantError(f"pages both free and live: {free & live}")
        if len(self._free) != len(free):
            raise InvariantError("duplicate entries in the free page list")
        if free | live != set(range(self.num_pages)):
            raise InvariantError("page leak: free ∪ live != all pages")
        if any(c < 1 for c in self._refs.values()):
            raise InvariantError("live page with refcount < 1")
        if self.alloc_count != self.release_count + len(live):
            raise InvariantError("page alloc/release counters out of balance")
        return {
            "free": len(free),
            "live": len(live),
            "allocs": self.alloc_count,
            "releases": self.release_count,
            "peak": self.peak,
        }


def page_bytes(caches) -> int:
    """Bytes ONE page occupies summed over every paged pool (all groups ×
    repetitions × K/V). Works on the ``global_cache_shapes`` tree of meta
    tensors or on live caches (the reference's ``_page_pool_bytes``)."""
    per_page = 0
    for group in caches:
        for node in group.values():
            if isinstance(node, PagedKVCache):
                for leaf in (node.k, node.v):  # stacked (R, P, page, ...)
                    per_page += leaf.numel() * leaf.element_size() // leaf.shape[1]
    return per_page


class ServeEngine:
    """Continuous-batching driver over ``make_prefill_step`` /
    ``make_decode_step`` (see the module docstring).

    ``storage`` is the weight tree (``tree_to_storage``); its device is
    the engine's device. ``plan`` drives every precision choice including
    the ``host_device`` staging entry. ``cache_capacity`` caps
    ``prompt_len + max_new`` per request (validated at submit).
    ``paged=True`` selects the paged layout: ``page_size`` tokens a page,
    ``num_pages`` allocatable pages (default ``max_slots`` × the table
    width, ``ceil(cache_capacity / page_size)``), ``share_prefix``
    interning of whole prompt pages."""

    def __init__(
        self,
        cfg: ModelConfig,
        mesh_cfg: MeshCfg,
        mesh,
        spec_tree,
        storage,
        *,
        plan: PrecisionPlan,
        max_slots: int,
        cache_capacity: int,
        window: int | None = None,
        weight_stationary: bool = False,
        paged: bool = False,
        page_size: int = 64,
        num_pages: int | None = None,
        share_prefix: bool = True,
        draft=None,
        spec_k: int | None = None,
    ):
        self.paged = bool(paged)
        self.page_size = int(page_size)
        if self.paged:
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1")
            if window is not None or cfg.sliding_window:
                raise ValueError(
                    f"{cfg.name}: paged serving keeps the full context "
                    "resident — sliding-window (ring) serving stays on the "
                    "contiguous layout"
                )
        if draft is not None or spec_k is not None:
            raise NotImplementedError("speculative decoding is not ported")
        if window is not None:
            raise NotImplementedError("sliding-window serving is not ported")
        if not cfg.causal:
            raise ValueError(f"{cfg.name} is encoder-only: nothing to serve")
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg
        self.storage = storage
        self.device = storage["embed"].device
        self.plan = plan.broadcast(cfg.num_groups + 1)
        self.max_slots = int(max_slots)
        self.cache_capacity = int(cache_capacity)
        self.token_width = self.plan.host_device_policies()[0].token_wire_width(
            cfg.vocab_size
        )
        self.slots = SlotManager(self.max_slots)
        # page-table width: the capacity rounded up to whole pages
        self._table_width = -(-self.cache_capacity // self.page_size)
        self.num_pages = (
            int(num_pages) if num_pages is not None
            else self.max_slots * self._table_width
        )
        self.share_prefix = bool(share_prefix) and self.paged
        self.pages = PageAllocator(self.num_pages) if self.paged else None
        self._intern: dict[tuple, int] = {}  # prompt-prefix key -> page
        self._page_key: dict[int, tuple] = {}  # page -> interned key
        self._slot_pages: dict[int, list[int]] = {}  # slot -> page row
        self._buckets_seen: set[int] = set()  # the reference's compiled prefills
        self.step_log: list[dict] = []

        B = self.max_slots
        self._decode = make_decode_step(
            cfg, mesh_cfg, mesh, spec_tree, plan=self.plan,
            weight_stationary=weight_stationary, paged=self.paged,
        )
        # paged: a page-rounded prefill cache, so any padded bucket length
        # fits; the tail past the prompt's pages never reaches the pool
        self._prefill = make_prefill_step(
            cfg, mesh_cfg, mesh, spec_tree, plan=self.plan,
            cache_capacity=(self._table_width * self.page_size if self.paged
                            else self.cache_capacity),
        )
        self._weights = storage
        if weight_stationary:
            place = make_place_step(cfg, mesh_cfg, mesh, spec_tree, plan=self.plan)
            self._weights = place(storage)
        self._cache_dtype = self.plan.compute_dtype
        self._page_bytes = page_bytes(global_cache_shapes(
            cfg, mesh_cfg, B, self.cache_capacity, self._cache_dtype,
            paged_pages=self.num_pages, page_size=self.page_size,
        )) if self.paged else 0

        # streaming state (populated by begin_stream; run() wraps it)
        self._caches = None
        self._next_tok = np.zeros((B,), np.int32)
        self._pos_host = np.zeros((B,), np.int32)
        self._active: dict[int, _ReqState] = {}
        self._results: dict[int, GenResult] = {}
        self._step = 0
        self._rec: dict | None = None

    # -- device-side plumbing --------------------------------------------
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy ids of the last position, packed on the device and
        brought to the host: ``(width, B)`` u8 planes (the d2h crossing)."""
        tok = torch.argmax(logits[:, -1, : self.cfg.vocab_size], dim=-1)
        return pack_tokens(tok, self.token_width).cpu().numpy()

    def _insert(self, small, slot: int) -> None:
        """Batch-of-1 prefill caches -> slot ``slot`` of the engine caches,
        in place; the pos leaves are the one rank mismatch: ``(R,)`` from
        prefill against the engine's ``(R, B)``."""
        for big_g, small_g in zip(self._caches, small):
            for key, big in big_g.items():
                s = small_g[key]
                big.k[:, slot] = s.k[:, 0]
                big.v[:, slot] = s.v[:, 0]
                big.pos[:, slot] = s.pos

    def _insert_paged(self, small, slot: int, phys: torch.Tensor, start: int,
                      pos_val: int) -> None:
        """Scatter the prompt's freshly computed KV pages into the pools, in
        place, and stamp the slot's position. ``phys`` are the pool rows of
        the prompt's pages from ``start // page`` on: shared-prefix hits
        are already resident and immutable, so they are skipped and the
        first writer's bits stay authoritative."""
        n_new, page = phys.shape[0], self.page_size
        for big_g, small_g in zip(self._caches, small):
            for key, big in big_g.items():
                s = small_g[key]
                for b_leaf, s_leaf in ((big.k, s.k), (big.v, s.v)):
                    seg = s_leaf[:, 0, start:start + n_new * page]  # (R, n_new·page, ...)
                    b_leaf[:, phys] = seg.reshape(
                        s_leaf.shape[0], n_new, page, *s_leaf.shape[3:]
                    ).to(b_leaf.dtype)
                big.pos[:, slot] = pos_val

    def _init_caches(self):
        env = self.plan.make_env(self.mesh_cfg)
        if self.paged:
            return M.init_paged_caches(
                self.cfg, env, self.max_slots, self.num_pages, self.page_size,
                self._cache_dtype, device=self.device,
            )
        return M.init_caches(
            self.cfg, env, self.max_slots, self.cache_capacity, self._cache_dtype,
            per_slot=True, device=self.device,
        )

    def _validate(self, req: Request):
        require_greedy(req)
        if max(req.prompt_ids) >= self.cfg.vocab_size or min(req.prompt_ids) < 0:
            raise ValueError(f"request {req.rid}: prompt id out of vocab")
        need = len(req.prompt_ids) + req.max_new
        check_cache_geometry(
            self.cache_capacity, need, label=f"request {req.rid}: prompt+gen ",
        )
        if self.paged:
            need_pages = -(-need // self.page_size)
            if need_pages > self.num_pages:
                raise ValueError(
                    f"request {req.rid}: needs {need_pages} pages of "
                    f"{self.page_size}, the pool has {self.num_pages}"
                )

    # -- the streaming surface --------------------------------------------
    def begin_stream(self) -> None:
        """Reset the slot allocator, caches and accounting for a fresh
        stream (:meth:`run` calls this; a caller driving :meth:`admit` /
        :meth:`decode_tick` itself calls it once first)."""
        self.slots = SlotManager(self.max_slots)
        B = self.max_slots
        if self.paged:
            self.pages = PageAllocator(self.num_pages)
            self._intern, self._page_key, self._slot_pages = {}, {}, {}
            # host-side page table; index num_pages = the pool's trash row
            # (unused entries and retired slots' ballast writes land there)
            self._table = np.full((B, self._table_width), self.num_pages, np.int32)
        self._caches = None  # free the previous stream's caches first
        self._caches = self._init_caches()
        self._next_tok = np.zeros((B,), np.int32)  # per-slot feed tokens
        self._pos_host = np.zeros((B,), np.int32)  # absorbed-token counts
        self._active = {}
        self._results = {}
        self._step = 0
        self._rec = None
        self.step_log = []

    def _ensure_rec(self) -> dict:
        """The current step's record: admissions accumulate into it,
        :meth:`decode_tick` finalizes and appends it."""
        if self._rec is None:
            self._rec = {"step": self._step, "admitted": 0, "active": 0,
                         "decoded": 0, "host_device": 0}
            if self.paged:
                # kv_migration: the fleet's migration admission, not ported,
                # stays 0; kept so that the record equals the reference's
                self._rec.update(page_table=0, prefill_hits=0,
                                 prefill_misses=0, kv_migration=0)
        return self._rec

    @property
    def active_slots(self) -> int:
        return len(self._active)

    def _prompt_hits(self, req: Request) -> list[int]:
        """Resident shared-prefix pages for this prompt (the longest run of
        interned whole-prompt pages)."""
        hits: list[int] = []
        if self.share_prefix:
            page = self.page_size
            for i in range(len(req.prompt_ids) // page):
                pid = self._intern.get(req.prompt_ids[:(i + 1) * page])
                if pid is None:
                    break
                hits.append(pid)
        return hits

    def can_admit(self, req: Request) -> tuple[bool, list[int]]:
        """Admission probe: a free slot and (paged) enough free pages once
        shared-prefix hits are discounted. Returns ``(ok, hits)``."""
        hits = self._prompt_hits(req)
        if not self.slots.free_slots:
            return False, hits
        if self.paged:
            need = -(-(len(req.prompt_ids) + req.max_new) // self.page_size)
            if need - len(hits) > self.pages.free_pages:
                return False, hits
        return True, hits

    def _alloc_residency(self, req: Request, hits: list[int]):
        """The request's slot and (paged) page row: retain the hit pages,
        allocate the rest, intern the new whole-prompt pages and stamp the
        host page table."""
        S = len(req.prompt_ids)
        slot = self.slots.alloc(req.rid)
        row: list[int] = []
        if self.paged:
            page = self.page_size
            need = -(-(S + req.max_new) // page)
            for pid in hits:
                self.pages.retain(pid)
            row = hits + self.pages.alloc(need - len(hits))
            if self.share_prefix:
                for i in range(len(hits), S // page):  # whole-prompt pages
                    key = req.prompt_ids[:(i + 1) * page]
                    self._intern[key] = row[i]
                    self._page_key[row[i]] = key
            self._slot_pages[slot] = list(row)
            self._table[slot, :] = self.num_pages  # trash
            self._table[slot, :len(row)] = row
        return slot, row

    def _finish_admission(self, req: Request, slot: int, first: int, rec: dict) -> None:
        st = _ReqState(req, slot, self._step)
        self._next_tok[slot] = first
        self._pos_host[slot] = len(req.prompt_ids)
        rec["admitted"] += 1
        if st.emit(first):
            self._results[req.rid] = self._retire(st, self._step)
        else:
            self._active[slot] = st

    def admit(self, req: Request) -> None:
        """Prefill admission of one request (between decode steps). Raises
        :class:`CapacityError` when :meth:`can_admit` says no."""
        ok, hits = self.can_admit(req)
        if not ok:
            raise CapacityError(f"request {req.rid}: no free slot/pages for admission")
        self._validate(req)
        rec = self._ensure_rec()
        S, page = len(req.prompt_ids), self.page_size
        slot, row = self._alloc_residency(req, hits)
        planes = pack_tokens_host(
            np.asarray(req.prompt_ids, np.int32)[None, :], self.token_width
        )  # (w, 1, S) — h2d prompt staging (true length, no pads)
        rec["host_device"] += planes.nbytes
        tokens_dev = unpack_tokens(stage(planes, self.device))
        if self.paged:
            # pad on the device to whole pages (causal-safe for the
            # attention-only pattern, the one ported); logits are read at S - 1
            Spad = -(-S // page) * page
            rec["prefill_hits" if Spad in self._buckets_seen else "prefill_misses"] += 1
            self._buckets_seen.add(Spad)
            tokens_dev = torch.nn.functional.pad(tokens_dev, (0, Spad - S))
            logits, pcaches = self._prefill(self.storage,
                                            {"tokens": tokens_dev, "last": S - 1})
            phys = torch.tensor(row[len(hits):-(-S // page)], dtype=torch.int64,
                                device=self.device)
            self._insert_paged(pcaches, slot, phys, len(hits) * page, S)
        else:
            logits, pcaches = self._prefill(self.storage, {"tokens": tokens_dev})
            self._insert(pcaches, slot)
        del pcaches
        tok_planes = self._sample(logits)  # (w, 1) — d2h first id
        rec["host_device"] += tok_planes.nbytes
        first = int(unpack_tokens_host(tok_planes)[0])
        self._finish_admission(req, slot, first, rec)

    def decode_tick(self) -> None:
        """One engine step: one batched decode when any slot is active,
        then finalize the step record (idle steps append a zero-decode
        record)."""
        rec = self._ensure_rec()
        rec["active"] = len(self._active)
        if self._active:
            feed_planes = pack_tokens_host(self._next_tok[:, None], self.token_width)
            rec["host_device"] += feed_planes.nbytes  # h2d token staging (w, B, 1)
            tokens_dev = unpack_tokens(stage(feed_planes, self.device))
            batch = {"tokens": tokens_dev, "pos": stage(self._pos_host, self.device)}
            if self.paged:
                # the page table is scheduler state staged fresh each step
                # (retires and admissions edit the host copy between steps)
                rec["host_device"] += self._table.nbytes
                rec["page_table"] += self._table.nbytes
                batch["page_table"] = stage(self._table, self.device)
            logits, self._caches = self._decode(self._weights, self._caches, batch)
            out_planes = self._sample(logits)  # (w, B) — d2h sampled ids
            rec["host_device"] += out_planes.nbytes
            sampled = unpack_tokens_host(out_planes)
            self._pos_host += 1  # mirrors cache.pos + 1 (ballast slots too)
            rec["decoded"] = len(self._active)
            for slot, st in list(self._active.items()):
                tok = int(sampled[slot])
                self._next_tok[slot] = tok
                if st.emit(tok):
                    self._results[st.req.rid] = self._retire(st, self._step)
                    del self._active[slot]
        self.step_log.append(rec)
        self._step += 1
        self._rec = None

    def finish(self) -> dict[int, GenResult]:
        """End-of-stream conservation audits; returns completed results."""
        self.slots.audit()
        if self.paged:
            audit = self.pages.audit()
            if audit["live"] or self._intern or self._slot_pages:
                raise InvariantError("page leak after drain")
        return self._results

    def run(self, requests, *, max_steps: int = 1_000_000) -> dict[int, GenResult]:
        """Drain ``requests`` (admission in list order) to completion.

        Returns ``{rid: GenResult}``. Appends one record per engine step to
        :attr:`step_log`: ``{"step", "admitted", "active", "decoded",
        "host_device"}`` — ``host_device`` is the measured staged byte
        count (``planes.nbytes`` over every boundary crossing that step)."""
        requests = list(requests)
        if len({r.rid for r in requests}) != len(requests):
            raise ValueError("duplicate request ids")
        for r in requests:
            self._validate(r)
        self.begin_stream()
        queue = collections.deque(requests)
        while (queue or self._active) and self._step < max_steps:
            # admission fills free slots between decode steps (FIFO: the
            # head of the line waits for slots / pages to free)
            while queue and self.can_admit(queue[0])[0]:
                self.admit(queue.popleft())
            self.decode_tick()
        if queue or self._active:
            raise CapacityError(f"engine stopped at max_steps={max_steps} "
                                f"with {len(queue) + len(self._active)} unfinished")
        return self.finish()

    def _retire(self, st: _ReqState, step: int) -> GenResult:
        self.slots.release(st.slot)
        if self.paged:
            for pid in self._slot_pages.pop(st.slot):
                if self.pages.release(pid):
                    # last holder gone: an interned prefix page dies with it
                    key = self._page_key.pop(pid, None)
                    if key is not None:
                        del self._intern[key]
            self._table[st.slot, :] = self.num_pages  # ballast -> trash
        return GenResult(
            rid=st.req.rid,
            prompt_len=len(st.req.prompt_ids),
            tokens=list(st.tokens),
            admitted_step=st.admitted_step,
            finished_step=step,
        )

    # -- accounting ---------------------------------------------------------
    def wire_summary(self) -> dict:
        """Aggregate of :attr:`step_log` in the shape the analytic serve-wire
        model (:func:`repro_torch.roofline.analysis.serve_host_device_bytes`)
        reproduces."""
        out = {
            "host_device": sum(r["host_device"] for r in self.step_log),
            "decode_steps": sum(1 for r in self.step_log if r["decoded"]),
            "admissions": sum(r["admitted"] for r in self.step_log),
            "steps": len(self.step_log),
            "token_width": self.token_width,
        }
        if self.paged:
            for key in ("page_table", "prefill_hits", "prefill_misses"):
                out[key] = sum(r[key] for r in self.step_log)
            out["page_table_entries"] = self.max_slots * self._table_width
        return out

    def kv_residency(self) -> dict:
        """Measured page-granular KV residency, the counterpart of the
        analytic :func:`repro_torch.roofline.analysis.serve_paged_kv_bytes`;
        ``bytes_per_page`` sums every pool's per-page bytes over layers."""
        if not self.paged:
            raise ValueError("kv_residency is defined for the paged engine (paged=True)")
        live, peak = self.pages.live_pages, self.pages.peak
        return {
            "pages_live": live,
            "pages_peak": peak,
            "page_size": self.page_size,
            "bytes_per_page": self._page_bytes,
            "kv_bytes_resident": live * self._page_bytes,
            "kv_bytes_peak": peak * self._page_bytes,
        }


# ---------------------------------------------------------------------------
# static one-shot reference path
# ---------------------------------------------------------------------------


def generate_static(
    cfg: ModelConfig,
    mesh_cfg: MeshCfg,
    mesh,
    spec_tree,
    storage,
    requests,
    *,
    plan: PrecisionPlan,
    window: int | None = None,
) -> dict[int, list[int]]:
    """Classic static batching, the engine's reference: requests are
    grouped by prompt length, each group runs one batched prefill and a
    scalar-``pos`` greedy decode loop to the group's longest request;
    per-request stop conditions truncate the streams afterwards."""
    if window is not None:
        raise NotImplementedError("sliding-window serving is not ported")
    for r in requests:
        require_greedy(r)
    plan = plan.broadcast(cfg.num_groups + 1)
    device = storage["embed"].device
    groups: dict[int, list[Request]] = {}
    for r in requests:
        groups.setdefault(len(r.prompt_ids), []).append(r)
    out: dict[int, list[int]] = {}
    for S, reqs in groups.items():
        gen = max(r.max_new for r in reqs)
        prefill = make_prefill_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan,
                                    cache_capacity=S + gen)
        decode = make_decode_step(cfg, mesh_cfg, mesh, spec_tree, plan=plan)
        toks = torch.tensor([r.prompt_ids for r in reqs], dtype=torch.int32, device=device)
        logits, caches = prefill(storage, {"tokens": toks})
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
        streams = [tok.cpu().numpy()[:, 0]]
        for i in range(gen - 1):
            pos = torch.tensor(S + i, dtype=torch.int32, device=device)
            logits, caches = decode(storage, caches, {"tokens": tok, "pos": pos})
            tok = torch.argmax(logits[:, 0, : cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
            streams.append(tok.cpu().numpy()[:, 0])
        del caches
        mat = np.stack(streams, axis=1)  # (B, gen)
        for b, r in enumerate(reqs):
            ids = mat[b].tolist()[: r.max_new]
            if r.eos_id is not None and r.eos_id in ids:
                ids = ids[: ids.index(r.eos_id) + 1]
            out[r.rid] = ids
    return out
