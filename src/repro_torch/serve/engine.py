"""Continuous-batching serve engine (counterpart of ``repro.serve.engine``).

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

Determinism contract: slots are independent, and a request's n-th
emitted id is the argmax of its logits (greedy) or the sampler's draw
under the key ``fold_in(PRNGKey(seed), n)``
(:mod:`repro_torch.serve.sampling`, row by row), so a request's token
stream is a function of its prompt and :class:`SamplingParams` alone, and
equals the static one-shot reference (:func:`generate_static`) for the
same requests. A MoE model keeps the contract per request only: its
capacity dispatch ranks a whole batch's tokens per expert, so its engine
is held to a static run made request by request (the serve launcher
makes it so), and a decode batch whose ``max_slots · top_k`` passes the
capacity floor of 8 may drop a congested expert's tokens and couple slots
(:class:`CapacityWarning` at construction). ``plan.int8_kv`` keeps the
KV caches in int8 with fp32 scales (either layout); ``window`` gives the contiguous layout a sliding
window, whose caches ring when ``cache_capacity <= window``.

``draft=`` (a :class:`~repro_torch.serve.spec.DraftBundle`) adds
speculative decoding: each decode step becomes a round in which the draft
proposes ``spec_k`` ids a slot and one ``(slots, spec_k + 1)`` verify
step of the target keeps the longest prefix it reproduces
(:meth:`ServeEngine._spec_tick`); streams equal the non-speculative
engine's, and ``wire_summary`` adds the rounds, the acceptance rate and
the tokens a target step.

``paged=True`` swaps the contiguous slotted layout for the block-paged
KV cache: fixed-size pages in one pool
(:func:`repro_torch.models.model.init_paged_caches`), a host-side per-slot
page table staged every decode step, a refcounted
:class:`PageAllocator` (the page-granular twin of :class:`SlotManager`),
shared-prefix page interning (a common prompt prefix is resident once)
and prompts padded to whole pages before prefill. Streams equal the
contiguous engine's and :func:`generate_static`'s. A MoE model's prompts
are neither padded nor share prefix pages, as in the reference: the
capacity ranking sees the whole sequence, pads included, so position i
depends on more than the tokens up to i.

On a mesh (``mesh`` from ``launch.mesh.make_mesh_from_cfg``; every rank a
process running this same engine on its TP slice) the decode step shards
the slots over the data ranks by the reference's rule (never when paged;
else when ``max_slots`` splits over ``dshards``), and admission prefills
run replicated (``shard_batch=False``): each data rank inserts a
prompt's caches only into the slot it owns, and the page pool holds the
rank's kv heads behind one host page table. Every step returns the
gathered global logits on every rank, so every rank samples the same
ids and runs the same host loop: admissions, retirements, page
allocations and the collectives they issue are identical and in the same
order on all ranks. :attr:`ServeEngine.wire_log` records each forward's
collectives per traffic class (``dist.comm``'s log; a speculative
engine's draft forwards too, kinds ``draft_prefill`` and
``draft_decode``) and
:attr:`ServeEngine.place_wire` the placement's.

Speculative decoding and sliding windows run on any mesh, as the
reference's: the draft on the target's mesh, ring caches at the rank's kv
heads.

The streaming surface (:meth:`ServeEngine.begin_stream`, :meth:`~ServeEngine.admit`,
:meth:`~ServeEngine.admit_pages`, :meth:`~ServeEngine.decode_tick`,
:meth:`~ServeEngine.take_completed`, :meth:`~ServeEngine.swap_weights`) is
what the fleet router (:mod:`repro_torch.fleet`) drives:
``admit_pages`` installs KV pages a prefill worker computed and shipped
through the fabric instead of running a local prefill (bit-equal to a
local paged admission), and ``swap_weights`` hot-swaps the weight tree
between steps. Migration admission runs on one device only (the fleet
at tp > 1 is ROADMAP item 10b). The reference compiles one
prefill per prompt length (per page-bucket length when paged); PyTorch
runs eagerly, so one prefill step serves every length. The paged engine still counts bucket lengths seen before
(``prefill_hits``) and not (``prefill_misses``), as the reference counts
its compiles, so that ``wire_summary`` equals the reference's.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import comm
from repro_torch.dist.spec import MeshCfg, mesh_coords
from repro_torch.models.attention import PAGED, check_cache_geometry, leaves
from repro_torch.models.model import RECURRENT_STATES
from repro_torch.plan import PrecisionPlan
from repro_torch.serve.api import Request, SamplingParams
from repro_torch.serve.sampling import sample_tokens, seed_words
from repro_torch.serve.spec import (
    DraftBundle,
    DraftRunner,
    check_spec_arch,
    insert_slot,
    rollback_caches,
)
from repro_torch.serve.step import (
    global_cache_shapes,
    init_serve_caches,
    make_decode_step,
    make_place_step,
    make_prefill_step,
    make_verify_step,
    serve_wire_table,
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
    "CapacityWarning",
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


class CapacityWarning(UserWarning):
    """A configuration passes a soft capacity floor (the MoE dispatch
    capacity at engine construction): decode may couple slots and break the
    per-request determinism contract. Typed, so that callers and tests
    filter or assert it rather than match a string."""


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
    repetitions × K/V, and the scale planes of int8 pools). Works on the
    ``global_cache_shapes`` tree of meta tensors or on live caches (the
    reference's ``_page_pool_bytes``)."""
    per_page = 0
    for group in caches:
        for node in group.values():
            if isinstance(node, PAGED):
                for leaf in leaves(node):  # stacked (R, P, page, ...)
                    per_page += leaf.numel() * leaf.element_size() // leaf.shape[1]
    return per_page


def sample_packed(logits: torch.Tensor, vocab: int, width: int, sampling=None) -> np.ndarray:
    """Ids of the last position, packed on the device and brought to the
    host: ``(width, B)`` u8 planes (the d2h crossing). Greedy argmax when
    ``sampling`` is None, else :func:`~repro_torch.serve.sampling.sample_tokens`
    with ``sampling = (temperature, top_p, top_k, seed, step)`` a row each.
    The engine's sampler, and the fleet's prefill worker's for the first
    id."""
    if sampling is None:
        tok = torch.argmax(logits[:, -1, :vocab], dim=-1)
    else:
        tok = sample_tokens(logits[:, -1], vocab, *sampling)
    return pack_tokens(tok, width).cpu().numpy()


def first_sampling(s: SamplingParams):
    """``sample_packed``'s ``sampling`` for a request's first id (emitted
    index 0): None (the argmax) when greedy."""
    return None if s.greedy else ([s.temperature], [s.top_p], [s.top_k], [s.seed], [0])


class ServeEngine:
    """Continuous-batching driver over ``make_prefill_step`` /
    ``make_decode_step`` (see the module docstring).

    ``storage`` is the weight tree (``tree_to_storage``); its device is
    the engine's device. ``plan`` drives every precision choice including
    the ``host_device`` staging entry. ``cache_capacity`` caps
    ``prompt_len + max_new`` per request (validated at submit).
    ``paged=True`` selects the paged layout: ``page_size`` tokens a page,
    ``num_pages`` allocatable pages (default ``max_slots`` × the table
    width, ``ceil((cache_capacity + spec_k) / page_size)``, ``spec_k``
    only with a draft), ``share_prefix`` interning of whole prompt pages.
    ``window`` is the decode's sliding window (contiguous layout);
    ``draft`` a :class:`~repro_torch.serve.spec.DraftBundle` (on the
    engine's mesh) for speculative decoding with ``spec_k`` proposals a
    round (default the plan's)."""

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
        draft: DraftBundle | None = None,
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
        if not cfg.causal:
            raise ValueError(f"{cfg.name} is encoder-only: nothing to serve")
        if cfg.num_image_tokens or cfg.embed_is_input_stub:
            raise ValueError(
                f"{cfg.name}: the serve engine stages token payloads only "
                "(no image/feature requests)"
            )
        if cfg.num_experts and max_slots * cfg.top_k > 8:
            warnings.warn(
                f"{cfg.name}: max_slots={max_slots} x top_k={cfg.top_k} "
                "exceeds the MoE dispatch capacity floor (8) — congested "
                "experts may drop ranked decode tokens, coupling slots "
                "(see the determinism contract in repro_torch.serve.engine)",
                CapacityWarning,
                stacklevel=2,
            )
        self.cfg = cfg
        self.mesh_cfg = mesh_cfg
        self.mesh = mesh
        self.spec_tree = spec_tree
        self.storage = storage
        self.device = storage["embed"].device
        self.plan = plan.broadcast(cfg.num_groups + 1)
        self.max_slots = int(max_slots)
        self.cache_capacity = int(cache_capacity)
        self.window = window
        self.spec_k = int(spec_k) if spec_k is not None else self.plan.spec_k
        if draft is not None:
            check_spec_arch(cfg, window=window)
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if draft.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft.cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size} — draft ids must be target ids"
                )
        self.token_width = self.plan.host_device_policies()[0].token_wire_width(
            cfg.vocab_size
        )
        self.slots = SlotManager(self.max_slots)
        # page-table width: the capacity rounded up to whole pages; under
        # speculative decoding the verify block can write up to spec_k
        # positions past a finished stream, so the table is widened until
        # such writes land in trash entries, never a live page
        spec_pad = self.spec_k if draft is not None else 0
        self._table_width = -(-(self.cache_capacity + spec_pad) // self.page_size)
        self.num_pages = (
            int(num_pages) if num_pages is not None
            else self.max_slots * self._table_width
        )
        # page-bucketed (padded) prompts are exact only for pure-attention
        # patterns, and shared prefix pages only when position i depends on
        # tokens <= i alone: the MoE capacity dispatch ranks tokens across
        # the whole sequence, and a recurrent state absorbs pad positions
        self._bucket = (self.paged and not cfg.num_experts
                        and all(k == "attn" for k in cfg.pattern))
        self.share_prefix = bool(share_prefix) and self.paged and not cfg.num_experts
        self.pages = PageAllocator(self.num_pages) if self.paged else None
        self._intern: dict[tuple, int] = {}  # prompt-prefix key -> page
        self._page_key: dict[int, tuple] = {}  # page -> interned key
        self._slot_pages: dict[int, list[int]] = {}  # slot -> page row
        self._buckets_seen: set[int] = set()  # the reference's compiled prefills
        self.step_log: list[dict] = []
        self.wire_log: list[dict] = []

        B = self.max_slots
        self._shard_batch = (
            not self.paged  # the page pool has no batch dim to shard
            and mesh_cfg.dshards > 1 and B % mesh_cfg.dshards == 0
        )
        self._decode = make_decode_step(
            cfg, mesh_cfg, mesh, spec_tree, plan=self.plan, shard_batch=self._shard_batch,
            window_override=window, weight_stationary=weight_stationary, paged=self.paged,
        )
        self._prefills: dict[bool, object] = {}  # by seq_parallel (_prefill_for)
        self._weights = storage
        self.weight_stationary = bool(weight_stationary)
        self.place_wire: dict[str, int] = {}
        self._place = None
        if weight_stationary:
            self._place = make_place_step(cfg, mesh_cfg, mesh, spec_tree, plan=self.plan)
            first = len(comm.LOG)
            self._weights = self._place(storage)
            self.place_wire = comm.wire_by_traffic(comm.LOG[first:])
        self._cache_dtype = self.plan.compute_dtype
        self._page_bytes = page_bytes(global_cache_shapes(
            cfg, mesh_cfg, B, self.cache_capacity, self._cache_dtype, shard_batch=False,
            int8_kv=self.plan.int8_kv, paged_pages=self.num_pages, page_size=self.page_size,
        )) if self.paged else 0
        self.draft = None
        self._verify = None
        if draft is not None:
            self._verify = make_verify_step(
                cfg, mesh_cfg, mesh, spec_tree, plan=self.plan, shard_batch=self._shard_batch,
                weight_stationary=weight_stationary, paged=self.paged,
            )
            # the draft keeps contiguous per-slot caches with spec_k spare
            # positions (its last micro step absorbs the last proposal
            # before the rollback)
            self.draft = DraftRunner(
                draft, mesh_cfg, mesh, plan=self.plan, max_slots=B,
                capacity=self.cache_capacity + self.spec_k, spec_k=self.spec_k,
                token_width=self.token_width, device=self.device, log_wire=self._log_wire,
            )

        # streaming state (populated by begin_stream; run() wraps it)
        self._caches = None
        self._next_tok = np.zeros((B,), np.int32)
        self._pos_host = np.zeros((B,), np.int32)
        self._active: dict[int, _ReqState] = {}
        self._results: dict[int, GenResult] = {}
        self._step = 0
        self._rec: dict | None = None
        self._reset_sampling_state()

    def _reset_sampling_state(self) -> None:
        """Per-slot :class:`SamplingParams` mirrors fed to the sampler.
        Ballast rows (free or retired slots) are greedy with seed 0: their
        draws are discarded, and the sampler's rows do not touch each
        other."""
        B = self.max_slots
        self._temp = np.zeros((B,), np.float32)
        self._top_p = np.ones((B,), np.float32)
        self._top_k = np.zeros((B,), np.int32)
        self._seed = np.zeros((B,), np.uint32)
        self._nemit = np.zeros((B,), np.int32)  # emitted-token counts

    def _set_sampling_slot(self, slot: int, s: SamplingParams) -> None:
        self._temp[slot] = s.temperature
        self._top_p[slot] = s.top_p
        self._top_k[slot] = s.top_k
        self._seed[slot] = seed_words(s.seed)  # a uint32, as the reference's key takes it
        self._nemit[slot] = 0

    def _clear_sampling_slot(self, slot: int) -> None:
        self._set_sampling_slot(slot, SamplingParams())

    # -- device-side plumbing --------------------------------------------
    def _sample(self, logits: torch.Tensor, sampling=None) -> np.ndarray:
        """:func:`sample_packed` at the engine's vocabulary and token width."""
        return sample_packed(logits, self.cfg.vocab_size, self.token_width, sampling)

    def _verify_sample(self, logits: torch.Tensor) -> np.ndarray:
        """``(width, B, T)`` planes of the target's samples over the verify
        block: block position j is the candidate of emitted index
        ``nemit + j`` and is keyed so, the keys of T successive decode
        steps (greedy rows take the argmax)."""
        T = logits.shape[1]

        def bt(a):
            return np.repeat(a[:, None], T, axis=1)

        steps = self._nemit[:, None] + np.arange(T, dtype=np.int32)
        tok = sample_tokens(logits, self.cfg.vocab_size, bt(self._temp), bt(self._top_p),
                            bt(self._top_k), bt(self._seed), steps)
        return pack_tokens(tok, self.token_width).cpu().numpy()

    def _prefill_for(self, S: int):
        """The admission prefill for a prompt of ``S`` tokens (padded, when
        paged), replicated over the data ranks, with the reference's plan
        fallbacks: a paged prompt reads its logits at ``last``, which needs
        the replicated layout, and a length the model group does not divide
        takes the psum layout (bit-equal to the sequence-parallel one)."""
        plan = self.plan
        if self.paged or (plan.seq_parallel and S % self.mesh_cfg.tp):
            plan = dataclasses.replace(plan, seq_parallel=False)
        if plan.seq_parallel not in self._prefills:
            # paged: a page-rounded prefill cache, so any padded bucket length
            # fits; the tail past the prompt's pages never reaches the pool
            self._prefills[plan.seq_parallel] = make_prefill_step(
                self.cfg, self.mesh_cfg, self.mesh, self.spec_tree, plan=plan,
                cache_capacity=(self._table_width * self.page_size if self.paged
                                else self.cache_capacity),
                shard_batch=False, window_override=self.window,
            )
        return self._prefills[plan.seq_parallel], plan.seq_parallel

    def _log_wire(self, kind: str, tokens: int, first: int, **extra) -> None:
        self.wire_log.append({"step": self._step, "kind": kind, "tokens": tokens, **extra,
                              "wire": comm.wire_by_traffic(comm.LOG[first:])})

    def _insert(self, small, slot: int) -> None:
        """Batch-of-1 prefill caches -> slot ``slot`` of the engine caches,
        in place; the pos leaves are the one rank mismatch: ``(R,)`` from
        prefill against the engine's ``(R, B)``. With the slots sharded over
        the data ranks, only the rank that owns the slot writes it, into
        its local row."""
        if self._shard_batch:
            per = self.max_slots // self.mesh_cfg.dshards
            if slot // per != mesh_coords(self.mesh_cfg, dist.get_rank())[0]:
                return
            slot %= per
        insert_slot(self._caches, small, slot)

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
                if isinstance(big, RECURRENT_STATES):  # slotted state: the slot insert
                    insert_slot([{key: big}], [{key: s}], slot)
                    continue
                for b_leaf, s_leaf in zip(leaves(big), leaves(s)):
                    seg = s_leaf[:, 0, start:start + n_new * page]  # (R, n_new·page, ...)
                    b_leaf[:, phys] = seg.reshape(
                        s_leaf.shape[0], n_new, page, *s_leaf.shape[3:]
                    ).to(b_leaf.dtype)
                big.pos[:, slot] = pos_val

    def _install_pages(self, pages, slot: int, phys: torch.Tensor, pos_val: int) -> None:
        """Scatter migrated pool pages (a worker's export, already at pool
        dtype and sliced as :meth:`_insert_paged` slices a prefill) into
        the pools, in place, and stamp the slot's position as the local
        insert does. ``pages`` is per group, per cache node, ``{"k", "v"(,
        "k_scale", "v_scale")}`` tensors ``(R, n_new, page, ...)``."""
        for big_g, pg in zip(self._caches, pages):
            for key, big in big_g.items():
                if not isinstance(big, PAGED):
                    raise TypeError("migrated admission covers paged pools only "
                                    f"(got {type(big).__name__})")
                names = ("k", "v", "k_scale", "v_scale")[:len(leaves(big))]
                for name, b_leaf in zip(names, leaves(big)):
                    src = pg[key][name]
                    want = (b_leaf.shape[0], phys.shape[0], *b_leaf.shape[2:])
                    if tuple(src.shape) != want or src.dtype != b_leaf.dtype:
                        raise ValueError(
                            f"migrated pages {key}/{name}: {tuple(src.shape)} {src.dtype}, "
                            f"the pool takes {want} {b_leaf.dtype}")
                    b_leaf[:, phys] = src.to(self.device)
                big.pos[:, slot] = pos_val

    def _init_caches(self):
        return init_serve_caches(
            self.cfg, self.mesh_cfg, self.max_slots, self.cache_capacity,
            self._cache_dtype, shard_batch=self._shard_batch, per_slot=True,
            int8_kv=self.plan.int8_kv,
            paged_pages=self.num_pages if self.paged else None, page_size=self.page_size,
            device=self.device,
        )

    def _validate(self, req: Request):
        if max(req.prompt_ids) >= self.cfg.vocab_size or min(req.prompt_ids) < 0:
            raise ValueError(f"request {req.rid}: prompt id out of vocab")
        need = len(req.prompt_ids) + req.max_new
        # the geometry rules live with the cache constructors: a linear
        # cache holds the request; rings only at capacity <= window
        check_cache_geometry(
            self.cache_capacity, self.window, need, label=f"request {req.rid}: prompt+gen ",
        )
        if self.paged:
            need_pages = -(-need // self.page_size)
            if need_pages > self.num_pages:
                raise ValueError(
                    f"request {req.rid}: needs {need_pages} pages of "
                    f"{self.page_size}, the pool has {self.num_pages}"
                )

    def validate_request(self, req: Request) -> None:
        """The admission geometry checks :meth:`run` applies up front (the
        fleet router's submit path)."""
        self._validate(req)

    # -- the streaming surface --------------------------------------------
    def begin_stream(self) -> None:
        """Reset the slot allocator, caches and accounting for a fresh
        stream (:meth:`run` calls this; a caller driving :meth:`admit` /
        :meth:`admit_pages` / :meth:`decode_tick` itself, as the fleet
        router does, calls it once first)."""
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
        self._reset_sampling_state()
        if self.draft is not None:
            self.draft.reset()
        self._active = {}
        self._results = {}
        self._step = 0
        self._rec = None
        self.step_log = []
        self.wire_log = []

    def _ensure_rec(self) -> dict:
        """The current step's record: admissions accumulate into it,
        :meth:`decode_tick` finalizes and appends it."""
        if self._rec is None:
            self._rec = {"step": self._step, "admitted": 0, "active": 0,
                         "decoded": 0, "host_device": 0}
            if self.paged:
                # kv_migration: the wire bytes of migrated parcels
                # (admit_pages), never host_device
                self._rec.update(page_table=0, prefill_hits=0,
                                 prefill_misses=0, kv_migration=0)
            if self.draft is not None:
                self._rec.update(spec_rounds=0, spec_proposed=0,
                                 spec_accepted=0, spec_emitted=0)
        return self._rec

    @property
    def has_work(self) -> bool:
        return bool(self._active)

    @property
    def active_slots(self) -> int:
        return len(self._active)

    @property
    def pending_record(self) -> bool:
        """True when admissions accumulated into a step record that no
        :meth:`decode_tick` has finalized yet."""
        return self._rec is not None

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
        self._set_sampling_slot(slot, req.sampling)
        self._nemit[slot] = 1  # the prefill's id is emitted index 0
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
        # the reference raises OverflowError for a seed outside [0, 2**32)
        # once the slot and the prefill are spent; here before either is
        seed_words(req.sampling.seed)
        rec = self._ensure_rec()
        S, page = len(req.prompt_ids), self.page_size
        slot, row = self._alloc_residency(req, hits)
        planes = pack_tokens_host(
            np.asarray(req.prompt_ids, np.int32)[None, :], self.token_width
        )  # (w, 1, S) — h2d prompt staging (true length, no pads)
        rec["host_device"] += planes.nbytes
        tokens_dev = unpack_tokens(stage(planes, self.device))
        if self.draft is not None:
            # the draft mirrors the slot from the same staged prompt: one
            # priced h2d crossing covers both prefills
            self.draft.prefill_insert(tokens_dev, slot)
        first_call = len(comm.LOG)
        if self.paged:
            # pad on the device to whole pages (causal-safe for the
            # attention-only pattern without experts); logits are read at S - 1
            # (a recurrent pattern's prompt is never padded)
            Spad = -(-S // page) * page if self._bucket else S
            rec["prefill_hits" if Spad in self._buckets_seen else "prefill_misses"] += 1
            self._buckets_seen.add(Spad)
            if Spad > S:
                tokens_dev = torch.nn.functional.pad(tokens_dev, (0, Spad - S))
            prefill, seq = self._prefill_for(Spad)
            logits, pcaches = prefill(self.storage, {"tokens": tokens_dev, "last": S - 1})
            phys = torch.tensor(row[len(hits):-(-S // page)], dtype=torch.int64,
                                device=self.device)
            self._insert_paged(pcaches, slot, phys, len(hits) * page, S)
        else:
            prefill, seq = self._prefill_for(S)
            logits, pcaches = prefill(self.storage, {"tokens": tokens_dev})
            self._insert(pcaches, slot)
        self._log_wire("prefill", tokens_dev.shape[1], first_call, seq_parallel=seq)
        del pcaches
        tok_planes = self._sample(logits, first_sampling(req.sampling))  # (w, 1) — d2h first id
        rec["host_device"] += tok_planes.nbytes
        first = int(unpack_tokens_host(tok_planes)[0])
        self._finish_admission(req, slot, first, rec)

    def admit_pages(self, req: Request, pages, *, n_hits: int, first_tok: int,
                    wire_bytes: int = 0) -> None:
        """Migration admission: install KV pages a prefill worker computed
        (``pages``, the unpacked parcel: prompt pages ``[n_hits,
        prompt_pages)``, see :meth:`_install_pages`) and its first id
        ``first_tok`` instead of a local prefill; bit-equal to
        :meth:`admit`, since the worker runs the same prefill. The parcel's
        ``wire_bytes`` land in the step record's ``kv_migration``, not
        ``host_device``. With a draft, the draft prefills locally from the
        prompt staged h2d (priced)."""
        if not self.paged:
            raise ValueError("admit_pages needs the paged engine (paged=True)")
        if not self.mesh_cfg.trivial:
            raise NotImplementedError("migration admission on a mesh is not ported "
                                      "(the fleet at tp > 1, ROADMAP item 10b)")
        ok, hits = self.can_admit(req)
        if not ok:
            raise CapacityError(f"request {req.rid}: no free slot/pages for migration admission")
        if len(hits) != int(n_hits):
            raise AllocatorError(
                f"request {req.rid}: parcel skipped {n_hits} prefix pages but {len(hits)} are "
                "resident — probe and admit must see the same intern table")
        self._validate(req)
        seed_words(req.sampling.seed)
        rec = self._ensure_rec()
        S, page = len(req.prompt_ids), self.page_size
        slot, row = self._alloc_residency(req, hits)
        phys = torch.tensor(row[len(hits):-(-S // page)], dtype=torch.int64, device=self.device)
        rec["kv_migration"] += int(wire_bytes)
        self._install_pages(pages, slot, phys, S)
        if self.draft is not None:
            # migration ships the target's KV, not tokens: the draft prefills
            # locally, so the prompt crosses h2d here (priced)
            planes = pack_tokens_host(np.asarray(req.prompt_ids, np.int32)[None, :],
                                      self.token_width)
            rec["host_device"] += planes.nbytes
            self.draft.prefill_insert(unpack_tokens(stage(planes, self.device)), slot)
        self._finish_admission(req, slot, int(first_tok), rec)

    def decode_tick(self) -> None:
        """One engine step: one batched decode when any slot is active,
        then finalize the step record (idle steps append a zero-decode
        record)."""
        rec = self._ensure_rec()
        rec["active"] = len(self._active)
        if self._active and self.draft is not None:
            self._spec_tick(rec)
        elif self._active:
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
            first_call = len(comm.LOG)
            logits, self._caches = self._decode(self._weights, self._caches, batch)
            self._log_wire("decode", 1, first_call)
            sampling = None  # all greedy: the argmax
            if any(not st.req.sampling.greedy for st in self._active.values()):
                sampling = (self._temp, self._top_p, self._top_k, self._seed, self._nemit)
            out_planes = self._sample(logits, sampling)  # (w, B) — d2h sampled ids
            rec["host_device"] += out_planes.nbytes
            sampled = unpack_tokens_host(out_planes)
            self._pos_host += 1  # mirrors cache.pos + 1 (ballast slots too)
            rec["decoded"] = len(self._active)
            for slot, st in list(self._active.items()):
                tok = int(sampled[slot])
                self._next_tok[slot] = tok
                self._nemit[slot] += 1
                if st.emit(tok):
                    self._results[st.req.rid] = self._retire(st, self._step)
                    del self._active[slot]
        self.step_log.append(rec)
        self._step += 1
        self._rec = None

    def _spec_tick(self, rec: dict) -> None:
        """One speculative round: the draft proposes ``spec_k`` ids a slot,
        the target verifies all ``k + 1`` block positions in ONE batched
        step, and the engine keeps the longest prefix the draft reproduced
        plus the target's own sample at the first divergence. Every
        emitted id is the target's sample under its request's key, so the
        streams are the non-speculative engine's.

        Both target and draft advance ``pos`` by ``k + 1`` in their steps;
        rejected positions are rolled back by re-stamping ``pos`` (in
        place). Ballast slots are not rolled back: their writes land in
        trash (clamped pages, dropped writes) or are masked."""
        w, k = self.token_width, self.spec_k
        T = k + 1
        drafts = self.draft.propose(
            self._next_tok, self._pos_host, self._nemit, self._temp, self._top_p,
            self._top_k, self._seed, rec)  # (B, k) host int32
        feed = np.concatenate([self._next_tok[:, None], drafts], axis=1)
        feed_planes = pack_tokens_host(feed, w)  # (w, B, T)
        rec["host_device"] += feed_planes.nbytes  # h2d verify block
        batch = {"tokens": unpack_tokens(stage(feed_planes, self.device)),
                 "pos": stage(self._pos_host, self.device)}
        if self.paged:
            rec["host_device"] += self._table.nbytes
            rec["page_table"] += self._table.nbytes
            batch["page_table"] = stage(self._table, self.device)
        first_call = len(comm.LOG)
        logits, self._caches = self._verify(self._weights, self._caches, batch)
        self._log_wire("verify", T, first_call)
        t_planes = self._verify_sample(logits)  # (w, B, T) — d2h verified ids
        rec["host_device"] += t_planes.nbytes
        targets = unpack_tokens_host(t_planes)  # (B, T)
        self._pos_host += T  # mirrors the step's pos += T (ballast too)
        rec["decoded"] = len(self._active)
        rec["spec_rounds"] += 1
        delta = np.zeros_like(self._pos_host)
        for slot, st in list(self._active.items()):
            accepted = considered = 0
            for j in range(T):
                tok = int(targets[slot, j])
                accepted += 1
                self._next_tok[slot] = tok
                self._nemit[slot] += 1
                rec["spec_emitted"] += 1
                if st.emit(tok):
                    self._results[st.req.rid] = self._retire(st, self._step)
                    del self._active[slot]
                    break
                if j < k:
                    # proposals past a finish are moot, not rejected: only
                    # examined ones count toward the acceptance rate (a
                    # perfect draft pins it at exactly 1.0)
                    considered += 1
                    if int(drafts[slot, j]) != tok:
                        break  # divergence: the target's sample replaces it
            rec["spec_proposed"] += considered
            rec["spec_accepted"] += accepted - 1
            delta[slot] = T - accepted
        self._pos_host -= delta
        delta_dev = torch.from_numpy(delta).to(self.device)
        rollback_caches(self._caches, delta_dev)
        self.draft.rollback(delta_dev)

    def take_completed(self) -> dict[int, GenResult]:
        """Drain the finished results (the router's stream reassembly)."""
        out, self._results = self._results, {}
        return out

    def swap_weights(self, storage) -> None:
        """Hot-swap the weight tree between steps (the fleet's
        ``weight_publish`` install), re-placed when weight-stationary. The
        swap is unconditional here: in-flight slots decode on under the new
        weights; the fleet swaps a replica only while it is idle."""
        if storage["embed"].device != self.device:
            raise ValueError(f"swap_weights: weights on {storage['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.storage = storage
        self._weights = None  # the old placement goes before the new one is built
        self._weights = self._place(storage) if self._place is not None else storage

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
        self._clear_sampling_slot(st.slot)
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
        reproduces; on a mesh also ``wire``, the steps' collectives per
        traffic class (:attr:`wire_log`, without the placement)."""
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
        if self.draft is not None:
            for key in ("spec_rounds", "spec_proposed", "spec_accepted", "spec_emitted"):
                out[key] = sum(r[key] for r in self.step_log)
            out["acceptance_rate"] = out["spec_accepted"] / max(out["spec_proposed"], 1)
            out["tokens_per_target_step"] = out["spec_emitted"] / max(out["spec_rounds"], 1)
            out["spec_k"] = self.spec_k
        if not self.mesh_cfg.trivial:  # the collectives of the steps, per class
            wire: dict[str, int] = {}
            for r in self.wire_log:
                for k, v in r["wire"].items():
                    wire[k] = wire.get(k, 0) + v
            out["wire"] = wire
        return out

    def wire_tables(self) -> list[dict]:
        """:func:`~repro_torch.serve.step.serve_wire_table` of each
        :attr:`wire_log` entry: what its collectives move per class by the
        plan's formulas (a prefill of its tokens in one row, a decode step
        over the rank's rows, without weights when weight-stationary; a
        draft's prefill or micro decode step under the draft's plan, config
        and spec tree, over one row or every slot)."""
        rows = self.max_slots // (self.mesh_cfg.dshards if self._shard_batch else 1)
        out = []
        for r in self.wire_log:
            if r["kind"].startswith("draft_"):  # the draft's own plan, config and weights
                d = self.draft
                out.append(serve_wire_table(
                    d.plan, d.cfg, d.spec_tree, self.mesh_cfg,
                    rows=1 if r["kind"] == "draft_prefill" else d.max_slots,
                    tokens=r["tokens"]))
                continue
            prefill = r["kind"] == "prefill"
            out.append(serve_wire_table(
                self.plan, self.cfg, self.spec_tree, self.mesh_cfg,
                rows=1 if prefill else rows, tokens=r["tokens"],
                gathers=prefill or not self.weight_stationary,
                seq_parallel=r.get("seq_parallel", False)))
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
    image_features=None,
) -> dict[int, list[int]]:
    """Classic static batching, the engine's reference: requests are
    grouped by prompt length, each group runs one batched prefill into a
    linear cache of ``S + gen`` and a scalar-``pos`` decode loop to the
    group's longest request; per-request stop conditions truncate the
    streams afterwards. All-greedy groups take the argmax; a group with a
    sampled request samples every row through
    :func:`~repro_torch.serve.sampling.sample_tokens` (greedy rows take the
    argmax there too) under the key-fold contract, so sampled streams equal
    the engine's at the same seeds. ``window`` masks the decode steps'
    attention (the engine's ring holds the same tokens). On a mesh a
    group's rows are sharded over the data ranks when they split evenly,
    and a length the model group does not divide takes the psum layout,
    as in the reference, and a window masks the rank's heads alike.

    A vision arch's requests carry their image features
    (``Request.image_features``, ``(num_image_tokens, vision_dim)``), which
    a group stacks into its prefill's ``image_features`` batch; a request
    without them raises ``ValueError``. The reference's older
    ``image_features={rid: array}`` keyword still works, behind a
    ``DeprecationWarning``."""
    plan = plan.broadcast(cfg.num_groups + 1)
    if image_features is not None:
        warnings.warn(
            "generate_static(image_features=...) is deprecated — set "
            "Request.image_features per request instead",
            DeprecationWarning, stacklevel=2,
        )

    def feats(r):
        if r.image_features is not None:
            return r.image_features
        return None if image_features is None else image_features.get(r.rid)

    if cfg.num_image_tokens and any(feats(r) is None for r in requests):
        raise ValueError(
            f"{cfg.name} needs image_features per request (Request.image_features, "
            f"({cfg.num_image_tokens}, {cfg.vision_dim}) array)"
        )
    device = storage["embed"].device
    groups: dict[int, list[Request]] = {}
    for r in requests:
        groups.setdefault(len(r.prompt_ids), []).append(r)
    out: dict[int, list[int]] = {}
    for S, reqs in groups.items():
        gen = max(r.max_new for r in reqs)
        gplan = plan
        if plan.seq_parallel and S % mesh_cfg.tp:
            gplan = dataclasses.replace(plan, seq_parallel=False)
        shard = mesh_cfg.dshards > 1 and len(reqs) % mesh_cfg.dshards == 0
        prefill = make_prefill_step(cfg, mesh_cfg, mesh, spec_tree, plan=gplan,
                                    cache_capacity=S + gen, shard_batch=shard)
        decode = make_decode_step(cfg, mesh_cfg, mesh, spec_tree, plan=gplan,
                                  shard_batch=shard, window_override=window)
        if all(r.sampling.greedy for r in reqs):
            def pick(lg, step):
                return torch.argmax(lg[:, -1, : cfg.vocab_size], dim=-1)
        else:
            rows = [r.sampling for r in reqs]
            temp = np.asarray([p.temperature for p in rows], np.float32)
            topp = np.asarray([p.top_p for p in rows], np.float32)
            topk = np.asarray([p.top_k for p in rows], np.int32)
            seed = seed_words([p.seed for p in rows])  # OverflowError past uint32

            def pick(lg, step):
                return sample_tokens(lg[:, -1], cfg.vocab_size, temp, topp, topk, seed,
                                     np.full((len(rows),), step, np.int32))

        batch = {"tokens": torch.tensor([r.prompt_ids for r in reqs], dtype=torch.int32,
                                        device=device)}
        if cfg.num_image_tokens:
            batch["image_features"] = torch.from_numpy(
                np.stack([np.asarray(feats(r), np.float32) for r in reqs])).to(device)
        logits, caches = prefill(storage, batch)
        tok = pick(logits, 0)[:, None].to(torch.int32)
        streams = [tok.cpu().numpy()[:, 0]]
        for i in range(gen - 1):
            pos = torch.tensor(S + i, dtype=torch.int32, device=device)
            logits, caches = decode(storage, caches, {"tokens": tok, "pos": pos})
            tok = pick(logits, i + 1)[:, None].to(torch.int32)
            streams.append(tok.cpu().numpy()[:, 0])
        del caches
        mat = np.stack(streams, axis=1)  # (B, gen)
        for b, r in enumerate(reqs):
            ids = mat[b].tolist()[: r.max_new]
            if r.eos_id is not None and r.eos_id in ids:
                ids = ids[: ids.index(r.eos_id) + 1]
            out[r.rid] = ids
    return out
