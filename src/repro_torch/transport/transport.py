"""The compression transport: pack -> collective -> unpack pipelines
(counterpart of ``repro.transport.transport``; the weight and gradient
paths of data-parallel training and the trivial-mesh quantize).

  * :func:`all_gather` — weight path. fp32 shard -> byte planes (Bitpack)
    -> plane all-gather over a process group -> Bitunpack. A
    ``torch.autograd.Function`` whose backward is the (optionally
    compressed) reduce-scatter, so a train step just calls it and gets the
    paper's weight / gradient motion.
  * :func:`reduce_scatter` — gradient path: pack the block destined for
    each peer, ``all_to_all`` the planes, unpack and sum locally in fp32
    (``grad_round_to < 4``), or the plain fp32 reduce-scatter (4, the
    paper's setting). Any rank and any scatter axis.
  * :func:`seq_gather` / :func:`seq_scatter` — activation path (TP axis).
    The sequence-parallel conjugate pair: compressed all-gather along the
    sequence dim with a compressed reduce-scatter backward, and vice
    versa; forwards at the policy's ``round_to`` / ``mode``, backwards at
    its ``grad_round_to`` / ``grad_mode``.
  * :func:`all_reduce` — compressed all-reduce, decomposed into a packed
    reduce-scatter and a packed all-gather along the rightmost divisible
    dim (:func:`pick_split_axis`). Not differentiable: it is the forward
    and cotangent mover inside the TP-region Functions of
    :mod:`repro_torch.core.collectives`.
  * :func:`quantize` — single-device format truncation (pack∘unpack) with
    a straight-through gradient: what the compute side sees when there is
    no collective to ride on.

Bitpack and Bitunpack run the CUDA kernels for CUDA tensors
(``impl="auto"``) in truncate mode; nearest and stochastic rounding stay on
the plain version, as in the reference's ``resolve_impl``. Stochastic
rounding takes a ``repro_torch.random`` key: the weight path packs with
the caller's key (folded by chunk index on the chunked path), the
gradient reduce-scatter in the gather's backward with ``fold_in(key,
_BWD_FOLD)``, as the reference's. An element's noise is drawn at its flat
index; a caller whose layout is not the reference's passes ``index``, the
flat index each element has in the reference's layout (:func:`all_gather`). Planes are always
exact-shape ``(round_to, *w.shape)`` u8. The collectives are
:mod:`repro_torch.dist.comm`'s (gloo; every call logged with its traffic
class: ``weights`` and ``gradients`` on the weight path, ``activations``
or ``seq_boundary`` on the activation path, as the caller says).

The chunked path (``policy.chunks > 1``) splits a flat gather into
independent pack -> all-gather -> unpack block pipelines and re-interleaves
the blocks to the exact layout of the unchunked gather.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import random as _random
from repro_torch.dist import comm
from repro_torch.kernels.ops import bitpack, bitunpack, resolve_impl
from repro_torch.transport.policy import FP32_BYTES, CompressionPolicy, policy_for

__all__ = [
    "Transport", "all_gather", "all_reduce", "pack_planes", "pick_split_axis", "quantize",
    "reduce_scatter", "resolve_impl", "seq_gather", "seq_scatter", "unpack_planes",
]


def pack_planes(
    w: torch.Tensor,
    round_to: int,
    *,
    mode: str = "truncate",
    impl: str = "auto",
    key=None,
    index=None,
) -> torch.Tensor:
    """fp32 tensor (any shape) -> uint8 byte planes ``(round_to, *w.shape)``.
    Plane 0 is the most significant byte."""
    return bitpack(w, round_to, impl=impl, mode=mode, key=key, index=index)


def unpack_planes(planes: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """uint8 byte planes ``(round_to, *shape)`` -> fp32 ``shape``."""
    return bitunpack(planes, impl=impl)


# ---------------------------------------------------------------------------
# forward implementations
# ---------------------------------------------------------------------------


def _packed_all_gather(x, group, round_to, mode, impl, axis: int, key=None, *,
                       traffic="weights", index=None):
    """Compressed all-gather of an arbitrary-rank tensor along ``axis``:
    pack (non-fp32 inputs cast to fp32 exactly), gather the planes (their
    data axis is one further along), unpack, cast back."""
    axis = axis % x.ndim  # planes prepend a dim: negatives must resolve first
    planes = pack_planes(x.to(torch.float32), round_to, mode=mode, impl=impl, key=key,
                         index=index)
    planes_g = comm.all_gather(planes, group, axis=axis + 1, traffic=traffic)
    return unpack_planes(planes_g, impl=impl).to(x.dtype)


def _packed_reduce_scatter(g, group, round_to, mode, impl, axis: int, key=None, *,
                           traffic="gradients", index=None):
    """Compressed reduce-scatter of an arbitrary-rank tensor along
    ``axis``: the scatter dim is split into per-peer blocks here, each
    block is packed, the planes ride one ``all_to_all``, and the unpacked
    contributions are summed locally in fp32 (in rank order). Only the
    scatter dim must divide by the group size."""
    axis = axis % g.ndim
    size = dist.get_world_size(group)
    length = g.shape[axis]
    if length % size:
        raise ValueError(
            f"scatter dim {axis} of shape {tuple(g.shape)} not divisible by "
            f"axis size {size}"
        )
    gm = g.to(torch.float32).movedim(axis, 0)
    gm = gm.reshape((size, length // size) + tuple(gm.shape[1:])).contiguous()
    if index is not None:  # laid out as g: the same moves
        index = index.movedim(axis, 0).reshape(gm.shape)
    planes = pack_planes(gm, round_to, mode=mode, impl=impl, key=key, index=index)
    # (round_to, size, loc, ...): block j of dim 1 goes to rank j, and after
    # the exchange block j holds rank j's contribution to this rank's block
    planes_x = comm.all_to_all(planes, group, axis=1, traffic=traffic)
    contribs = unpack_planes(planes_x, impl=impl)
    out = torch.sum(contribs, dim=0)  # fp32 accumulation
    return out.movedim(0, axis).to(g.dtype)


def _all_gather_impl(w, group, policy: CompressionPolicy, axis: int, key=None, index=None):
    if not policy.compresses:
        return comm.all_gather(w, group, axis=axis, traffic="weights")
    if (
        policy.chunks > 1
        and axis == 0
        and w.ndim == 1
        and w.shape[0] % policy.chunks == 0
    ):
        return _chunked_all_gather(w, group, policy, key, index)
    return _packed_all_gather(w, group, policy.round_to, policy.mode, policy.impl, axis,
                              key=key, index=index)


def _pack_by_chunk(piece, index, loc: int, policy: CompressionPolicy, key):
    """Planes of ``piece`` whose elements sit, in the reference's layout, at
    the shard offsets ``index``: an element at offset ``q`` lies in the
    reference's chunk ``q // loc``, which packs with ``fold_in(key, q //
    loc)`` at ``q % loc``, so each element takes that chunk's key and
    index, whichever chunk of the port's layout holds it."""
    owner = index // loc
    planes = torch.empty((policy.round_to, piece.shape[0]), dtype=torch.uint8,
                         device=piece.device)
    for c in torch.unique(owner).tolist():
        sel = owner == c
        planes[:, sel] = pack_planes(piece[sel], policy.round_to, mode=policy.mode,
                                     impl=policy.impl, key=_random.fold_in(key, c),
                                     index=index[sel] % loc)
    return planes


def _chunked_all_gather(w, group, policy: CompressionPolicy, key=None, index=None):
    """Gather in ``policy.chunks`` independent plane blocks, re-interleaved
    to the unchunked layout exactly; block ``c`` packs with ``fold_in(key,
    c)``, as the reference's. With a noise ``index`` (the shard offset of
    each element in the reference's layout) an element draws under the key
    and at the index of the reference's chunk that holds it
    (:func:`_pack_by_chunk`)."""
    n_chunks = policy.chunks
    loc = w.shape[0] // n_chunks
    gathered = []
    for c in range(n_chunks):
        piece = w[c * loc:(c + 1) * loc]
        if key is not None and index is not None:
            planes = _pack_by_chunk(piece, index[c * loc:(c + 1) * loc], loc, policy, key)
        else:
            planes = pack_planes(piece, policy.round_to, mode=policy.mode, impl=policy.impl,
                                 key=None if key is None else _random.fold_in(key, c))
        planes_g = comm.all_gather(planes, group, axis=1, traffic="weights")
        gathered.append(unpack_planes(planes_g, impl=policy.impl))
    # gathered[c] = concat_d shard_d[block c]; the full gather is
    # concat_d concat_c shard_d[block c]: transpose (chunk, device) out
    n_dev = dist.get_world_size(group)
    stacked = torch.stack(gathered, 0).reshape(n_chunks, n_dev, loc)
    return stacked.transpose(0, 1).reshape(-1)


def _reduce_scatter_impl(g, group, policy: CompressionPolicy, axis: int, key=None,
                         index=None):
    if not policy.compresses_grads:
        return comm.reduce_scatter(g, group, axis=axis, traffic="gradients")
    return _packed_reduce_scatter(g, group, policy.grad_round_to, policy.grad_mode,
                                  policy.impl, axis, key=key, index=index)


def _seq_gather_impl(x, group, policy: CompressionPolicy, axis: int):
    if not policy.compresses:
        return comm.all_gather(x, group, axis=axis, traffic="seq_boundary")
    return _packed_all_gather(x, group, policy.round_to, policy.mode, policy.impl, axis,
                              traffic="seq_boundary")


def _seq_scatter_impl(x, group, policy: CompressionPolicy, axis: int):
    # forward activation path: the policy's *forward* format fields
    if not policy.compresses:
        return comm.reduce_scatter(x, group, axis=axis, traffic="seq_boundary")
    return _packed_reduce_scatter(x, group, policy.round_to, policy.mode, policy.impl, axis,
                                  traffic="seq_boundary")


def pick_split_axis(shape, size: int) -> int | None:
    """Rightmost dim divisible by ``size`` — the axis the compressed
    all-reduce splits along (rightmost, so that the per-peer blocks stay
    contiguous in the activation layout (B, S, d)). None = no divisible
    dim; the caller falls back to an uncompressed all-reduce."""
    for a in reversed(range(len(shape))):
        if shape[a] >= size and shape[a] % size == 0:
            return a
    return None


def _all_reduce_impl(x, group, policy: CompressionPolicy, use_grad_format: bool,
                     traffic: str):
    rt = policy.grad_round_to if use_grad_format else policy.round_to
    mode = policy.grad_mode if use_grad_format else policy.mode
    axis = None if rt >= FP32_BYTES else pick_split_axis(x.shape, dist.get_world_size(group))
    if axis is None:
        return comm.all_reduce(x, group, traffic=traffic)
    part = _packed_reduce_scatter(x, group, rt, mode, policy.impl, axis, traffic=traffic)
    return _packed_all_gather(part, group, rt, mode, policy.impl, axis, traffic=traffic)


def _quantize_impl(w, policy: CompressionPolicy, key=None, index=None):
    planes = pack_planes(
        w, policy.round_to, mode=policy.mode, impl=policy.impl, key=key, index=index
    )
    return unpack_planes(planes, impl=policy.impl)


class _Quantize(torch.autograd.Function):
    """pack∘unpack forward, identity backward (straight-through)."""

    @staticmethod
    def forward(ctx, w, policy, key, index):
        return _quantize_impl(w, policy, key, index)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def quantize(w: torch.Tensor, policy: CompressionPolicy, key=None, index=None) -> torch.Tensor:
    """Format truncation (pack∘unpack) with a straight-through gradient;
    ``index``: each element's noise index (stochastic rounding)."""
    if not policy.compresses:
        # rt=4 keeps every byte: rounding is a no-op regardless of mode
        return w
    return _Quantize.apply(w, policy, key, index)


# fold id of the backward (cotangent) pack: outside the forward chunked
# gather's per-chunk fold range (0..chunks-1), so the forward's and the
# backward's stochastic-rounding noise never share a stream
_BWD_FOLD = 0x62776421


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    """Compressed all-gather forward, reduce-scatter backward (the format
    is not differentiated: straight-through, like the paper's fp32
    master-weight update)."""

    @staticmethod
    def forward(ctx, w_local, group, policy, axis, key, index):
        ctx.group, ctx.policy, ctx.axis, ctx.key = group, policy, axis, key
        fwd, ctx.bwd_index = index if index is not None else (None, None)
        return _all_gather_impl(w_local, group, policy, axis, key, fwd)

    @staticmethod
    def backward(ctx, g):
        gkey = None if ctx.key is None else _random.fold_in(ctx.key, _BWD_FOLD)
        return (_reduce_scatter_impl(g, ctx.group, ctx.policy, ctx.axis, key=gkey,
                                     index=ctx.bwd_index),
                None, None, None, None, None)


def all_gather(
    w_local: torch.Tensor,
    group,
    policy: CompressionPolicy,
    axis: int = 0,
    key=None,
    index=None,
) -> torch.Tensor:
    """Compressed all-gather over the process group ``group`` with a
    reduce-scatter backward.

    The forward moves ``policy.round_to`` of every fp32 byte; the backward
    reduce-scatters the cotangent at ``policy.grad_round_to`` (4 =
    uncompressed, paper-faithful). ``key`` is the stochastic-rounding key,
    needed exactly when a used direction of the policy is stochastic.
    ``index``, ``(forward, backward)`` or None: the flat index at which
    each element's noise is drawn, laid out as ``w_local`` (the forward
    pack) and as the gathered tensor (the gradient's)."""
    return _AllGather.apply(w_local, group, policy, axis, key, index)


def reduce_scatter(
    g: torch.Tensor,
    group,
    policy: CompressionPolicy,
    axis: int = 0,
    key=None,
) -> torch.Tensor:
    """Compressed reduce-scatter along ``axis`` (default 0: the flat
    gradient path, ``(S,)`` -> ``(S / n,)``) at ``policy.grad_round_to``
    bytes; rounding defaults to *nearest* (gradient sums are
    bias-sensitive); ``grad_mode="stochastic"`` needs ``key``."""
    return _reduce_scatter_impl(g, group, policy, axis, key=key)


# -- activation path (TP axis) ----------------------------------------------


class _SeqGather(torch.autograd.Function):
    """Sequence-parallel enter: (compressed) all-gather of activation
    shards along ``axis``, (compressed) reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, policy, axis):
        ctx.group, ctx.policy, ctx.axis = group, policy, axis
        return _seq_gather_impl(x, group, policy, axis)

    @staticmethod
    def backward(ctx, g):
        pol = ctx.policy
        if not pol.compresses_grads:
            out = comm.reduce_scatter(g, ctx.group, axis=ctx.axis, traffic="seq_boundary")
        else:
            out = _packed_reduce_scatter(g, ctx.group, pol.grad_round_to, pol.grad_mode,
                                         pol.impl, ctx.axis, traffic="seq_boundary")
        return out, None, None, None


class _SeqScatter(torch.autograd.Function):
    """Sequence-parallel exit: (compressed) reduce-scatter of partial
    activations along ``axis``, (compressed) all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, group, policy, axis):
        ctx.group, ctx.policy, ctx.axis = group, policy, axis
        return _seq_scatter_impl(x, group, policy, axis)

    @staticmethod
    def backward(ctx, g):
        pol = ctx.policy
        if not pol.compresses_grads:
            out = comm.all_gather(g, ctx.group, axis=ctx.axis, traffic="seq_boundary")
        else:
            out = _packed_all_gather(g, ctx.group, pol.grad_round_to, pol.grad_mode,
                                     pol.impl, ctx.axis, traffic="seq_boundary")
        return out, None, None, None


def seq_gather(x: torch.Tensor, group, policy: CompressionPolicy, axis: int = 1):
    """Sequence-parallel enter over ``group``: the forward moves
    ``policy.round_to`` of every fp32 byte, the cotangent's reduce-scatter
    ``policy.grad_round_to``. Dtype-preserving."""
    return _SeqGather.apply(x, group, policy, axis)


def seq_scatter(x: torch.Tensor, group, policy: CompressionPolicy, axis: int = 1):
    """Sequence-parallel exit over ``group``: each peer's block packed at
    ``policy.round_to`` (contributions summed in fp32 after unpacking —
    planes are never added); the cotangent all-gathers at
    ``policy.grad_round_to``."""
    return _SeqScatter.apply(x, group, policy, axis)


def all_reduce(x: torch.Tensor, group, policy: CompressionPolicy, *,
               use_grad_format: bool = False, traffic: str = "activations"):
    """Compressed all-reduce over ``group``: a packed reduce-scatter and a
    packed all-gather along the rightmost divisible dim
    (:func:`pick_split_axis`); an uncompressed width (4) or a shape with
    no divisible dim falls back to a plain all-reduce (the reference's
    rule). ``use_grad_format=True`` selects the policy's grad fields
    (cotangent psums). Not differentiable on purpose: it moves data inside
    the TP-region Functions, whose transposes are pinned."""
    return _all_reduce_impl(x, group, policy, use_grad_format, traffic)


# ---------------------------------------------------------------------------
# object API
# ---------------------------------------------------------------------------


class Transport:
    """Pack -> collective -> unpack pipeline bound to one process group
    (the reference binds a set of mesh axes)::

        t = Transport(fsdp_group)
        w_full = t.all_gather(w_shard, policy)        # differentiable
        g_shard = t.reduce_scatter(g_full, policy)    # any rank, axis=...

    The activation path is called as functions (``seq_gather``,
    ``seq_scatter``, ``all_reduce``) by :mod:`repro_torch.core.collectives`.
    """

    def __init__(self, group=None):
        self.group = group

    def all_gather(self, w, policy, *, axis: int = 0, key=None):
        return all_gather(w, self.group, policy_for(policy), axis, key)

    def reduce_scatter(self, g, policy, *, axis: int = 0, key=None):
        return reduce_scatter(g, self.group, policy_for(policy), axis, key)

    def quantize(self, w, policy, *, key=None):
        return quantize(w, policy_for(policy), key)

    def axis_size(self) -> int:
        return dist.get_world_size(self.group)
