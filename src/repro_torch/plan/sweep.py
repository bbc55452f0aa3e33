"""Roofline sweep that picks the weight-gather chunk count for a plan
(counterpart of ``repro.plan.sweep``).

The chunked gather (``CompressionPolicy.chunks > 1``) splits a flat FSDP
shard into independent pack → all-gather → unpack block pipelines so the
wire time of block *k* overlaps the pack/unpack of block *k±1*. More
chunks buy more overlap but pay a per-collective launch latency, so
there is an interior optimum. This helper models the pipeline and
returns the argmin — the ``plan``-selected chunk count the launchers use
for ``--chunks auto``. The arithmetic is the reference's; its three
hardware terms are keyword parameters whose defaults are the port's
constants in :mod:`repro_torch.roofline.analysis` (the card's memory
rate and the measured collective path), not the reference's TPU ones.
"""
from __future__ import annotations

from repro_torch.roofline import analysis as _hw
from repro_torch.transport import CompressionPolicy, policy_for

CHUNK_CANDIDATES = (1, 2, 4, 8, 16)


def modeled_gather_time(s_loc: int, axis_size: int, policy: CompressionPolicy, chunks: int,
                        *, hbm_bw: float | None = None, link_bw: float | None = None,
                        latency: float | None = None) -> float:
    """Modeled seconds for one chunked compressed all-gather of an
    ``s_loc``-element fp32 shard over ``axis_size`` ranks.

    Per block: pack touches the fp32 read + plane write, unpack the
    gathered planes + fp32 write (the ``hbm_bw`` term); the plane
    all-gather pays the policy's ring wire bytes (the ``link_bw`` term)
    plus a launch ``latency``. Blocks double-buffer: total ≈ first pack +
    (chunks-1) overlapped stages + last unpack. ``None`` takes the port's
    constant (``HBM_BW``, ``LINK_BW``, ``COLLECTIVE_LATENCY``)."""
    hbm_bw = _hw.HBM_BW if hbm_bw is None else hbm_bw
    link_bw = _hw.LINK_BW if link_bw is None else link_bw
    latency = _hw.COLLECTIVE_LATENCY if latency is None else latency
    n = max(int(axis_size), 1)
    blk = s_loc / chunks
    pack_s = blk * (4 + policy.round_to) / hbm_bw
    unpack_s = n * blk * (policy.round_to + 4) / hbm_bw
    wire_s = policy.all_gather_wire_bytes(max(int(blk), 1), n) / link_bw + latency
    # fill (first pack) + steady state (wire overlaps neighbouring
    # pack/unpack) + drain (last unpack); chunks=1 degenerates to the
    # unoverlapped pack + wire + unpack sum
    stage = max(pack_s + unpack_s, wire_s)
    return pack_s + stage * (chunks - 1) + wire_s + unpack_s


def sweep_chunks(s_loc: int, axis_size: int, policy=2, candidates=CHUNK_CANDIDATES,
                 **hw) -> dict[int, float]:
    """Modeled gather time per candidate chunk count (only candidates that
    divide ``s_loc`` — the transport falls back to the unchunked pipeline
    otherwise, so a non-dividing pick would be a silent no-op). ``hw``:
    :func:`modeled_gather_time`'s hardware keywords."""
    pol = policy_for(policy)
    return {c: modeled_gather_time(s_loc, axis_size, pol, c, **hw)
            for c in candidates if c >= 1 and s_loc % c == 0}


def pick_chunks(s_loc: int, axis_size: int, policy=2, candidates=CHUNK_CANDIDATES,
                **hw) -> int:
    """The plan-selected chunk count: argmin of :func:`sweep_chunks` (1 when
    nothing divides, or when the gather is degenerate)."""
    if s_loc <= 0 or axis_size <= 1:
        return 1
    table = sweep_chunks(s_loc, axis_size, policy, candidates, **hw)
    if not table:
        return 1
    return min(table, key=table.get)
