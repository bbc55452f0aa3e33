"""Paged decode attention: the port's plain version and caches against the
JAX reference, and the CUDA kernel against the plain version on the card.

The reference's ``paged_attend`` runs in Pallas interpret mode on the CPU,
as ``tests/test_kernels.py`` runs it; its oracle ``paged_attend_ref`` is
bitwise equal to it there. Inputs are unit normals from numpy seeds, on
the shapes of ``tests/test_kernels.py`` plus G > 1, page 64 and slot
lengths 0, 1, page, page + 1 and the whole table.

Tolerances: the port's plain version and its dense paged decode are
within ``ATOL`` = 2e-6 of the reference's (fp32 sums in another order in
PyTorch and XLA on O(1) outputs; the largest gap seen on these cases is
7.7e-7); the cache write and permuted tables are exact, and the dense
paged decode is bitwise the contiguous decode of the same rows. On the
card the kernel is within ``KERNEL_TOL`` = 2e-6 of the plain version
(another summation order again: per-row dots, shuffle-tree sums; 6.0e-7
seen on an H100).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attend as j_paged_attend
from repro.kernels.paged_attention import paged_attend_ref as j_paged_attend_ref
from repro.models import attention as ja
from repro_torch.convert import convert_paged_cache
from repro_torch.kernels import paged_attend as pa
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attend import paged_attend, paged_splits
from repro_torch.models import attention as ta

ATOL = 2e-6
KERNEL_TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(B, Kv, G, page, n_pages, num_phys, seed=0, lengths=None, hd=128):
    """``tests/test_kernels.py::_paged_setup`` with the lengths optional
    and the head width free: distinct physical pages per table entry."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Kv, G, hd)).astype(np.float32)
    pool_shape = (num_phys, page, Kv, hd)
    k_pool = rng.normal(0, 1, pool_shape).astype(np.float32)
    v_pool = rng.normal(0, 1, pool_shape).astype(np.float32)
    perm = rng.permutation(num_phys)[: B * n_pages]
    table = perm.reshape(B, n_pages).astype(np.int32)
    if lengths is None:
        lengths = rng.integers(1, page * n_pages + 1, (B,))
    return q, k_pool, v_pool, table, np.asarray(lengths, np.int32)


def _port(args, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in args]


# (B, Kv, G, page, n_pages, pool rows, seed, lengths): the reference
# kernel test's three shapes, then G = 1, 3, 4 at the boundary lengths and
# the main path's page 64 (qwen3-1.7b: Kv 8, G 2; lengths 0 and 528)
CASES = [
    (3, 2, 2, 8, 4, 16, 11, None),
    (2, 2, 4, 8, 4, 12, 13, None),
    (2, 2, 2, 8, 3, 12, 17, None),
    (5, 2, 1, 8, 4, 24, 19, (0, 1, 8, 9, 32)),
    (5, 1, 3, 8, 4, 24, 23, (32, 9, 8, 1, 0)),
    (5, 2, 4, 5, 3, 16, 29, (0, 1, 5, 6, 15)),
    (2, 8, 2, 64, 9, 19, 31, (528, 0)),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"B{c[0]}Kv{c[1]}G{c[2]}p{c[3]}n{c[4]}")
def test_plain_version_matches_reference_kernel_and_oracle(case):
    B, Kv, G, page, n_pages, phys, seed, lengths = case
    args = _setup(B, Kv, G, page, n_pages, phys, seed=seed, lengths=lengths)
    jargs = [jnp.asarray(a) for a in args]
    kern = np.asarray(j_paged_attend(*jargs, interpret=True))
    oracle = np.asarray(j_paged_attend_ref(*jargs))
    np.testing.assert_array_equal(kern, oracle)
    got = ref.paged_attend_ref(*_port(args)).numpy()
    np.testing.assert_allclose(got, kern, atol=ATOL, rtol=0)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(paged_attend(*_port(args)).numpy(), got)


def test_length_zero_is_the_mean_of_v_over_the_table():
    """All rows masked: every score is -1e30, so p = exp(0) = 1 on every
    row of every page, as in the reference's walk."""
    q, kp, vp, table, _ = _setup(1, 2, 2, 8, 3, 6, seed=37, lengths=(0,))
    got = ref.paged_attend_ref(*_port((q, kp, vp, table, np.zeros(1, np.int32))))
    want = vp[table[0]].reshape(-1, 2, 128).mean(axis=0)  # (Kv, hd)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(want[:, None], (2, 2, 128)),
                               atol=ATOL, rtol=0)


def test_page_table_permutation_invariance():
    """The same logical pages at other pool rows give bitwise the same
    output (``tests/test_kernels.py``'s invariance, on the port)."""
    q, kp, vp, table, lengths = _setup(2, 2, 2, 8, 3, 12, seed=17)
    base = ref.paged_attend_ref(*_port((q, kp, vp, table, lengths)))
    perm = np.random.default_rng(23).permutation(kp.shape[0])
    inv = np.argsort(perm).astype(np.int32)
    moved = ref.paged_attend_ref(*_port((q, kp[perm], vp[perm], inv[table], lengths)))
    assert torch.equal(base, moved)


def test_dense_gather_matches_plain_version():
    """``attend_decode_paged``'s CPU path (gather + ``attend_decode``) and
    the page walk compute the same attention."""
    q, kp, vp, table, lengths = _setup(3, 2, 2, 8, 4, 16, seed=11)
    tq, tk, tv, tt, tl = _port((q, kp, vp, table, lengths))
    cache = ta.PagedKVCache(tk, tv, tl)
    dense = ta.attend_decode_paged(tq.reshape(3, 1, 2, 2, 128), cache, tt)
    np.testing.assert_allclose(dense[:, 0].numpy(), ref.paged_attend_ref(tq, tk, tv, tt, tl).numpy(),
                               atol=ATOL, rtol=0)


def test_wrapper_rejects_mismatched_shapes():
    q, kp, vp, table, lengths = _port(_setup(2, 2, 2, 8, 3, 12, seed=3))
    with pytest.raises(ValueError):
        paged_attend(q[:, :1], kp, vp, table, lengths)  # Kv 1 against the pools' 2
    with pytest.raises(ValueError):
        paged_attend(q, kp, vp, table[:1], lengths)
    with pytest.raises(ValueError):
        paged_attend(q, kp, vp[:, :4], table, lengths)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attend(*(t.to("meta") for t in (q, kp, vp, table, lengths)))


# ---------------------------------------------------------------------------
# the split over pages (host side) and its merge algebra
# ---------------------------------------------------------------------------

# (B, Kv, table width, SM count): the main path's decode (132 SMs), B=16 at
# (n_pages, page): the decode shape (9 pages of 64), B=16's 64 pages,
# the shared-prefix run's 7, a table of one page, pages of 8 and of 5
# rows (several a split), and pages of 192 and 256 rows (over 128)
SPLIT_SHAPES = [(9, 64), (64, 64), (7, 64), (1, 64), (100, 8), (3, 5), (40, 192), (9, 256)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_splits_cover_every_page_once(shape):
    """Every page is walked by exactly one split, in split order; no split
    reaches past the table or is empty of table pages; a split holds
    ``pps = max(1, SPLIT_ROWS // page)`` pages (the last one fewer), so it
    covers a fixed range of logical rows."""
    n_pages, page = shape
    n_splits, pps = paged_splits(n_pages, page)
    pages = [p for s in range(n_splits) for p in range(s * pps, min((s + 1) * pps, n_pages))]
    assert pages == list(range(n_pages))  # each once, in split order
    assert all(s * pps < n_pages for s in range(n_splits))
    assert pps == max(1, pa.SPLIT_ROWS // page)
    assert (n_splits - 1) * pps < n_pages <= n_splits * pps


@pytest.mark.parametrize("page", [8, 64, 256])
def test_a_slots_splits_do_not_depend_on_the_batch_or_the_table(page):
    """The splits come from the table width and the page size alone (no
    batch, kv heads or SM count in the signature), so a slot's live pages
    fall in the same splits, in the same order, at B = 1, 2 and 4 and in a
    table twice as wide: the kernel's partials for it are the same."""
    assert list(inspect.signature(paged_splits).parameters) == ["n_pages", "page"]
    live = 5  # the slot's live pages

    def live_splits(n_pages):
        n_splits, pps = paged_splits(n_pages, page)
        return [tuple(range(s * pps, min((s + 1) * pps, live))) for s in range(n_splits)
                if s * pps < live]

    want = live_splits(live)
    for B in (1, 2, 4):  # the wrapper passes no B; the grid is B * Kv copies of this
        assert live_splits(live) == want
    assert live_splits(2 * live) == live_splits(9 * live) == want


def _split_merge(q, k_pool, v_pool, table, lengths, n_splits, pps):
    """The kernel's algebra in plain PyTorch: each split's online softmax
    over its live pages (every page for a slot of length 0), a split past
    them empty (l = 0), then the merge in split order."""
    B, Kv, G, hd = q.shape
    page = k_pool.shape[1]
    out = torch.empty_like(q)
    for b in range(B):
        n = int(lengths[b])
        walk = min(-(-n // page), table.shape[1]) if n else table.shape[1]
        parts = []
        for s in range(n_splits):
            pages = range(s * pps, min((s + 1) * pps, walk))
            if not pages:
                parts.append(None)
                continue
            rows = torch.tensor([j * page + o for j in pages for o in range(page)])
            phys = table[b, rows // page].to(torch.int64)
            k, v = k_pool[phys, rows % page], v_pool[phys, rows % page]  # (R, Kv, hd)
            sc = torch.einsum("kgh,rkh->kgr", q[b], k) * hd ** -0.5
            sc = torch.where(rows[None, None] < n, sc, ref.NEG_INF)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgr,rkh->kgh", p, v)))
        live = [x for x in parts if x is not None]
        m = torch.stack([x[0] for x in live]).amax(0)
        w = [torch.exp(x[0] - m) for x in live]
        l = sum(wi * x[1] for wi, x in zip(w, live))
        acc = sum(wi[..., None] * x[2] for wi, x in zip(w, live))
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out


@pytest.mark.parametrize("case", [
    (2, 2, 2, 8, 9, 19, 61, (72, 0)),       # one page a split; a slot of length 0
    (3, 2, 2, 8, 7, 22, 67, (8, 9, 17)),    # lengths at split edges, table wider
    (2, 1, 4, 5, 10, 21, 71, (50, 3)),      # multi-page splits; splits past the live pages
], ids=["one-page", "edges", "multi-page"])
def test_split_merge_algebra_matches_plain_version(case):
    """Splitting at logical pages and merging partials is the same
    attention as the reference's walk (within ATOL); a split made only of
    masked rows weighs exactly 0 and a split past the live pages nothing."""
    B, Kv, G, page, n_pages, phys, seed, lengths = case
    args = _port(_setup(B, Kv, G, page, n_pages, phys, seed=seed, lengths=lengths))
    want = ref.paged_attend_ref(*args)
    for pps in (1, 2, 4, paged_splits(n_pages, page)[1]):
        got = _split_merge(*args, -(-n_pages // pps), pps)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the paged cache against the reference's, from converted identical state
# ---------------------------------------------------------------------------


def _cache_state(seed, B=3, P=6, page=4, Kv=2, hd=16, n_pages=2):
    """A pool of ``P - 1`` pages plus the trash row, a table whose unused
    entries point at the trash row, and positions that include one past
    the table's end (a retired ballast slot, clamped into the trash)."""
    rng = np.random.default_rng(seed)
    k = rng.normal(0, 1, (P, page, Kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (P, page, Kv, hd)).astype(np.float32)
    table = np.array([[0, 3], [2, P - 1], [P - 1, P - 1]], np.int32)[:B]
    pos = np.array([5, 3, 9], np.int32)[:B]  # page 1 / page 0 / past the table
    kn = rng.normal(0, 1, (B, 1, Kv, hd)).astype(np.float32)
    vn = rng.normal(0, 1, (B, 1, Kv, hd)).astype(np.float32)
    return k, v, pos, table, kn, vn


def test_paged_write_matches_reference_bitwise():
    k, v, pos, table, kn, vn = _cache_state(41)
    jc = ja._paged_write(ja.PagedKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)),
                         jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(table))
    tc = convert_paged_cache(ja.PagedKVCache(k, v, pos), device="cpu")
    out = ta._paged_write(tc, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(table))
    assert out is tc  # in place
    for j, t in ((jc.k, tc.k), (jc.v, tc.v), (jc.pos, tc.pos)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # slot 2 is past its table: the write went to the trash row, offset 9 % 4
    np.testing.assert_array_equal(tc.k[5, 1].numpy(), kn[2, 0])


def test_paged_write_of_a_verify_block_is_not_ported():
    """The speculative verify block's paged write (T = 2 here), once
    deferred, now ported: bitwise the reference's, the block tails of slot
    1 (past its live page) and of the ballast slot 2 in the trash row."""
    k, v, pos, table, kn, vn = _cache_state(43)
    kb, vb = np.concatenate([kn, vn], axis=1), np.concatenate([vn, kn], axis=1)
    jc = ja._paged_write(ja.PagedKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)),
                         jnp.asarray(kb), jnp.asarray(vb), jnp.asarray(table))
    tc = convert_paged_cache(ja.PagedKVCache(k, v, pos), device="cpu")
    ta._paged_write(tc, torch.from_numpy(kb), torch.from_numpy(vb), torch.from_numpy(table))
    for j, t in ((jc.k, tc.k), (jc.v, tc.v), (jc.pos, tc.pos)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tc.pos.tolist() == (pos + 2).tolist()


def test_dense_paged_decode_matches_reference():
    """``attend_decode_paged``'s dense gather on converted state against the
    reference's (which ``attend_decode`` runs with XLA's softmax)."""
    k, v, pos, table, kn, vn = _cache_state(47)
    pos = np.array([6, 2, 8], np.int32)  # after the write: live tokens per slot
    rng = np.random.default_rng(53)
    q = rng.normal(0, 1, (3, 1, 2, 2, 16)).astype(np.float32)
    jout = ja.attend_decode_paged(
        jnp.asarray(q), ja.PagedKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)),
        jnp.asarray(table), impl="dense")
    tc = convert_paged_cache(ja.PagedKVCache(k, v, pos), device="cpu")
    tout = ta.attend_decode_paged(torch.from_numpy(q), tc, torch.from_numpy(table))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    # bitwise, the gather is the contiguous layout: the same rows in a
    # KVCache of table-width capacity give the same bits
    rows = torch.from_numpy(table).to(torch.int64)
    flat = ta.KVCache(tc.k[rows].reshape(3, -1, 2, 16), tc.v[rows].reshape(3, -1, 2, 16), tc.pos)
    assert torch.equal(ta.attend_decode(torch.from_numpy(q), flat, ring=False, window=None), tout)


def test_converter_keeps_stacked_leaves():
    k, v, pos, *_ = _cache_state(59)
    stacked = ja.PagedKVCache(np.stack([k, v]), np.stack([v, k]), np.stack([pos, pos + 1]))
    tc = convert_paged_cache(stacked, device="cpu")
    assert tc.rep(1).pos.tolist() == (pos + 1).tolist()
    np.testing.assert_array_equal(tc.rep(0).v.numpy(), v)
    assert tc.rep(0).page_size == 4 and tuple(tc.k.shape[:2]) == (2, 6)


def test_mha_paged_errors_match_reference():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.env import Env

    cfg = ModelConfig(name="t", arch_type="dense", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=1, head_dim=16, d_ff=0, vocab_size=8)
    w = {n: torch.zeros(shape) for n, shape in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)), ("wo", (32, 32)))}
    cache = ta.init_paged_cache(2, 3, 4, 1, 16, torch.float32)
    x = torch.zeros(2, 1, 32)
    table = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="decode-only"):
        ta.mha(x, w, cfg, Env(), mode="prefill", cache=cache, page_table=table)
    with pytest.raises(ValueError, match="page_table"):
        ta.mha(x, w, cfg, Env(), mode="decode", cache=cache)
    with pytest.raises(ValueError, match="contiguous"):
        ta.mha(x, w, cfg, Env(), mode="decode", cache=cache, page_table=table, window=4)
    # the int8 pool, once deferred, is ported: the reference's leaves
    q8 = ta.init_paged_cache(2, 3, 4, 1, 16, torch.int8)
    j8 = ja.init_paged_cache(2, 3, 4, 1, 16, jnp.int8)
    assert type(q8).__name__ == type(j8).__name__ == "PagedQuantKVCache"
    for f in ("k", "v", "k_scale", "v_scale", "pos"):
        assert tuple(getattr(q8, f).shape) == getattr(j8, f).shape, f


# ---------------------------------------------------------------------------
# on the card (marker ``cuda``; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"B{c[0]}Kv{c[1]}G{c[2]}p{c[3]}n{c[4]}")
def test_kernel_matches_plain_version_on_card(cuda_device, case):
    """The CUDA kernel against the plain version on the same CUDA tensors,
    within KERNEL_TOL; one launch per call; a permuted table gives the
    same output.

        PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -m cuda tests/test_torch_paged_attend.py
    """
    B, Kv, G, page, n_pages, phys, seed, lengths = case
    args = _port(_setup(B, Kv, G, page, n_pages, phys, seed=seed, lengths=lengths),
                 cuda_device)
    launches = paged_attend.launches
    got = paged_attend(*args)
    assert paged_attend.launches == launches + 1
    err = float((got - ref.paged_attend_ref(*args)).abs().max())
    torch.cuda.synchronize()
    assert err <= KERNEL_TOL, err
    q, kp, vp, table, lengths = args
    perm = torch.randperm(kp.shape[0], generator=torch.Generator().manual_seed(seed))
    inv = torch.argsort(perm).to(torch.int32).to(cuda_device)
    perm = perm.to(cuda_device)
    moved = paged_attend(q, kp[perm].contiguous(), vp[perm].contiguous(),
                         inv[table.to(torch.int64)].contiguous(), lengths)
    assert torch.equal(moved, got)


# (B, Kv, G, page, n_pages, pool rows, seed, lengths) that cross the
# split edges on a 132-SM card: lengths at the one-page splits' edges and
# the full table; a table wider than the live pages (splits past them are
# empty); multi-page splits (B=16 at 64 pages: 3 splits of 22 pages) at
# and across a split's edge
SPLIT_CASES = [
    (2, 8, 2, 64, 9, 19, 73, (576, 64)),
    (2, 8, 2, 64, 9, 19, 79, (128, 129)),
    (3, 8, 2, 64, 20, 61, 83, (65, 1, 0)),
    (16, 8, 2, 64, 64, 1025, 89, (1408, 1409) * 8),
    (2, 8, 2, 16, 40, 81, 97, (300, 0)),
    (2, 8, 2, 192, 4, 9, 103, (700, 193)),   # pages over 128 rows: chunks of one
    (2, 8, 2, 256, 3, 7, 107, (768, 257)),   # pool row, the last one partial
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: f"B{c[0]}p{c[3]}n{c[4]}L{c[7][0]}")
def test_kernel_at_split_edges_on_card(cuda_device, case):
    """Split edges on the card: within KERNEL_TOL of the plain version, two
    calls give the same bits, and a permuted pool the same output."""
    B, Kv, G, page, n_pages, phys, seed, lengths = case
    args = _port(_setup(B, Kv, G, page, n_pages, phys, seed=seed, lengths=lengths),
                 cuda_device)
    got = paged_attend(*args)
    again = paged_attend(*args)
    err = float((got - ref.paged_attend_ref(*args)).abs().max())
    torch.cuda.synchronize()
    assert err <= KERNEL_TOL, err
    assert torch.equal(got, again)
    q, kp, vp, table, lengths = args
    perm = torch.randperm(kp.shape[0], generator=torch.Generator().manual_seed(seed))
    inv = torch.argsort(perm).to(torch.int32).to(cuda_device)
    perm = perm.to(cuda_device)
    moved = paged_attend(q, kp[perm].contiguous(), vp[perm].contiguous(),
                         inv[table.to(torch.int64)].contiguous(), lengths)
    assert torch.equal(moved, got)


@pytest.mark.cuda
def test_kernel_marks_a_bad_table_entry_on_card(cuda_device):
    """An entry outside [0, P) in any split makes its slot NaN, and only
    its slot."""
    q, kp, vp, table, lengths = _port(_setup(2, 8, 2, 64, 9, 19, seed=101,
                                             lengths=(528, 528)), cuda_device)
    for j in (0, 5, 8):
        bad = table.clone()
        bad[1, j] = kp.shape[0]
        out = paged_attend(q, kp, vp, bad, lengths)
        torch.cuda.synchronize()
        assert bool(out[1].isnan().all()) and bool(out[0].isfinite().all()), j


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    args = _port(_setup(2, 2, 2, 8, 3, 12, seed=3), cuda_device)
    q, kp, vp, table, lengths = args
    with pytest.raises(ValueError, match="head_dim"):
        paged_attend(q[..., :64].contiguous(), kp[..., :64].contiguous(),
                     vp[..., :64].contiguous(), table, lengths)
    with pytest.raises(ValueError, match="int32"):
        paged_attend(q, kp, vp, table.to(torch.int64), lengths)
    with pytest.raises(ValueError, match="float32"):
        paged_attend(q.double(), kp.double(), vp.double(), table, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attend(q.transpose(1, 2), kp, vp, table, lengths)
    # a table whose rows would overflow the kernel's int32 row index
    kp1 = torch.zeros((1, 1 << 16, 1, 128), device=cuda_device)
    wide = torch.zeros((1, 1 << 15), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="page_size"):
        paged_attend(q[:1, :1, :1].contiguous(), kp1, kp1, wide, lengths[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 8, 2, 64, 9, 19), (3, 8, 4, 8, 66, 199),
                                  (2, 8, 2, 256, 3, 7)], ids=lambda c: "x".join(map(str, c)))
def test_bf16_kernel_matches_plain_version_on_card(cuda_device, case):
    """The bf16 kernel (it replaced a refusal of bf16 inputs) against its
    plain version on the same bf16 inputs: each element within one bf16
    step of the plain version's, plus the fp32 kernel's bar 2e-6 (both
    compute in fp32 and round once). One launch of the bf16 kernel, none
    of the fp32 one; mixed types raise without a launch."""
    B, Kv, G, page, width, P = case
    q, kp, vp, table, lengths = _port(_setup(B, Kv, G, page, width, P, seed=3), cuda_device)
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    before = (paged_attend.launches, paged_attend.launches_bf16)
    got = paged_attend(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert (paged_attend.launches, paged_attend.launches_bf16) == (before[0], before[1] + 1)
    want = ref.paged_attend_ref(q, kp, vp, table, lengths)
    step = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                       torch.frexp(want.float())[1] - 8)
    gap = (got.float() - want.float()).abs()
    assert got.dtype == torch.bfloat16 and bool((gap <= step + 2e-6).all()), float(gap.max())
    with pytest.raises(ValueError, match="bfloat16"):
        paged_attend(q.float(), kp, vp, table, lengths)
    assert paged_attend.launches_bf16 == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("page", [64, 256])
def test_a_row_alone_and_in_a_batch_gives_the_same_bits_on_card(cuda_device, page):
    """A slot's output is bit-equal alone, inside batches of 2 and 4 and
    inside a table twice as wide (unused entries at a trash row): its
    splits and merge order depend on the page size alone."""
    n_pages = 2048 // page
    args = _port(_setup(4, 8, 2, page, n_pages, 4 * n_pages + 1, seed=109,
                        lengths=(1500, 700, 2048, 65)), cuda_device)
    q, kp, vp, table, lengths = args
    alone = [paged_attend(q[b:b + 1].contiguous(), kp, vp, table[b:b + 1].contiguous(),
                          lengths[b:b + 1].contiguous()) for b in range(4)]
    for B in (2, 4):
        batch = paged_attend(q[:B].contiguous(), kp, vp, table[:B].contiguous(),
                             lengths[:B].contiguous())
        for b in range(B):
            assert torch.equal(batch[b], alone[b][0]), (B, b)
    trash = torch.full_like(table, kp.shape[0] - 1)
    wider = paged_attend(q, kp, vp, torch.cat([table, trash], 1).contiguous(), lengths)
    for b in range(4):
        assert torch.equal(wider[b], alone[b][0]), b
    err = float((wider - ref.paged_attend_ref(*args)).abs().max())
    torch.cuda.synchronize()
    assert err <= KERNEL_TOL, err
