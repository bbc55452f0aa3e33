"""flash_prefill: the port's plain version, wrapper and dispatch against
the JAX package, and the CUDA kernel against its plain version on the
card (marker ``cuda``).

Inputs are numpy-seeded unit normals. Tolerance atol 2e-5 between the
packages, as the reference holds its kernel to dense softmax attention
(``tests/test_kernels.py``): the same online-softmax algebra, summed in
another order by XLA and PyTorch. On the card the kernel is held to its
plain version within 1e-5.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as j_flash
from repro.kernels.flash_prefill import flash_prefill_ref as j_flash_ref
from repro.models.attention import attend_tiled as j_attend_tiled
from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import (KEY_TILE, MIN_TILES_BF16, SLOTS, SLOTS_BF16,
                                              flash_prefill, flash_work)
from repro_torch.models import attention as ta

ATOL = 2e-5

# (B, H, Kv, Sq, Sk, hd, q_offset): the reference's kernel test shapes
# (q tile ending the kv sequence) and its q_offset case
FLASH_CASES = [
    (1, 2, 1, 256, 256, 128, 0),
    (2, 4, 2, 128, 384, 128, 256),
    (1, 2, 2, 128, 256, 128, 128),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(B, H, Kv, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, s).astype(np.float32)
                 for s in ((B, H, Sq, hd), (B, Kv, Sk, hd), (B, Kv, Sk, hd)))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_version_matches_reference_kernel_and_oracle(case):
    *shape, off = case
    q, k, v = _qkv(*shape, seed=5)
    got = ref.flash_prefill_ref(*map(torch.from_numpy, (q, k, v)), q_offset=off).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = j_flash(jq, jk, jv, causal=True, q_offset=off, interpret=True)
    oracle = j_flash_ref(jq, jk, jv, causal=True, q_offset=off)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=ATOL, rtol=0)


def test_wrapper_on_a_cpu_tensor_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 128, 256, 128, seed=2))
    launches = flash_prefill.launches
    got = flash_prefill(q, k, v, q_offset=128)
    want = ref.flash_prefill_ref(q, k, v, q_offset=128)
    assert torch.equal(got, want)
    assert flash_prefill.launches == launches  # no kernel ran


@pytest.mark.parametrize("causal,window,chunk,Sq,Sk,off", [
    (True, None, 16, 64, 64, 0),
    (True, None, 32, 32, 96, 64),    # continuation: q ends the kv sequence
    (False, None, 16, 32, 40, 0),    # short kv: padded to a chunk multiple
    (True, 24, 16, 64, 64, 0),       # windowed
    (True, None, 64, 64, 64, 0),     # one chunk
])
def test_attend_tiled_matches_reference(causal, window, chunk, Sq, Sk, off):
    rng = np.random.default_rng(Sq + Sk + chunk)
    B, Kv, G, hd = 2, 2, 3, 32
    q = rng.normal(0, 1, (B, Sq, Kv, G, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off, chunk=chunk)
    got = ta.attend_tiled(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    want = np.asarray(j_attend_tiled(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("G,off", [(2, 0), (4, 128)])
def test_plain_version_through_the_fold_matches_attend_tiled(G, off):
    """``_flash_prefill_call`` folds ``(B,S,Kv,G,hd)`` into ``(B, Kv*G, S,
    hd)`` with ``h = kv*G + g``; with G > 1 a wrong fold gives other heads."""
    rng = np.random.default_rng(G)
    B, S, Kv, hd = 2, 128, 2, 128
    Sk = S + off
    q = torch.from_numpy(rng.normal(0, 1, (B, S, Kv, G, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32))
    got = ta._flash_prefill_call(q, k, v, q_offset=off)
    want = ta.attend_tiled(q, k, v, causal=True, window=None, q_offset=off, chunk=128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the kernel's work list (host side) and its piece / merge algebra
# ---------------------------------------------------------------------------

# (B, H, Kv, Sq, Sk, q_offset): chip_smoke's timed and main-path shapes
# (qwen3-1.7b's heads), the continuation at B=2, G=1, 3 and 4, and the
# reference kernel test's continuation
WORK_SHAPES = [
    (1, 16, 8, 128, 128, 0), (1, 16, 8, 512, 512, 0), (1, 16, 8, 2048, 2048, 0),
    (2, 16, 8, 512, 512, 0), (1, 16, 8, 384, 384, 0), (2, 16, 8, 128, 512, 384),
    (1, 16, 8, 1024, 1024, 0), (1, 8, 8, 256, 256, 0), (1, 24, 8, 256, 256, 0),
    (1, 32, 8, 192, 320, 128), (2, 4, 2, 128, 384, 256),
]


def _unit_rows(unit, Gc, Sq, H):
    """(b, heads, positions) of a unit's 64 rows, as the kernel reads them."""
    bq = 64 // Gc
    nqb, groups = Sq // bq, H // Gc
    qb, bhg = unit % nqb, unit // nqb
    hg, b = bhg % groups, bhg // groups
    return b, [hg * Gc + r // bq for r in range(64)], [qb * bq + r % bq for r in range(64)]


def _tilings(shapes):
    """Each shape at the fp32 kernel's tiling (``(slots, min_tiles)``; ids
    as the shape), then at the bf16 kernel's (ids ``bf16-`` and the
    shape)."""
    name = lambda c: "x".join(map(str, c))  # noqa: E731
    return [pytest.param(s, (SLOTS, 1), id=name(s)) for s in shapes] + \
        [pytest.param(s, (SLOTS_BF16, MIN_TILES_BF16), id=f"bf16-{name(s)}") for s in shapes]


@pytest.mark.parametrize("shape,tiling", _tilings(WORK_SHAPES))
def test_work_list_covers_every_unmasked_tile_once(shape, tiling):
    """Every (unit, unmasked 64-key tile) pair is in exactly one item, no
    tile lies past Sk or wholly above the diagonal, the units cover every
    (b, head, position) once, a split unit's pieces are near-equal runs of
    consecutive tiles on consecutive partial slots, no item holds more
    than ``max(min_tiles, ceil(tiles of one batch row / slots))`` tiles
    unless its unit is whole, and the items come longest first; at either
    kernel's tiling."""
    B, H, Kv, Sq, Sk, off = shape
    slots, min_tiles = tiling
    Gc, items, merges, n_parts = flash_work(B, H, Kv, Sq, Sk, off, slots, min_tiles)
    assert Gc in (1, 2, 4) and (H // Kv) % Gc == 0
    bq = 64 // Gc
    units = B * (H // Gc) * (Sq // bq)
    need = [-(-min(Sk, off + (u % (Sq // bq) + 1) * bq) // KEY_TILE) for u in range(units)]
    kmax = max(min_tiles, -(-sum(need) // B // slots))  # every row has the same tiles
    seen = {}
    for unit, lo, hi, slot, merge in items:
        _, _, pos = _unit_rows(unit, Gc, Sq, H)
        assert 0 <= lo < hi <= need[unit] and hi * KEY_TILE <= Sk
        assert (hi - 1) * KEY_TILE <= off + max(pos)  # the last tile holds a live key
        assert hi - lo <= kmax or (lo, hi) == (0, need[unit])
        seen.setdefault(unit, []).append((lo, hi, slot, merge))
    assert sorted(seen) == list(range(units))
    rows = {(b, h, p) for u in range(units)
            for b, hs, ps in [_unit_rows(u, Gc, Sq, H)] for h, p in zip(hs, ps)}
    assert len(rows) == B * H * Sq
    slots = []
    for unit, pieces in seen.items():
        pieces.sort()
        tiles = [t for lo, hi, _, _ in pieces for t in range(lo, hi)]
        assert tiles == list(range(need[unit]))
        if len(pieces) == 1:
            assert pieces[0][2:] == (-1, -1)
            continue
        first, n = merges[pieces[0][3]]
        assert n == len(pieces) and [p[2] for p in pieces] == list(range(first, first + n))
        assert {p[3] for p in pieces} == {pieces[0][3]}
        sizes = [hi - lo for lo, hi, _, _ in pieces]
        assert max(sizes) - min(sizes) <= 1
        slots += [p[2] for p in pieces]
    assert sorted(slots) == list(range(n_parts))
    lengths = [hi - lo for _, lo, hi, _, _ in items]
    assert lengths == sorted(lengths, reverse=True)


def _row_work(B, H, Kv, Sq, Sk, off, b, tiling):
    """Row ``b``'s items as ``(unit within the row, first tile, end tile,
    pieces of its unit)`` in list order, and its merges' piece counts."""
    Gc, items, merges, _ = flash_work(B, H, Kv, Sq, Sk, off, *tiling)
    per_row = (H // Gc) * (Sq // (64 // Gc))
    pieces = lambda merge: 1 if merge < 0 else merges[merge][1]  # noqa: E731
    mine = [(u - b * per_row, lo, hi, pieces(m)) for u, lo, hi, _, m in items
            if u // per_row == b]
    return mine, sorted(n for _, _, _, n in mine if n > 1)


@pytest.mark.parametrize("shape,tiling", _tilings([
    (16, 8, 512, 512, 0), (16, 8, 256, 256, 0), (16, 8, 128, 512, 384), (4, 2, 128, 384, 256),
    (8, 4, 512, 512, 0)]))
def test_a_rows_work_list_does_not_depend_on_the_batch(shape, tiling):
    """A row's items, their tile ranges and pieces, and so its merge order,
    are the same alone and as any row of a batch of 2 or 4: the piece size
    comes from one row's tiles, never from B. (Phase 7's static run
    prefills 512-token prompts at B=2, the engine at B=1.) At either
    kernel's tiling, and at the tp-2 heads."""
    H, Kv, Sq, Sk, off = shape
    alone = _row_work(1, H, Kv, Sq, Sk, off, 0, tiling)
    assert alone[0]
    for B in (2, 4):
        for b in range(B):
            assert _row_work(B, H, Kv, Sq, Sk, off, b, tiling) == alone, (B, b)


def _merged(parts):
    """``(m, l, acc)`` partials merged in order, as the kernels do."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - m) for p in parts]
    return (m, sum(wi * p[1] for wi, p in zip(w, parts)),
            sum(wi[:, None] * p[2] for wi, p in zip(w, parts)))


def _pieces_and_merge(q, k, v, q_offset, slots, halves=False, min_tiles=1):
    """The kernels' algebra in plain PyTorch: each item's softmax over its
    tiles (rows fully masked in a piece score -1e30 throughout; with
    ``halves``, as the bf16 kernel's two warpgroups, over the first and the
    second half of them, merged in that order), a whole unit normalised in
    place, a split unit's partials merged in piece order."""
    B, H, Sq, hd = q.shape
    Kv = k.shape[1]
    Gc, items, merges, _ = flash_work(B, H, Kv, Sq, k.shape[2], q_offset, slots, min_tiles)
    out, parts = torch.empty_like(q), {}
    for unit, lo, hi, slot, _ in items:
        b, heads, pos = _unit_rows(unit, Gc, Sq, H)
        kvh = heads[0] // (H // Kv)
        cuts = [lo, lo + (hi - lo + 1) // 2, hi] if halves else [lo, hi]
        runs = []
        for a, e in zip(cuts, cuts[1:]):
            if a == e:
                continue
            keys = torch.arange(a * KEY_TILE, e * KEY_TILE)
            s = q[b, heads, pos] @ k[b, kvh, keys].T * hd ** -0.5
            s = torch.where(torch.tensor(pos)[:, None] + q_offset >= keys[None], s, ref.NEG_INF)
            m = s.amax(-1)
            p = torch.exp(s - m[:, None])
            runs.append((m, p.sum(-1), p @ v[b, kvh, keys]))
        m, l, acc = _merged(runs)
        if slot < 0:
            out[b, heads, pos] = acc / torch.clamp(l, min=1e-30)[:, None]
        else:
            parts[slot] = (unit, m, l, acc)
    for first, n in merges:
        unit = parts[first][0]
        b, heads, pos = _unit_rows(unit, Gc, Sq, H)
        _, l, acc = _merged([parts[first + i][1:] for i in range(n)])
        out[b, heads, pos] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("shape", [(1, 4, 2, 256, 256, 0), (2, 4, 1, 128, 384, 256),
                                   (1, 8, 2, 192, 320, 128)],
                         ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("slots", [1, 16, 256, SLOTS_BF16])
def test_pieces_and_merge_match_plain_version(shape, slots):
    """Cutting a unit's tiles into pieces and merging their partials is
    the reference's attention (within ATOL), from whole units (one slot)
    down to one tile a piece; a row wholly masked in a piece weighs
    exactly 0. At the bf16 kernel's tiling each item is also cut in halves
    merged in shared memory, as its two warpgroups do."""
    B, H, Kv, Sq, Sk, off = shape
    bf16 = slots == SLOTS_BF16
    min_tiles = MIN_TILES_BF16 if bf16 else 1
    merges = flash_work(B, H, Kv, Sq, Sk, off, slots, min_tiles)[2]
    assert bool(merges) == (slots > 1) or slots in (16, SLOTS_BF16)  # as the shape falls
    q, k, v = map(torch.from_numpy, _qkv(B, H, Kv, Sq, Sk, 128, seed=Sq + slots))
    want = ref.flash_prefill_ref(q, k, v, q_offset=off, block_q=64, block_k=64)
    got = _pieces_and_merge(q, k, v, off, slots, halves=bf16, min_tiles=min_tiles)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def _fake(shape, device):
    return types.SimpleNamespace(shape=shape, device=torch.device(device))


@pytest.mark.parametrize("device,hd,Sq,Sk,window,pos,want", [
    ("cuda", 128, 256, 256, None, 0, True),
    ("cuda", 256, 128, 384, None, 0, True),
    ("cpu", 128, 256, 256, None, 0, False),      # the reference: not on its chip
    ("cuda", 64, 256, 256, None, 0, False),      # hd % 128
    ("cuda", 128, 200, 200, None, 0, False),     # untiled length
    ("cuda", 128, 256, 256, 64, 0, False),       # window
    ("cuda", 128, 256, 256, None, "per-slot", False),
])
def test_viability_rule(device, hd, Sq, Sk, window, pos, want):
    qg, k = _fake((1, Sq, 2, 2, hd), device), _fake((1, Sk, 2, hd), device)
    pos = torch.zeros(3, dtype=torch.int32) if pos == "per-slot" else pos
    assert ta._flash_prefill_viable(True, window, False, pos, qg, k) is want
    assert not ta._flash_prefill_viable(False, None, False, 0, qg, k)
    assert not ta._flash_prefill_viable(True, None, True, 0, qg, k)


# ---------------------------------------------------------------------------
# the bf16 kernel's exact P . V: p as three bf16 terms
# ---------------------------------------------------------------------------


def _split3(p: torch.Tensor):
    """The bf16 kernel's split of fp32 ``p`` (``split3`` in
    ``csrc/flash_prefill_bf16.cu``): each term the top 16 bits of what is
    left (a bf16 by truncation), the remainders taken in fp32. Returns the
    terms as fp32 tensors."""
    def top(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)  # 0xFFFF0000

    hi = top(p)
    r = p - hi
    mid = top(r)
    return hi, mid, r - mid


def _split_cases(kind):
    if kind == "uniform in log2":  # the softmax's p = exp2(s - m) over [2^-100, 1]
        e = np.random.default_rng(21).uniform(-100.0, 0.0, 1_000_000)
        return torch.from_numpy(np.exp2(e).astype(np.float32)).clamp(2.0**-100, 1.0)
    powers = torch.ldexp(torch.ones(101), -torch.arange(101)).float()  # 1, 1/2, ..., 2^-100
    if kind == "powers of two":
        return powers
    up = torch.nextafter(powers, torch.full_like(powers, 2.0))
    down = torch.nextafter(powers, torch.zeros_like(powers))
    return torch.cat([up[1:], down[:-1]])  # one ulp either side, inside [2^-100, 1]


@pytest.mark.parametrize("kind", ["uniform in log2", "powers of two",
                                  "one ulp either side of a power of two"])
def test_three_bf16_terms_give_back_p_and_exact_products(kind):
    """The exactness the bf16 kernel's P . V rests on: each term is a bf16,
    hi + mid + lo == p bit for bit for fp32 p in [2^-100, 1], and each
    term's product with a bf16 v is exact in fp32 (8 bits times 8 bits), so
    three bf16 wgmmas give the fp32 product p . v up to the fp32 sums'
    order."""
    p = _split_cases(kind)
    assert bool(((p >= 2.0**-100) & (p <= 1.0)).all())
    hi, mid, lo = _split3(p)
    for term in (hi, mid, lo):  # each a bf16: the low 16 bits are zero
        assert torch.equal(term.to(torch.bfloat16).float(), term)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, p.double())
    v = torch.from_numpy(np.random.default_rng(22).normal(0, 1, p.numel())
                         .astype(np.float32)).to(torch.bfloat16).float()
    for term in (hi, mid, lo):
        assert torch.equal((term * v).double(), term.double() * v.double())
    if kind == "uniform in log2":  # two terms are not enough: the third carries bits of p
        assert bool((lo != 0).any())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


# (B, H, Kv, Sq, Sk, q_offset): qwen3's heads at chip_smoke's lengths, a
# continuation, batch 2, and untiled-by-128 lengths; then the work list's
# edges: the continuation at B=2 (every unit in pieces), S=1024 (units of
# 1 to 16 tiles, those above 9 cut in two), G=4 (units of four heads) and
# G=3 (of one)
CARD_CASES = [
    (1, 16, 8, 128, 128, 0),
    (1, 16, 8, 512, 512, 0),
    (1, 16, 8, 128, 512, 384),
    (2, 16, 8, 256, 256, 0),
    (1, 4, 4, 192, 320, 128),
    (2, 16, 8, 128, 512, 384),
    (1, 16, 8, 1024, 1024, 0),
    (1, 32, 8, 192, 320, 128),
    (1, 24, 8, 256, 256, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_matches_plain_version_on_card(cuda_device, case):
    B, H, Kv, Sq, Sk, off = case
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(B, H, Kv, Sq, Sk, 128, seed=Sq))
    launches = flash_prefill.launches
    got = flash_prefill(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert flash_prefill.launches == launches + 1
    if Sq % 128 or Sk % 128:
        want = ref.flash_prefill_ref(q, k, v, q_offset=off, block_q=64, block_k=64)
    else:
        want = ref.flash_prefill_ref(q, k, v, q_offset=off)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_gives_the_same_bits_twice_on_card(cuda_device, case):
    """The work list is a function of the shapes and every merge runs in
    piece order, so two calls on one input give the same bits."""
    B, H, Kv, Sq, Sk, off = case
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(B, H, Kv, Sq, Sk, 128, seed=1))
    first = flash_prefill(q, k, v, q_offset=off)
    assert torch.equal(first, flash_prefill(q, k, v, q_offset=off))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = (torch.zeros(s, device=cuda_device) for s in
               ((1, 2, 128, 128), (1, 1, 128, 128), (1, 1, 128, 128)))
    launches = flash_prefill.launches
    with pytest.raises(ValueError):
        flash_prefill(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_prefill(q[..., :64].contiguous(), k[..., :64].contiguous(), v[..., :64].contiguous())
    with pytest.raises(ValueError):
        flash_prefill(q[:, :, :100], k, v)
    with pytest.raises(ValueError):
        flash_prefill(q.transpose(2, 3), k, v)
    # contiguous but 4 bytes off a float4 boundary
    flat = torch.zeros(q.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        flash_prefill(flat[1:].view(q.shape), k, v)
    assert flash_prefill.launches == launches


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step (the spacing of bf16 numbers) at each value of ``x``."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float())[1] - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 16, 8, 512, 512, 0), (2, 16, 8, 384, 384, 0),
                                  (1, 16, 8, 128, 512, 384), (1, 4, 4, 256, 256, 0),
                                  (1, 16, 8, 2048, 2048, 0), (1, 8, 4, 512, 512, 0)],
                         ids=lambda c: "x".join(map(str, c)))
def test_bf16_kernel_matches_plain_version_on_card(cuda_device, case):
    """The bf16 kernel (wgmma on the tensor cores) against its plain
    version on the same bf16 inputs: each element within one bf16 step of
    the plain version's, plus the fp32 kernels' bar 1e-5 (both compute in
    fp32 and round once; the fp32 sums' order moves a value near 0 by more
    than its own bf16 step); two calls give the same bits. One launch of
    the bf16 kernel a call, none of the fp32 one; mixed types raise
    without a launch."""
    B, H, Kv, Sq, Sk, off = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(B, H, Kv, Sq, Sk, 128, seed=7))
    before = (flash_prefill.launches, flash_prefill.launches_bf16)
    got = flash_prefill(q, k, v, q_offset=off)
    again = flash_prefill(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert (flash_prefill.launches, flash_prefill.launches_bf16) == (before[0], before[1] + 2)
    assert torch.equal(got, again)
    want = ref.flash_prefill_ref(q, k, v, q_offset=off)
    assert got.dtype == torch.bfloat16
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= bf16_step(want) + 1e-5).all()), float(gap.max())
    with pytest.raises(ValueError, match="bfloat16"):
        flash_prefill(q, k.float(), v)
    assert flash_prefill.launches_bf16 == before[1] + 2


ROW_CASES = [(16, 8, 512, 512, 0), (16, 8, 256, 256, 0), (16, 8, 128, 512, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    *(pytest.param(c, torch.float32, id="x".join(map(str, c))) for c in ROW_CASES),
    *(pytest.param(c, torch.bfloat16, id="bf16-" + "x".join(map(str, c))) for c in ROW_CASES)])
def test_a_row_alone_and_in_a_batch_gives_the_same_bits_on_card(cuda_device, case, dtype):
    """A row's output is bit-equal alone and inside batches of 2 and 4,
    from either kernel."""
    H, Kv, Sq, Sk, off = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(4, H, Kv, Sq, Sk, 128, seed=7))
    alone = [flash_prefill(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                           v[b:b + 1].contiguous(), q_offset=off) for b in range(4)]
    for B in (2, 4):
        batch = flash_prefill(q[:B].contiguous(), k[:B].contiguous(), v[:B].contiguous(),
                              q_offset=off)
        for b in range(B):
            assert torch.equal(batch[b], alone[b][0]), (B, b)
