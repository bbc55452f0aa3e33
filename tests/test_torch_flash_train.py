"""Training attention through the flash kernels: the differentiable
``flash_attention`` (the fp32 flash kernel with its log-sum-exp, forward;
``csrc/flash_attn_bwd.cu``, backward), its plain versions, the backward's
work list, and train mode's route (``models.attention._flash_train_viable``)
on the CPU; the kernels against their plain versions on the card (marker
``cuda``).

Inputs are numpy-seeded unit normals at head width 128. Tolerance: the
plain backward against autograd through ``attend_tiled`` within atol 2e-5
and rtol 1e-5 (the packages' attention tolerance; the same algebra summed
in another order: the two read 1.4e-6 to 6e-6 apart on gradients up to
13 at these shapes); a layer's weight gradients, sums over its rows,
within 1e-5 of their largest element. On the card the kernels are held to
the plain version run there: the output and the log-sum-exp within 1e-5,
each gradient within ``CARD_RTOL`` of its largest element (fp32 sums over
up to 2,048 rows in another order).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.registry import get_config, reduced
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attn_bwd import (SLOTS, bwd_work, flash_attention,
                                               flash_attn_bwd)
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models import attention as ta
from repro_torch.models.env import Env
from repro_torch.utils import spans

ATOL, RTOL = 2e-5, 1e-5
CARD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counters():
    spans.reset()
    yield
    spans.reset()


def _grouped(B, S, Kv, G, seed, Sk=None):
    """q (B, S, Kv, G, 128), k / v (B, Sk, Kv, 128), an output gradient
    like q: mha's layouts."""
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    shapes = ((B, S, Kv, G, 128), (B, Sk, Kv, 128), (B, Sk, Kv, 128), (B, S, Kv, G, 128))
    return tuple(torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for s in shapes)


def _folded(B, H, Kv, Sq, Sk, seed):
    """q, out-gradient (B, H, Sq, 128), k / v (B, Kv, Sk, 128): the
    kernels' layouts."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for s in
                  ((B, H, Sq, 128), (B, Kv, Sk, 128), (B, Kv, Sk, 128), (B, H, Sq, 128)))
    return q, k, v, g


GRID = [(B, G, S) for B in (1, 2) for G in (1, 2, 5, 8) for S in (128, 384)]
GRID_IDS = [f"B{B}-G{G}-S{S}" for B, G, S in GRID]


@pytest.mark.parametrize("B,G,S", GRID, ids=GRID_IDS)
def test_plain_backward_matches_autograd_through_attend_tiled(B, G, S):
    """The Function on CPU tensors (the plain forward with its log-sum-exp,
    the plain backward) through train mode's layouts against autograd
    through ``attend_tiled`` (chunk 128: several kv chunks a row)."""
    q, k, v, g = _grouped(B, S, 2, G, seed=B * 100 + G * 10 + S)
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want = ta.attend_tiled(*want_in, causal=True, window=None, q_offset=0, chunk=128)
    dwant = torch.autograd.grad(want, want_in, g)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    got = ta._flash_train_call(*got_in)
    dgot = torch.autograd.grad(got, got_in, g)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=ATOL, rtol=0)
    for name, a, b in zip("qkv", dgot, dwant):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


@pytest.mark.parametrize("B,G,S", GRID, ids=GRID_IDS)
def test_plain_forward_lse_is_logsumexp_of_masked_scores(B, G, S):
    H, Kv = 2 * G, 2
    q, k, v, _ = _folded(B, H, Kv, S, S, seed=S + G)
    out, lse = ref.flash_prefill_ref(q, k, v, return_lse=True)
    assert torch.equal(out, ref.flash_prefill_ref(q, k, v))
    s = q @ k.repeat_interleave(G, dim=1).transpose(-1, -2) * 128 ** -0.5
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s, ref.NEG_INF)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, dim=-1).numpy(), atol=2e-6, rtol=0)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    launches = flash_prefill.launches
    got = flash_prefill(q, k, v, return_lse=True)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)
    assert flash_prefill.launches == launches


def test_wrapper_backward_on_a_cpu_tensor_is_the_plain_version():
    q, k, v, g = _folded(1, 4, 2, 128, 256, seed=3)
    out, lse = ref.flash_prefill_ref(q, k, v, q_offset=128, return_lse=True)
    launches = flash_attn_bwd.launches
    got = flash_attn_bwd(q, k, v, out, lse, g, q_offset=128)
    want = ref.flash_attn_bwd_ref(q, k, v, out, lse, g, q_offset=128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert flash_attn_bwd.launches == launches


# ---------------------------------------------------------------------------
# the backward's work list, and its steps, pieces and dQ slots emulated
# ---------------------------------------------------------------------------

# (B, H, Kv, Sq, Sk, q_offset): qwen3-1.7b's training shape, a tp-2 rank's
# heads at B 1 (the long units cut), G 1, 5 and 8, and a continuation
WORK_SHAPES = [
    (2, 16, 8, 2048, 2048, 0), (1, 8, 4, 2048, 2048, 0), (1, 16, 8, 512, 512, 0),
    (2, 4, 4, 384, 384, 0), (1, 40, 8, 512, 512, 0), (1, 64, 8, 256, 256, 0),
    (2, 16, 8, 128, 512, 384), (1, 4, 2, 192, 320, 128),
]


def _imin(j, q_offset):
    first = 64 * j - q_offset - 63
    return -(-first // 64) if first > 0 else 0


@pytest.mark.parametrize("shape", WORK_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_bwd_work_covers_every_step_once(shape):
    """Each (unit, step) is in exactly one item; a unit's steps are the G
    heads' q-blocks that see its tile; a cut unit's pieces are near-equal
    runs of consecutive steps on consecutive partial slots; no piece holds
    more than ``ceil(steps of one batch row / SLOTS)``; items come longest
    first; ``qoff`` gives each q-block one dQ slot per kv tile up to the
    last it sees."""
    B, H, Kv, Sq, Sk, off = shape
    G, nqb, nkt = H // Kv, Sq // 64, Sk // 64
    items, merges, n_parts, qoff = bwd_work(B, H, Kv, Sq, Sk, off)
    steps = [G * max(0, nqb - _imin(j, off)) for j in range(nkt)]
    kmax = max(1, -(-sum(steps) * Kv // SLOTS))
    by_unit: dict = {}
    for unit, lo, hi, slot, merge in items:
        by_unit.setdefault(unit, []).append((lo, hi, slot, merge))
    assert sorted(by_unit) == list(range(B * Kv * nkt))
    slots_seen = []
    for unit, pieces in by_unit.items():
        pieces.sort()
        n = steps[unit % nkt]
        assert pieces[0][0] == 0 and pieces[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        if len(pieces) == 1:
            assert pieces[0][2:] == (-1, -1)
            continue
        sizes = [hi - lo for lo, hi, _, _ in pieces]
        assert max(sizes) <= kmax and max(sizes) - min(sizes) <= 1
        first, count = merges[pieces[0][3]]
        assert count == len(pieces) and [p[2] for p in pieces] == list(range(first, first + count))
        assert {p[3] for p in pieces} == {pieces[0][3]}
        slots_seen += [p[2] for p in pieces]
    assert sorted(slots_seen) == list(range(n_parts))
    lengths = [hi - lo for _, lo, hi, _, _ in items]
    assert lengths == sorted(lengths, reverse=True)
    for i in range(nqb):
        seen = [j for j in range(nkt) if _imin(j, off) <= i]
        assert seen == list(range(qoff[i + 1] - qoff[i]))
    if shape == (2, 16, 8, 2048, 2048, 0):  # qwen3's training shape: 512 whole units
        assert n_parts == 0 and len(items) == 512 and lengths[0] == 64 and lengths[-1] == 2


def _emulate_bwd(q, k, v, out, lse, dout, q_offset, slots):
    """The main kernel's schedule in plain PyTorch: each item's steps in
    order (P from the log-sum-exp, dV and dK accumulated over the steps,
    each step's dQ contribution into its slot), a cut unit's partials
    summed in piece order, then each q-block's slots summed in kv-tile
    order and scaled."""
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    G, nqb, nkt, scale = H // Kv, Sq // 64, Sk // 64, hd ** -0.5
    items, merges, n_parts, qoff = bwd_work(B, H, Kv, Sq, Sk, q_offset, slots)
    delta = (dout * out).sum(-1)
    dq_part = torch.zeros(B, H, qoff[-1], 64, hd)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part, last = torch.zeros(n_parts, 2, 64, hd), {}
    for unit, lo, hi, slot, merge in items:
        j, bk = unit % nkt, unit // nkt
        b, kvh = bk // Kv, bk % Kv
        imin = _imin(j, q_offset)
        kt, vt = k[b, kvh, 64 * j:64 * j + 64], v[b, kvh, 64 * j:64 * j + 64]
        acc_v, acc_k = torch.zeros(64, hd), torch.zeros(64, hd)
        for s in range(lo, hi):
            h, i = kvh * G + s // (nqb - imin), imin + s % (nqb - imin)
            rows = slice(64 * i, 64 * i + 64)
            qt, gt = q[b, h, rows], dout[b, h, rows]
            qpos = q_offset + 64 * i + torch.arange(64)
            keys = 64 * j + torch.arange(64)
            p = torch.exp(qt @ kt.T * scale - lse[b, h, rows, None])
            p = torch.where(qpos[:, None] >= keys[None, :], p, 0.0)
            ds = p * (gt @ vt.T - delta[b, h, rows, None])
            acc_v += p.T @ gt
            acc_k += ds.T @ qt
            dq_part[b, h, qoff[i] + j] = ds @ kt
        if slot < 0:
            dv[b, kvh, 64 * j:64 * j + 64], dk[b, kvh, 64 * j:64 * j + 64] = acc_v, acc_k * scale
            continue
        part[slot] = torch.stack([acc_v, acc_k])
        last[merge] = (b, kvh, j)
    for merge, (first, pieces) in enumerate(merges):  # whichever piece finishes last
        b, kvh, j = last[merge]
        total = part[first:first + pieces].sum(0)
        dv[b, kvh, 64 * j:64 * j + 64] = total[0]
        dk[b, kvh, 64 * j:64 * j + 64] = total[1] * scale
    dq = torch.stack([dq_part[:, :, qoff[i]:qoff[i + 1]].sum(2) for i in range(nqb)], 2)
    return dq.reshape(B, H, Sq, hd) * scale, dk, dv


@pytest.mark.parametrize("shape,slots", [
    ((1, 4, 2, 256, 256, 0), SLOTS), ((1, 4, 2, 256, 256, 0), 4),
    ((2, 4, 1, 128, 384, 256), 3), ((1, 6, 2, 192, 320, 128), 5), ((1, 2, 2, 256, 256, 0), 1),
], ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else f"slots{c}")
def test_steps_pieces_and_dq_slots_match_plain_version(shape, slots):
    B, H, Kv, Sq, Sk, off = shape
    q, k, v, g = _folded(B, H, Kv, Sq, Sk, seed=Sq + slots)
    out, lse = ref.flash_prefill_ref(q, k, v, q_offset=off, block_q=64, block_k=64,
                                     return_lse=True)
    got = _emulate_bwd(q, k, v, out, lse, g, off, slots)
    want = ref.flash_attn_bwd_ref(q, k, v, out, lse, g, q_offset=off)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=RTOL, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# train mode's route
# ---------------------------------------------------------------------------


def _fake(shape, device):
    return types.SimpleNamespace(shape=shape, device=torch.device(device))


@pytest.mark.parametrize("device,hd,S,causal,window,cross,pos,want", [
    ("cuda", 128, 256, True, None, False, 0, True),
    ("cuda", 128, 2048, True, None, False, 0, True),
    ("cpu", 128, 256, True, None, False, 0, False),       # the CPU: attend_tiled
    ("cuda", 64, 256, True, None, False, 0, False),       # hd 64
    ("cuda", 256, 256, True, None, False, 0, False),      # the kernels' width is 128
    ("cuda", 128, 200, True, None, False, 0, False),      # untiled length
    ("cuda", 128, 256, True, 64, False, 0, False),        # windowed
    ("cuda", 128, 256, True, None, True, 0, False),       # cross
    ("cuda", 128, 256, False, None, False, 0, False),     # bidirectional (hubert)
    ("cuda", 128, 256, True, None, False, "per-slot", False),
], ids=["viable", "viable-S2048", "cpu", "hd64", "hd256", "S200", "window", "cross",
        "bidirectional", "per-slot"])
def test_train_viability_rule(device, hd, S, causal, window, cross, pos, want):
    qg, k = _fake((2, S, 8, 2, hd), device), _fake((2, S, 8, hd), device)
    pos = torch.zeros(2, dtype=torch.int32) if pos == "per-slot" else pos
    assert ta._flash_train_viable(causal, window, cross, pos, qg, k) is want


def _close(got, want, rtol=CARD_RTOL):
    """Within ``rtol`` of the largest element of ``want``."""
    gap = float((got - want).abs().max())
    assert gap <= rtol * float(want.abs().max()), (gap, float(want.abs().max()))


def _layer(seed=0, H=4, Kv=2):
    """A qk-norm GQA layer at head width 128 (reduced qwen3-1.7b's other
    widths) and its weights."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), head_dim=128, num_heads=H,
                              num_kv_heads=Kv)
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {"wq": (d, H * hd), "wk": (d, Kv * hd), "wv": (d, Kv * hd), "wo": (H * hd, d)}
    w = {n: torch.from_numpy(rng.normal(0, d ** -0.5, s).astype(np.float32))
         for n, s in shapes.items()}
    w["q_norm"] = torch.from_numpy(rng.uniform(0.5, 1.5, hd).astype(np.float32))
    w["k_norm"] = torch.from_numpy(rng.uniform(0.5, 1.5, hd).astype(np.float32))
    return cfg, w


def _layer_grads(cfg, w, x, remat=False):
    """The layer's output and the gradients of its input and weights for
    a fixed output gradient."""
    xs = x.clone().requires_grad_()
    ws = {n: t.clone().requires_grad_() for n, t in w.items()}
    fn = lambda x_: ta.mha(x_, ws, cfg, Env(), mode="train")[0]  # noqa: E731
    y = checkpoint(fn, xs, use_reentrant=False) if remat else fn(xs)
    g = torch.from_numpy(np.random.default_rng(9).normal(0, 1, y.shape).astype(np.float32)).to(y)
    grads = torch.autograd.grad(y, [xs, *ws.values()], g)
    return y.detach(), dict(zip(["x", *ws], grads))


def test_train_mode_on_cpu_takes_attend_tiled(monkeypatch):
    """On the CPU a viable shape keeps ``attend_tiled`` (the JAX package's
    branch there): the flash route is never called, and the counters say so."""
    def no_flash(*a, **k):
        raise AssertionError("train mode on the CPU reached the flash route")

    monkeypatch.setattr(ta, "_flash_train_call", no_flash)
    cfg, w = _layer()
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (1, 128, cfg.d_model))
                         .astype(np.float32))
    with spans.enabled():
        y, _ = ta.mha(x, w, cfg, Env(), mode="train")
    assert y.shape == x.shape
    assert spans.counters() == {"attention.tiled_train": 1}


def test_train_mode_takes_the_flash_route_where_viable(monkeypatch):
    """With the rule made to hold on the CPU, train mode takes the flash
    Function (its plain versions here), counts it, and gives the tiled
    route's output and gradients, remat or not."""
    cfg, w = _layer()
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (2, 256, cfg.d_model))
                         .astype(np.float32))
    y_t, g_t = _layer_grads(cfg, w, x)
    monkeypatch.setattr(ta, "_flash_train_viable", lambda *a: True)
    with spans.enabled():
        y_f, g_f = _layer_grads(cfg, w, x)
        assert spans.counters() == {"attention.flash_train": 1}
        y_r, g_r = _layer_grads(cfg, w, x, remat=True)
        assert spans.counters() == {"attention.flash_train": 3}  # remat: forward twice
    np.testing.assert_allclose(y_f.numpy(), y_t.numpy(), atol=ATOL, rtol=RTOL)
    assert torch.equal(y_r, y_f)
    for n in g_t:  # the weights' gradients sum 512 rows: held to their largest element
        _close(g_f[n], g_t[n])
        assert torch.equal(g_r[n], g_f[n]), n


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``, loaded as a module."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,layers,seq,on_card,want", [
    ("qwen3-1.7b", None, 128, True, (112, 56)),  # 28 layers x 2 steps, remat: 2 forwards
    ("qwen3-1.7b", 4, 2048, True, (16, 8)),
    ("qwen3-1.7b", None, 128, False, (0, 0)),  # the CPU
    ("qwen3-1.7b", None, 200, True, (0, 0)),  # not a multiple of 128
    ("llama-3.2-vision-90b", 5, 128, True, (16, 8)),  # 4 self-attention layers; no cross
    ("hubert-xlarge", None, 128, True, (0, 0)),  # bidirectional, head width 80
    ("mixtral-8x7b", 4, 128, True, (0, 0)),  # windowed
    ("xlstm-1.3b", 4, 128, True, (0, 0)),  # no attention layer
    ("recurrentgemma-9b", 19, 128, True, (0, 0)),  # local attention: windowed
], ids=["qwen3", "qwen3-4-layers", "cpu", "S200", "vision", "hubert", "mixtral", "xlstm",
        "recurrentgemma"])
def test_chip_smoke_counts_the_training_flash_launches(smoke, name, layers, seq, on_card, want):
    """``chip_smoke.train_flash``: the flash forwards (twice a layer under
    remat) and backward calls of two training steps, by the route's rule."""
    cfg = get_config(name)
    cfg = cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
    got = smoke.train_flash(cfg, seq, 2, on_card)
    assert (got["flash_prefill"], got["flash_attn_bwd"]) == want
    no_remat = smoke.train_flash(dataclasses.replace(cfg, remat=False), seq, 2, on_card)
    assert no_remat == {"flash_prefill": want[1], "flash_attn_bwd": want[1]}


def test_chip_smoke_holds_training_flash_calls_to_plain_versions(smoke, monkeypatch):
    """``chip_smoke.watch_train_flash`` records the first forward and
    backward of a layer on the flash route (the plain versions here), the
    backward's launch count stays on the wrapper while it watches (the
    wrapper bumps it through its module's name), and
    ``check_seen_train_flash`` passes the records and fails a corrupted
    one."""
    from repro_torch.kernels import flash_attn_bwd as fab

    monkeypatch.setattr(ta, "_flash_train_viable", lambda *a: True)
    cfg, w = _layer(H=4, Kv=2)
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (1, 256, cfg.d_model))
                         .astype(np.float32))
    seen = {}
    undo = smoke.watch_train_flash(torch, seen)
    try:
        _layer_grads(cfg, w, x, remat=True)
        before = flash_attn_bwd.launches
        fab.flash_attn_bwd.launches += 2  # as the wrapper counts a launch on the card
        assert flash_attn_bwd.launches == before + 2
        assert smoke.counts()["flash_attn_bwd"] == before + 2
        smoke.zero_counts()
        assert flash_attn_bwd.launches == 0
    finally:
        undo()
    assert fab.flash_attn_bwd is flash_attn_bwd and fab.flash_prefill is flash_prefill
    assert sorted(seen) == [("backward", (1, 4, 256, 128), (1, 2, 256, 128)),
                            ("forward", (1, 4, 256, 128), (1, 2, 256, 128))]
    (ins, (dq, dk, dv)) = seen[("backward", (1, 4, 256, 128), (1, 2, 256, 128))]
    bad = {("backward", "bad", ""): (ins, (dq, dk, dv + 1e-3 * dv.abs().max()))}
    errs = []
    smoke.check_seen_train_flash(seen, errs)
    assert errs == [0.0] * 5 and all(rec is None for rec in seen.values())
    with pytest.raises(smoke.CheckFailed, match="training flash backward"):
        smoke.check_seen_train_flash(bad, errs)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


# (B, H, Kv, Sq, Sk, q_offset): qwen3-1.7b's training shape, a tp-2 rank's
# heads at B 2 and at B 1 (the long units cut into pieces), G 5, and a
# continuation (q_offset > 0, Sk > Sq)
CARD_CASES = [
    (2, 16, 8, 2048, 2048, 0), (2, 8, 4, 2048, 2048, 0), (1, 8, 4, 2048, 2048, 0),
    (1, 40, 8, 512, 512, 0), (1, 16, 8, 128, 512, 384),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernels_match_plain_version_on_card(cuda_device, case):
    B, H, Kv, Sq, Sk, off = case
    q, k, v, g = (t.to(cuda_device) for t in _folded(B, H, Kv, Sq, Sk, seed=Sq + H))
    before = (flash_prefill.launches, flash_attn_bwd.launches)
    out, lse = flash_prefill(q, k, v, q_offset=off, return_lse=True)
    grads = flash_attn_bwd(q, k, v, out, lse, g, q_offset=off)
    torch.cuda.synchronize()
    assert (flash_prefill.launches, flash_attn_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_out, want_lse = ref.flash_prefill_ref(q, k, v, q_offset=off, return_lse=True)
    assert float((out - want_out).abs().max()) <= 1e-5
    assert float((lse - want_lse).abs().max()) <= 1e-5
    want = ref.flash_attn_bwd_ref(q, k, v, want_out, want_lse, g, q_offset=off)
    for a, b in zip(grads, want):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES[:3], ids=lambda c: "x".join(map(str, c)))
def test_backward_gives_the_same_bits_twice_on_card(cuda_device, case):
    """No float atomics: the dQ slots and a cut unit's partials are summed
    in a fixed order, so two calls give the same bits."""
    B, H, Kv, Sq, Sk, off = case
    q, k, v, g = (t.to(cuda_device) for t in _folded(B, H, Kv, Sq, Sk, seed=1))
    out, lse = flash_prefill(q, k, v, q_offset=off, return_lse=True)
    first = flash_attn_bwd(q, k, v, out, lse, g, q_offset=off)
    again = flash_attn_bwd(q, k, v, out, lse, g, q_offset=off)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(1, 16, 8, 2048, 2048, 0), (2, 16, 8, 512, 512, 0),
                                  (2, 16, 8, 128, 512, 384), (1, 24, 8, 256, 256, 0)],
                         ids=lambda c: "x".join(map(str, c)))
def test_lse_output_leaves_the_serving_bits_on_card(cuda_device, case):
    """Serving passes no log-sum-exp pointer: its output has the same bits
    as the training forward's, whose LSE the unit's only or merging piece
    writes."""
    B, H, Kv, Sq, Sk, off = case
    q, k, v, _ = (t.to(cuda_device) for t in _folded(B, H, Kv, Sq, Sk, seed=4))
    serve = flash_prefill(q, k, v, q_offset=off)
    train, lse = flash_prefill(q, k, v, q_offset=off, return_lse=True)
    assert torch.equal(serve, train)
    assert bool(torch.isfinite(lse).all())


@pytest.mark.cuda
def test_remat_layer_matches_no_remat_on_card(cuda_device):
    """One layer at qwen3-1.7b's heads (16 / 8) on the flash route, under
    ``torch.utils.checkpoint`` and without: the same gradients (the
    recomputed forward gives the forward's bits), and both near the plain
    versions' on the CPU, run in float64 there (a host's fp32 products may
    run at reduced precision: one host read 1e-4 of the largest element
    off, where the card reads 1.1e-6 from float64)."""
    cfg, w = _layer(H=16, Kv=8)
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 512, cfg.d_model))
                         .astype(np.float32))
    wd = {n: t.to(cuda_device) for n, t in w.items()}
    with spans.enabled():
        y, grads = _layer_grads(cfg, wd, x.to(cuda_device))
        y_r, grads_r = _layer_grads(cfg, wd, x.to(cuda_device), remat=True)
        assert spans.counters() == {"attention.flash_train": 3}
    # attend_tiled on the CPU, in float64
    _, grads_cpu = _layer_grads(cfg, {n: t.double() for n, t in w.items()}, x.double())
    assert torch.equal(y, y_r)
    for n in grads:
        _close(grads_r[n], grads[n])
        _close(grads[n].cpu().double(), grads_cpu[n], rtol=1e-4)


@pytest.mark.cuda
def test_bf16_inputs_take_the_fp32_kernels_on_card(cuda_device):
    """bf16 q / k / v go through the fp32 kernels as their exact fp32
    values: the output and gradients are the fp32 route's, rounded to
    bf16."""
    q, k, v, g = _grouped(1, 512, 8, 2, seed=5)
    q, k, v, g = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v, g))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ta._flash_train_call(*ins)
    grads = torch.autograd.grad(out, ins, g)
    ins32 = [t.float().requires_grad_() for t in (q, k, v)]
    out32 = ta._flash_train_call(*ins32)
    grads32 = torch.autograd.grad(out32, ins32, g.float())
    assert out.dtype == torch.bfloat16 and torch.equal(out, out32.to(torch.bfloat16))
    for a, b in zip(grads, grads32):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))
