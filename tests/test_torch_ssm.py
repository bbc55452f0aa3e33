"""The recurrent blocks of the port (``repro_torch.models.ssm``: the mLSTM,
sequential and chunkwise, and the sLSTM; ``repro_torch.models.rglru``)
against the JAX reference (``repro.models.ssm``, ``repro.models.rglru``)
on the CPU, at ``reduced()`` widths (d 256, 4 heads; the mLSTM's 512 value
columns, dk 128 a head; an RG-LRU 256 wide).

Inputs and weights are numpy from seeds, given to both packages as they
are. Tolerances (fp32; the libraries' ``exp``, ``tanh``, ``sigmoid`` and
``log1p`` differ in their last bits, and their sums run in another order):

* a block's output against the reference's: atol 2e-5 / rtol 2e-4 (the
  outputs are O(0.1-1) after hundreds of recurrent steps), the states
  within atol 1e-4 / rtol 1e-4 (the mLSTM's ``C`` sums ``i'·k·v`` terms
  of O(10));
* the chunkwise mLSTM against the sequential one: the reference's own
  bars (``tests/test_ssm.py``): rtol 2e-3 / atol 1e-5 on h, rtol 2e-4 /
  atol 2e-5 on ``C`` and ``n``, rtol 1e-4 on ``m``;
* decode continuation (a prefill, then one-token steps) against the
  whole sequence in one call: the block's output at atol 1e-5 / rtol 1e-4;
* the RG-LRU's associative scan against a sequential scan and against
  ``lax.associative_scan``: rtol 1e-6 / atol 1e-6 (products of numbers in
  (0, 1) and sums of O(1) terms, in the same tree order as XLA's up to its
  fusion).

A last test pins that heads wider than 128 (recurrentgemma's 256,
xlstm's 512) never reach either CUDA attention kernel, which take 128
only: their wrappers refuse such a head on the card before any launch,
and no ported arch sends one there (xLSTM has no attention;
recurrentgemma's 256-wide heads sit in ``local`` blocks, whose window
keeps them off flash prefill and out of the paged engine).
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.models import rglru as jr
from repro.models import ssm as js
from repro.models.env import Env as JEnv
from repro_torch.configs.registry import get_config, reduced
from repro_torch.models import attention as ta
from repro_torch.models import rglru as tr
from repro_torch.models import ssm as ts
from repro_torch.models.env import Env

OUT_TOL = dict(atol=2e-5, rtol=2e-4)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
CHUNK_H_TOL = dict(rtol=2e-3, atol=1e-5)
CHUNK_CN_TOL = dict(rtol=2e-4, atol=2e-5)
CHUNK_M_RTOL = 1e-4
DECODE_TOL = dict(atol=1e-5, rtol=1e-4)
SCAN_TOL = dict(atol=1e-6, rtol=1e-6)
B = 2

# the reference's blocks under ``jax.jit`` (config and env static): one
# compile a shape, where eager mode compiles each of their ops one by one
J_MLSTM, J_SLSTM, J_RGLRU = (jax.jit(f, static_argnums=(2, 3), static_argnames=("mode",))
                             for f in (js.mlstm_block, js.slstm_block, jr.rglru_block))
J_CHUNKWISE = jax.jit(js.mlstm_chunkwise, static_argnums=6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return j_reduced(j_get_config(arch)), reduced(get_config(arch))


def _weights(shapes, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in shapes.items():
        if k == "ln":
            out[k] = (1 + rng.normal(0, 0.1, shp)).astype(np.float32)
        elif k == "lam":
            out[k] = rng.uniform(0.5, 3.0, shp).astype(np.float32)
        else:
            out[k] = rng.normal(0, scale, shp).astype(np.float32)
    return out


def _pair(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v.copy()) for k, v in w.items()})


def _x(S, d, seed):
    return np.random.default_rng(seed).normal(0, 1, (B, S, d)).astype(np.float32)


def _mlstm_weights(cfg, seed=0):
    d, H = cfg.d_model, cfg.num_heads
    dv = int(cfg.mlstm_proj_factor * d)
    return _weights({"ln": (d,), "wq": (d, dv), "wk": (d, dv), "wv": (d, dv), "wi": (d, H),
                     "wf": (d, H), "wog": (d, dv), "w_down": (dv, d)}, seed)


def _close_state(t, j, tol):
    for f in dataclasses.fields(t):
        np.testing.assert_allclose(getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)),
                                   err_msg=f.name, **tol)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8, 16, 64])
def test_mlstm_block_matches_reference(chunk):
    """Sequential (chunk 0) and chunkwise mLSTM blocks over 64 tokens: the
    output and the final state against the reference's block at the same
    ``mlstm_chunk``."""
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jw, tw = _pair(_mlstm_weights(tcfg))
    x = _x(64, tcfg.d_model, 1)
    jy, jst = J_MLSTM(jnp.asarray(x), jw, jcfg, JEnv(mlstm_chunk=chunk))
    ty, tst = ts.mlstm_block(torch.from_numpy(x), tw, tcfg, Env(mlstm_chunk=chunk))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    _close_state(tst, jst, STATE_TOL)


def _mlstm_inputs(S, H=4, dk=16, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (B, S, H, n)).astype(np.float32) for n in (dk, dk, dv))
    i = rng.normal(0, 0.5, (B, S, H)).astype(np.float32)
    f = np.array(jax.nn.log_sigmoid(rng.normal(1, 0.5, (B, S, H)).astype(np.float32)))
    return q, k, v, i, f


def _seq_scan(q, k, v, i, f, st):
    """The port's sequential mLSTM over (B, S, ...) inputs."""
    C, n, m, hs = st.C, st.n, st.m, []
    for t in range(q.shape[1]):
        C, n, m, h = ts._mlstm_step(C, n, m, q[:, t], k[:, t], v[:, t], i[:, t], f[:, t])
        hs.append(h)
    return torch.stack(hs, 1), ts.MLSTMState(C, n, m)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_sequential_and_reference(chunk):
    """``mlstm_chunkwise`` against the port's sequential steps at the
    reference's own bars, and against the reference's chunkwise form."""
    arrs = _mlstm_inputs(64)
    t = [torch.from_numpy(a) for a in arrs]
    st0 = ts.init_mlstm_state(B, 4, 16, 16, torch.float32)
    h1, s1 = _seq_scan(*t, st0)
    h2, s2 = ts.mlstm_chunkwise(*t, st0, chunk)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), **CHUNK_H_TOL)
    np.testing.assert_allclose(s2.C.numpy(), s1.C.numpy(), **CHUNK_CN_TOL)
    np.testing.assert_allclose(s2.n.numpy(), s1.n.numpy(), **CHUNK_CN_TOL)
    np.testing.assert_allclose(s2.m.numpy(), s1.m.numpy(), rtol=CHUNK_M_RTOL)
    jh, jst = J_CHUNKWISE(*map(jnp.asarray, arrs),
                                 js.init_mlstm_state(B, 4, 16, 16, jnp.float32), chunk)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh), **OUT_TOL)
    _close_state(s2, jst, STATE_TOL)


def _chunk_grads(torch_mode, scale, seed=0):
    """Gradients of Σh over the gates' pre-activations, chunk 64 over 128
    steps, the forget gate's pre-activation at ``scale`` (log-space decay
    cumulating to -100s: the masked ``exp`` overflows at scale 5)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (B, 128, 4, 16)).astype(np.float32) for _ in range(3))
    i = rng.normal(0, scale, (B, 128, 4)).astype(np.float32)
    x = rng.normal(0, scale, (B, 128, 4)).astype(np.float32)
    if torch_mode:
        ti, tx = torch.tensor(i, requires_grad=True), torch.tensor(x, requires_grad=True)
        h, _ = ts.mlstm_chunkwise(*(torch.from_numpy(a) for a in (q, k, v)), ti,
                                  torch.nn.functional.logsigmoid(tx),
                                  ts.init_mlstm_state(B, 4, 16, 16, torch.float32), 64)
        h.sum().backward()
        return h.detach().numpy(), ti.grad.numpy(), tx.grad.numpy()

    def loss(i, x):
        h, _ = js.mlstm_chunkwise(q, k, v, i, jax.nn.log_sigmoid(x),
                                  js.init_mlstm_state(B, 4, 16, 16, jnp.float32), 64)
        return h.sum(), h

    (_, h), (gi, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(i), jnp.asarray(x))
    return np.asarray(h), np.asarray(gi), np.asarray(gx)


def test_mlstm_chunkwise_gradients_stay_finite():
    """ROADMAP F4: where an s > t entry of the intra-chunk decay overflows,
    the reference's ``where(mask, exp(w), 0)`` turns its zero cotangent
    into 0 · inf = NaN; the port masks before the ``exp`` (the same
    values), so its gradients stay finite, and where nothing overflows
    they equal the reference's (atol 1e-4 / rtol 1e-3: sums of hundreds of
    O(1) terms in another order)."""
    h, gi, gx = _chunk_grads(True, 5.0)
    jh, jgi, jgx = _chunk_grads(False, 5.0)
    assert np.isfinite(h).all() and np.isfinite(gi).all() and np.isfinite(gx).all()
    assert not (np.isfinite(jgi).all() and np.isfinite(jgx).all())  # the reference's fault
    np.testing.assert_allclose(h, jh, **OUT_TOL)
    h, gi, gx = _chunk_grads(True, 1.0)
    jh, jgi, jgx = _chunk_grads(False, 1.0)
    np.testing.assert_allclose(gi, jgi, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(gx, jgx, atol=1e-4, rtol=1e-3)


def test_mlstm_nonzero_initial_state():
    """A chunkwise and a sequential pass from the same non-zero state, in
    both packages."""
    arrs = _mlstm_inputs(16, seed=3)
    rng = np.random.default_rng(9)
    C0 = rng.normal(0, 0.1, (B, 4, 16, 16)).astype(np.float32)
    n0 = rng.normal(0, 0.1, (B, 4, 16)).astype(np.float32)
    m0 = rng.normal(0, 0.1, (B, 4)).astype(np.float32)
    tst = ts.MLSTMState(*(torch.from_numpy(a) for a in (C0, n0, m0)))
    h1, s1 = _seq_scan(*(torch.from_numpy(a) for a in arrs), tst)
    h2, s2 = ts.mlstm_chunkwise(*(torch.from_numpy(a) for a in arrs), tst, 8)
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), **CHUNK_H_TOL)
    np.testing.assert_allclose(s2.C.numpy(), s1.C.numpy(), **CHUNK_CN_TOL)
    jh, jst = J_CHUNKWISE(*map(jnp.asarray, arrs),
                                 js.MLSTMState(*map(jnp.asarray, (C0, n0, m0))), 8)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh), **OUT_TOL)
    _close_state(s2, jst, STATE_TOL)


@pytest.mark.parametrize("chunk", [0, 16])
def test_mlstm_decode_continues_prefill(chunk):
    """A 32-token prefill into a state (updated in place), then 4 decode
    steps, equals the 36-token block in one call; the reference's decode
    from the reference's prefill state gives the same outputs."""
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jw, tw = _pair(_mlstm_weights(tcfg, seed=2))
    x = _x(36, tcfg.d_model, 4)
    env = Env(mlstm_chunk=chunk)
    whole, _ = ts.mlstm_block(torch.from_numpy(x), tw, tcfg, env)
    H, dv = tcfg.num_heads, int(tcfg.mlstm_proj_factor * tcfg.d_model)
    st = ts.init_mlstm_state(B, H, dv // H, dv // H, torch.float32)
    y0, back = ts.mlstm_block(torch.from_numpy(x[:, :32]), tw, tcfg, env, mode="prefill",
                              state=st)
    assert back is st  # in place
    ys = [y0]
    jy0, jst = J_MLSTM(jnp.asarray(x[:, :32]), jw, jcfg, JEnv(mlstm_chunk=chunk))
    jys = [jy0]
    for t in range(32, 36):
        ys.append(ts.mlstm_block(torch.from_numpy(x[:, t:t + 1]), tw, tcfg, env,
                                 mode="decode", state=st)[0])
        jy, jst = J_MLSTM(jnp.asarray(x[:, t:t + 1]), jw, jcfg, JEnv(), mode="decode",
                                 state=jst)
        jys.append(jy)
    got = torch.cat(ys, 1).numpy()
    np.testing.assert_allclose(got, whole.numpy(), **DECODE_TOL)
    np.testing.assert_allclose(got, np.concatenate([np.asarray(a) for a in jys], 1), **OUT_TOL)
    _close_state(st, jst, STATE_TOL)


def test_mlstm_value_columns_shard_within_heads():
    """At tp 2 a rank's contiguous slice of wv / wog / w_down holds half of
    every head's value dim (the (dvh, H) layout): the two ranks' partial
    outputs sum to the one-device block's output, each rank's state
    keeping all 4 heads with half the value columns."""
    _, tcfg = _cfgs("xlstm-1.3b")
    _, tw = _pair(_mlstm_weights(tcfg, seed=6))
    x = torch.from_numpy(_x(12, tcfg.d_model, 7))
    whole, st = ts.mlstm_block(x, tw, tcfg, Env())
    dv = tw["wv"].shape[1]
    parts = []
    for r in range(2):
        cols = slice(r * dv // 2, (r + 1) * dv // 2)
        w = dict(tw, wv=tw["wv"][:, cols], wog=tw["wog"][:, cols], w_down=tw["w_down"][cols])
        env = types.SimpleNamespace(enter=lambda a: a, exit=lambda a: a, mlstm_chunk=0,
                                    ff_local=lambda n: n // 2)
        y, s = ts.mlstm_block(x, w, tcfg, env)
        assert tuple(s.C.shape) == (B, 4, dv // 4, dv // 8)
        parts.append(y)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(), atol=1e-6, rtol=1e-5)
    assert tuple(st.C.shape) == (B, 4, dv // 4, dv // 4)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_weights(cfg, seed=0):
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    return _weights({"ln": (d,), "w_in": (d, 4 * d), "r": (H, dh, 4 * dh), "b": (4 * d,),
                     "w_out": (d, d)}, seed, scale=0.1)


def test_slstm_block_matches_reference_and_decode():
    """The sLSTM over 24 tokens against the reference's scan; a 20-token
    prefill into a state and 4 decode steps against the whole in one call
    (the scan and the step are one function here, so exactly), and the
    reference's decode from its prefill state."""
    jcfg, tcfg = _cfgs("xlstm-1.3b")
    jw, tw = _pair(_slstm_weights(tcfg))
    x = _x(24, tcfg.d_model, 5)
    jy, jst = J_SLSTM(jnp.asarray(x), jw, jcfg, JEnv())
    ty, tst = ts.slstm_block(torch.from_numpy(x), tw, tcfg, Env())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **OUT_TOL)
    _close_state(tst, jst, STATE_TOL)
    st = ts.init_slstm_state(B, tcfg.d_model, torch.float32)
    ys = [ts.slstm_block(torch.from_numpy(x[:, :20]), tw, tcfg, Env(), mode="prefill",
                         state=st)[0]]
    _, jst = J_SLSTM(jnp.asarray(x[:, :20]), jw, jcfg, JEnv())
    jys = []
    for t in range(20, 24):
        ys.append(ts.slstm_block(torch.from_numpy(x[:, t:t + 1]), tw, tcfg, Env(),
                                 mode="decode", state=st)[0])
        jy1, jst = J_SLSTM(jnp.asarray(x[:, t:t + 1]), jw, jcfg, JEnv(), mode="decode",
                                  state=jst)
        jys.append(np.asarray(jy1))
    got = torch.cat(ys, 1).numpy()
    assert np.array_equal(got, ty.numpy())
    np.testing.assert_allclose(got[:, 20:], np.concatenate(jys, 1), **OUT_TOL)
    _close_state(st, jst, STATE_TOL)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_associative_scan_matches_sequential_and_lax(S):
    """The port's scan tree against a sequential scan and against
    ``lax.associative_scan`` with the reference's monoid, at lengths that
    exercise the odd and even branches of the tree."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (B, S, 8)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, 8)).astype(np.float32)
    _, h = tr.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    seq = tr.sequential_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(h.numpy(), seq.numpy(), **SCAN_TOL)

    def op(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, jh = jax.lax.associative_scan(op, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


def _rglru_weights(cfg, seed=0):
    d, r, W = cfg.d_model, cfg.lru_dim or cfg.d_model, cfg.conv1d_width
    return _weights({"ln": (d,), "w_x": (d, r), "w_y": (d, r), "conv_w": (W, r),
                     "conv_b": (r,), "w_a": (d, r), "b_a": (r,), "w_i": (d, r), "b_i": (r,),
                     "lam": (r,), "w_down": (r, d)}, seed)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` at every x (``F.softplus``
    returns ``x`` past its threshold): the port's matches it bit for bit
    on these values, past 20 included."""
    x = np.array([-30, -1, 0, 0.5, 3, 19.9, 20, 20.1, 40], np.float32)
    assert np.array_equal(tr.softplus(torch.from_numpy(x)).numpy(),
                          np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_rglru_block_matches_reference_with_carried_state():
    """A 16-token prefill, a second 8-token chunk from the carried (h, conv)
    state (folded into its first step), and 3 decode steps: each output
    and state against the reference's, and the chunks against the whole
    24-token sequence in one call."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b")
    jw, tw = _pair(_rglru_weights(tcfg))
    x = _x(27, tcfg.d_model, 8)
    whole, _ = tr.rglru_block(torch.from_numpy(x[:, :24]), tw, tcfg, Env())
    st = tr.init_rglru_state(B, tcfg.lru_dim, tcfg.conv1d_width, torch.float32)
    jstate, ys, jys = None, [], []
    for lo, hi, mode in ((0, 16, "prefill"), (16, 24, "prefill"), (24, 25, "decode"),
                         (25, 26, "decode"), (26, 27, "decode")):
        ys.append(tr.rglru_block(torch.from_numpy(x[:, lo:hi]), tw, tcfg, Env(), mode=mode,
                                 state=st)[0])
        jy, jstate = J_RGLRU(jnp.asarray(x[:, lo:hi]), jw, jcfg, JEnv(), mode=mode,
                                    state=jstate)
        jys.append(np.asarray(jy))
        np.testing.assert_allclose(ys[-1].numpy(), jys[-1], **OUT_TOL)
        np.testing.assert_allclose(st.h.numpy(), np.asarray(jstate[0]), **STATE_TOL)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jstate[1]), **STATE_TOL)
    np.testing.assert_allclose(torch.cat(ys[:2], 1).numpy(), whole.numpy(), **DECODE_TOL)


# ---------------------------------------------------------------------------
# the CUDA attention kernels take heads of 128 only
# ---------------------------------------------------------------------------


def _on_card(shape, dtype=torch.float32):
    """A stand-in for a tensor on the card: the wrappers read its shape,
    device and dtype, and refuse a head width, before any launch."""
    return types.SimpleNamespace(shape=torch.Size(shape), ndim=len(shape), dtype=dtype,
                                 device=torch.device("cuda"))


@pytest.mark.parametrize("hd", [128, 256, 512])
def test_wide_heads_never_reach_the_attention_kernels(hd):
    """At hd 256 / 512 both wrappers refuse on the card and count no
    launch. Every ported arch of that head width keeps its attention off
    both kernels: no ``attn`` block, and its ``local`` blocks carry a
    window, which the flash rule refuses even on the card and for which
    ``init_paged_caches`` raises. At hd 128 some ported arch has plain
    ``attn`` blocks, which the flash rule admits on the card."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attend import paged_attend
    from repro_torch.models.model import init_paged_caches

    before = (flash_prefill.launches, paged_attend.launches)
    if hd != 128:
        with pytest.raises(ValueError, match=f"head_dim 128, got {hd}"):
            flash_prefill(_on_card((1, 4, 128, hd)), _on_card((1, 2, 128, hd)),
                          _on_card((1, 2, 128, hd)))
        pool = _on_card((4, 16, 2, hd))
        with pytest.raises(ValueError, match=f"head_dim 128, got {hd}"):
            paged_attend(_on_card((1, 2, 2, hd)), pool, pool, _on_card((1, 2), torch.int32),
                         _on_card((1,), torch.int32))
    assert (flash_prefill.launches, paged_attend.launches) == before
    archs = [cfg for cfg in ARCHS.values() if cfg.head_dim == hd]
    assert archs

    def flash_viable(cfg):  # a 128-token prefill on the card
        H, Kv = cfg.num_heads, cfg.num_kv_heads
        qg, k = _on_card((1, 128, Kv, H // Kv, hd)), _on_card((1, 128, Kv, hd))
        return ta._flash_prefill_viable(True, cfg.sliding_window, False, 0, qg, k)

    plain = [cfg.name for cfg in archs if "attn" in cfg.pattern and flash_viable(cfg)]
    assert bool(plain) == (hd == 128), plain
    for cfg in archs:
        if "local" in cfg.pattern:
            assert not flash_viable(cfg), cfg.name
            with pytest.raises(ValueError, match="no paged layout"):
                init_paged_caches(reduced(cfg), Env(), 1, 4, 16, torch.float32)
    rg = get_config("recurrentgemma-9b")
    assert rg.head_dim == 256 and "attn" not in rg.pattern and rg.sliding_window
