"""Sliding windows and the ring KV layout: the port against the JAX
reference.

``check_cache_geometry`` refuses the reference's geometries with the
reference's messages; windowed ``attend_tiled`` and the ring decode
(``attend_decode(ring=True)`` over a rolled cache, scalar and per-slot
positions, fp32 and int8) are within ``ATOL`` of the reference's on
converted numpy inputs (fp32 sums in another order); the rolled ring
prefill stores the reference's layout (codes of the int8 cache at most one
step apart at rounding midpoints). End to end on reduced qwen3-1.7b (the
reference's weights converted): the engine with ``window`` 12 and a ring of
12 slots, prompts of 16, 10 and 20 tokens (longer than the window), greedy
and sampled, gives the port's ``generate_static`` streams (a linear cache
and the window mask) and the reference's ``generate_static`` streams,
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.models import attention as ja
from repro.models.env import Env as JEnv
from repro.models.init import init_params as j_init_params
from repro.plan import PrecisionPlan as JPlan
from repro.plan import SamplingParams as JSampling
from repro.serve import engine as jeng
from repro.transport import CompressionPolicy as JPolicy
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_cache, convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.models import attention as ta
from repro_torch.models.env import Env
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan, SamplingParams
from repro_torch.serve import engine as teng
from repro_torch.transport import CompressionPolicy

ATOL = 2e-6
WINDOW = 12
SPEC = ((16, 8), (10, 8), (20, 6))  # (prompt length, max_new): 16 and 20 ring at once


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("capacity,window,context", [
    (20, 12, 24),   # window set, capacity > window: a linear cache that overflows
    (10, 16, 18),   # a ring narrower than the window would evict live tokens
    (8, None, 9),   # no window at all
    (12, 12, 24),   # capacity == window rings exactly: fine
    (10, 16, 8),    # a narrow ring the context never wraps: fine
    (24, None, 24),
])
def test_check_cache_geometry_matches_reference(capacity, window, context):
    def outcome(fn):
        try:
            fn(capacity, window, context, label="request 3: ")
            return None
        except ValueError as e:
            return str(e)

    got, want = outcome(ta.check_cache_geometry), outcome(ja.check_cache_geometry)
    assert got == want
    with (pytest.raises(ValueError) if want else _nothing()):
        ta.init_cache(1, capacity, 2, 8, torch.float32, window=window, context=context)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("window,chunk,Sq,Sk,off", [
    (8, 16, 48, 48, 0), (24, 16, 64, 64, 0), (12, 32, 32, 96, 64), (5, 8, 40, 40, 0),
])
def test_windowed_attend_tiled_matches_reference(window, chunk, Sq, Sk, off):
    rng = np.random.default_rng(window + Sq)
    B, Kv, G, hd = 2, 2, 2, 16
    q = rng.normal(0, 1, (B, Sq, Kv, G, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=off, chunk=chunk)
    got = ta.attend_tiled(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    want = np.asarray(ja.attend_tiled(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _ring_state(seed, quant, per_slot, B=2, C=8, Kv=2, G=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, 1, Kv, G, hd)).astype(np.float32)
    pos = np.array([13, 5], np.int32) if per_slot else np.asarray(19, np.int32)
    if quant:
        k = rng.integers(-127, 128, (B, C, Kv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (B, C, Kv, hd)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (B, C, Kv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (B, C, Kv)).astype(np.float32)
        return q, ja.QuantKVCache(k, v, ks, vs, pos)
    k = rng.normal(0, 1, (B, C, Kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, Kv, hd)).astype(np.float32)
    return q, ja.KVCache(k, v, pos)


@pytest.mark.parametrize("window", [8, 6])
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_ring_decode_matches_reference(quant, per_slot, window):
    """A ring of 8 slots (slot j holds absolute position ``pos - ((pos - j)
    mod 8)``), the window at the capacity or inside it; one slot below the
    capacity (per-slot position 5) sees only its prefix."""
    q, jc = _ring_state(7 + 2 * quant + per_slot, quant, per_slot)
    tc = convert_cache(jc, device="cpu")
    got = ta.attend_decode(torch.from_numpy(q), tc, ring=True, window=window)
    want = ja.attend_decode(jnp.asarray(q), jax.tree_util.tree_map(jnp.asarray, jc), ring=True,
                            window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _layer(seed):
    cfg = ModelConfig(name="t", arch_type="dense", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=1, head_dim=16, d_ff=0, vocab_size=8, qk_norm=True)
    rng = np.random.default_rng(seed)
    w = {n: rng.normal(0, 0.2, shape).astype(np.float32) for n, shape in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)), ("wo", (32, 32)))}
    w["q_norm"] = np.ones(16, np.float32)
    w["k_norm"] = np.ones(16, np.float32)
    return cfg, w


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_rolled_ring_prefill_and_decode_match_reference(quant):
    """A 20-token prefill into an 8-slot cache keeps the trailing 8 tokens
    rolled by ``20 % 8`` (the reference's layout), then two ring decode
    steps with window 8 write at ``pos % 8``."""
    cfg, w = _layer(31)
    rng = np.random.default_rng(37)
    x = rng.normal(0, 1, (2, 20, 32)).astype(np.float32)
    xs = rng.normal(0, 1, (2, 2, 1, 32)).astype(np.float32)
    dtype = (jnp.int8, torch.int8) if quant else (jnp.float32, torch.float32)
    jcache = ja.init_cache(2, 8, 1, 16, dtype[0], window=8, context=22)
    tcache = ta.init_cache(2, 8, 1, 16, dtype[1], window=8, context=22)
    jw = jax.tree_util.tree_map(jnp.asarray, w)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    jy, jcache = ja.mha(jnp.asarray(x), jw, cfg, JEnv(), mode="prefill", cache=jcache)
    ty, _ = ta.mha(torch.from_numpy(x), tw, cfg, Env(), mode="prefill", cache=tcache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    for i in range(2):
        pos = 20 + i
        jy, jcache = ja.mha(jnp.asarray(xs[:, i]), jw, cfg, JEnv(), mode="decode", cache=jcache,
                            window=8, pos_offset=jnp.asarray(pos, jnp.int32))
        ty, _ = ta.mha(torch.from_numpy(xs[:, i]), tw, cfg, Env(), mode="decode",
                       cache=tcache, window=8, pos_offset=torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    assert int(tcache.pos) == int(jcache.pos) == 22
    if quant:  # codes at most one step apart (a rounding midpoint), scales close
        moved = np.abs(tcache.k.numpy().astype(int) - np.asarray(jcache.k).astype(int))
        assert moved.max() <= 1, moved.max()
        print(f"int8 ring: {int((moved > 0).sum())} of {moved.size} key codes one step apart")
        np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jcache.k_scale),
                                   rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the engine's ring against the static reference
# ---------------------------------------------------------------------------


def _requests(cls, sampling_cls, vocab, sampled):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, S)),
                max_new=g, sampling=sampling_cls(0.8, 0.95, 40, seed=100 + i) if sampled
                else None)
            for i, (S, g) in enumerate(SPEC)]


@pytest.fixture(scope="module")
def streams():
    jcfg, tcfg = j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))
    jmesh, tmesh = JMesh(tp=1, dp=1, compress_min_size=4096), MeshCfg(compress_min_size=4096)
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jspec = j_build_spec_tree(params, metas, jmesh)
    jstorage = j_tree_to_storage(params, jspec, jmesh)
    _, tmetas = init_params(tcfg, device="meta")
    tparams = convert_lm_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tspec = build_spec_tree(tparams, tmetas, tmesh)
    tstorage = tree_to_storage(tparams, tspec, tmesh)
    nrt = jcfg.num_groups + 1
    jplan = JPlan(weights=(JPolicy(round_to=2),) * nrt, host_device=JPolicy(round_to=2))
    tplan = PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * nrt,
                          host_device=CompressionPolicy(round_to=2))
    out = {}
    for sampled in (False, True):
        jreqs = _requests(jeng.Request, JSampling, jcfg.vocab_size, sampled)
        treqs = _requests(teng.Request, SamplingParams, tcfg.vocab_size, sampled)
        out["j", sampled] = jeng.generate_static(jcfg, jmesh, None, jspec, jstorage, jreqs,
                                                 plan=jplan, window=WINDOW)
        out["t", sampled] = teng.generate_static(tcfg, tmesh, None, tspec, tstorage, treqs,
                                                 plan=tplan, window=WINDOW)
        eng = teng.ServeEngine(tcfg, tmesh, None, tspec, tstorage, plan=tplan, max_slots=2,
                               cache_capacity=WINDOW, window=WINDOW)
        out["engine", sampled] = {k: r.tokens for k, r in eng.run(treqs).items()}
    out["unwindowed"] = teng.generate_static(
        tcfg, tmesh, None, tspec, tstorage,
        _requests(teng.Request, SamplingParams, tcfg.vocab_size, False), plan=tplan)
    out["port"] = (tcfg, tmesh, tspec, tstorage, tplan)
    return out


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_ring_engine_equals_static_and_reference(streams, sampled):
    assert streams["engine", sampled] == streams["t", sampled] == streams["j", sampled]
    assert {k: len(v) for k, v in streams["engine", sampled].items()} == \
        {i: g for i, (_, g) in enumerate(SPEC)}
    if not sampled:  # the window changes what the prompts longer than it see
        assert streams["t", False] != streams["unwindowed"]


def test_ring_engine_refuses_evicting_geometries(streams):
    tcfg, tmesh, tspec, tstorage, tplan = streams["port"]
    engine = teng.ServeEngine(tcfg, tmesh, None, tspec, tstorage, plan=tplan, max_slots=1,
                              cache_capacity=20, window=12)
    with pytest.raises(ValueError, match="does not ring"):
        engine.run([teng.Request(rid=0, prompt_ids=(1,) * 16, max_new=8)])
    narrow = teng.ServeEngine(tcfg, tmesh, None, tspec, tstorage, plan=tplan, max_slots=1,
                              cache_capacity=10, window=16)
    with pytest.raises(ValueError, match="live tokens would be evicted"):
        narrow.run([teng.Request(rid=0, prompt_ids=(1,) * 8, max_new=8)])
    narrow.run([teng.Request(rid=1, prompt_ids=(1, 2, 3), max_new=2)])  # never wraps
    with pytest.raises(ValueError, match="contiguous"):
        teng.ServeEngine(tcfg, tmesh, None, tspec, tstorage, plan=tplan, max_slots=1,
                         cache_capacity=12, window=12, paged=True)
    # a window runs on a mesh (ROADMAP item 7.6: the launcher twin below at
    # 1x2), but not without the mesh's process groups: refused, not run on
    # one rank
    with pytest.raises(ValueError, match="make_mesh_from_cfg"):
        teng.ServeEngine(tcfg, MeshCfg(tp=2), None, tspec, tstorage, plan=tplan, max_slots=1,
                         cache_capacity=12, window=12)


def test_window_launcher_twin_on_cpu(capsys):
    from repro_torch.launch import serve as launch

    argv = ["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "16,10,20", "--gen", "6",
            "--max-slots", "2", "--window", "12", "--check-static", "--device", "cpu"]
    results = launch.main(argv)
    assert sorted(results) == [0, 1, 2]
    assert "check-static: 3 streams equal to the static reference" in capsys.readouterr().out
    # at tp 2 the ring caches hold the rank's kv heads: the same streams
    mesh = launch.main([*argv, "--mesh", "1x2"])
    assert "check-static: 3 streams equal to the static reference" in capsys.readouterr().out
    assert {k: r.tokens for k, r in mesh.items()} == {k: r.tokens for k, r in results.items()}
