"""Speculative decoding: the port against the JAX reference.

The port's twin of ``benchmarks/run.py::spec_decode_bench`` (the
``spec_decode`` section of ``BENCH_serve.json``): reduced qwen3-1.7b from
the reference's ``init_params(cfg, PRNGKey(0))`` converted by
``repro_torch.convert``, 2 slots, cache 32, ``spec_k`` 3, sampled
requests (temperature 0.8, top-p 0.95, top-k 40, seeds 100 + i; prompts
16, 12, 16, 8 from ``default_rng(0)``; 12 new tokens each), drained with
no draft, the target as its own draft and the reference's tiny draft
(``build_draft(cfg, mesh_cfg, "tiny")``, its weights converted by
``convert_draft``), on the contiguous and the paged (page 8) layout.

Exact: every stream equal across the drafts and to the reference
engine's; spec rounds 6 (self) and 22 (tiny); wire 6.0 / 9.83 / 29.83 B a
token; acceptance 1.0 and 0.0; measured wire == ``serve_spec_decode_bytes``
== the reference's; the step logs equal to the reference engine's. The
verify block's attention is bitwise T one-token steps in the port and
within ``ATOL`` of the reference's (fp32 sums in another order).
"""
import dataclasses
import json
import os

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
from repro.models.init import init_params as j_init_params
from repro.plan import PrecisionPlan as JPlan
from repro.plan import SamplingParams as JSampling
from repro.roofline.analysis import serve_spec_decode_bytes as j_spec_bytes
from repro.serve import engine as jeng
from repro.serve import spec as jspec
from repro.transport import CompressionPolicy as JPolicy
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_cache, convert_draft, convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.models import attention as ta
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan, SamplingParams
from repro_torch.roofline.analysis import serve_spec_decode_bytes
from repro_torch.serve import engine as teng
from repro_torch.serve import spec as tspec
from repro_torch.transport import CompressionPolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_SIZE = 4096
SPEC_K, SLOTS, CAPACITY, GEN = 3, 2, 32, 12
LENS = (16, 12, 16, 8)
DRAFTS = ("none", "self", "tiny")
ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _requests(cls, sampling, vocab):
    rng = np.random.default_rng(0)  # spec_decode_bench's prompts
    return [cls(rid=i, prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, S)),
                max_new=GEN, sampling=sampling(temperature=0.8, top_p=0.95, top_k=40,
                                               seed=100 + i))
            for i, S in enumerate(LENS)]


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    tcfg = reduced(get_config("qwen3-1.7b"))
    jmesh, tmesh = JMesh(tp=1, dp=1, compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jspec_tree = j_build_spec_tree(params, metas, jmesh)
    jstorage = j_tree_to_storage(params, jspec_tree, jmesh)
    _, tmetas = init_params(tcfg, device="meta")
    tparams = convert_lm_params(tcfg, _np_tree(params), device="cpu")
    tspec_tree = build_spec_tree(tparams, tmetas, tmesh)
    tstorage = tree_to_storage(tparams, tspec_tree, tmesh)
    nrt = jcfg.num_groups + 1
    jplan = JPlan(weights=(JPolicy(round_to=2),) * nrt, host_device=JPolicy(round_to=2))
    tplan = PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * nrt,
                          host_device=CompressionPolicy(round_to=2))
    jtiny = jspec.build_draft(jcfg, jmesh, "tiny")
    # the reference draft's weights: build_draft's init_params at seed 1
    dparams, _ = j_init_params(jtiny.cfg, jax.random.PRNGKey(1), tp=1)
    ttiny = convert_draft(tcfg, tmesh, _np_tree(dparams), "tiny", device="cpu")
    return dict(
        jcfg=jcfg, tcfg=tcfg, jmesh=jmesh, tmesh=tmesh, jplan=jplan, tplan=tplan,
        j=(jspec_tree, jstorage), t=(tspec_tree, tstorage),
        jdrafts={"none": None, "self": jspec.DraftBundle(jcfg, jspec_tree, jstorage),
                 "tiny": jtiny},
        tdrafts={"none": None, "self": tspec.DraftBundle(tcfg, tspec_tree, tstorage),
                 "tiny": ttiny},
    )


def _drain(side, s, name, paged):
    cfg, mesh, plan = s[f"{side}cfg"], s[f"{side}mesh"], s[f"{side}plan"]
    spec_tree, storage = s[side]
    eng_mod = jeng if side == "j" else teng
    draft = s[f"{side}drafts"][name]
    reqs = _requests(eng_mod.Request, JSampling if side == "j" else SamplingParams,
                     cfg.vocab_size)
    kw = dict(paged=True, page_size=8) if paged else {}
    eng = eng_mod.ServeEngine(cfg, mesh, None, spec_tree, storage, plan=plan,
                              max_slots=SLOTS, cache_capacity=CAPACITY, draft=draft,
                              spec_k=SPEC_K if draft is not None else None, **kw)
    res = eng.run(reqs)
    return {"streams": {k: r.tokens for k, r in res.items()},
            "summary": eng.wire_summary(), "step_log": eng.step_log}


@pytest.fixture(scope="module")
def runs(setup):
    # the reference's paged engine gives its contiguous streams (its own
    # tests); the port's paged runs are held to those and to the models
    runs = {("j", name, False): _drain("j", setup, name, False) for name in DRAFTS}
    runs.update({("t", name, paged): _drain("t", setup, name, paged)
                 for name in DRAFTS for paged in (False, True)})
    return runs


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", DRAFTS)
def test_streams_equal_across_drafts_and_reference(runs, name, paged):
    """Speculation moves the acceptance and the wire, never the streams:
    each draft's streams are the non-speculative ones and the reference
    engine's."""
    got = runs["t", name, paged]["streams"]
    assert got == runs["t", "none", False]["streams"]
    assert got == runs["j", name, False]["streams"]
    assert {k: len(v) for k, v in got.items()} == dict.fromkeys(range(len(LENS)), GEN)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", DRAFTS)
def test_wire_rounds_and_acceptance_match_bench(runs, name, paged):
    """``BENCH_serve.json``'s ``spec_decode`` section: 6.0 / 9.83 / 29.83 B
    a token, 6 and 22 rounds, acceptance 1.0 and 0.0; the contiguous
    summary and step log equal to the reference engine's, the paged ones
    to the contiguous ones but for the page table's staging."""
    run = runs["t", name, paged]
    summary = run["summary"]
    ref = runs["j", name, False]
    if paged:
        table = {"page_table", "page_table_entries", "prefill_hits", "prefill_misses"}
        flat = {k: v for k, v in summary.items() if k not in table}
        flat["host_device"] -= summary["page_table"]
        assert flat == ref["summary"]
        return
    assert summary == ref["summary"]
    assert run["step_log"] == ref["step_log"]
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        bench = json.load(f)["spec_decode"]["drafts"][name]
    tokens = sum(len(v) for v in run["streams"].values())
    assert tokens == bench["new_tokens"] == 48
    assert round(summary["host_device"] / tokens, 2) == bench["wire_bytes_per_token"]
    if name != "none":
        assert summary["spec_rounds"] == bench["spec_rounds"]
        assert summary["acceptance_rate"] == bench["acceptance_rate"]
        assert round(summary["tokens_per_target_step"], 4) == bench["tokens_per_target_step"]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("name", ["self", "tiny"])
def test_measured_wire_equals_spec_model_and_reference(setup, runs, name, paged):
    s, summary = setup, runs["t", name, paged]["summary"]
    kw = dict(n_slots=SLOTS, prompt_lens=list(LENS), spec_rounds=summary["spec_rounds"],
              spec_k=SPEC_K, page_table_entries=summary.get("page_table_entries", 0))
    want = j_spec_bytes(s["jplan"], s["jcfg"].vocab_size, **kw)
    assert serve_spec_decode_bytes(s["tplan"], s["tcfg"].vocab_size, **kw) == want
    assert summary["host_device"] == want["total"]
    if paged:  # the table widened by spec_k: ceil((32 + 3) / 8) = 5 pages a slot
        assert summary["page_table_entries"] == SLOTS * 5


def test_draft_config_and_weights_match_reference(setup):
    s = setup
    jd, td = s["jdrafts"]["tiny"], s["tdrafts"]["tiny"]
    for f in dataclasses.fields(td.cfg):
        assert getattr(td.cfg, f.name) == getattr(jd.cfg, f.name), f.name
    assert (td.cfg.head_dim, td.cfg.d_model, td.cfg.num_kv_heads) == (64, 128, 1)
    jl = jax.tree_util.tree_leaves(jd.storage)
    tl = jax.tree_util.tree_leaves(td.storage)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _multi_state(seed, B=2, C=12, Kv=2, G=2, hd=16, T=4, quant=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, T, Kv, G, hd)).astype(np.float32)
    pos = np.array([7, 12], np.int32)[:B]  # after a T-block write
    if quant:
        k = rng.integers(-127, 128, (B, C, Kv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (B, C, Kv, hd)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (B, C, Kv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (B, C, Kv)).astype(np.float32)
        return q, ja.QuantKVCache(k, v, ks, vs, pos)
    k = rng.normal(0, 1, (B, C, Kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, C, Kv, hd)).astype(np.float32)
    return q, ja.KVCache(k, v, pos)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_verify_block_attention_is_t_one_token_steps(quant):
    """``_attend_decode_multi``: bitwise the T successive one-token steps
    (each at its own position over the same cache) in the port, and within
    ``ATOL`` of the reference's block."""
    T = 4
    q, jc = _multi_state(61 + quant, T=T, quant=quant)
    tc = convert_cache(jc, device="cpu")
    tq = torch.from_numpy(q)
    block = ta.attend_decode(tq, tc, ring=False, window=None)
    for j in range(T):
        one = type(tc)(*[getattr(tc, f.name) for f in dataclasses.fields(tc)][:-1],
                       tc.pos - (T - 1 - j))
        step = ta.attend_decode(tq[:, j:j + 1], one, ring=False, window=None)
        assert torch.equal(block[:, j:j + 1], step), j
    want = ja.attend_decode(jnp.asarray(q), jax.tree_util.tree_map(jnp.asarray, jc),
                            ring=False, window=None)
    np.testing.assert_allclose(block.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_verify_block_write_drops_past_capacity_as_reference():
    """The per-slot T-block write of ``mha`` at (slot, pos + j): past the
    linear cache's end the writes are dropped (the reference's
    ``mode="drop"``), in place, and ``pos`` advances by T."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.env import Env

    cfg = ModelConfig(name="t", arch_type="dense", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=1, head_dim=16, d_ff=0, vocab_size=8, qk_norm=True)
    rng = np.random.default_rng(67)
    w = {n: rng.normal(0, 0.2, shape).astype(np.float32) for n, shape in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)), ("wo", (32, 32)))}
    w["q_norm"] = np.ones(16, np.float32)
    w["k_norm"] = np.ones(16, np.float32)
    x = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    pos = np.array([4, 7], np.int32)  # slot 1's block runs past capacity 8
    k0 = rng.normal(0, 1, (2, 8, 1, 16)).astype(np.float32)
    jcache = ja.KVCache(jnp.asarray(k0), jnp.asarray(-k0), jnp.asarray(pos))
    from repro.models.env import Env as JEnv

    jy, jc = ja.mha(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, w), cfg, JEnv(),
                    mode="decode", cache=jcache, pos_offset=jnp.asarray(pos))
    tcache = convert_cache(ja.KVCache(k0, -k0, pos), device="cpu")
    ty, tc = ta.mha(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in w.items()},
                    cfg, Env(), mode="decode", cache=tcache, pos_offset=torch.from_numpy(pos))
    assert tc is tcache
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tc.k[1, :7].numpy(), k0[1, :7])  # only pos 7 written
    assert tc.pos.tolist() == np.asarray(jc.pos).tolist() == [7, 10]
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)


def test_rollback_caches_restamps_pos_in_place():
    caches = [{"p0": ta.KVCache(torch.zeros(2, 2, 5, 1, 4), torch.zeros(2, 2, 5, 1, 4),
                                torch.tensor([[5, 4], [5, 4]], dtype=torch.int32))},
              {"p0": ta.init_paged_cache(2, 3, 4, 1, 4, torch.int8)}]  # one rep: pos (B,)
    caches[1]["p0"].pos.fill_(3)
    k_before = caches[0]["p0"].k
    tspec.rollback_caches(caches, torch.tensor([2, 0]))
    assert caches[0]["p0"].pos.tolist() == [[3, 4], [3, 4]]
    assert caches[1]["p0"].pos.tolist() == [1, 3]
    assert caches[0]["p0"].k is k_before
    with pytest.raises(TypeError, match="attention caches"):
        tspec.rollback_caches([{"p0": object()}], torch.tensor([1]))


@pytest.mark.parametrize("change,match", [
    (dict(causal=False), "encoder-only"),
    (dict(sliding_window=16), "sliding-window"),
    ("window", "sliding-window"),
])
def test_check_spec_arch_refusals_match_reference(change, match):
    jcfg, tcfg = j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))
    kw = {"window": 16} if change == "window" else {}
    if change != "window":
        jcfg, tcfg = dataclasses.replace(jcfg, **change), dataclasses.replace(tcfg, **change)
    for check, cfg in ((jspec.check_spec_arch, jcfg), (tspec.check_spec_arch, tcfg)):
        with pytest.raises(ValueError, match=match):
            check(cfg, **kw)


def test_engine_refusals(setup):
    s = setup
    spec_tree, storage = s["t"]
    small = dataclasses.replace(s["tcfg"], vocab_size=256)
    bad = tspec.DraftBundle(small, None, None)
    with pytest.raises(ValueError, match="draft vocab"):
        teng.ServeEngine(s["tcfg"], s["tmesh"], None, spec_tree, storage, plan=s["tplan"],
                         max_slots=2, cache_capacity=32, draft=bad)
    with pytest.raises(ValueError, match="sliding-window"):
        teng.ServeEngine(s["tcfg"], s["tmesh"], None, spec_tree, storage, plan=s["tplan"],
                         max_slots=2, cache_capacity=32, window=16,
                         draft=s["tdrafts"]["self"])
    with pytest.raises(NotImplementedError, match="7.6"):
        tspec.build_draft(s["tcfg"], MeshCfg(tp=2), "tiny", device="cpu")


def test_spec_launcher_twin_on_cpu(capsys):
    from repro_torch.launch import serve as launch

    results = launch.main(["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "16,12,16,8",
                           "--gen", "6", "--max-slots", "2", "--spec-decode", "--spec-k", "3",
                           "--temperature", "0.8", "--top-p", "0.95", "--top-k", "40",
                           "--seed", "100", "--check-static", "--device", "cpu"])
    assert sorted(results) == [0, 1, 2, 3]
    out = capsys.readouterr().out
    assert "== serve_spec_decode_bytes" in out and "draft qwen3-1.7b-draft-tiny" in out
    assert "check-static: 4 streams equal to the static reference" in out
