"""Paged-KV serving slice: port vs the JAX reference.

Both packages serve reduced qwen3-1.7b (2 layers, d 256, hd 64) from the
same weights (the reference's ``init_params(cfg, PRNGKey(0))`` carried
across by ``convert_lm_params``), with the reference engine test's plan
(``round_to=2`` weights and host_device entry), ``compress_min_size=4096``,
2 slots, capacity 24 and pages of 8 tokens: the geometry of
``tests/test_serve_engine.py``'s paged tests, whose counterparts these
are. On the CPU both sides decode through the dense gather, as the
reference does off its chip.

Tolerances: logits atol 2e-5 / rtol 1e-5, pools written by a decode step
atol 1e-5 (fp32 sums in another order in XLA and PyTorch); token streams,
step logs, byte counts, page counts and tree shapes exactly equal.
"""
import argparse

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
from repro.launch import serve as j_launch
from repro.models.init import init_params as j_init_params
from repro.plan import PrecisionPlan as JPlan
from repro.roofline.analysis import serve_host_device_bytes as j_serve_bytes
from repro.roofline.analysis import serve_paged_kv_bytes as j_paged_kv_bytes
from repro.serve import engine as jeng
from repro.serve import step as jstep
from repro.transport import CompressionPolicy as JPolicy
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params, convert_paged_cache
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.launch import serve as launch
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline.analysis import serve_host_device_bytes, serve_paged_kv_bytes
from repro_torch.serve import engine as teng
from repro_torch.serve import step as tstep
from repro_torch.serve.api import Request
from repro_torch.transport import CompressionPolicy

MIN_SIZE = 4096
SLOTS = 2
CAPACITY = 24
PAGE = 8
# (prompt length, max_new): the reference engine test's mix; at page 8
# the lengths 16, 12, 16, 8, 12 bucket to {16, 8}
SPEC = ((16, 6), (12, 8), (16, 4), (8, 8), (12, 5))
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    tcfg = reduced(get_config("qwen3-1.7b"))
    jmesh, tmesh = JMesh(tp=1, dp=1, compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
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
    return dict(jcfg=jcfg, tcfg=tcfg, jmesh=jmesh, tmesh=tmesh, jspec=jspec,
                jstorage=jstorage, tspec=tspec, tstorage=tstorage, jplan=jplan,
                tplan=tplan)


def _requests(vocab, spec=SPEC, cls=Request):
    rng = np.random.default_rng(7)
    return [
        cls(rid=i, prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, S)), max_new=g)
        for i, (S, g) in enumerate(spec)
    ]


def _shared_requests(vocab, cls=Request):
    """The reference test's shared-prefix geometry: a 2-page common prompt
    plus tails of 4, 9 and 12 tokens, 6 new tokens each."""
    rng = np.random.default_rng(3)
    shared = tuple(int(t) for t in rng.integers(0, vocab, 2 * PAGE))
    return [
        cls(rid=i, max_new=6,
            prompt_ids=shared + tuple(int(t) for t in rng.integers(0, vocab, t)))
        for i, t in enumerate((4, 9, 12))
    ]


def _engine(pkg, s, **kw):
    kw.setdefault("max_slots", SLOTS)
    kw.setdefault("cache_capacity", CAPACITY)
    if pkg == "port":
        return teng.ServeEngine(s["tcfg"], s["tmesh"], None, s["tspec"], s["tstorage"],
                                plan=s["tplan"], **kw)
    return jeng.ServeEngine(s["jcfg"], s["jmesh"], None, s["jspec"], s["jstorage"],
                            plan=s["jplan"], **kw)


def _record(eng, results):
    out = {"streams": {k: r.tokens for k, r in results.items()},
           "step_log": eng.step_log, "summary": eng.wire_summary()}
    if eng.paged:
        out["residency"] = eng.kv_residency()
        out["audit"] = eng.pages.audit()
    return out


@pytest.fixture(scope="module")
def runs(setup):
    """Every engine run the tests read, each made once: the port's paged,
    contiguous and static runs, and the reference's paged run, on SPEC and
    on the shared-prefix requests."""
    s = setup
    out = {}
    for name, reqs_of in (("mixed", _requests), ("shared", _shared_requests)):
        kw = {} if name == "mixed" else {"max_slots": 3, "cache_capacity": 40}
        treqs, jreqs = reqs_of(s["tcfg"].vocab_size), reqs_of(s["jcfg"].vocab_size, cls=jeng.Request)
        paged = _engine("port", s, paged=True, page_size=PAGE, **kw)
        jpaged = _engine("ref", s, paged=True, page_size=PAGE, **kw)
        out[name] = {
            "requests": treqs,
            "paged": _record(paged, paged.run(treqs)),
            "reference": _record(jpaged, jpaged.run(jreqs)),
            "static": teng.generate_static(s["tcfg"], s["tmesh"], None, s["tspec"],
                                           s["tstorage"], treqs, plan=s["tplan"]),
        }
        if name == "mixed":
            cont = _engine("port", s)
            out[name]["contiguous"] = _record(cont, cont.run(treqs))
    return out


# ---------------------------------------------------------------------------
# allocator, shapes and byte models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [teng.PageAllocator, jeng.PageAllocator], ids=["port", "reference"])
def test_page_allocator_refcount_and_audit(cls):
    """The reference test's sequence on both allocators: the same pages,
    refcounts, audits and errors."""
    errors = {"capacity": (teng.CapacityError, jeng.CapacityError),
              "allocator": (teng.AllocatorError, jeng.AllocatorError),
              "invariant": (teng.InvariantError, jeng.InvariantError)}
    pa = cls(4)
    a, b = pa.alloc(2)
    assert (a, b) == (0, 1)
    pa.retain(a)  # shared-prefix second holder
    assert pa.refcount(a) == 2
    assert not pa.release(a)  # still one holder: not freed
    assert pa.release(a)  # last holder: freed
    assert pa.release(b)
    audit = pa.audit()
    assert audit == {"free": 4, "live": 0, "allocs": 2, "releases": 2, "peak": 2}
    with pytest.raises(errors["allocator"]):
        pa.release(a)  # double free
    with pytest.raises(errors["capacity"]):
        pa.alloc(5)  # exhaustion
    pa._refs[9] = 1  # a leaked page
    with pytest.raises(errors["invariant"]):
        pa.audit()


def test_paged_cache_shapes_match_reference(setup):
    s = setup
    j = jstep.global_cache_shapes(s["jcfg"], s["jmesh"], SLOTS, CAPACITY, per_slot=True,
                                  paged_pages=6, page_size=PAGE)
    t = tstep.global_cache_shapes(s["tcfg"], s["tmesh"], SLOTS, CAPACITY, per_slot=True,
                                  paged_pages=6, page_size=PAGE)
    for jg, tg in zip(j, t):
        for key in jg:
            for leaf in ("k", "v", "pos"):
                assert tuple(getattr(jg[key], leaf).shape) == tuple(getattr(tg[key], leaf).shape)
            assert tg[key].k.shape[1:] == (7, PAGE, 4, 64)  # 6 pages + the trash row
    assert teng.page_bytes(t) == jeng._page_pool_bytes(j)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
@pytest.mark.parametrize("geometry", [
    (8, ((20, 6), (13, 6), (24, 6)), 16),
    (64, ((320, 16), (356, 16), (384, 16)), 256),
    (64, ((512, 16), (200, 16)), 0),
])
def test_paged_kv_bytes_model_matches_reference(full, geometry):
    page, reqs, shared = geometry
    jcfg, tcfg = j_get_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    if not full:
        jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
    kw = dict(page_size=page, requests=reqs, shared_prefix_len=shared)
    assert serve_paged_kv_bytes(tcfg, **kw) == j_paged_kv_bytes(jcfg, **kw)


def test_full_width_shared_prefix_geometry():
    """``chip_smoke.py``'s shared-prefix run: 11 pages of 14,680,064 B."""
    got = serve_paged_kv_bytes(get_config("qwen3-1.7b"), page_size=64,
                               requests=[(320, 16), (356, 16), (384, 16)],
                               shared_prefix_len=256)
    assert (got["pages"], got["shared_pages"], got["bytes_per_page"]) == (11, 4, 14_680_064)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_prefill_with_last_on_a_padded_prompt_matches_reference(setup):
    """``forward_prefill`` with ``batch["last"]``: a 12-token prompt padded
    to 16 gives the reference's logits, and the unpadded prompt's."""
    s = setup
    toks = np.random.default_rng(5).integers(0, s["jcfg"].vocab_size, (1, 12)).astype(np.int32)
    padded = np.pad(toks, ((0, 0), (0, 4)))
    jpre = jstep.make_prefill_step(
        s["jcfg"], s["jmesh"], None, s["jspec"],
        {"tokens": jax.ShapeDtypeStruct((1, 16), jnp.int32),
         "last": jax.ShapeDtypeStruct((), jnp.int32)}, plan=s["jplan"], cache_capacity=24)
    tpre = tstep.make_prefill_step(s["tcfg"], s["tmesh"], None, s["tspec"], plan=s["tplan"],
                                   cache_capacity=24)
    jl, _ = jpre(s["jstorage"], {"tokens": jnp.asarray(padded), "last": jnp.asarray(11, jnp.int32)})
    tl, tc = tpre(s["tstorage"], {"tokens": torch.from_numpy(padded), "last": 11})
    assert tuple(tl.shape) == (1, 1, s["tcfg"].vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert int(tc[0]["p0"].pos[0]) == 16  # the cache absorbed the padded length
    tl_true, _ = tpre(s["tstorage"], {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), tl_true.numpy(), **LOGIT_TOL)
    tl_t, _ = tpre(s["tstorage"], {"tokens": torch.from_numpy(padded),
                                   "last": torch.tensor(11, dtype=torch.int32)})
    assert torch.equal(tl_t, tl)


def test_paged_decode_step_matches_reference(setup):
    """``make_decode_step(paged=True)`` (``mha(page_table=...)``,
    ``_paged_write``, ``attend_decode_paged``) on the reference engine's
    own pools, table and positions after two admissions, converted: the
    same logits and the same pools after the write."""
    s = setup
    jreqs = _requests(s["jcfg"].vocab_size, cls=jeng.Request)[:2]
    eng = _engine("ref", s, paged=True, page_size=PAGE)
    eng.begin_stream()
    for r in jreqs:
        eng.admit(r)
    table, pos, tok = eng._table.copy(), eng._pos_host.copy(), eng._next_tok.copy()
    tcaches = [{key: convert_paged_cache(jax.tree_util.tree_map(np.asarray, node), device="cpu")
                for key, node in g.items()} for g in eng._caches]
    jl, jc = eng._decode(eng._weights, eng._caches,
                         {"tokens": jnp.asarray(tok[:, None]), "pos": jnp.asarray(pos),
                          "page_table": jnp.asarray(table)})
    step = tstep.make_decode_step(s["tcfg"], s["tmesh"], None, s["tspec"], plan=s["tplan"],
                                  paged=True)
    batch = {"tokens": torch.from_numpy(tok[:, None]), "pos": torch.from_numpy(pos),
             "page_table": torch.from_numpy(table)}
    tl, tc = step(s["tstorage"], tcaches, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for jg, tg in zip(jc, tc):
        for key in jg:
            np.testing.assert_allclose(tg[key].k.numpy(), np.asarray(jg[key].k), atol=1e-5, rtol=0)
            np.testing.assert_array_equal(tg[key].pos.numpy(), np.asarray(jg[key].pos))
    contiguous = tstep.make_decode_step(s["tcfg"], s["tmesh"], None, s["tspec"], plan=s["tplan"])
    with pytest.raises(ValueError, match="page_table"):
        contiguous(s["tstorage"], tc, batch)
    with pytest.raises(ValueError, match="page_table"):
        step(s["tstorage"], tc, {k: v for k, v in batch.items() if k != "page_table"})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_paged_matches_contiguous_and_static(runs):
    """Mixed prompt lengths, slot reuse after release (5 requests, 2
    slots), prompt bucketing: paged == contiguous == static streams,
    exactly; 2 bucket lengths first seen and 3 seen before."""
    run = runs["mixed"]
    assert run["paged"]["streams"] == run["static"]
    assert run["paged"]["streams"] == run["contiguous"]["streams"]
    assert {k: len(v) for k, v in run["static"].items()} == {i: g for i, (_, g) in enumerate(SPEC)}
    summary = run["paged"]["summary"]
    assert (summary["prefill_misses"], summary["prefill_hits"]) == (2, 3)
    audit = run["paged"]["audit"]
    assert audit["live"] == 0 and audit["allocs"] == audit["releases"] >= len(SPEC)


@pytest.mark.parametrize("name", ["mixed", "shared"])
def test_paged_engine_equals_reference_paged_engine(runs, name):
    """Streams, step log, wire summary, residency and the page audit equal
    the reference's paged engine on the same requests."""
    port, ref = runs[name]["paged"], runs[name]["reference"]
    for key in ("streams", "step_log", "summary", "residency", "audit"):
        assert port[key] == ref[key], key


def test_paged_wire_log_pins_analytic_serve_model(setup, runs):
    s, run = setup, runs["mixed"]
    measured = run["paged"]["summary"]
    kw = dict(n_slots=SLOTS, prompt_lens=[S for S, _ in SPEC],
              decode_steps=measured["decode_steps"],
              page_table_entries=measured["page_table_entries"])
    analytic = serve_host_device_bytes(s["tplan"], s["tcfg"].vocab_size, **kw)
    assert analytic == j_serve_bytes(s["jplan"], s["jcfg"].vocab_size, **kw)
    assert measured["host_device"] == analytic["total"]
    assert measured["page_table"] == analytic["page_table_h2d"] > 0
    assert measured["page_table_entries"] == SLOTS * CAPACITY // PAGE


def test_paged_shared_prefix_refcount_and_residency(setup, runs):
    """3 requests share a 2-page prompt and are resident at once: the peak
    equals the analytic page model (shared pages stored once), streams
    equal the static reference, every refcount returns to zero."""
    s, run = setup, runs["shared"]
    reqs = run["requests"]
    assert run["paged"]["streams"] == run["static"]
    analytic = serve_paged_kv_bytes(s["tcfg"], page_size=PAGE,
                                    requests=[(len(r.prompt_ids), 6) for r in reqs],
                                    shared_prefix_len=2 * PAGE)
    assert analytic["shared_pages"] == 2
    res = run["paged"]["residency"]
    assert res["bytes_per_page"] == analytic["bytes_per_page"]
    assert res["pages_peak"] == analytic["pages"]
    assert res["kv_bytes_peak"] == analytic["kv_bytes_resident"]
    assert res["pages_live"] == 0 and res["kv_bytes_resident"] == 0
    no_share = sum(-(-(len(r.prompt_ids) + 6) // PAGE) for r in reqs)
    assert analytic["pages"] == no_share - 2 * (len(reqs) - 1) < no_share


def test_paged_without_sharing_keeps_private_pages(setup):
    s = setup
    reqs = _shared_requests(s["tcfg"].vocab_size)
    eng = _engine("port", s, paged=True, page_size=PAGE, max_slots=3, cache_capacity=40,
                  share_prefix=False)
    eng.run(reqs)
    assert eng.kv_residency()["pages_peak"] == sum(
        -(-(len(r.prompt_ids) + 6) // PAGE) for r in reqs)


def test_paged_rejects_windows_and_oversized_requests(setup):
    s = setup
    with pytest.raises(ValueError, match="contiguous"):
        _engine("port", s, paged=True, page_size=PAGE, window=12)
    eng = _engine("port", s, paged=True, page_size=PAGE, num_pages=2)
    with pytest.raises(ValueError, match="pages"):
        eng.run([Request(rid=0, prompt_ids=(1,) * 16, max_new=8)])
    with pytest.raises(ValueError, match="page_size"):
        _engine("port", s, paged=True, page_size=0)
    with pytest.raises(ValueError, match="paged"):
        _engine("port", s).kv_residency()


# ---------------------------------------------------------------------------
# the launcher twin
# ---------------------------------------------------------------------------


def test_shared_prefix_requests_match_reference_launcher():
    """The prefix is drawn first from ``default_rng(0)``, so the prompts
    are the reference launcher's, and with no prefix the same as before."""
    vocab = get_config("qwen3-1.7b").vocab_size
    for shared in (0, 8):
        args = argparse.Namespace(prompt_lens="5,3", prompt_len=0, requests=0,
                                  shared_prefix=shared, gen=4, temperature=0.0)
        want = j_launch.build_requests(args, j_get_config("qwen3-1.7b"))
        got = launch.build_requests([5, 3], 4, vocab, shared_prefix=shared)
        assert [r.prompt_ids for r in got] == [r.prompt_ids for r in want]
        assert [len(r.prompt_ids) for r in got] == [shared + 5, shared + 3]
        assert len({r.prompt_ids[:shared] for r in got}) == 1


def test_paged_launcher_twin_on_cpu(capsys):
    results = launch.main(["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "8,6,8",
                           "--gen", "3", "--max-slots", "3", "--paged", "--page-size", "8",
                           "--shared-prefix", "8", "--check-static", "--device", "cpu"])
    assert sorted(results) == [0, 1, 2] and all(len(r.tokens) == 3 for r in results.values())
    out = capsys.readouterr().out
    assert "check-static: 3 streams equal to the static reference" in out
    # prompts of 16, 14 and 16 tokens share one page: 1 + 2 + 2 + 2 pages
    assert "peak 7 pages resident" in out
    assert "page-table staging" in out


def test_chip_smoke_paged_phase_rehearses_on_cpu(capsys):
    """``chip_smoke.py`` phases 7 and 9 at reduced width on the CPU (plain
    versions; launch counts, memory and profiles are read on a card only):
    the paged runs' streams, wire bytes, page audits, bucket counts and the
    shared-prefix residency pass their checks."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu = torch.device("cpu")
    served = smoke.serve_path(torch, cpu, cfg=reduced(get_config("qwen3-1.7b")),
                              lens=(32, 32, 24, 16, 12), gen=5)
    out = smoke.paged_path(torch, cpu, served, page=8, shared=16, tails=(8, 12, 16),
                           shared_cap=40)
    assert out["analytic"]["pages"] == out["runs"]["shared-prefix engine"]["residency"]["pages_peak"]
    assert out["diverged"] == 0
    text = capsys.readouterr().out
    assert "paged engine: streams equal to the static reference and the contiguous engine" in text
    assert "buckets 3 first seen, 2 seen before" in text


def test_bench_serve_paged_bytes(setup):
    """``BENCH_serve.json``'s paged geometry (``benchmarks/run.py::
    serve_engine_bench``: a 2-page shared prefix, tails 8, 4, 12, 6, 10, 5,
    8 new tokens, 2 slots, capacity 40, page 8; the measured second run):
    the port's byte and page counts equal the committed file's."""
    import json
    import pathlib

    bench = json.loads((pathlib.Path(__file__).resolve().parent.parent
                        / "BENCH_serve.json").read_text())["layouts"]["paged"]
    s = setup
    rng = np.random.default_rng(0)
    shared = tuple(int(t) for t in rng.integers(0, s["tcfg"].vocab_size, 2 * PAGE))
    reqs = [Request(rid=i, max_new=8, prompt_ids=shared + tuple(
        int(t) for t in rng.integers(0, s["tcfg"].vocab_size, tail)))
        for i, tail in enumerate((8, 4, 12, 6, 10, 5))]
    eng = _engine("port", s, paged=True, page_size=PAGE, cache_capacity=40)
    eng.run(reqs)  # the bench's warm-up run
    results = eng.run(reqs)
    wire, res = eng.wire_summary(), eng.kv_residency()
    new_tokens = sum(len(r.tokens) for r in results.values())
    assert new_tokens == bench["new_tokens"]
    assert round(wire["host_device"] / new_tokens, 2) == bench["wire_bytes_per_token"]
    assert round(res["kv_bytes_peak"] / (res["pages_peak"] * PAGE)) == \
        bench["kv_bytes_resident_per_token"]
    assert res["pages_peak"] == bench["pages_peak"]
    assert (wire["prefill_misses"], wire["prefill_hits"]) == \
        (bench["prefill_compiles"], bench["prefill_bucket_hits"])
