"""int8 KV caches: the port against the JAX reference.

``_quantize_kv`` on the same fp32 input gives the reference's codes byte
for byte and its scales bit for bit (fp32 amax, ``max(amax, 1e-6) / 127``,
round half to even, clip ±127), midpoints and zero rows included. The int8
decode (contiguous, scalar and per-slot positions) is within ``ATOL`` of
the reference's on converted state; the int8 paged decode is bitwise the
contiguous int8 decode of the gathered rows. End to end on reduced
qwen3-1.7b (the reference's weights converted): the int8 engine's,
paged int8 engine's and static streams equal the reference's int8 engine
and static streams, K/V codes of an int8 prefill move by at most one step
from the reference's (the K/V they quantize differ by ~1e-7, so a code at
a rounding midpoint may move; counted), the decode logits stay within
``scenario_perf_levers.py``'s 5 % of fp32's, and the measured paged
residency equals ``serve_paged_kv_bytes(int8_kv=True)``, which equals the
reference's.
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
from repro.models.init import init_params as j_init_params
from repro.plan import PrecisionPlan as JPlan
from repro.roofline.analysis import serve_paged_kv_bytes as j_paged_bytes
from repro.serve import engine as jeng
from repro.serve import step as jstep
from repro.transport import CompressionPolicy as JPolicy
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_cache, convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.models import attention as ta
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline.analysis import serve_paged_kv_bytes
from repro_torch.serve import engine as teng
from repro_torch.serve import step as tstep
from repro_torch.transport import CompressionPolicy

ATOL = 2e-6
# int8 logits against the reference's: the K/V the two packages quantize
# differ by ~1e-7, so a code at a rounding midpoint may move by one step
# (amax / 127 of its row), which moves the logits by up to ~4e-4 here
INT8_LOGIT_TOL = 2e-3
SPEC = ((16, 6), (8, 6), (16, 4), (12, 5))
CAPACITY, SLOTS, PAGE = 24, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quant_inputs():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # amax 0: the 1e-6 floor
    # exact rounding midpoints: x / scale = k + 0.5 with scale = 1/127
    x[1, 1, 1] = (np.arange(16) - 8 + 0.5).astype(np.float32) / 127.0
    x[1, 1, 1, 0] = 1.0  # amax 1: scale 1/127
    x[1, 2, 2] = rng.normal(0, 1e-7, 16).astype(np.float32)  # below the floor
    return x


def test_quantize_kv_byte_and_bit_equal_reference():
    x = _quant_inputs()
    jq, js = ja._quantize_kv(jnp.asarray(x))
    tq, ts = ta._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def _quant_state(seed, per_slot, B=2, C=10, Kv=2, G=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, 1, Kv, G, hd)).astype(np.float32)
    k, ks = ja._quantize_kv(jnp.asarray(rng.normal(0, 1, (B, C, Kv, hd)).astype(np.float32)))
    v, vs = ja._quantize_kv(jnp.asarray(rng.normal(0, 1, (B, C, Kv, hd)).astype(np.float32)))
    pos = np.array([7, 10], np.int32) if per_slot else np.asarray(6, np.int32)
    return q, ja.QuantKVCache(*(np.asarray(a) for a in (k, v, ks, vs)), pos)


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
def test_int8_attend_decode_matches_reference(per_slot):
    q, jc = _quant_state(11 + per_slot, per_slot)
    tc = convert_cache(jc, device="cpu")
    got = ta.attend_decode(torch.from_numpy(q), tc, ring=False, window=None)
    want = ja.attend_decode(jnp.asarray(q), jax.tree_util.tree_map(jnp.asarray, jc), ring=False,
                            window=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", [1, 4])
def test_paged_int8_decode_is_contiguous_int8_bitwise(T):
    """An int8 pool through a permuted page table: the dense gather is
    bitwise the contiguous int8 decode of the same rows (one token and a
    verify block), and within ``ATOL`` of the reference's paged decode."""
    rng = np.random.default_rng(17 + T)
    B, P, page, Kv, G, hd, width = 2, 7, 4, 2, 2, 16, 3
    k, ks = ja._quantize_kv(jnp.asarray(rng.normal(0, 1, (P, page, Kv, hd)).astype(np.float32)))
    v, vs = ja._quantize_kv(jnp.asarray(rng.normal(0, 1, (P, page, Kv, hd)).astype(np.float32)))
    table = np.array([[4, 1, 6], [0, 5, 6]], np.int32)
    pos = np.array([9, 6], np.int32)
    q = rng.normal(0, 1, (B, T, Kv, G, hd)).astype(np.float32)
    jc = ja.PagedQuantKVCache(*(np.asarray(a) for a in (k, v, ks, vs)), pos)
    tc = convert_cache(jc, device="cpu")
    assert isinstance(tc, ta.PagedQuantKVCache)
    tq = torch.from_numpy(q)
    got = ta.attend_decode_paged(tq, tc, torch.from_numpy(table))
    rows = torch.from_numpy(table).to(torch.int64)
    flat = ta.QuantKVCache(*(x[rows].reshape(B, width * page, *x.shape[2:])
                             for x in ta.leaves(tc)), tc.pos)
    assert torch.equal(ta.attend_decode(tq, flat, ring=False, window=None), got)
    want = ja.attend_decode_paged(jnp.asarray(q), jax.tree_util.tree_map(jnp.asarray, jc),
                                  jnp.asarray(table), impl="dense")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the model, the engines and the byte model
# ---------------------------------------------------------------------------


def _requests(cls, vocab):
    rng = np.random.default_rng(7)
    return [cls(rid=i, prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, S)), max_new=g)
            for i, (S, g) in enumerate(SPEC)]


@pytest.fixture(scope="module")
def setup():
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
    plans = {}
    for int8 in (False, True):
        plans[int8] = (
            JPlan(weights=(JPolicy(round_to=2),) * nrt, host_device=JPolicy(round_to=2),
                  int8_kv=int8),
            PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * nrt,
                          host_device=CompressionPolicy(round_to=2), int8_kv=int8))
    return dict(jcfg=jcfg, tcfg=tcfg, jmesh=jmesh, tmesh=tmesh, j=(jspec, jstorage),
                t=(tspec, tstorage), plans=plans)


@pytest.fixture(scope="module")
def runs(setup):
    s = setup
    jplan, tplan = s["plans"][True]
    jreqs, treqs = _requests(jeng.Request, s["jcfg"].vocab_size), _requests(
        teng.Request, s["tcfg"].vocab_size)
    out = {"j_static": jeng.generate_static(s["jcfg"], s["jmesh"], None, *s["j"], jreqs,
                                           plan=jplan),
           "t_static": teng.generate_static(s["tcfg"], s["tmesh"], None, *s["t"], treqs,
                                            plan=tplan)}
    eng = jeng.ServeEngine(s["jcfg"], s["jmesh"], None, *s["j"], plan=jplan, max_slots=SLOTS,
                           cache_capacity=CAPACITY)
    out["j_engine"] = {k: r.tokens for k, r in eng.run(jreqs).items()}
    for paged in (False, True):
        eng = teng.ServeEngine(s["tcfg"], s["tmesh"], None, *s["t"], plan=tplan,
                               max_slots=SLOTS, cache_capacity=CAPACITY, paged=paged,
                               page_size=PAGE)
        out["t_paged" if paged else "t_engine"] = {k: r.tokens for k, r in eng.run(treqs).items()}
        if paged:
            out["residency"] = eng.kv_residency()
    # every request resident at once: the peak pages are the analytic ones
    eng = teng.ServeEngine(s["tcfg"], s["tmesh"], None, *s["t"], plan=tplan,
                           max_slots=len(SPEC), cache_capacity=CAPACITY, paged=True,
                           page_size=PAGE)
    eng.run(treqs)
    out["all_resident"] = eng.kv_residency()
    return out


def test_int8_streams_match_reference(runs):
    assert runs["t_static"] == runs["j_static"]
    assert runs["t_engine"] == runs["j_engine"] == runs["j_static"]
    assert runs["t_paged"] == runs["t_engine"]


def test_int8_prefill_codes_and_decode_logits(setup):
    """One 16-token prefill and a decode step at int8 against the
    reference's: codes at most one step apart (counted), scales and logits
    close; the int8 decode logits within 5 % (relative l2) of fp32's."""
    s = setup
    rng = np.random.default_rng(3)
    toks = rng.integers(0, s["jcfg"].vocab_size, (2, 16)).astype(np.int32)
    out = {}
    for int8 in (False, True):
        jplan, tplan = s["plans"][int8]
        jpre = jstep.make_prefill_step(s["jcfg"], s["jmesh"], None, s["j"][0],
                                       {"tokens": jax.ShapeDtypeStruct((2, 16), jnp.int32)},
                                       plan=jplan, cache_capacity=20)
        jdec = jstep.make_decode_step(s["jcfg"], s["jmesh"], None, s["j"][0],
                                      {"tokens": jax.ShapeDtypeStruct((2, 1), jnp.int32),
                                       "pos": jax.ShapeDtypeStruct((), jnp.int32)}, plan=jplan)
        tpre = tstep.make_prefill_step(s["tcfg"], s["tmesh"], None, s["t"][0], plan=tplan,
                                       cache_capacity=20)
        tdec = tstep.make_decode_step(s["tcfg"], s["tmesh"], None, s["t"][0], plan=tplan)
        jl, jc = jpre(s["j"][1], {"tokens": jnp.asarray(toks)})
        tl, tc = tpre(s["t"][1], {"tokens": torch.from_numpy(toks)})
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc = jdec(s["j"][1], jc, {"tokens": jnp.asarray(nxt),
                                      "pos": jnp.asarray(16, jnp.int32)})
        tl, tc = tdec(s["t"][1], tc, {"tokens": torch.from_numpy(nxt),
                                      "pos": torch.tensor(16, dtype=torch.int32)})
        out[int8] = tl.numpy()
        if not int8:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=1e-5)
            continue
        node, jnode = tc[0]["p0"], jc[0]["p0"]
        assert isinstance(node, ta.QuantKVCache)
        moved = sum(int((np.abs(getattr(node, f).numpy().astype(int)
                                - np.asarray(getattr(jnode, f)).astype(int)) > 0).sum())
                    for f in ("k", "v"))
        worst = max(int(np.abs(getattr(node, f).numpy().astype(int)
                               - np.asarray(getattr(jnode, f)).astype(int)).max())
                    for f in ("k", "v"))
        gap = float(np.abs(tl.numpy() - np.asarray(jl)).max())
        print(f"int8 prefill: {moved} of {2 * node.k.numel()} K/V codes one step from the "
              f"reference's; decode logits within {gap:.3e} of the reference's")
        assert worst <= 1
        np.testing.assert_allclose(node.k_scale.numpy(), np.asarray(jnode.k_scale),
                                   rtol=1e-5, atol=0)
        # a moved code shifts its key or value by one scale step (amax / 127)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=INT8_LOGIT_TOL, rtol=0)
    rel = np.linalg.norm(out[True] - out[False]) / np.linalg.norm(out[False])
    print(f"int8 decode logits: relative l2 error {rel:.3e} against fp32")
    assert rel < 0.05


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
def test_int8_paged_kv_bytes_match_reference_and_residency(setup, runs, full):
    jcfg, tcfg = j_get_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    if not full:
        jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    reqs = [(S, g) for S, g in SPEC]
    for int8 in (False, True):
        want = j_paged_bytes(jcfg, page_size=PAGE, requests=reqs, int8_kv=int8)
        assert serve_paged_kv_bytes(tcfg, page_size=PAGE, requests=reqs, int8_kv=int8) == want
    want = serve_paged_kv_bytes(tcfg, page_size=1, requests=reqs, int8_kv=True)
    if full:  # 28 layers x (2 x 8 x 128 x 1 B + 2 x 8 x 4 B) against fp32's 229,376 B a token
        assert want["bytes_per_page"] == 59_136
        assert serve_paged_kv_bytes(tcfg, page_size=1, requests=reqs)["bytes_per_page"] \
            == 229_376
        return
    res = runs["all_resident"]
    analytic = serve_paged_kv_bytes(tcfg, page_size=PAGE, requests=reqs, int8_kv=True)
    assert (res["pages_peak"], res["bytes_per_page"]) == (analytic["pages"],
                                                          analytic["bytes_per_page"])
    shapes = tstep.global_cache_shapes(setup["tcfg"], setup["tmesh"], SLOTS, CAPACITY,
                                       int8_kv=True, paged_pages=6, page_size=PAGE)
    jshapes = jstep.global_cache_shapes(setup["jcfg"], setup["jmesh"], SLOTS, CAPACITY,
                                        int8_kv=True, paged_pages=6, page_size=PAGE)
    for f in ("k", "v", "k_scale", "v_scale", "pos"):
        assert tuple(getattr(shapes[0]["p0"], f).shape) == getattr(jshapes[0]["p0"], f).shape
        assert str(getattr(shapes[0]["p0"], f).dtype).split(".")[-1] == \
            str(getattr(jshapes[0]["p0"], f).dtype)


def test_int8_launcher_twin_on_cpu(capsys):
    from repro_torch.launch import serve as launch

    results = launch.main(["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "16,12,8",
                           "--gen", "4", "--max-slots", "2", "--int8-kv", "--paged",
                           "--page-size", "8", "--check-static", "--device", "cpu"])
    assert sorted(results) == [0, 1, 2]
    out = capsys.readouterr().out
    assert "check-static: 3 streams equal to the static reference" in out
    assert "B/page" in out
