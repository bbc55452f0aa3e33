"""Sampled requests: the port's sampler, engine and static path against the
JAX reference.

``uniform_for`` and ``fold_key`` must be bit-equal to the reference's
(threefry on int64 words). ``sample_tokens`` is held to the reference's
over temperature {0, 0.5, 0.8, 1.5} × top_p {1, 0.95, 0.5} × top_k {0, 1,
40}, on rows of qwen3-1.7b's vocabulary (151,936) and of the reduced one
(512), seeds {0, 2**31, 2**32 - 1} and eight steps (two at 151,936: XLA's
argsort of such rows takes ~0.1 s each on the CPU), from numpy logits.
Tie rule: XLA's and PyTorch's ``exp`` and ``cumsum`` differ in their last
bits, so a token may differ only where the reference's draw lies within
``TIE`` × ``cw[-1]`` of a cumulative boundary (the disagreements are
printed), and on no more than a thousandth of the draws. Within the port
a row's token is the same alone as in a batch of 8. The engine's and
``generate_static``'s sampled streams (reduced qwen3-1.7b, the
reference's weights converted) equal the reference engine's and static
run's. A seed outside ``[0, 2**32)`` raises ``OverflowError`` in both
packages' ``uniform_for``, engine admission and ``generate_static``.
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
from repro.models.init import init_params as j_init_params
from repro.plan import PrecisionPlan as JPlan
from repro.plan import SamplingParams as JSampling
from repro.serve import engine as jeng
from repro.serve import sampling as js
from repro.transport import CompressionPolicy as JPolicy
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.models.init import init_params
from repro_torch.plan import PrecisionPlan, SamplingParams
from repro_torch.serve import engine as teng
from repro_torch.serve import sampling as ts
from repro_torch.transport import CompressionPolicy

TIE = 1e-6
SEEDS = (0, 2**31, 2**32 - 1)
STEPS = (0, 1, 2, 3, 7, 11, 100, 2**31 - 1)
VOCABS = (151_936, 512)
# (prompt length, max_new, SamplingParams keywords or None for greedy)
SPEC = ((16, 6, dict(temperature=0.8, top_p=0.95, top_k=40, seed=100)),
        (8, 6, None),
        (16, 5, dict(temperature=1.5, top_p=0.5, top_k=0, seed=2**32 - 1)),
        (8, 4, dict(temperature=0.5, top_p=1.0, top_k=1, seed=2**31)))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rows(steps=STEPS):
    seed = np.repeat(np.array(SEEDS, np.uint32), len(steps))
    step = np.tile(np.array(steps, np.int32), len(SEEDS))
    return seed, step


def _steps(vocab):
    return STEPS if vocab < 1000 else STEPS[2::5]


def test_uniform_for_and_fold_key_bit_equal_reference():
    seed, step = _rows()
    want = np.asarray(js.uniform_for(seed, step))
    got = ts.uniform_for(seed, step).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.shape == (len(seed),) and got.dtype == np.float32
    for s, n in ((0, 0), (2**31, 5), (2**32 - 1, 2**31 - 1)):
        key = np.asarray(jax.random.key_data(js.fold_key(np.uint32(s), n)))
        assert ts.fold_key(s, n) == tuple(int(x) for x in key)
    # a larger seed raises, as the reference's conversion to uint32 does
    with pytest.raises(OverflowError):
        ts.uniform_for([2**32 + 5], [3])


def _reference_parts(lg, vocab, temp, top_p, top_k, seed, step):
    """The reference sampler's ops (``repro.serve.sampling.sample_tokens``,
    jitted as the engines run it), returning its token, its cumulative
    weights ``cw`` and its target ``u · cw[-1]``
    (``test_reference_parts_are_the_reference_sampler`` holds the token to
    the function's)."""
    lg = lg[..., :vocab].astype(jnp.float32)
    greedy = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    temp = jnp.asarray(temp, jnp.float32)
    scaled = lg / jnp.maximum(temp, 1e-6)[..., None]
    order = jnp.argsort(-scaled, axis=-1)
    probs = jax.nn.softmax(jnp.take_along_axis(scaled, order, axis=-1), axis=-1)
    keep = (jnp.asarray(top_k, jnp.int32)[..., None] <= 0) | (
        jnp.arange(vocab, dtype=jnp.int32) < jnp.asarray(top_k, jnp.int32)[..., None])
    cum = jnp.cumsum(probs, axis=-1)
    keep &= (cum - probs) < jnp.asarray(top_p, jnp.float32)[..., None]
    cw = jnp.cumsum(probs * keep, axis=-1)
    target = js.uniform_for(seed, step) * cw[..., -1]
    idx = jnp.minimum(jnp.sum((cw <= target[..., None]).astype(jnp.int32), axis=-1), vocab - 1)
    tok = jnp.take_along_axis(order, idx[..., None], axis=-1)[..., 0]
    tok = jnp.where(temp <= 0.0, greedy, tok.astype(jnp.int32))
    return tok, cw, target


_reference_parts = jax.jit(_reference_parts, static_argnums=1)


def _case(temperature, top_p, top_k, vocab):
    seed, step = _rows(_steps(vocab))
    R = len(seed)
    rng = np.random.default_rng(vocab + int(100 * temperature) + int(100 * top_p) + top_k)
    # logits of a random model's scale, padded past the vocabulary
    lg = (rng.normal(0, 3, (R, vocab + 64))).astype(np.float32)
    row = lambda x, dt: np.full((R,), x, dt)  # noqa: E731
    return lg, (row(temperature, np.float32), row(top_p, np.float32), row(top_k, np.int32),
                seed, step)


@pytest.mark.parametrize("vocab", VOCABS)
def test_reference_parts_are_the_reference_sampler(vocab):
    lg, args = _case(0.8, 0.95, 40, vocab)
    want = np.asarray(js.sample_tokens(jnp.asarray(lg), vocab, *args))
    np.testing.assert_array_equal(np.asarray(_reference_parts(jnp.asarray(lg), vocab, *args)[0]),
                                  want)


CASES = [(t, p, k) for t in (0.0, 0.5, 0.8, 1.5) for p in (1.0, 0.95, 0.5) for k in (0, 1, 40)]


def _sweep_case(temperature, top_p, top_k):
    """One case of the sweep: ``(draws, disagreements)`` over both
    vocabularies, each disagreement ``(vocab, row, port, reference, the
    reference's draw distance to its nearest boundary / cw[-1])``."""
    draws, out = 0, []
    for vocab in VOCABS:
        lg, args = _case(temperature, top_p, top_k, vocab)
        want, cw, target = (np.asarray(x) for x in _reference_parts(jnp.asarray(lg), vocab,
                                                                      *args))
        got = ts.sample_tokens(torch.from_numpy(lg), vocab, *args).numpy()
        assert got.shape == want.shape and got.max() < vocab
        draws += len(got)
        for r in np.flatnonzero(got != want):
            dist = float(np.abs(cw[r] - target[r]).min() / cw[r, -1])
            out.append((vocab, int(r), int(got[r]), int(want[r]), dist))
        if temperature == 0 or top_k == 1:  # argmax, or the best id alone survives
            np.testing.assert_array_equal(got, lg[:, :vocab].argmax(-1))
    return draws, out


@pytest.fixture(scope="module")
def sweep():
    return {case: _sweep_case(*case) for case in CASES}


@pytest.mark.parametrize("top_k", [0, 1, 40])
@pytest.mark.parametrize("top_p", [1.0, 0.95, 0.5])
@pytest.mark.parametrize("temperature", [0.0, 0.5, 0.8, 1.5])
def test_sample_tokens_match_reference(sweep, temperature, top_p, top_k):
    """Every disagreement of this case lies at a cumulative boundary."""
    _, cases = sweep[temperature, top_p, top_k]
    for vocab, r, got, want, dist in cases:
        print(f"disagreement: T {temperature} p {top_p} k {top_k} vocab {vocab} row {r}: "
              f"port {got}, reference {want}, draw {dist:.3e} x cw[-1] from a boundary")
        assert dist < TIE, "a disagreement away from a cumulative boundary"


def test_sampler_disagreements_below_a_thousandth(sweep):
    """Over the whole sweep: disagreements are at most a thousandth of the
    draws."""
    draws = sum(d for d, _ in sweep.values())
    cases = [(case, *c) for case, (_, cs) in sweep.items() for c in cs]
    assert draws == 36 * len(SEEDS) * sum(len(_steps(v)) for v in VOCABS)
    print(f"{len(cases)} disagreements in {draws} draws: {cases}")
    assert len(cases) <= draws / 1000


@pytest.mark.parametrize("vocab", VOCABS)
def test_row_alone_equals_row_in_a_batch_of_8(vocab):
    rng = np.random.default_rng(5)
    lg = torch.from_numpy(rng.normal(0, 3, (8, vocab)).astype(np.float32))
    temp = np.array([0.8, 0, 1.5, 0.5, 0.8, 0.8, 1.0, 0.3], np.float32)
    topp = np.array([0.95, 1, 0.5, 1, 0.95, 1, 0.5, 0.95], np.float32)
    topk = np.array([40, 0, 0, 1, 0, 40, 0, 40], np.int32)
    seed = np.array([100, 0, 2**32 - 1, 2**31, 7, 8, 9, 10], np.uint32)
    step = np.arange(8, dtype=np.int32)
    batch = ts.sample_tokens(lg, vocab, temp, topp, topk, seed, step)
    for r in range(8):
        one = ts.sample_tokens(lg[r:r + 1], vocab, temp[r:r + 1], topp[r:r + 1],
                               topk[r:r + 1], seed[r:r + 1], step[r:r + 1])
        assert int(one[0]) == int(batch[r]), r
    again = ts.sample_tokens(lg, vocab, temp, topp, topk, seed, step)
    assert torch.equal(again, batch)


def test_plan_sampling_fields_round_trip_reference_json():
    """``sampling``, ``int8_kv``, ``spec_draft`` and ``spec_k`` load from
    the reference's plan JSON and write it back byte for byte."""
    jp = JPlan.build(5, round_to=2, int8_kv=True)
    import dataclasses

    jp = dataclasses.replace(jp, sampling=JSampling(0.8, 0.95, 40, 2**32 - 1),
                             spec_draft="tiny", spec_k=3)
    tp = PrecisionPlan.from_json(jp.to_json())
    assert tp.int8_kv and tp.spec_k == 3 and tp.spec_draft == "tiny"
    assert tp.sampling == SamplingParams(0.8, 0.95, 40, 2**32 - 1)
    assert tp.to_json() == jp.to_json()
    assert PrecisionPlan.build(5, round_to=2).to_json() == JPlan.build(5, round_to=2).to_json()
    assert tp.make_env(MeshCfg()).int8_kv


# ---------------------------------------------------------------------------
# the engine and the static path
# ---------------------------------------------------------------------------


def _requests(cls, sampling_cls, vocab):
    rng = np.random.default_rng(11)
    return [cls(rid=i, prompt_ids=tuple(int(t) for t in rng.integers(0, vocab, S)),
                max_new=g, sampling=None if kw is None else sampling_cls(**kw))
            for i, (S, g, kw) in enumerate(SPEC)]


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
    jreqs = _requests(jeng.Request, JSampling, jcfg.vocab_size)
    treqs = _requests(teng.Request, SamplingParams, tcfg.vocab_size)
    out = {"j_static": jeng.generate_static(jcfg, jmesh, None, jspec, jstorage, jreqs,
                                           plan=jplan),
           "t_static": teng.generate_static(tcfg, tmesh, None, tspec, tstorage, treqs,
                                            plan=tplan)}
    eng = jeng.ServeEngine(jcfg, jmesh, None, jspec, jstorage, plan=jplan, max_slots=2,
                           cache_capacity=24)
    out["j_engine"] = {k: r.tokens for k, r in eng.run(jreqs).items()}
    out["j_summary"] = eng.wire_summary()
    out["setup"] = dict(jcfg=jcfg, jmesh=jmesh, jspec=jspec, jstorage=jstorage, jplan=jplan,
                        jeng=eng, tcfg=tcfg, tmesh=tmesh, tspec=tspec, tstorage=tstorage,
                        tplan=tplan, treqs=treqs)
    for paged in (False, True):
        eng = teng.ServeEngine(tcfg, tmesh, None, tspec, tstorage, plan=tplan, max_slots=2,
                               cache_capacity=24, paged=paged, page_size=8)
        out[f"t_engine{'_paged' * paged}"] = {k: r.tokens for k, r in eng.run(treqs).items()}
        out[f"t_summary{'_paged' * paged}"] = eng.wire_summary()
    return out


def test_sampled_streams_match_reference_engine_and_static(streams):
    assert streams["t_static"] == streams["j_static"]
    assert streams["t_engine"] == streams["j_engine"] == streams["j_static"]
    assert streams["t_engine_paged"] == streams["t_engine"]
    assert streams["t_summary"] == streams["j_summary"]
    assert {k: len(v) for k, v in streams["t_engine"].items()} == \
        {i: g for i, (_, g, _) in enumerate(SPEC)}


def test_sampled_launcher_twin_on_cpu(capsys):
    from repro_torch.launch import serve as launch

    results = launch.main(["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "16,12,8",
                           "--gen", "4", "--max-slots", "2", "--temperature", "0.8",
                           "--top-p", "0.95", "--top-k", "40", "--seed", "100",
                           "--check-static", "--device", "cpu"])
    assert sorted(results) == [0, 1, 2]
    assert "check-static: 3 streams equal to the static reference" in capsys.readouterr().out
    reqs = launch.build_requests([4, 4], 2, 512, temperature=0.8, seed=100)
    assert [r.sampling.seed for r in reqs] == [100, 101]
    assert launch.build_requests([4], 2, 512)[0].sampling.greedy


BIG_SEED = 2**32 + 5


@pytest.mark.parametrize("sampled", [True, False], ids=["sampled", "greedy"])
def test_seed_past_uint32_raises_in_both_packages(streams, sampled):
    """A seed of 2**32 + 5 raises ``OverflowError`` in both packages'
    ``uniform_for``, at admission in both engines (the reference converts
    every request's seed to uint32 there, greedy or not) and in both
    ``generate_static`` runs of a sampled group. The port's engine raises
    before it holds a slot or a page: the same stream then serves request
    2 (seed 2**32 - 1, the largest that is taken) as the reference's
    engine does, and its slot and page audits pass."""
    for uniform in (js.uniform_for, ts.uniform_for):
        with pytest.raises(OverflowError):
            uniform([BIG_SEED], [3])
    st = streams["setup"]
    kw = dict(temperature=0.8, top_p=0.95, top_k=40) if sampled else {}
    prompt = st["treqs"][0].prompt_ids
    jbad = jeng.Request(rid=9, prompt_ids=prompt, max_new=3,
                        sampling=JSampling(seed=BIG_SEED, **kw))
    tbad = teng.Request(rid=9, prompt_ids=prompt, max_new=3,
                        sampling=SamplingParams(seed=BIG_SEED, **kw))
    with pytest.raises(OverflowError):
        st["jeng"].run([jbad])
    if sampled:  # an all-greedy group never converts its seeds
        with pytest.raises(OverflowError):
            jeng.generate_static(st["jcfg"], st["jmesh"], None, st["jspec"], st["jstorage"],
                                 [jbad], plan=st["jplan"])
        with pytest.raises(OverflowError):
            teng.generate_static(st["tcfg"], st["tmesh"], None, st["tspec"], st["tstorage"],
                                 [tbad], plan=st["tplan"])
    for paged in (False, True):
        eng = teng.ServeEngine(st["tcfg"], st["tmesh"], None, st["tspec"], st["tstorage"],
                               plan=st["tplan"], max_slots=2, cache_capacity=24, paged=paged,
                               page_size=8)
        eng.begin_stream()
        with pytest.raises(OverflowError):
            eng.admit(tbad)
        assert eng.slots.free_slots == 2 and eng.slots.alloc_count == 0
        eng.admit(st["treqs"][2])
        while eng._active:
            eng.decode_tick()
        assert eng.finish()[2].tokens == streams["j_engine"][2] == streams["j_static"][2]
