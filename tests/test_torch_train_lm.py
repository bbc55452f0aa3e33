"""Dense LM A²DTWP training slice: the port against the JAX reference.

Both packages train reduced qwen3-1.7b (2 layers in 2 precision groups,
d 256, hd 64, vocab 512; every matrix a ``DIST`` leaf) from the same
weights — the reference's ``init_params(cfg, PRNGKey(0))`` carried across
by ``repro_torch.convert.convert_lm_params`` — on the same
``synthetic_lm_batch`` tokens. At hd 64 both sides attend through
``attend_tiled``, as the reference does on the CPU; the port's train mode
never takes the flash kernel on any device.

Tolerances (fp32 sums in another order in XLA and PyTorch): the loss and
``lm_loss`` within rtol 1e-6; Σw² per group within rtol 1e-6; one SGD
step's weight updates (up to ~1e-4) within atol 1e-8 plus one ulp of the
leaf's largest weight (the new weight is rounded at its own scale: ~1e-9
for the matrices, ~1e-7 for the norm scales at 1.0); the verify skill's
25-step run's losses within rtol 2e-5.
Token streams, AWP histories, wire bytes and launch counts must be equal.
The port with ``remat`` on and off gives the same loss and norms bit for
bit, weights within one ulp of the leaf's largest weight and gradients
(the momentum after one step, up to ~1e-3) within rtol 1e-6, atol 1e-9:
the CPU's scatter of the embedding's gradient accumulates in no fixed
order, so a few of its 131,072 weights land one ulp apart from run to
run, with or without ``remat``.

The card test (marker ``cuda``) runs one full-width step on the card
against the reference on the host's CPU: the loss within rtol 1e-6, Σw²
within rtol 1e-5, and six leaves' weight updates within the atol rule
above plus 2e-5 of the leaf's largest update:

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -m cuda -s tests/test_torch_train_lm.py
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jlaunch
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.data.pipeline import synthetic_lm_batch as j_batch
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import dist_elems_per_group as j_dist_elems
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.env import Env as JEnv
from repro.models.init import init_params as j_init_params
from repro.models.loss import lm_loss as j_lm_loss
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.train import step as jstep
from repro.transport import CompressionPolicy as JPolicy
from repro_torch import random as tr
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.dist.spec import MeshCfg, build_spec_tree, dist_elems_per_group
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.env import Env
from repro_torch.models.init import init_params
from repro_torch.models.loss import lm_loss
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.train import step as tstep
from repro_torch.transport import CompressionPolicy
from repro_torch.utils.trees import tree_leaves

LR, B, S = 0.05, 8, 128
LOSS_RTOL = 1e-6
NORM_RTOL = 1e-6
UPDATE_ATOL = 1e-8
RUN_RTOL = 2e-5
# the verify skill's run (.claude/skills/verify/SKILL.md)
VERIFY_ARGV = ["--arch", "qwen3-1.7b", "--reduced", "--mesh", "1x1", "--steps", "25",
               "--awp-interval", "5", "--awp-threshold", "1e-3"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    """{path: numpy leaf} of a reference or port tree (dicts and lists)."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    tcfg = reduced(get_config("qwen3-1.7b"))
    jmesh, tmesh = JMesh(tp=1, dp=1), MeshCfg()
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jspec = j_build_spec_tree(params, metas, jmesh)
    _, tmetas = init_params(tcfg, device="meta")
    np_params = _np_tree(params)
    tspec = build_spec_tree(convert_lm_params(tcfg, np_params, device="cpu"), tmetas, tmesh)
    tokens, labels = j_batch(jcfg.vocab_size, B, S, 0)
    return dict(jcfg=jcfg, tcfg=tcfg, jmesh=jmesh, tmesh=tmesh, params=params,
                np_params=np_params, jspec=jspec, tspec=tspec,
                jbatch={"tokens": tokens, "labels": labels})


def _tparams(s):
    """A fresh port copy of the reference's weights."""
    return convert_lm_params(s["tcfg"], s["np_params"], device="cpu")


def _tbatch():
    tokens, labels = synthetic_lm_batch(512, B, S, 0, device="cpu")
    return {"tokens": tokens, "labels": labels}


# ---------------------------------------------------------------------------
# data, geometry, state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq,step,seed", [
    (512, 8, 128, 0, 0), (512, 8, 128, 24, 0), (151_936, 2, 33, 5, 3), (7, 1, 1, 0, 0)])
def test_synthetic_lm_batch_equals_reference(vocab, batch, seq, step, seed):
    jt, jl = j_batch(vocab, batch, seq, step, seed=seed)
    tt, tl = synthetic_lm_batch(vocab, batch, seq, step, seed=seed, device="cpu")
    assert tt.dtype == tl.dtype == torch.int32 and tuple(tt.shape) == (batch, seq)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_dist_elems_and_wd_mask_match_reference(setup):
    s = setup
    nrt = s["jcfg"].num_groups + 1
    assert dist_elems_per_group(s["tspec"], s["tmesh"], nrt) == \
        j_dist_elems(s["jspec"], s["jmesh"], nrt)
    assert _paths(jstep.build_wd_mask(s["jspec"])) == _paths(tstep.build_wd_mask(s["tspec"]))


def test_momentum_starts_equal_across_packages(setup):
    """The reference's zero momentum converts like the weights, and equals
    the port's ``init_momentum`` of the converted weights."""
    s = setup
    jm = convert_lm_params(s["tcfg"], _np_tree(j_init_momentum(s["params"])), device="cpu")
    tm = init_momentum(_tparams(s))
    assert _paths(jm).keys() == _paths(tm).keys()
    for k, v in _paths(tm).items():
        np.testing.assert_array_equal(_paths(jm)[k], v)
        assert not v.any()


# ---------------------------------------------------------------------------
# loss, attention, forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["all-valid", "ignored", "padded-vocab"])
def test_lm_loss_matches_reference(case):
    rng = np.random.default_rng(4)
    V, real = 17, 13 if case == "padded-vocab" else 17
    logits = rng.normal(0, 3, (2, 5, V)).astype(np.float32)
    labels = rng.integers(0, real, (2, 5)).astype(np.int32)
    if case == "ignored":
        labels[0, 1] = labels[1, 4] = -1
    jn, jc = j_lm_loss(jnp.asarray(logits), jnp.asarray(labels), JEnv(), 0, real)
    tn, tc = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels), Env(), 0, real)
    np.testing.assert_allclose(float(tn), float(jn), rtol=LOSS_RTOL)
    assert float(tc) == float(jc) == (8 if case == "ignored" else 10)


def test_mha_train_mode_matches_reference(setup):
    s = setup
    w = jax.tree_util.tree_map(lambda a: a[0], s["np_params"]["groups"][0]["p0"]["attn"])
    x = np.random.default_rng(5).normal(0, 1, (2, 16, s["jcfg"].d_model)).astype(np.float32)
    jy, jc = jattn.mha(jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, w), s["jcfg"],
                       JEnv(), mode="train")
    ty, tc = tattn.mha(torch.from_numpy(x), {k: torch.from_numpy(np.array(v)) for k, v in w.items()},
                       s["tcfg"], Env(), mode="train")
    assert jc is None and tc is None
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=2e-6, rtol=1e-5)


def test_train_mode_never_takes_the_flash_kernel(setup, monkeypatch):
    """The flash prefill call has no backward: even where its viability
    rule holds, train mode never takes it (at the reduced config's head
    width, 64, not the flash route's either: ``attend_tiled``)."""
    s = setup

    def no_flash(*a, **k):
        raise AssertionError("train mode reached the flash kernel")

    monkeypatch.setattr(tattn, "_flash_prefill_viable", lambda *a: True)
    monkeypatch.setattr(tattn, "_flash_prefill_call", no_flash)
    w = {k: torch.from_numpy(np.array(v[0])) for k, v in
         s["np_params"]["groups"][0]["p0"]["attn"].items()}
    y, _ = tattn.mha(torch.zeros(1, 8, s["tcfg"].d_model), w, s["tcfg"], Env(), mode="train")
    assert y.shape == (1, 8, s["tcfg"].d_model)
    cache = tattn.init_cache(1, 8, s["tcfg"].num_kv_heads, s["tcfg"].head_dim, torch.float32)
    with pytest.raises(ValueError, match="no KV cache"):
        tattn.mha(torch.zeros(1, 8, s["tcfg"].d_model), w, s["tcfg"], Env(), mode="train",
                  cache=cache)


@pytest.mark.parametrize("round_to", [4, 2])
def test_forward_loss_matches_reference(setup, round_to):
    s = setup
    nrt = s["jcfg"].num_groups + 1
    jplan, tplan = JPlan.build(nrt, round_to=round_to), PrecisionPlan.build(nrt, round_to=round_to)
    jg, jt = jstep.make_mat_fns(s["jspec"], s["jmesh"], jplan.weight_policies())
    jn, jm = jmodel.forward_loss(s["params"], s["jbatch"], s["jcfg"], jplan.make_env(s["jmesh"]),
                                 mat_group=jg, mat_top=jt(s["params"]))
    tp = _tparams(s)
    tg, tt = tstep.make_mat_fns(s["tspec"], s["tmesh"], tplan.weight_policies())
    tn, tm = tmodel.forward_loss(tp, _tbatch(), s["tcfg"], tplan.make_env(s["tmesh"]),
                                 mat_group=tg, mat_top=tt(tp))
    np.testing.assert_allclose(float(tn), float(jn), rtol=LOSS_RTOL)
    assert float(tm["token_count"]) == float(jm["token_count"]) == B * S


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _jstep(s, plan, storage):
    shapes = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    fn = jstep.make_train_step(s["jcfg"], s["jmesh"], None, s["jspec"],
                               JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes, plan=plan)
    return fn(storage, j_init_momentum(storage), s["jbatch"], LR)


def _tstep(s, plan, cfg=None):
    tp = _tparams(s)
    fn = tstep.make_train_step(cfg or s["tcfg"], s["tmesh"], None, s["tspec"],
                               SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4),
                               {"tokens": (B, S), "labels": (B, S)}, plan=plan)
    return fn(tp, init_momentum(tp), _tbatch(), LR)


@pytest.mark.parametrize("round_to", [4, 2, 1])
def test_train_step_matches_reference(setup, round_to):
    """One step from converted weights: loss, token count, the updated
    masters and ``group_norms_sq`` (held to the reference's
    ``awp_group_norms`` on the reference's new storage)."""
    s = setup
    nrt = s["jcfg"].num_groups + 1
    jplan, tplan = JPlan.build(nrt, round_to=round_to), PrecisionPlan.build(nrt, round_to=round_to)
    old = _paths(s["params"])
    jnew, _, jmet = _jstep(s, jplan, jax.tree_util.tree_map(jnp.copy, s["params"]))
    tnew, tmom, tmet = _tstep(s, tplan)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    assert float(tmet["token_count"]) == float(jmet["token_count"]) == B * S
    assert tmet["group_norms_sq"].shape == (nrt,)
    np.testing.assert_allclose(tmet["group_norms_sq"].numpy(),
                               np.asarray(jmet["group_norms_sq"]), rtol=NORM_RTOL)
    jp, tp = _paths(jnew), _paths(tnew)
    assert jp.keys() == tp.keys()
    for k in jp:  # the weight update, not just the weights
        atol = UPDATE_ATOL + float(np.spacing(np.abs(old[k]).max()))
        np.testing.assert_allclose(tp[k] - old[k], jp[k] - old[k], rtol=0, atol=atol,
                                   err_msg=k)
    for k, m in _paths(tmom).items():  # momentum = the first gradient (+ decay)
        atol = UPDATE_ATOL + float(np.spacing(np.abs(old[k]).max()))
        np.testing.assert_allclose(-LR * m, tp[k] - old[k], rtol=0, atol=atol, err_msg=k)


def test_awp_group_norms_match_reference_one_call_per_leaf(setup, monkeypatch):
    s = setup
    calls = []
    real = tstep.ops.l2norm_sq
    monkeypatch.setattr(tstep.ops, "l2norm_sq", lambda w: calls.append(w.shape) or real(w))
    got = tstep.awp_group_norms(_tparams(s), s["tspec"], s["tmesh"])
    want = jstep.awp_group_norms(s["params"], s["jspec"], s["jmesh"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=NORM_RTOL)
    n_dist = sum(x.kind == "dist" for x in tree_leaves(s["tspec"]))
    assert len(calls) == n_dist == 16  # 7 stacked matrices x 2 groups + embed + head


def test_remat_gives_the_same_step_and_recomputes_the_transfer(setup, monkeypatch):
    """``remat`` (the full-width default; reduced configs turn it off, as
    the reference's do) wraps each layer in ``torch.utils.checkpoint``:
    the same step up to the embedding gradient's run-to-run ulps, and
    every group leaf goes through pack∘unpack again in the backward."""
    from repro_torch.transport import transport

    s = setup
    nrt = s["tcfg"].num_groups + 1
    plan = PrecisionPlan.build(nrt, round_to=2)
    calls = []
    real = transport._quantize_impl
    monkeypatch.setattr(transport, "_quantize_impl",
                        lambda w, pol, *a: calls.append(w.shape) or real(w, pol, *a))
    runs = {}
    for remat in (False, True):
        calls.clear()
        cfg = dataclasses.replace(s["tcfg"], remat=remat)
        new, mom, met = _tstep(s, plan, cfg)
        runs[remat] = (_paths(new), _paths(mom), met, len(calls))
    (a, am, ameta, a_calls), (b, bm, bmeta, b_calls) = runs[False], runs[True]
    assert float(ameta["loss"]) == float(bmeta["loss"])
    assert torch.equal(ameta["group_norms_sq"], bmeta["group_norms_sq"])
    apart = {k: int((a[k] != b[k]).sum()) for k in a if (a[k] != b[k]).any()}
    print(f"\nremat on vs off: weights that differ {apart}")
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=np.spacing(np.abs(a[k]).max()),
                                   err_msg=k)
        np.testing.assert_allclose(am[k], bm[k], rtol=1e-6, atol=1e-9, err_msg=k)
    group_mats = sum(x.reps for g in s["tspec"]["groups"] for x in tree_leaves(g)
                     if x.kind == "dist")
    assert (a_calls, b_calls) == (group_mats + 2, 2 * group_mats + 2) == (16, 30)


def _raises_mesh(s):
    tstep.make_train_step(s["tcfg"], MeshCfg(tp=2), None, s["tspec"], SGDConfig(), {},
                          plan=PrecisionPlan.build(3))


def _raises_mesh_object(s):
    tstep.make_train_step(s["tcfg"], s["tmesh"], object(), s["tspec"], SGDConfig(), {},
                          plan=PrecisionPlan.build(3))


@pytest.mark.parametrize("case", [_raises_mesh, _raises_mesh_object],
                         ids=lambda f: f.__name__[len("_raises_"):])
def test_step_needs_the_mesh_of_its_cfg(setup, case):
    """A sharded ``MeshCfg`` runs (``tests/test_torch_tp.py``) with the
    mesh ``launch.mesh.make_mesh_from_cfg`` gives for it; without one, or
    with a mesh object on the trivial mesh, the factory refuses."""
    with pytest.raises(ValueError, match="mesh"):
        case(setup)


def _raises_stochastic(s):
    """A stochastic plan's step takes the key as its fifth argument (the
    reference's signature) and runs; the loss is the reference's."""
    jplan = JPlan(weights=(JPolicy(round_to=2, mode="stochastic"),) * 3)
    plan = PrecisionPlan(weights=(CompressionPolicy(round_to=2, mode="stochastic"),) * 3)
    assert plan.needs_rng and jplan.needs_rng
    shapes = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    jfn = jstep.make_train_step(s["jcfg"], s["jmesh"], None, s["jspec"],
                                JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes, plan=jplan)
    storage = jax.tree_util.tree_map(jnp.copy, s["params"])
    _, _, jm = jfn(storage, j_init_momentum(storage), s["jbatch"], LR, jax.random.PRNGKey(5))
    tp = _tparams(s)
    fn = tstep.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"],
                               SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4),
                               {"tokens": (B, S), "labels": (B, S)}, plan=plan)
    with pytest.raises(TypeError):
        fn(tp, init_momentum(tp), _tbatch(), LR)  # the key is not optional
    _, _, tm = fn(tp, init_momentum(tp), _tbatch(), LR, tr.PRNGKey(5))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)


def _raises_accum(s):
    """A plan with ``accum_steps`` 2 loads, and a batch that does not split
    into its micro-batches raises ``ValueError``."""
    plan = PrecisionPlan.from_json_dict({"weights": [{"round_to": 2}], "accum_steps": 2})
    assert plan.accum_steps == 2
    tp = _tparams(s)
    fn = tstep.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"], SGDConfig(),
                               {"tokens": (3, S), "labels": (3, S)}, plan=plan)
    tokens, labels = synthetic_lm_batch(512, 3, S, 0, device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        fn(tp, init_momentum(tp), {"tokens": tokens, "labels": labels}, LR)


@pytest.mark.parametrize("case", [_raises_stochastic, _raises_accum],
                         ids=lambda f: f.__name__[len("_raises_"):])
def test_unported_step_options_raise(setup, case):
    """Both options raised ``NotImplementedError`` until this slice ported
    them; each case now runs the ported option (see its docstring)."""
    case(setup)


def test_make_train_step_needs_its_arguments(setup):
    s = setup
    with pytest.raises(TypeError):
        tstep.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"], None, {},
                              plan=PrecisionPlan.build(3))
    with pytest.raises(TypeError):
        tstep.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"], SGDConfig(), {})


# ---------------------------------------------------------------------------
# the verify skill's run, both launchers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def verify_runs(setup, tmp_path_factory):
    """The reference launcher's run (its own stdout and ``--losses-out``)
    and the port launcher's run from the reference's weights."""
    out = tmp_path_factory.mktemp("verify") / "losses.json"
    argv, buf = sys.argv, io.StringIO()
    sys.argv = ["repro.launch.train", *VERIFY_ARGV, "--losses-out", str(out)]
    try:
        with contextlib.redirect_stdout(buf):
            jlaunch.main()
    finally:
        sys.argv = argv
    ref_text = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port = tlaunch.main([*VERIFY_ARGV, "--device", "cpu"], params=_tparams(setup))
    return {"ref_text": ref_text, "ref_losses": json.loads(out.read_text())["losses"],
            "port": port, "port_text": buf.getvalue()}


def _line(text, prefix):
    return next(ln for ln in text.splitlines() if ln.startswith(prefix))


def test_verify_run_matches_reference(setup, verify_runs):
    """``--reduced --mesh 1x1 --steps 25 --awp-interval 5 --awp-threshold
    1e-3``: the same AWP history (8→16→24→32), the same wire bytes at
    every step, losses allclose."""
    s, r = setup, verify_runs
    hist = r["port"]["bits_history"]
    assert [(st, b[0]) for st, b in hist] == [(0, 8), (6, 16), (11, 24), (16, 32)]
    assert _line(r["port_text"], "AWP:") == _line(r["ref_text"], "AWP:")
    gap = np.abs(np.subtract(r["port"]["losses"], r["ref_losses"])) / np.abs(r["ref_losses"])
    print(f"\n25 verify steps: losses within {gap.max():.2e} relative of the reference")
    np.testing.assert_allclose(r["port"]["losses"], r["ref_losses"], rtol=RUN_RTOL)
    # the reference's wire bytes a step, from its plan at its history's formats
    nrt = s["jcfg"].num_groups + 1
    elems = j_dist_elems(s["jspec"], s["jmesh"], nrt)
    plan = JPlan.build(nrt, schedule="awp", awp_threshold=1e-3, awp_interval=5)
    starts = [st for st, _ in hist] + [25]
    want = [plan.with_round_tos(tuple(b // 8 for b in bits)).wire_table(elems, 1)["total"]
            for (st, bits), end in zip(hist, starts[1:]) for _ in range(st, end)]
    assert r["port"]["step_wire_bytes"] == want
    done = re.compile(r"wire-reduction (\S+)  recompiles (\d+)")
    assert done.search(r["port_text"]).groups() == done.search(r["ref_text"]).groups()
    assert _line(r["port_text"], "wire by plan entry") == _line(r["ref_text"], "wire by plan entry")


def test_launcher_twin_prints_the_reference_awp_line(verify_runs, capsys, tmp_path):
    """The port launcher with its own seeded weights on the CPU: the
    reference launcher's AWP line, and ``--check`` against its own losses."""
    losses = tmp_path / "losses.json"
    tlaunch.main([*VERIFY_ARGV, "--device", "cpu", "--losses-out", str(losses)])
    text = capsys.readouterr().out
    assert _line(text, "AWP:") == _line(verify_runs["ref_text"], "AWP:")
    assert _line(text, "step   20") and "done: loss" in text
    tlaunch.main([*VERIFY_ARGV, "--steps", "2", "--device", "cpu", "--check", str(losses)])
    assert "--check OK" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--ckpt", "x"], ["--resume"], ["--data-dir", "x"], ["--chunks", "auto"],
], ids=lambda f: f[0])
def test_launcher_unported_flags_raise(flags, tmp_path, capsys):
    """``--chunks auto``, which raised until ``plan/sweep.py`` was ported
    (ROADMAP item 12), takes ``pick_chunks`` at the largest ``DIST`` shard
    on two data ranks. The training I/O flags, which raised on a
    mesh until item 9b, run on two data ranks: ``--ckpt`` writes the mesh's
    global storage (its shapes, its bytes), ``--resume`` continues a run
    bit-exactly, ``--data-dir`` trains from shards with the ingest bytes
    of ``train_ingest_bytes`` (``test_torch_mesh_io.py`` holds them to the
    reference)."""
    from repro_torch.checkpoint.sharded import leaf_entries, manifest_bytes, read_meta
    from repro_torch.dist.spec import storage_shape

    base = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2", "--seq", "16", "--device",
            "cpu", "--mesh", "2x1"]
    ck = str(tmp_path / "ck")
    if flags[0] == "--chunks":
        from repro_torch.plan import pick_chunks

        out = tlaunch.main([*base, "--steps", "1", *flags])
        cfg, mcfg = reduced(get_config("qwen3-1.7b")), MeshCfg(dp=2)
        shapes, metas = init_params(cfg, device="meta")
        s_loc = max(s.s_loc for s in tree_leaves(build_spec_tree(shapes, metas, mcfg))
                    if s.kind == "dist")
        assert out["chunks"] == pick_chunks(s_loc, 2, 1)  # AWP starts at 8 bits
    elif flags[0] == "--ckpt":
        tlaunch.main([*base, "--steps", "1", "--ckpt", ck])
        meta = read_meta(ck + ".ckpt")
        assert meta["step"] == 1 and meta["plan"] is not None
        sizes = sum(os.path.getsize(os.path.join(ck + ".ckpt", f))
                    for f in os.listdir(ck + ".ckpt") if f.endswith(".bin"))
        assert manifest_bytes(meta)["total"] == sizes
        cfg, mcfg = reduced(get_config("qwen3-1.7b")), MeshCfg(dp=2)
        shapes, metas = init_params(cfg, device="meta")
        specs = dict(leaf_entries(build_spec_tree(shapes, metas, mcfg)))
        for e in meta["trees"]["storage"]:
            assert tuple(e["shape"]) == storage_shape(specs[e["path"]], mcfg), e["path"]
    elif flags[0] == "--resume":
        losses = str(tmp_path / "full.json")
        tlaunch.main([*base, "--steps", "2", "--losses-out", losses])
        tlaunch.main([*base, "--steps", "1", "--ckpt", ck])
        tlaunch.main([*base, "--steps", "2", "--ckpt", ck, "--resume", "--check", losses])
        assert "--check OK: losses bit-exact" in capsys.readouterr().out
    else:
        from repro_torch.data.shards import write_lm_shards

        write_lm_shards(str(tmp_path / "sh"), vocab=512, seq=16, num_records=8)
        tlaunch.main([*base, "--steps", "2", "--data-dir", str(tmp_path / "sh")])
        assert re.search(r"ingest bytes measured .* \[OK\]", capsys.readouterr().out)


# (flags, the traffic class that must move) of the flags the FSDP×TP slice
# ported: each runs on a small mesh of gloo ranks (2 processes)
PORTED_FLAGS = (
    (["--mesh", "2x1"], "gradients"),
    (["--mesh", "2x1", "--grad-round-to", "2", "--grad-mode", "truncate"], "gradients"),
    (["--mesh", "1x2", "--act-round-to", "2"], "activations"),
    (["--mesh", "1x2", "--seq-parallel"], "seq_boundary"),
    (["--mesh", "2x1", "--chunks", "2"], "weights"),
    # ported by the slice after: the flags that raised until then
    (["--mesh", "2x1", "--grad-round-to", "2", "--grad-mode", "stochastic"], "gradients"),
    (["--mesh", "2x1", "--accum", "2"], "weights"),
    (["--mesh", "1x2", "--bf16"], "activations"),
)


@pytest.fixture(scope="module")
def one_device_step(setup):
    """The 1x1 launcher's first loss at the ported flags' batch."""
    return tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--device", "cpu",
                         "--seq", "16", "--batch", "4", "--policy", "oracle:2"])


@pytest.mark.parametrize("flags,moves", PORTED_FLAGS,
                         ids=["--mesh", "--grad-round-to", "--act-round-to", "--seq-parallel",
                              "--chunks", "--grad-mode", "--accum", "--bf16"])
def test_launcher_ported_flags_run(flags, moves, one_device_step, capsys):
    """The flags that raised before the FSDP×TP slice, and ``--grad-mode
    stochastic``, ``--accum`` and ``--bf16`` that raised before the slice
    after it, run on two ranks: the measured wire equals
    ``step_wire_table`` (the launcher prints OK only then), the flag's
    class moves, and the first loss is the one device's within rtol 1e-5
    (rounded activations: 1e-3; bf16 compute, whose 8-bit activations
    move the loss by ~1e-4: 1e-3)."""
    s = tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--device", "cpu",
                      "--seq", "16", "--batch", "4", "--policy", "oracle:2", *flags])
    assert "[OK against step_wire_table]" in capsys.readouterr().out
    assert s["measured"][0][moves] > 0
    rtol = 1e-3 if "--act-round-to" in flags or "--bf16" in flags else 1e-5
    np.testing.assert_allclose(s["losses"][0], one_device_step["losses"][0], rtol=rtol)


def test_launcher_plan_file(tmp_path, capsys):
    ok, act, hd = tmp_path / "ok.json", tmp_path / "act.json", tmp_path / "hd.json"
    ok.write_text(PrecisionPlan.build(3, round_to=2).to_json())
    act.write_text(PrecisionPlan.build(3, round_to=2, act_round_to=2).to_json())
    hd.write_text(PrecisionPlan(weights=(CompressionPolicy(round_to=2),) * 3,
                                host_device=CompressionPolicy(round_to=1)).to_json())
    s = tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--device", "cpu",
                      "--plan", str(ok)])
    assert s["wire_reduction"] == 0.5
    # the activation policy runs (one device: no TP region, the same step)
    a = tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--device", "cpu",
                      "--plan", str(act)])
    assert a["losses"] == s["losses"] and a["wire_reduction"] == 0.5
    # a host_device entry (ported with training I/O) prices the host->device
    # wire at its own width and leaves the step alone
    h = tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1", "--device", "cpu",
                      "--plan", str(hd)])
    assert h["losses"] == s["losses"]
    assert 2 * h["wire_by_entry"]["host_device"] == s["wire_by_entry"]["host_device"] > 0


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])


def test_chip_smoke_train_phase_rehearses_on_cpu(capsys):
    """``chip_smoke.py`` phase 11 at reduced width on the CPU, with
    ``remat`` on as at full width (plain versions; launch counts, the
    monitor record, memory and the profile are read on a card only)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), remat=True)
    out = smoke.lm_train_path(torch, torch.device("cpu"), cfg=cfg, batch=4, seq=32)
    assert [(st, b[0]) for st, b in out["awp"].bits_history] == \
        [(0, 8), (3, 16), (5, 24), (7, 32)]
    assert "per step 16 + 14 (remat) DIST materializations" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card (marker ``cuda``; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


FULL_LOSS_RTOL = 1e-6  # 28 layers of fp32 sums in other orders, loss ~12
FULL_NORM_RTOL = 1e-5
# the CPU test's atol rule plus this share of the leaf's largest update:
# gradients back through 28 layers in other fp32 orders (7.6e-6 of it
# measured on the embedding, H100 against the host CPU)
FULL_UPDATE_RTOL = 2e-5
# leaves whose one-step update is held to the reference's: the head, the
# embedding (a scattered gradient), the first group's stacked gate (layers
# 0-6, recomputed under remat), the last group's wq, and two norm scales
FULL_LEAVES = ("['head']", "['embed']", "['final_norm']",
               "['groups'][0]['p0']['mix']['w_gate']", "['groups'][0]['p0']['attn']['ln']",
               "['groups'][3]['p0']['attn']['wq']")


def _pick(tree, keys):
    """Host copies of the leaves of ``tree`` at the paths ``keys``."""
    out = {}
    for p, x in jax.tree_util.tree_leaves_with_path(tree):
        k = jax.tree_util.keystr(p)
        if k in keys:
            out[k] = x.detach().cpu().numpy().copy() if torch.is_tensor(x) else np.array(x)
    assert out.keys() == set(keys)
    return out


@pytest.mark.cuda
def test_full_width_qwen3_train_step_on_card_matches_reference(cuda_device):
    """Full-width qwen3-1.7b (28 layers, ``remat`` on) from the reference's
    ``init_params(cfg, PRNGKey(0))``: one ``oracle:2`` step on the card
    (Bitpack/Bitunpack and ``l2norm_sq`` in CUDA) against the reference's
    step on the host's CPU, batch 2 x seq 128 of ``synthetic_lm_batch``.
    Step-0 loss within ``FULL_LOSS_RTOL``, ``group_norms_sq`` within
    ``FULL_NORM_RTOL``, the weight update of the ``FULL_LEAVES`` within the
    CPU test's atol (``UPDATE_ATOL`` plus one ulp of the leaf's largest
    weight) plus ``FULL_UPDATE_RTOL`` of the leaf's largest update; the
    kernels' launch counts are exact."""
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.l2norm import l2norm_sq

    jcfg, tcfg = j_get_config("qwen3-1.7b"), get_config("qwen3-1.7b")
    jmesh, tmesh = JMesh(tp=1, dp=1), MeshCfg()
    nrt = jcfg.num_groups + 1
    batch, seq = 2, 128
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    tparams = convert_lm_params(tcfg, _np_tree(params), device=cuda_device)
    jspec = j_build_spec_tree(params, metas, jmesh)
    tokens, labels = j_batch(jcfg.vocab_size, batch, seq, 0)
    shapes = {k: jax.ShapeDtypeStruct((batch, seq), jnp.int32) for k in ("tokens", "labels")}
    jfn = jstep.make_train_step(jcfg, jmesh, None, jspec, JSGD(lr=LR, momentum=0.9,
                                weight_decay=1e-4), shapes, plan=JPlan.build(nrt, round_to=2))
    old = _pick(params, FULL_LEAVES)
    jnew, _, jmet = jfn(params, j_init_momentum(params), {"tokens": tokens, "labels": labels},
                        LR)
    jloss, jnorms = float(jmet["loss"]), np.asarray(jmet["group_norms_sq"])
    jup = {k: x - old[k] for k, x in _pick(jnew, FULL_LEAVES).items()}
    del params, jfn, jmet, jnew

    _, tmetas = init_params(tcfg, device="meta")
    tspec = build_spec_tree(tparams, tmetas, tmesh)
    tfn = tstep.make_train_step(tcfg, tmesh, None, tspec, SGDConfig(lr=LR, momentum=0.9,
                                weight_decay=1e-4), {}, plan=PrecisionPlan.build(nrt, round_to=2))
    tt, tl = synthetic_lm_batch(tcfg.vocab_size, batch, seq, 0, device=cuda_device)
    packs, norms = bitpack.launches, l2norm_sq.launches
    tnew, _, tmet = tfn(tparams, init_momentum(tparams), {"tokens": tt, "labels": tl}, LR)
    tloss, tnorms = float(tmet["loss"]), tmet["group_norms_sq"].cpu().numpy()
    tup = {k: x - old[k] for k, x in _pick(tnew, FULL_LEAVES).items()}
    assert bitpack.launches - packs == 198 + 196  # forward + the remat recomputation
    assert l2norm_sq.launches - norms == 30
    print(f"\nstep-0 loss: reference {jloss!r}, port {tloss!r} (rel {abs(tloss - jloss) / jloss:.2e})")
    print(f"group_norms_sq: reference {jnorms.tolist()}, port {tnorms.tolist()} (max rel "
          f"{float(np.max(np.abs(tnorms - jnorms) / jnorms)):.2e})")
    for k in FULL_LEAVES:
        gap = np.abs(tup[k] - jup[k]).max()
        print(f"update {k}: max |reference| {np.abs(jup[k]).max():.3e}, max |port - reference| "
              f"{gap:.3e}, relative l2 gap "
              f"{np.linalg.norm(tup[k] - jup[k]) / np.linalg.norm(jup[k]):.2e}")
    np.testing.assert_allclose(tloss, jloss, rtol=FULL_LOSS_RTOL)
    np.testing.assert_allclose(tnorms, jnorms, rtol=FULL_NORM_RTOL)
    for k in FULL_LEAVES:
        atol = (UPDATE_ATOL + float(np.spacing(np.abs(old[k]).max()))
                + FULL_UPDATE_RTOL * float(np.abs(jup[k]).max()))
        np.testing.assert_allclose(tup[k], jup[k], rtol=0, atol=atol, err_msg=k)
