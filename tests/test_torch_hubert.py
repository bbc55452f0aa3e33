"""hubert-xlarge (the audio encoder: bidirectional attention, a GeLU MLP,
frame-embedding inputs through ``embed_in``, 504 frame classes) in the port
against the JAX reference at ``reduced()`` (2 layers, d 256, 32-wide
input features), on one device.

Both packages start from the same weights, the reference's
``init_params(cfg, PRNGKey(0))`` carried across by
``repro_torch.convert.convert_lm_params``; batches from each package's
``synthetic_feature_batch`` (equal by construction) or from the same
feature shards (``data.shards.write_feature_shards``).

Tolerances: last-frame logits atol 2e-5 / rtol 1e-5; one SGD step's loss
within rtol 1e-5, Σw² within rtol 1e-6, each leaf's update within 1e-8
plus one ulp of its largest weight plus 2e-4 of its largest update
(``tests/test_torch_archs.py``'s bars); launcher losses rtol 2e-5.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jlaunch_train
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.data.pipeline import synthetic_feature_batch as j_feature_batch
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.models.init import init_params as j_init_params
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.serve import step as jserve
from repro.train import step as jtrain
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.data.pipeline import synthetic_feature_batch
from repro_torch.data.shards import write_feature_shards
from repro_torch.dist.spec import MeshCfg, build_spec_tree, tree_to_storage
from repro_torch.launch import train as tlaunch_train
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.serve import step as tserve
from repro_torch.train import step as ttrain

ARCH = "hubert-xlarge"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIN_SIZE = 4096
B, S, LR = 4, 32, 0.05
LOGIT_TOL = dict(atol=2e-5, rtol=1e-5)
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-6
UPDATE_ATOL, UPDATE_REL = 1e-8, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    np_params = jax.tree_util.tree_map(np.array, params)
    jmesh, tmesh = JMesh(compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
    jspec = j_build_spec_tree(params, metas, jmesh)
    _, tmetas = init_params(tcfg, device="meta")
    tspec = build_spec_tree(convert_lm_params(tcfg, np_params, device="cpu"), tmetas, tmesh)
    nrt = jcfg.num_groups + 1
    return dict(jcfg=jcfg, tcfg=tcfg, np_params=np_params, jmesh=jmesh, tmesh=tmesh,
                jspec=jspec, tspec=tspec, jplan=JPlan.build(nrt, round_to=2),
                tplan=PrecisionPlan.build(nrt, round_to=2))


def _jstorage(s):
    return j_tree_to_storage(jax.tree_util.tree_map(jnp.asarray, s["np_params"]), s["jspec"],
                             s["jmesh"])


def _tstorage(s):
    return tree_to_storage(convert_lm_params(s["tcfg"], s["np_params"], device="cpu"),
                           s["tspec"], s["tmesh"])


def test_prefill_logits_match_reference():
    """The encoder's forward over 16 frames (the prefill step's last-frame
    logits): ``embed_in``, bidirectional attention, the GeLU MLP."""
    s = _setup()
    feats = np.random.default_rng(3).normal(0, 1, (2, 16, s["tcfg"].vision_dim)).astype(
        np.float32)
    shapes = {"features": jax.ShapeDtypeStruct(feats.shape, jnp.float32)}
    jfn = jserve.make_prefill_step(s["jcfg"], s["jmesh"], None, s["jspec"], shapes,
                                   plan=s["jplan"], cache_capacity=16)
    jl, _ = jfn(_jstorage(s), {"features": jnp.asarray(feats)})
    tfn = tserve.make_prefill_step(s["tcfg"], s["tmesh"], None, s["tspec"], plan=s["tplan"],
                                   cache_capacity=16)
    tl, _ = tfn(_tstorage(s), {"features": torch.from_numpy(feats)})
    assert tuple(tl.shape) == (2, 1, s["tcfg"].vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_train_step_matches_reference():
    """One SGD step at round_to 2 on the same frame batch: the loss (ln 504
    ≈ 6.22 at init), Σw² and every leaf's update, ``embed_in``'s and the
    GeLU MLP's among them."""
    s = _setup()
    dim, V = s["jcfg"].vision_dim, s["jcfg"].vocab_size
    jf, jl = j_feature_batch(dim, V, B, S, 0)
    shapes = {"features": jax.ShapeDtypeStruct((B, S, dim), jnp.float32),
              "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    jfn = jtrain.make_train_step(s["jcfg"], s["jmesh"], None, s["jspec"],
                                 JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes,
                                 plan=s["jplan"])
    jst = _jstorage(s)
    old = {k: np.array(v) for k, v in _paths(jst).items()}
    jnew, _, jmet = jfn(jst, j_init_momentum(jst), {"features": jf, "labels": jl}, LR)
    tfn = ttrain.make_train_step(s["tcfg"], s["tmesh"], None, s["tspec"],
                                 SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4),
                                 {"features": (B, S, dim), "labels": (B, S)}, plan=s["tplan"])
    tst = _tstorage(s)
    tf, tl = synthetic_feature_batch(dim, V, B, S, 0, device="cpu")
    assert np.array_equal(tf.numpy(), np.asarray(jf)) and np.array_equal(tl.numpy(),
                                                                         np.asarray(jl))
    tnew, _, tmet = tfn(tst, init_momentum(tst), {"features": tf, "labels": tl}, LR)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    assert abs(float(tmet["loss"]) - np.log(V)) < 0.5
    np.testing.assert_allclose(tmet["group_norms_sq"].numpy(), np.asarray(jmet["group_norms_sq"]),
                               rtol=NORM_RTOL)
    jp, tp = _paths(jnew), _paths(tnew)
    assert jp.keys() == tp.keys() and "['embed_in']" in tp and "['embed']" not in tp
    for k in jp:
        ju, tu = np.asarray(jp[k]) - old[k], tp[k].numpy() - old[k]
        atol = (UPDATE_ATOL + float(np.spacing(np.abs(old[k]).max()))
                + UPDATE_REL * float(np.abs(ju).max()))
        np.testing.assert_allclose(tu, ju, rtol=0, atol=atol, err_msg=k)


def _run_reference(main, argv):
    old, buf = sys.argv, io.StringIO()
    sys.argv = ["reference", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = old
    return buf.getvalue()


def test_train_launcher_on_feature_shards_matches_reference(tmp_path):
    """``launch.train --arch hubert-xlarge --reduced --data-dir <feature
    shards>``: both launchers read the same shards; losses within rtol 2e-5
    of the reference launcher's, the same AWP line, and the port's
    measured ingest bytes equal ``train_ingest_bytes`` (with the frames'
    fp32 bytes); ``lm`` shards are refused."""
    s = _setup()
    shards = str(tmp_path / "shards")
    write_feature_shards(shards, dim=s["tcfg"].vision_dim, vocab=s["tcfg"].vocab_size, seq=S,
                         num_records=16)
    argv = ["--arch", ARCH, "--reduced", "--mesh", "1x1", "--steps", "3", "--batch", str(B),
            "--seq", str(S), "--data-dir", shards]
    params, _ = j_init_params(s["jcfg"], jax.random.PRNGKey(0), tp=1)
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run_reference(jlaunch_train.main, [*argv, "--losses-out", str(ref_out)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch_train.main([*argv, "--device", "cpu", "--losses-out", str(port_out)],
                           params=convert_lm_params(s["tcfg"], jax.tree_util.tree_map(
                               np.asarray, params), device="cpu"))
    want = json.loads(ref_out.read_text())["losses"]
    got = json.loads(port_out.read_text())["losses"]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    out = buf.getvalue()
    awp = [ln for ln in ref.splitlines() if ln.startswith("AWP:")]
    assert awp and awp == [ln for ln in out.splitlines() if ln.startswith("AWP:")]
    assert "ingest bytes measured" in out and "[OK]" in out
    from repro_torch.data.shards import write_lm_shards

    lm = str(tmp_path / "lm")
    write_lm_shards(lm, vocab=s["tcfg"].vocab_size, seq=S, num_records=8)
    with pytest.raises(SystemExit, match="arch needs 'feature'"):
        tlaunch_train.main([*argv[:-1], lm, "--device", "cpu"])


def test_chip_smoke_vision_phase_rehearses_on_cpu():
    """``chip_smoke.py`` phase 22 at reduced configs on the CPU (the plain
    versions; launch counts and memory are read on a card only): llama's
    static run with requests 0 and 1 on one prompt and two images (first
    logits apart, a decode step within 1e-4 of the largest |logit| of a
    fresh prefill, every logit finite), hubert's two A²DTWP steps with
    finite losses."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    out = chip_smoke.vision_path(
        torch, torch.device("cpu"), a_cfg=reduced(get_config("llama-3.2-vision-90b")),
        b_cfg=reduced(get_config(ARCH)), lens=(32, 32, 24, 16, 12), gen=4, steps=2, batch=2,
        seq=16)
    a = out["a"]
    assert a["apart"] > chip_smoke.VLM_DECODE_RTOL * a["scale"]  # checked there too
    assert a["decode_gap"] < a["apart"]
    assert len(out["b"]["losses"]) == 2 and all(np.isfinite(out["b"]["losses"]))
    assert all(v == 0 for v in out["launches"].values())  # no kernel on the CPU
