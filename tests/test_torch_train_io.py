"""Training I/O, the port against the JAX reference: width-aware sharded
checkpoints (sync and async), the legacy ``.npz`` read, exact resume, and
the launchers' I/O flags. Reduced qwen3-1.7b (2 layers, vocab 512) at
batch 2, seq 32, as ``BENCH_train.json``.

What must hold, and how tightly:

* (4) the reference's state after three AWP steps (widened to 16 bits at
  step 3), carried across through numpy and saved by both packages, with
  residuals and without: every ``.bin`` byte-equal; ``meta.json`` equal as
  JSON except the AWP ``prev_norms``, which the port computes with its own
  ``l2norm_sq`` (rtol 1e-5; bits, counters, step and history exact); each
  package loads the other's bit-exactly at ``exact`` and ``wire`` quality;
  ``manifest_bytes`` equals ``train_checkpoint_bytes``, the file sizes and
  the reference's numbers, ``BENCH_train.json``'s 12,595,200 = 9,449,472 +
  3,145,728 among them;
* (5) a legacy ``.npz`` in the reference's ``a{i}`` / ``__meta__`` layout
  loads equally in both packages, and mismatched leaf counts raise
  ``CheckpointError`` in both;
* (6) the port's resume is bit-exact (losses, AWP history, final storage
  and momentum) on the static and AWP plans of ``scenario_train_io.py``;
* (7) the async snapshot survives an in-place optimizer step;
* (8) the launchers: ``launch.train``'s I/O flags resume bit-exactly and
  stay within ``test_torch_train_lm.py``'s ``RUN_RTOL`` of the reference
  launcher's losses, with the reference's ingest and wire lines;
  ``train_lm --ckpt`` writes what the reference reads; ``launch.serve
  --ckpt`` on a reference-written checkpoint streams the reference
  launcher's tokens.

Plus a CPU rehearsal of ``chip_smoke.py`` phase 17 at reduced width.
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

import repro.launch.serve as jserve_launch
import repro.launch.train as jlaunch
from repro.checkpoint import ckpt as jckpt
from repro.checkpoint import sharded as jsharded
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.data.pipeline import synthetic_lm_batch as j_batch
from repro.data.shards import write_lm_shards as j_write_lm_shards
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import dist_elems_per_group as j_dist_elems
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.models.init import init_params as j_init_params
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.roofline import analysis as janalysis
from repro.train.loop import Trainer as JTrainer
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.checkpoint import sharded as tsharded
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.core.awp import AWPController
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.shards import ShardReader, batches, write_lm_shards
from repro_torch.dist.spec import MeshCfg, build_spec_tree, dist_elems_per_group
from repro_torch.launch import serve as tserve_launch
from repro_torch.launch import train as tlaunch
from repro_torch.launch import train_lm
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline import analysis as tanalysis
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_train_step
from repro_torch.utils.trees import tree_leaves

B, S, LR = 2, 32, 0.05
NRT = 3  # reduced qwen3-1.7b: 2 layer groups + the top-level leaves
PREV_NORMS_RTOL = 1e-5
RUN_RTOL = 2e-5  # test_torch_train_lm.py's bar for the launchers' losses
BENCH = {"wire": 9_449_472, "residual": 3_145_728, "total": 12_595_200}
# scenario_train_io.py's AWP plan: every norm delta hits, widening every 2 steps
AWP_KW = dict(schedule="awp", awp_threshold=1e9, awp_interval=2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """``{key path: numpy copy}`` of a port tree (tensors) or a reference tree."""
    return {p: (x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x))
            for p, x in tsharded.leaf_entries(tree)}


def _bits_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def _port_trainer(cfg, spec_tree, plan, batch=B, seq=S):
    opt = SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4)
    mesh_cfg = MeshCfg()

    def builder(rts):
        return make_train_step(cfg, mesh_cfg, None, spec_tree, opt,
                               {"tokens": (batch, seq), "labels": (batch, seq)},
                               plan=plan.with_round_tos(rts))

    return Trainer(builder, NRT, plan=plan,
                   dist_elems_per_group=dist_elems_per_group(spec_tree, mesh_cfg, NRT))


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced qwen3-1.7b after three AWP steps (its own
    trainer), the port's controller after the same three steps from the
    same weights, and both packages' spec trees."""
    jcfg, tcfg = j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jspec = j_build_spec_tree(params, metas, JMesh())
    init = _np(params)
    jplan = JPlan.build(NRT, **AWP_KW)
    shapes = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    jtr = JTrainer(lambda rts: j_make_train_step(
        jcfg, JMesh(), None, jspec, JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes,
        plan=jplan.with_round_tos(rts)), NRT, plan=jplan,
        dist_elems_per_group=j_dist_elems(jspec, JMesh(), NRT))
    storage, mom = params, j_init_momentum(params)
    for step in range(3):
        t, lab = j_batch(jcfg.vocab_size, B, S, step)
        storage, mom, _ = jtr.run_step(storage, mom, {"tokens": t, "labels": lab}, LR)

    tplan = PrecisionPlan.build(NRT, **AWP_KW)
    _, tmetas = init_params(tcfg, device="meta")
    tstorage = convert_lm_params(tcfg, init, device="cpu")
    tspec = build_spec_tree(tstorage, tmetas, MeshCfg())
    ttr = _port_trainer(tcfg, tspec, tplan)
    tmom = init_momentum(tstorage)
    from repro_torch.data.pipeline import synthetic_lm_batch

    for step in range(3):
        t, lab = synthetic_lm_batch(tcfg.vocab_size, B, S, step, device="cpu")
        tstorage, tmom, _ = ttr.run_step(tstorage, tmom, {"tokens": t, "labels": lab}, LR)
    assert ttr.controller.history == jtr.controller.history == [(0, (8, 8, 8)),
                                                                 (3, (16, 16, 16))]
    return dict(jcfg=jcfg, tcfg=tcfg, init=init, jspec=jspec, tspec=tspec, jplan=jplan,
                tplan=tplan, jstorage=_np(storage), jmom=_np(mom), jctl=jtr.controller,
                tctl=ttr.controller, rts=jtr.current_round_tos())


def _port_tree(r, tree):
    """A reference-layout numpy tree as port tensors on the CPU."""
    return convert_lm_params(r["tcfg"], tree, device="cpu")


# ---------------------------------------------------------------------------
# (4) the sharded format across packages
# ---------------------------------------------------------------------------


def _dir_files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("residuals", [True, False], ids=["residuals", "wire-only"])
def test_sharded_checkpoint_byte_equal_and_cross_loads(ref, tmp_path, residuals):
    r = ref
    assert r["rts"] == (2, 2, 2)
    extra = {"data_state": {"seed": 0, "epoch": 1, "pos": 3, "quality": 4}}
    jdir, tdir = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jmeta = jsharded.save_sharded(jdir, r["jstorage"], r["jmom"], r["jctl"], 3, plan=r["jplan"],
                                  spec_tree=r["jspec"], round_tos=r["rts"], extra=extra,
                                  residuals=residuals)
    tstorage, tmom = _port_tree(r, r["jstorage"]), _port_tree(r, r["jmom"])
    tmeta = tsharded.save_sharded(tdir, tstorage, tmom, r["tctl"], 3, plan=r["tplan"],
                                  spec_tree=r["tspec"], round_tos=r["rts"], extra=extra,
                                  residuals=residuals)
    fj, ft = _dir_files(jdir), _dir_files(tdir)
    assert sorted(ft) == sorted(fj)
    tiered = sum(e["tiered"] for e in tmeta["trees"]["storage"])
    assert tiered > 0 and sum(f.endswith(".r.bin") for f in ft) == tiered * residuals
    for name in fj:
        if name != "meta.json":
            assert ft[name] == fj[name], name
    mj, mt = json.loads(fj["meta.json"]), json.loads(ft["meta.json"])
    assert mt == tmeta and mj == json.loads(json.dumps(jmeta))
    pj, pt = mj["awp"].pop("prev_norms"), mt["awp"].pop("prev_norms")
    np.testing.assert_allclose(pt, pj, rtol=PREV_NORMS_RTOL)
    assert mt == mj

    # bytes: manifest == analytic (both packages) == file sizes == BENCH_train.json
    mb = tsharded.manifest_bytes(tmeta)
    on_disk = sum(os.path.getsize(os.path.join(tdir, f)) for f in ft if f.endswith(".bin"))
    analytic = tanalysis.train_checkpoint_bytes(tstorage, tmom, spec_tree=r["tspec"],
                                                round_tos=r["rts"], residuals=residuals)
    want = janalysis.train_checkpoint_bytes(r["jstorage"], r["jmom"], spec_tree=r["jspec"],
                                            round_tos=r["rts"], residuals=residuals)
    assert mb == analytic == want == jsharded.manifest_bytes(jmeta)
    assert mb["total"] == on_disk
    if residuals:
        assert mb == BENCH
    else:
        assert mb == {"wire": BENCH["wire"], "residual": 0, "total": BENCH["wire"]}

    # each package reads the other's, at every quality the save allows
    for quality in (("exact", "wire") if residuals else ("wire",)):
        js, jm, jstep, _ = jsharded.load_sharded(tdir, r["jstorage"], r["jmom"],
                                                 quality=quality)
        like_s, like_m = _port_tree(r, r["init"]), init_momentum(_port_tree(r, r["init"]))
        ctl = AWPController(NRT)
        ts, tm, tstep, _ = tsharded.load_sharded(jdir, like_s, like_m, ctl, quality=quality)
        assert jstep == tstep == 3
        assert ctl.history == r["jctl"].history
        assert np.array_equal(ctl.state.prev_norms, r["jctl"].state.prev_norms)
        _bits_equal(ts, js)
        _bits_equal(tm, jm)
        for x in tree_leaves(ts) + tree_leaves(tm):
            assert x.is_contiguous() and x.dtype == torch.float32
        if quality == "exact":
            _bits_equal(ts, r["jstorage"])
        else:  # the transport's truncation: tiered leaves keep their top 2 bytes
            want = _flat(r["jstorage"])
            for e in tmeta["trees"]["storage"]:
                if e["tiered"]:
                    want[e["path"]] = (want[e["path"]].view(np.uint32)
                                       & np.uint32(0xFFFF0000)).view(np.float32)
            for k, x in _flat(ts).items():
                assert x.tobytes() == want[k].tobytes(), k
    if not residuals:
        with pytest.raises(tsharded.CheckpointError, match="residual tier"):
            tsharded.load_sharded(jdir, _port_tree(r, r["init"]), quality="exact")


def test_bench_train_bytes_reproduced(ref, tmp_path):
    """``BENCH_train.json``'s ingest bytes: 7 steps of batch 2 from 14
    records at round_to 2 read 134 B a step (floor) and stage 132."""
    d = str(tmp_path / "sh")
    write_lm_shards(d, vocab=512, seq=S, num_records=14)
    plan = PrecisionPlan.build(NRT, round_to=2, schedule="static")
    reader = ShardReader(d, seed=0)
    analytic = tanalysis.train_ingest_bytes(plan, 512, kind="lm", batch=B, seq=S, steps=7,
                                            reader=reader)
    pf = Prefetcher(batches(reader, B), kind="lm", vocab=512, plan=plan, device="cpu")
    logs = [pf.next()[1] for _ in range(7)]
    pf.close()
    reader.close()
    read, h2d = sum(x["shard_read"] for x in logs), sum(x["host_device"] for x in logs)
    assert (read, h2d) == (analytic["shard_read"], analytic["ingest_h2d"])
    assert (read // 7, h2d // 7, analytic["token_width"]) == (134, 132, 2)
    storage = _port_tree(ref, ref["init"])
    assert tanalysis.train_checkpoint_bytes(storage, init_momentum(storage),
                                            spec_tree=ref["tspec"], round_tos=(2, 2, 2)) == BENCH


def test_structure_mismatch_raises_in_both(ref, tmp_path):
    r = ref
    d = str(tmp_path / "c.ckpt")
    tsharded.save_sharded(d, _port_tree(r, r["jstorage"]), None, None, 3)
    short = dict(_port_tree(r, r["init"]))
    del short["final_norm"]
    with pytest.raises(tsharded.CheckpointError, match="first unmatched"):
        tsharded.load_sharded(d, short)
    jshort = dict(r["jstorage"])
    del jshort["final_norm"]
    with pytest.raises(jsharded.CheckpointError, match="first unmatched"):
        jsharded.load_sharded(d, jshort)
    bad = _port_tree(r, r["init"])
    bad["head"] = bad["head"][:, :8]
    with pytest.raises(tsharded.CheckpointError, match="shape mismatch at storage/head"):
        tsharded.load_sharded(d, bad)


# ---------------------------------------------------------------------------
# (5) the legacy .npz
# ---------------------------------------------------------------------------


def test_legacy_npz_loads_equally(ref, tmp_path):
    r = ref
    flat = jax.tree_util.tree_leaves((r["jstorage"], r["jmom"]))
    meta = {"num_arrays": len(flat), "step": 3, "awp": jsharded.awp_to_meta(r["jctl"]),
            "plan": r["jplan"].to_json_dict()}
    path = str(tmp_path / "old.npz")
    np.savez(path, __meta__=json.dumps(meta), **{f"a{i}": x for i, x in enumerate(flat)})
    js, jm, jstep = jckpt.load_checkpoint(path, r["jstorage"], r["jmom"])
    like = _port_tree(r, r["init"])
    ctl = AWPController(NRT)
    ts, tm, tstep = tckpt.load_checkpoint(path, like, init_momentum(like), ctl)
    assert jstep == tstep == 3 and ctl.history == r["jctl"].history
    _bits_equal(ts, js)
    _bits_equal(tm, jm)
    ws, wstep = tckpt.load_storage(path, like)
    _bits_equal(ws, jckpt.load_storage(path, r["jstorage"])[0])
    assert wstep == 3 and tckpt.load_extra(path) == {}
    assert tckpt.load_plan(path).to_json_dict() == jckpt.load_plan(path).to_json_dict()
    # a target with one leaf fewer: both raise
    short = {k: v for k, v in like.items() if k != "final_norm"}
    jshort = {k: v for k, v in r["jstorage"].items() if k != "final_norm"}
    with pytest.raises(tckpt.CheckpointError, match="leaves"):
        tckpt.load_checkpoint(path, short, init_momentum(short))
    with pytest.raises(jckpt.CheckpointError, match="leaves"):
        jckpt.load_checkpoint(path, jshort, j_init_momentum(jshort))
    flat_t = tsharded.leaf_entries((like, init_momentum(like)))
    assert [p for p, _ in flat_t] == [jax.tree_util.keystr(p, simple=True, separator="/")
                                      for p, _ in jax.tree_util.tree_leaves_with_path(
                                          (r["jstorage"], r["jmom"]))]


# ---------------------------------------------------------------------------
# (6) the port's resume, bit-exact (scenario_train_io.py's two plans)
# ---------------------------------------------------------------------------

R_STEPS, R_HALF, R_SEQ = 6, 3, 16


def _port_run(trainer, storage, mom, shard_dir, plan, steps, data_state=None):
    reader = ShardReader(shard_dir, seed=0)
    if data_state is not None:
        reader.load_state(data_state)
    pf = Prefetcher(batches(reader, B), kind="lm", vocab=512, plan=plan, device="cpu")
    losses, state, io_sum = [], None, {"shard_read": 0, "host_device": 0}
    try:
        for _ in range(steps):
            batch, log = pf.next()
            storage, mom, m = trainer.run_step(storage, mom, batch, LR, io_log=log)
            losses.append(float(m["loss"]))
            state = log["data_state"]
            io_sum = {k: io_sum[k] + log[k] for k in io_sum}
    finally:
        pf.close()
        reader.close()
    return storage, mom, losses, state, io_sum


@pytest.mark.parametrize("plan_kw", [dict(round_to=2, schedule="static"), AWP_KW],
                         ids=["static", "awp"])
def test_port_resume_bit_exact(ref, tmp_path, plan_kw):
    cfg = ref["tcfg"]
    plan = PrecisionPlan.build(NRT, **plan_kw)
    shard_dir = str(tmp_path / "sh")
    write_lm_shards(shard_dir, vocab=cfg.vocab_size, seq=R_SEQ, num_records=8)
    rd = ShardReader(shard_dir, seed=0)
    ingest = tanalysis.train_ingest_bytes(plan, cfg.vocab_size, kind="lm", batch=B, seq=R_SEQ,
                                          steps=R_STEPS, reader=rd)
    rd.close()

    def trainer():
        return _port_trainer(cfg, ref["tspec"], plan, seq=R_SEQ)

    full = trainer()
    s0 = _port_tree(ref, ref["init"])
    s_full, m_full, losses_full, _, io = _port_run(full, s0, init_momentum(s0), shard_dir, plan,
                                                   R_STEPS)
    assert io == {"shard_read": ingest["shard_read"], "host_device": ingest["ingest_h2d"]}
    assert full.summary()["io_by_entry"] == io

    half = trainer()
    s1 = _port_tree(ref, ref["init"])
    s_half, m_half, losses_a, state, _ = _port_run(half, s1, init_momentum(s1), shard_dir,
                                                   plan, R_HALF)
    ck = str(tmp_path / "ck")
    ac = tckpt.AsyncCheckpointer()
    rts = half.current_round_tos()
    tckpt.save_checkpoint(ck, s_half, m_half, half.controller, R_HALF, plan=plan,
                          spec_tree=ref["tspec"], round_tos=rts, extra={"data_state": state},
                          async_ckpt=ac)
    ac.wait()
    meta = tsharded.read_meta(tckpt.ckpt_dir(ck))
    d = tckpt.ckpt_dir(ck)
    mb = tsharded.manifest_bytes(meta)
    assert mb == tanalysis.train_checkpoint_bytes(s_half, m_half, spec_tree=ref["tspec"],
                                                  round_tos=rts)
    assert mb["total"] == sum(os.path.getsize(os.path.join(d, f))
                              for f in os.listdir(d) if f.endswith(".bin"))
    widths = {e["width"] for e in meta["trees"]["storage"] if e["tiered"]}
    assert widths and widths <= set(rts)

    resumed = trainer()
    like = _port_tree(ref, ref["init"])
    s_r, m_r, step = tckpt.load_checkpoint(ck, like, init_momentum(like), resumed.controller)
    assert step == R_HALF
    s_res, m_res, losses_b, _, _ = _port_run(resumed, s_r, m_r, shard_dir, plan,
                                             R_STEPS - R_HALF,
                                             data_state=tckpt.load_extra(ck)["data_state"])
    assert losses_a + losses_b == losses_full
    _bits_equal(s_res, s_full)
    _bits_equal(m_res, m_full)
    assert resumed.controller.history == full.controller.history
    if plan_kw is AWP_KW:
        assert len(full.controller.history) == 3  # widened before and after the save


# ---------------------------------------------------------------------------
# (7) the async snapshot and in-place steps
# ---------------------------------------------------------------------------


def test_async_snapshot_survives_in_place_step(ref, tmp_path, monkeypatch):
    """Submit, step (in place, on the CPU, where ``Tensor.numpy()`` shares
    memory), wait, load: the checkpoint holds the state at submit. The
    writer is held back until the step has run."""
    import threading

    cfg, plan = ref["tcfg"], PrecisionPlan.build(NRT, round_to=2, schedule="static")
    tr = _port_trainer(cfg, ref["tspec"], plan)
    storage = _port_tree(ref, ref["jstorage"])
    mom = _port_tree(ref, ref["jmom"])
    at_submit = (_flat(storage), _flat(mom))
    stepped = threading.Event()
    save = tsharded.save_sharded

    def held_save(*a, **kw):
        stepped.wait(timeout=30)
        return save(*a, **kw)

    monkeypatch.setattr(tsharded, "save_sharded", held_save)
    ac = tsharded.AsyncCheckpointer()
    tckpt.save_checkpoint(str(tmp_path / "a"), storage, mom, tr.controller, 3, plan=plan,
                          spec_tree=ref["tspec"], round_tos=(2, 2, 2), async_ckpt=ac)
    assert ac.in_flight
    from repro_torch.data.pipeline import synthetic_lm_batch

    t, lab = synthetic_lm_batch(cfg.vocab_size, B, S, 3, device="cpu")
    storage, mom, _ = tr.run_step(storage, mom, {"tokens": t, "labels": lab}, LR)
    stepped.set()
    ac.wait()
    assert not ac.in_flight and ac.saves == 1
    assert any(not np.array_equal(a, _flat(storage)[k]) for k, a in at_submit[0].items())
    like = _port_tree(ref, ref["init"])
    ls, lm, _ = tckpt.load_checkpoint(str(tmp_path / "a"), like, init_momentum(like))
    for got, want in ((_flat(ls), at_submit[0]), (_flat(lm), at_submit[1])):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    # a failing write surfaces as CheckpointError on wait()
    monkeypatch.setattr(tsharded, "save_sharded",
                        lambda *a, **kw: (_ for _ in ()).throw(OSError("disk full")))
    ac.save(str(tmp_path / "b"), storage, mom, None, 4)
    with pytest.raises(tsharded.CheckpointError, match="disk full"):
        ac.wait()


# ---------------------------------------------------------------------------
# (8) the launchers
# ---------------------------------------------------------------------------

PLAN_JSON = {"version": 1, "weights": [{"round_to": 4}], "host_device": {"round_to": 2},
             "schedule": {"source": "awp", "awp_threshold": 1e9, "awp_interval": 2}}


def _launch_lines(text):
    keep = ("wire by plan entry", "ingest bytes", "AWP:")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def test_train_launcher_io_flags(ref, tmp_path, capsys):
    r = ref
    shards = str(tmp_path / "sh")
    write_lm_shards(shards, vocab=512, seq=S, num_records=9)
    plan = str(tmp_path / "plan.json")
    with open(plan, "w") as f:
        json.dump(PLAN_JSON, f)
    common = ["--arch", "qwen3-1.7b", "--reduced", "--batch", str(B), "--seq", str(S),
              "--plan", plan, "--data-dir", shards, "--data-quality", "4",
              "--prefetch-depth", "3"]
    full = str(tmp_path / "full.json")
    argv = sys.argv
    sys.argv = ["repro.launch.train", *common, "--steps", "6", "--ckpt",
                str(tmp_path / "jck"), "--losses-out", full]
    try:
        jlaunch.main()
    finally:
        sys.argv = argv
    jout = capsys.readouterr().out
    with open(full) as f:
        jlosses = json.load(f)["losses"]

    params = _port_tree(r, r["init"])
    mine = str(tmp_path / "mine.json")
    s = tlaunch.main([*common, "--steps", "6", "--ckpt", str(tmp_path / "tck"), "--ckpt-every",
                      "3", "--async-ckpt", "--losses-out", mine, "--device", "cpu"],
                     params=params)
    tout = capsys.readouterr().out
    assert _launch_lines(tout) == _launch_lines(jout)
    assert "[OK]" in tout and "host_device" in tout and "(plan + data state persisted)" in tout
    np.testing.assert_allclose(s["losses"], jlosses, rtol=RUN_RTOL)
    assert s["io"][0] == {"shard_read": s["io"][0]["shard_read"], "host_device": B * (S + 1) * 2}

    # interrupted at 3 with an async save, resumed to 6: bit-exact
    tlaunch.main([*common, "--steps", "3", "--ckpt", str(tmp_path / "half"), "--async-ckpt",
                  "--device", "cpu"], params=_port_tree(r, r["init"]))
    capsys.readouterr()
    s2 = tlaunch.main([*common, "--steps", "6", "--ckpt", str(tmp_path / "half"), "--resume",
                       "--check", mine, "--device", "cpu"], params=_port_tree(r, r["init"]))
    out = capsys.readouterr().out
    assert "resumed" in out and "--check OK" in out
    assert s2["start_step"] == 3 and s2["losses"] == s["losses"][3:]
    assert s2["bits_history"] == s["bits_history"]
    # the reference reads the port's final checkpoint, and the other way round
    jmeta = jsharded.read_meta(str(tmp_path / "tck.ckpt"))
    assert jmeta["step"] == 6 and jmeta["extra"]["data_state"]["pos"] == 12 - 9
    js, _, jstep = jckpt.load_checkpoint(str(tmp_path / "tck"), r["jstorage"], r["jmom"])
    ts, _, _ = tckpt.load_checkpoint(str(tmp_path / "half"), params, init_momentum(params))
    _bits_equal(ts, js)
    jm = jsharded.read_meta(str(tmp_path / "jck.ckpt"))
    assert jm["extra"] == jmeta["extra"] and jm["awp"]["history"] == jmeta["awp"]["history"]


def test_train_launcher_mesh_io_raises_item_9b(tmp_path, capsys):
    """Raised on a mesh until ROADMAP item 9b; now the launchers' I/O runs on
    two data ranks: shards in, an async checkpoint out that the reference
    loads into its own 2x1 storage, and ``launch.serve --ckpt`` at 2x1
    serving it (its engine equal to its static run). The parity of the
    mesh's checkpoints and resumes is ``test_torch_mesh_io.py``'s."""
    shards, ck = str(tmp_path / "sh"), str(tmp_path / "ck")
    write_lm_shards(shards, vocab=512, seq=S, num_records=8)
    mesh = ["--arch", "qwen3-1.7b", "--reduced", "--mesh", "2x1", "--device", "cpu"]
    tlaunch.main([*mesh, "--batch", "2", "--seq", str(S), "--steps", "2", "--data-dir", shards,
                  "--ckpt", ck, "--async-ckpt"])
    assert "[OK]" in capsys.readouterr().out
    jcfg = j_reduced(j_get_config("qwen3-1.7b"))
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jmesh = JMesh(dp=2)
    like = j_tree_to_storage(params, j_build_spec_tree(params, metas, jmesh), jmesh)
    _, _, step = jckpt.load_checkpoint(ck, like, j_init_momentum(like))
    assert step == 2 and jckpt.load_extra(ck)["data_state"]
    tserve_launch.main([*mesh, "--prompt-lens", "8,6", "--gen", "3", "--ckpt", ck,
                        "--check-static"])
    out = capsys.readouterr().out
    assert f"restored weights from {ck} (train step 2" in out
    assert "check-static: 2 streams equal to the static reference" in out


def test_train_lm_ckpt_reads_in_the_reference(tmp_path, capsys):
    path = str(tmp_path / "lm.npz")
    s = train_lm.main(["--preset", "cpu-demo", "--steps", "2", "--device", "cpu", "--ckpt",
                       path])
    assert f"checkpoint -> {path}" in capsys.readouterr().out
    cfg, mesh_cfg, *_ = train_lm.build_preset("cpu-demo")
    jcfg = j_reduced(j_get_config("qwen3-1.7b"), layers=4)
    params, _ = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    params = _np(params)
    js, jm, step = jckpt.load_checkpoint(path, params, j_init_momentum(params))
    assert step == 2 and os.path.isdir(str(tmp_path / "lm.ckpt"))
    assert (jckpt.load_plan(path).to_json_dict()
            == train_lm.build_plan("awp", cfg.num_groups + 1).to_json_dict())
    like = convert_lm_params(cfg, params, device="cpu")
    ctl = AWPController(cfg.num_groups + 1)
    ts, tm, _ = tckpt.load_checkpoint(path, like, init_momentum(like), ctl)
    _bits_equal(ts, js)
    _bits_equal(tm, jm)
    assert ctl.history == s["bits_history"]


def test_serve_ckpt_streams_the_reference_launchers(ref, tmp_path, capsys):
    r = ref
    path = str(tmp_path / "served")
    jckpt.save_checkpoint(path, r["jstorage"], r["jmom"], r["jctl"], 3,
                          plan=JPlan.build(NRT, round_to=2), spec_tree=r["jspec"],
                          round_tos=r["rts"])
    flags = ["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "16,12,8", "--gen", "4",
             "--max-slots", "2", "--ckpt", path]
    argv = sys.argv
    sys.argv = ["repro.launch.serve", *flags]
    try:
        jserve_launch.main()
    finally:
        sys.argv = argv
    jout = capsys.readouterr().out
    want = {int(m.group(1)): json.loads(m.group(2))
            for m in re.finditer(r"^  req(\d+): (\[.*\])$", jout, re.M)}
    results = tserve_launch.main([*flags, "--check-static", "--device", "cpu"])
    tout = capsys.readouterr().out
    assert "restored weights from" in tout and "plan rts (2, 2, 2)" in tout
    assert len(want) == 3
    assert {rid: list(res.tokens) for rid, res in results.items()} == want


# ---------------------------------------------------------------------------
# chip_smoke.py phase 17, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_io_phase_rehearses_on_cpu(capsys):
    """``chip_smoke.py`` phase 17 on the CPU at reduced qwen3-1.7b (plain
    versions; launch counts and times are read on a card only): shards
    through the prefetcher, six steps uninterrupted against three + async
    save + three resumed, bit-equal, and the wire-tier hand-off served."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), remat=True)
    out = chip_smoke.io_path(torch, torch.device("cpu"), cfg=cfg, batch=B, seq=S,
                             prompt_len=16, gen=4, min_free=0)
    assert out["ckpt_rts"] == (2, 2, 2) and out["ckpt_bytes"] == BENCH["total"]
    assert out["export_bytes"] == BENCH["wire"] - 4 * out["n_params"]
    text = capsys.readouterr().out
    assert "bit-equal to (b)" in text and "hand-off" in text and "raw int32" in text
