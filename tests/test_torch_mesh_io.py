"""Training I/O across ranks, the port against the JAX reference: the
storage layout read backwards, checkpoints written and read on an FSDP×TP
mesh, exact resume on the mesh, shard ingest across data ranks, and the
launchers' I/O flags on a mesh.

Reduced qwen3-1.7b (2 layers, d 256, vocab 512). The port's meshes run as
gloo ranks (``spawn_ranks``, one CPU thread each); the reference runs in
one subprocess of this file (``python tests/test_torch_mesh_io.py INPUTS
OUT``) with 4 emulated host devices. Its donated train steps fail at dp 2
under jax 0.9.0 (ROADMAP "Reference caveats"), so its state is built
without its launcher: the port's 2×2 ranks train three AWP steps (widened
to 16 bits at step 3), and the reference assembles its sharded arrays from
the ranks' blocks with its own partition specs
(``jax.make_array_from_single_device_arrays``), independently of the
port's :func:`storage_to_global`.

Exact, byte for byte and bit for bit:

* :func:`storage_to_global` of every rank's :func:`local_shard` of the
  reference's ``tree_to_storage`` is that array, and each rank's block of
  a logical leaf is the reference's block, at 2×2 and at ``8dev``'s 4×2;
* the port's 2×2 checkpoint directory (manifest, every ``.bin``,
  ``meta.json``) equals the reference's ``save_sharded`` of the same
  global state at the same mesh; each package loads the other's, and the
  port a legacy ``.npz`` of that state across ranks; the
  manifest bytes equal ``train_checkpoint_bytes`` at the mesh and the
  files' sizes; the gathers are logged under ``checkpoint`` and nothing
  else;
* a one-device checkpoint loaded at 2×2 raises the reference's
  ``CheckpointError`` message on every rank;
* ``launch.train --mesh 2x2 --data-dir`` resumed from a sync or an async
  checkpoint gives the uninterrupted run's losses, AWP history and final
  checkpoint bytes;
* at 2×1 each rank's rows of a shard batch are the reference prefetcher's
  batch sliced as its step slices it, and every rank's ingest bytes equal
  ``train_ingest_bytes`` of the global batch;
* ``train_lm --preset 8dev --ckpt`` writes what the reference loads at its
  mesh, and ``launch.serve --ckpt`` at 1×2 streams the reference
  launcher's ``--static`` tokens at 2 emulated devices.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.data.prefetch import Prefetcher as JPrefetcher
from repro.data.shards import ShardReader as JShardReader
from repro.data.shards import batches as j_batches
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.dist.spec import tree_to_storage as j_tree_to_storage
from repro.models.init import init_params as j_init_params
from repro.optim.sgd import init_momentum as j_init_momentum
from repro_torch.checkpoint import sharded as tsharded
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.data.shards import write_lm_shards
from repro_torch.dist.spec import (
    MeshCfg, build_spec_tree, leaf_to_local, local_shard, storage_to_global,
)
from repro_torch.models.init import init_params

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
B, S = 4, 32
AWP = ["--awp-interval", "2", "--awp-threshold", "1e9"]  # widens every 2 steps
MESHES = {"2x2": dict(tp=2, dp=2), "4x2": dict(tp=2, dp=4, compress_min_size=4096)}
STATE_STEPS = 3
EXTRA = {"data_state": {"pos": 12, "epoch": 0}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))


def _files(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


# ---------------------------------------------------------------------------
# the layout read backwards (in this process: the reference's layout needs
# no devices)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
def test_storage_to_global_inverts_the_reference_layout(mesh):
    jcfg, tcfg = _cfgs()
    kw = MESHES[mesh]
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=kw["tp"])
    jmesh = JMesh(**kw)
    jstorage = j_tree_to_storage(params, j_build_spec_tree(params, metas, jmesh), jmesh)
    tparams = convert_lm_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu",
                                tp=kw["tp"])
    _, tmetas = init_params(tcfg, device="meta", tp=kw["tp"])
    mcfg = MeshCfg(**kw)
    spec = build_spec_tree(tparams, tmetas, mcfg)
    world = mcfg.dshards * mcfg.tp
    want = dict(tsharded.leaf_entries(jax.tree_util.tree_map(np.asarray, jstorage)))
    specs = dict(tsharded.leaf_entries(spec))
    logical = dict(tsharded.leaf_entries(tparams))
    kinds = set()
    for path, g in want.items():
        s = specs[path]
        kinds.add(s.kind)
        blocks = [local_shard(torch.from_numpy(g.copy()), s, mcfg, r) for r in range(world)]
        back = storage_to_global(blocks, s, mcfg).numpy()
        assert back.shape == g.shape and back.tobytes() == g.tobytes(), path
        assert storage_to_global([b.numpy() for b in blocks], s, mcfg).tobytes() == g.tobytes()
        for r in range(world):
            mine = leaf_to_local(logical[path], s, mcfg, r)
            assert mine.numpy().tobytes() == blocks[r].numpy().tobytes(), (path, r)
    assert kinds == {"dist", "repl", "tp_small"} or kinds == {"dist", "repl"}


# ---------------------------------------------------------------------------
# the reference (a subprocess of this file, 4 emulated host devices)
# ---------------------------------------------------------------------------


def _reference(inputs_path, out_path):
    from jax.sharding import NamedSharding

    import repro.launch.serve as jserve
    from repro.checkpoint import sharded as jsharded
    from repro.dist.spec import LeafSpec, leaf_partition_spec
    from repro.launch.mesh import make_mesh_from_cfg
    from repro.plan import PrecisionPlan as JPlan

    with open(inputs_path) as f:
        inp = json.load(f)
    blocks = dict(np.load(inp["blocks"]))
    res = {}
    jcfg, _ = _cfgs()
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=2)
    mcfg = JMesh(tp=2, dp=2)
    mesh = make_mesh_from_cfg(mcfg)
    spec = j_build_spec_tree(params, metas, mcfg)
    like = j_tree_to_storage(params, spec, mcfg)
    devs = list(mesh.devices.flat)  # rank r = device r in mesh order

    def assemble(tree_name):
        def leaf(path_parts, x, s):
            path = "/".join(path_parts)
            sharding = NamedSharding(mesh, leaf_partition_spec(s, mcfg))
            arrs = [jax.device_put(blocks[f"{tree_name}/{r}/{path}"], d)
                    for r, d in enumerate(devs)]
            return jax.make_array_from_single_device_arrays(x.shape, sharding, arrs)

        flat = jax.tree_util.tree_flatten_with_path(like)[0]
        specs = jax.tree_util.tree_leaves(spec, is_leaf=lambda v: isinstance(v, LeafSpec))
        leaves = [leaf([str(getattr(k, "key", getattr(k, "idx", k))) for k in kp], x, s)
                  for (kp, x), s in zip(flat, specs)]
        return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)

    storage, mom = assemble("storage"), assemble("opt")
    meta = inp["meta"]
    # the same global state as a legacy .npz (one array a leaf, flatten order)
    flat = [np.asarray(x) for x in jax.tree_util.tree_leaves((storage, mom))]
    np.savez(inp["legacy"], __meta__=json.dumps({"num_arrays": len(flat), "step": meta["step"],
                                                  "awp": meta["awp"], "plan": meta["plan"]}),
             **{f"a{i}": x for i, x in enumerate(flat)})
    plan = JPlan.from_json_dict(meta["plan"])
    jsharded.save_sharded(inp["ref_dir"], storage, mom, meta["awp"], meta["step"], plan=plan,
                          spec_tree=spec, round_tos=inp["round_tos"], extra=meta["extra"])
    # the port's directory in the reference, bit for bit
    ls, lm, step, _ = jsharded.load_sharded(inp["port_dir"], like, j_init_momentum(like))
    ok = step == meta["step"]
    for got, want in ((ls, storage), (lm, mom)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            ok = ok and np.asarray(a).tobytes() == np.asarray(b).tobytes()
    res["loads_port"] = ok
    # a one-device directory at this mesh
    try:
        jsharded.load_sharded(inp["one_dir"], like, j_init_momentum(like))
        res["one_error"] = ""
    except jsharded.CheckpointError as e:
        res["one_error"] = str(e)
    # train_lm's 8dev directory at its mesh
    mcfg8 = JMesh(tp=2, dp=4, compress_min_size=4096)
    cfg8 = j_reduced(j_get_config("qwen3-1.7b"), layers=4)
    p8, m8 = j_init_params(cfg8, jax.random.PRNGKey(0), tp=2)
    like8 = j_tree_to_storage(p8, j_build_spec_tree(p8, m8, mcfg8), mcfg8)
    _, _, step8 = jckpt.load_checkpoint(inp["lm_ckpt"], like8, j_init_momentum(like8))
    res["lm_step"] = step8
    # the reference launcher's static streams from the served checkpoint at 1x2
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["serve", "--arch", "qwen3-1.7b", "--reduced", "--mesh", "1x2", "--ckpt",
                inp["serve_ckpt"], *inp["serve_argv"], "--static"]
    try:
        with contextlib.redirect_stdout(buf):
            jserve.main()
    finally:
        sys.argv = argv
    res["serve"] = buf.getvalue()
    with open(out_path, "w") as f:
        json.dump(res, f)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def _train_args(*argv):
    from repro_torch.launch import train as tl

    return tl.build_parser().parse_args(["--arch", "qwen3-1.7b", "--reduced", "--batch",
                                         str(B), "--seq", str(S), *AWP, "--device", "cpu",
                                         *argv])


def _state_rank(rank, tmp, shards):
    """Rank ``rank`` of 2×2: three AWP steps from seed 0, a sync
    checkpoint (its blocks, manifest and logged bytes returned); then the
    launcher's uninterrupted and interrupted runs (sync and async) off the
    shards, and the 2×1 ingest."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.checkpoint.sharded import global_like
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist import comm
    from repro_torch.dist.spec import dist_elems_per_group
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import train_checkpoint_bytes
    from repro_torch.train.loop import Trainer
    from repro_torch.train.step import make_train_step

    _, cfg = _cfgs()
    mcfg = MeshCfg(tp=2, dp=2)
    mesh = make_mesh_from_cfg(mcfg)
    spec, storage, mom = tl.setup(cfg, mcfg, device=torch.device("cpu"), rank=rank)
    plan = PrecisionPlan.build(3, schedule="awp", awp_threshold=1e9, awp_interval=2)
    opt = SGDConfig(lr=0.05, momentum=0.9, weight_decay=1e-4)

    def builder(rts):
        return make_train_step(cfg, mcfg, mesh, spec, opt, {"tokens": (B, S), "labels": (B, S)},
                               plan=plan.with_round_tos(rts))

    trainer = Trainer(builder, 3, plan=plan, dist_elems_per_group=dist_elems_per_group(
        spec, mcfg, 3), gather_axis_size=2)
    for step in range(STATE_STEPS):
        t, lab = synthetic_lm_batch(cfg.vocab_size, B, S, step, device="cpu")
        storage, mom, _ = trainer.run_step(storage, mom, {"tokens": t, "labels": lab}, 0.05)
    rts = trainer.current_round_tos()
    first = len(comm.LOG)
    meta = save_checkpoint(os.path.join(tmp, "port"), storage, mom, trainer.controller,
                           STATE_STEPS, plan=plan, spec_tree=spec, round_tos=rts, extra=EXTRA,
                           mesh_cfg=mcfg)
    logged = {(r.kind, r.traffic) for r in comm.LOG[first:]}
    out = {
        "meta": meta, "round_tos": list(rts), "logged": sorted(logged),
        "analytic": train_checkpoint_bytes(global_like(storage, spec, mcfg),
                                           global_like(mom, spec, mcfg), spec_tree=spec,
                                           round_tos=rts),
        "blocks": {f"{name}/{rank}/{p}": x.numpy().copy()
                   for name, tree in (("storage", storage), ("opt", mom))
                   for p, x in tsharded.leaf_entries(tree)},
    }
    # the launcher: uninterrupted, then interrupted at step 2 (sync, async)
    data = ["--mesh", "2x2", "--data-dir", shards]
    full = os.path.join(tmp, "full")
    out["full"] = tl._train(rank, _train_args(*data, "--steps", "4", "--ckpt", full))
    for mode in ("sync", "async"):
        half = os.path.join(tmp, mode)
        flags = ["--async-ckpt"] if mode == "async" else []
        tl._train(rank, _train_args(*data, "--steps", "2", "--ckpt", half, *flags))
        out[mode] = tl._train(rank, _train_args(*data, "--steps", "4", "--ckpt", half,
                                                "--resume"))
    return out


def _ingest_rank(rank, shards):
    """Rank ``rank`` of 2×1: the rows the step takes of two shard batches,
    and the launcher's ingest check."""
    from repro_torch.data.prefetch import Prefetcher
    from repro_torch.data.shards import ShardReader, batches
    from repro_torch.launch import train as tl
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import train_ingest_bytes
    from repro_torch.train.step import _rank_rows

    reader = ShardReader(shards, seed=0)
    plan = PrecisionPlan.build(3)
    pf = Prefetcher(batches(reader, B), kind="lm", vocab=512, plan=plan, depth=2,
                    device=torch.device("cpu"))
    rows, logs = [], []
    for _ in range(2):
        batch, log = pf.next()
        rows.append({k: _rank_rows(v, None, 2).numpy().copy() for k, v in batch.items()})
        logs.append(log)
    pf.close()
    reader.close()
    run = tl._train(rank, _train_args("--mesh", "2x1", "--data-dir", shards, "--steps", "2"))
    analytic = train_ingest_bytes(plan, 512, kind="lm", batch=B, seq=S, steps=2,
                                  reader=ShardReader(shards, seed=0))
    return {"rows": rows, "states": [log["data_state"] for log in logs],
            "io": [r["io"] for r in run["records"]], "notes": run["notes"],
            "analytic": analytic}


def _load_rank(rank, tmp):
    """Rank ``rank`` of 2×2: the reference's directory and a one-device one
    loaded into fresh blocks."""
    from repro_torch.checkpoint.ckpt import load_checkpoint, load_storage
    from repro_torch.checkpoint.sharded import CheckpointError
    from repro_torch.launch import train as tl
    from repro_torch.launch.mesh import make_mesh_from_cfg

    _, cfg = _cfgs()
    mcfg = MeshCfg(tp=2, dp=2)
    make_mesh_from_cfg(mcfg)
    from repro_torch.optim.sgd import init_momentum

    spec, storage = tl.setup_storage(cfg, mcfg, device=torch.device("cpu"), rank=rank, seed=5)
    mom = init_momentum(storage)
    st, mo, step = load_checkpoint(os.path.join(tmp, "ref"), storage, mom, spec_tree=spec,
                                   mesh_cfg=mcfg)
    out = {"step": step, "blocks": {f"{name}/{rank}/{p}": x.numpy().copy()
                                    for name, tree in (("storage", st), ("opt", mo))
                                    for p, x in tsharded.leaf_entries(tree)}}
    st, mo, lstep = load_checkpoint(os.path.join(tmp, "legacy.npz"), storage, mom,
                                    spec_tree=spec, mesh_cfg=mcfg)
    ws, _ = load_storage(os.path.join(tmp, "legacy.npz"), storage, spec_tree=spec, mesh_cfg=mcfg)
    out["legacy"] = {f"{name}/{rank}/{p}": x.numpy().copy()
                     for name, tree in (("storage", st), ("opt", mo), ("weights", ws))
                     for p, x in tsharded.leaf_entries(tree)}
    out["legacy_step"] = lstep
    try:
        load_checkpoint(os.path.join(tmp, "one"), storage, mom, spec_tree=spec, mesh_cfg=mcfg)
        out["one_error"] = ""
    except CheckpointError as e:
        out["one_error"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port run and the reference's, in the order they need each
    other: the state ranks and the one-device, train_lm and 1×2 training
    checkpoints, then the reference subprocess beside the 2×1 ingest
    ranks, then the ranks loading the reference's directory."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.launch import train as tl
    from repro_torch.launch import train_lm
    from repro_torch.launch.mesh import spawn_ranks

    tmp = str(tmp_path_factory.mktemp("mesh_io"))
    shards = os.path.join(tmp, "shards")
    write_lm_shards(shards, vocab=512, seq=S, num_records=24)
    state = spawn_ranks(_state_rank, 4, tmp, shards)
    _, cfg = _cfgs()
    _, one, one_mom = tl.setup(cfg, MeshCfg(), device=torch.device("cpu"))
    save_checkpoint(os.path.join(tmp, "one"), one, one_mom, None, 0)
    lm_ckpt = os.path.join(tmp, "lm.npz")
    with contextlib.redirect_stdout(io.StringIO()) as lm_out:
        train_lm.main(["--preset", "8dev", "--steps", "1", "--device", "cpu", "--ckpt",
                       lm_ckpt])
    serve_ckpt = os.path.join(tmp, "serve")
    tl.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh", "1x2", "--steps", "1", "--batch",
             "2", "--seq", "16", "--device", "cpu", "--ckpt", serve_ckpt])
    blocks = os.path.join(tmp, "blocks.npz")
    merged = {}
    for r in state:
        merged.update(r["blocks"])
    np.savez(blocks, **merged)
    inp = {"blocks": blocks, "meta": state[0]["meta"], "round_tos": state[0]["round_tos"],
           "ref_dir": os.path.join(tmp, "ref.ckpt"), "port_dir": os.path.join(tmp, "port.ckpt"),
           "one_dir": os.path.join(tmp, "one.ckpt"), "lm_ckpt": lm_ckpt,
           "serve_ckpt": serve_ckpt, "serve_argv": SERVE_ARGV,
           "legacy": os.path.join(tmp, "legacy.npz")}
    with open(os.path.join(tmp, "inputs.json"), "w") as f:
        json.dump(inp, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = os.path.join(tmp, "ref.json")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             os.path.join(tmp, "inputs.json"), out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ingest = spawn_ranks(_ingest_rank, 2, shards)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    with open(out) as f:
        ref = json.load(f)
    loaded = spawn_ranks(_load_rank, 4, tmp)
    return {"tmp": tmp, "state": state, "ref": ref, "ingest": ingest, "loaded": loaded,
            "lm_out": lm_out.getvalue(), "shards": shards, "serve_ckpt": serve_ckpt}


def test_checkpoint_at_2x2_byte_equal_reference(runs):
    """The port's 2×2 directory is the reference's ``save_sharded`` of the
    same global state at the same mesh, file for file; its bytes are the
    analytic model's and the files'; the gathers are logged as
    ``checkpoint`` only; every rank got the same manifest."""
    tmp, state = runs["tmp"], runs["state"]
    port, ref = _files(os.path.join(tmp, "port.ckpt")), _files(os.path.join(tmp, "ref.ckpt"))
    assert sorted(port) == sorted(ref) and len(port) > 20
    for name in port:
        assert port[name] == ref[name], name
    meta = state[0]["meta"]
    assert all(r["meta"] == meta for r in state)
    assert meta["step"] == STATE_STEPS and meta["extra"] == EXTRA
    assert state[0]["round_tos"] == [2, 2, 2]  # tiered at the widened width
    got = tsharded.manifest_bytes(meta)
    sizes = sum(len(v) for k, v in port.items() if k.endswith(".bin"))
    assert got["total"] == sizes
    assert {k: state[0]["analytic"][k] for k in got} == got
    assert all(r["logged"] == [["gather", "checkpoint"]] or
               r["logged"] == [("gather", "checkpoint")] for r in state)


def test_each_package_loads_the_others_2x2_directory(runs):
    """Each package's 2×2 directory in the other, bit for bit; the same
    global state as a legacy ``.npz`` (written by the reference) loads
    across ranks too, whole and weights only."""
    ref, loaded, state = runs["ref"], runs["loaded"], runs["state"]
    assert ref["loads_port"] is True
    for r, got in enumerate(loaded):
        assert got["step"] == got["legacy_step"] == STATE_STEPS
        for k, v in got["blocks"].items():
            assert v.tobytes() == state[r]["blocks"][k].tobytes(), k
        for k, v in got["legacy"].items():
            want = state[r]["blocks"][k.replace("weights/", "storage/", 1)]
            assert v.tobytes() == want.tobytes(), k


def test_load_at_another_mesh_raises_as_the_reference(runs):
    msg = runs["ref"]["one_error"]
    assert "checkpoint shape mismatch at storage/" in msg
    assert [got["one_error"] for got in runs["loaded"]] == [msg] * 4


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resume_at_2x2_is_bit_exact(runs, mode):
    """Two steps, a checkpoint (sync or async, with the plan and the data
    state), then a resumed launcher to step 4: the uninterrupted run's
    losses, AWP history and final checkpoint, byte for byte."""
    tmp = runs["tmp"]
    for r in runs["state"]:
        full, resumed = r["full"], r[mode]
        assert resumed["start_step"] == 2
        assert [x["loss"] for x in resumed["records"]] == [x["loss"] for x in
                                                          full["records"]][2:]
        assert resumed["summary"]["bits_history"] == full["summary"]["bits_history"]
        assert "[OK]" in resumed["notes"]["ingest"]
    a, b = _files(os.path.join(tmp, "full.ckpt")), _files(os.path.join(tmp, f"{mode}.ckpt"))
    assert sorted(a) == sorted(b)
    for name in a:
        if name != "meta.json":
            assert a[name] == b[name], name
    ma, mb = json.loads(a["meta.json"]), json.loads(b["meta.json"])
    assert ma == mb and ma["extra"]["data_state"]


def test_shard_rows_and_ingest_across_data_ranks(runs):
    """At 2×1 every rank reads the global batch: its rows are the
    reference prefetcher's batch sliced as the reference's step slices it
    (``P(dp)``), its data state is the same on both ranks, and its ingest
    bytes equal ``train_ingest_bytes`` of the global batch."""
    reader = JShardReader(runs["shards"], seed=0)
    pf = JPrefetcher(j_batches(reader, B), kind="lm", vocab=512, depth=2)
    want = [pf.next() for _ in range(2)]
    pf.close()
    reader.close()
    ingest = runs["ingest"]
    for r, got in enumerate(ingest):
        for (batch, log), rows, state in zip(want, got["rows"], got["states"]):
            for k, v in rows.items():
                np.testing.assert_array_equal(v, np.asarray(batch[k])[r * B // 2:(r + 1) * B // 2])
            assert state == log["data_state"]
        measured = {"shard_read": sum(x.get("shard_read", 0) for x in got["io"]),
                    "ingest_h2d": sum(x.get("host_device", 0) for x in got["io"])}
        assert measured == {k: got["analytic"][k] for k in measured}
    assert "[OK]" in ingest[0]["notes"]["ingest"]


def test_train_lm_ckpt_at_8dev(runs):
    """``train_lm --preset 8dev --ckpt`` writes the 4×2 mesh's global state,
    which the reference loads into its own 8dev storage."""
    assert runs["ref"]["lm_step"] == 1
    assert "checkpoint -> " in runs["lm_out"] and "no checkpoint" not in runs["lm_out"]


SERVE_ARGV = ["--requests", "2", "--prompt-len", "8", "--gen", "4"]


def test_serve_launcher_ckpt_at_1x2(runs, capsys):
    """``launch.serve --ckpt`` at 1×2: rank 0 reads the 1×2 training
    checkpoint and scatters it; the streams equal the reference launcher's
    static run of the same checkpoint at 2 devices, and the engine's equal
    its static run."""
    from repro_torch.launch import serve as tserve

    tserve.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh", "1x2", "--ckpt",
                 runs["serve_ckpt"], *SERVE_ARGV, "--check-static", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored weights from" in out and "check-static: 2 streams equal" in out
    streams = re.findall(r"^  req(\d+): (\[.*\])$", out, re.M)
    assert streams and streams == re.findall(r"^  req(\d+): (\[.*\])$", runs["ref"]["serve"],
                                             re.M)


def test_chip_smoke_mesh_phase_rehearses_on_cpu(capsys):
    """``chip_smoke.py`` phase 18 (a) on the CPU at reduced qwen3-1.7b
    (plain versions; launch counts and times are read on a card only):
    2×2 training off shards with an export and an async checkpoint across
    ranks, a load equal to the state at submit, the export served at 2×2
    and step 3 resumed bit-equal. Its (b) and (c) run in phase 23's rank
    pair on the returned ``"bc_args"``, rehearsed in
    ``tests/test_torch_fleet_mesh.py``."""
    import dataclasses

    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.launch.serve import build_requests

    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), remat=True)
    requests = build_requests((32, 32, 24, 16, 12), 4, cfg.vocab_size)
    out = chip_smoke.mesh_path(torch, torch.device("cpu"), cfg=cfg, batch=B, seq=S, gen=4,
                               window=16, min_free=0, requests=requests)
    assert out["launches"] == dict.fromkeys(out["launches"], 0)  # plain versions here
    assert out["bc_args"] == chip_smoke.mesh_bc_args(cfg, requests, gen=4, window=16)
    text = capsys.readouterr().out
    assert "== train_checkpoint_bytes == the files' sizes" in text
    assert "equal to the state at submit on every rank" in text
    assert "== the weights truncated in memory" in text


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
