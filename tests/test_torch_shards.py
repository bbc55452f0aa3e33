"""Training ingest, the port against the JAX reference: the byte-plane
codec, the tiered record shards and the prefetcher.

Everything here is exact: planes bit-equal for every dtype; the manifest
JSON and every ``shard_*.bin`` byte-equal from both writers; each
package's reader on the other's shards gives equal records, stored bytes,
``planned_bytes`` and ``state()`` at every quality; a reader state carried
across packages through JSON replays the same stream across an epoch
wrap; the prefetcher's batches and ``io_log``s equal the reference's, and
``train_ingest_bytes`` equals the reference's and the measured sum. Sizes
are reduced qwen3-1.7b's (vocab 512) at batch 2, seq 32, as
``BENCH_train.json``, and the full vocabulary (151,936, 3-byte ids).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.data import prefetch as jprefetch
from repro.data import shards as jshards
from repro.plan import PrecisionPlan as JPlan
from repro.roofline import analysis as janalysis
from repro.transport import CompressionPolicy as JPolicy
from repro.utils import planes as jplanes
from repro_torch.data import prefetch as tprefetch
from repro_torch.data import shards as tshards
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline import analysis as tanalysis
from repro_torch.transport import CompressionPolicy
from repro_torch.utils import planes as tplanes

B, S = 2, 32
VOCAB = 512  # reduced qwen3-1.7b
FULL_VOCAB = 151_936


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


# ---------------------------------------------------------------------------
# (1) the plane codec
# ---------------------------------------------------------------------------


def _array(dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (3, 37)
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.dtype(dtype).kind == "f":
        x = rng.normal(0, 1e3, shape).astype(dtype)
        x.flat[:4] = [0.0, -0.0, np.inf, -np.inf]
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32, np.int64, np.uint8,
                                   np.bool_], ids=lambda d: np.dtype(d).name)
def test_planes_bit_equal_reference(dtype):
    for seed in (0, 1):
        x = _array(dtype, seed)
        got, want = tplanes.plane_split(x), jplanes.plane_split(x)
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
        n = x.dtype.itemsize
        assert got.shape == (n, x.size)
        back = tplanes.plane_join(got, x.dtype, x.shape)
        assert back.tobytes() == x.tobytes()
        for k in range(n + 1):  # truncated reads zero-fill the dropped planes
            a = tplanes.plane_join(got[:k], x.dtype, x.shape)
            b = jplanes.plane_join(want[:k], x.dtype, x.shape)
            assert a.tobytes() == b.tobytes()
            assert np.array_equal(tplanes.plane_split(x, k), want[:k])  # the k kept planes
        # small non-negative ids: leading zero planes trimmed and restored
        small = np.random.default_rng(seed).integers(0, 200, x.shape).astype(x.dtype)
        planes = tplanes.plane_split(small)
        skip = tplanes.lead_zero_planes(planes)
        assert skip == jplanes.lead_zero_planes(jplanes.plane_split(small))
        rest = planes[skip:]
        a = tplanes.plane_join(rest, small.dtype, small.shape, lead_skip=skip)
        b = jplanes.plane_join(rest, small.dtype, small.shape, lead_skip=skip)
        assert a.tobytes() == b.tobytes() == small.tobytes()


# ---------------------------------------------------------------------------
# (2) shards
# ---------------------------------------------------------------------------


def _write(pkg, kind, d, **kw):
    if kind == "lm":
        return pkg.write_lm_shards(d, vocab=kw.get("vocab", VOCAB), seq=S, num_records=11,
                                   seed=kw.get("seed", 0), codec=kw.get("codec", "zlib"),
                                   records_per_shard=4)
    return pkg.write_feature_shards(d, dim=16, vocab=VOCAB, seq=8, num_records=7,
                                    seed=kw.get("seed", 0), codec=kw.get("codec", "zlib"),
                                    records_per_shard=3)


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    """Both packages' shards of each kind: {(kind, codec): (ref dir, port dir)}."""
    root = tmp_path_factory.mktemp("shards")
    out = {}
    for kind in ("lm", "feature"):
        for codec in ("zlib", "raw"):
            j, t = str(root / f"{kind}_{codec}_j"), str(root / f"{kind}_{codec}_t")
            mj = _write(jshards, kind, j, codec=codec, seed=3)
            mt = _write(tshards, kind, t, codec=codec, seed=3)
            out[(kind, codec)] = (j, t, mj, mt)
    return out


@pytest.mark.parametrize("codec", ["zlib", "raw"])
@pytest.mark.parametrize("kind", ["lm", "feature"])
def test_shards_byte_equal_reference(shard_dirs, kind, codec):
    j, t, mj, mt = shard_dirs[(kind, codec)]
    assert mt == mj
    fj, ft = _files(j), _files(t)
    assert sorted(ft) == sorted(fj) and len(fj) >= 3
    assert json.loads(ft["manifest.json"]) == json.loads(fj["manifest.json"])
    for name in fj:
        assert ft[name] == fj[name], name


def test_full_vocab_lm_shards_byte_equal_reference(tmp_path):
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    assert _write(tshards, "lm", t, vocab=FULL_VOCAB) == _write(jshards, "lm", j,
                                                                 vocab=FULL_VOCAB)
    assert _files(t) == _files(j)
    field = json.loads(_files(t)["manifest.json"])["shards"][0]["records"][0]["fields"]
    assert field["stream"]["lead_skip"] == 1  # 18-bit ids: three stored planes


def _same_record(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("quality", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["lm", "feature"])
def test_readers_cross_read(shard_dirs, kind, quality):
    """Each package's reader on the other's shards (and its own): equal
    records, stored bytes, planned bytes and state, over an epoch wrap."""
    j, t, *_ = shard_dirs[(kind, "zlib")]
    readers = [tshards.ShardReader(j, quality=quality, seed=5),
               jshards.ShardReader(t, quality=quality, seed=5),
               jshards.ShardReader(j, quality=quality, seed=5)]
    try:
        n = readers[0].num_records
        assert all(r.num_records == n for r in readers)
        for step in range(n + 3):
            planned = {r.planned_bytes(2 * n + 1) for r in readers}
            assert len(planned) == 1
            if step < n:
                assert len({r.record_stored_bytes(step) for r in readers}) == 1
            got = [r.next_record() for r in readers]
            for rec, nbytes in got[1:]:
                _same_record(rec, got[0][0])
                assert nbytes == got[0][1]
            assert readers[0].state() == readers[1].state() == readers[2].state()
        assert len({r.bytes_read for r in readers}) == 1
        if kind == "feature" and quality < 4:
            full = jshards.ShardReader(j, quality=4, seed=5)
            assert readers[0].planned_bytes(n) < full.planned_bytes(n)
            full.close()
    finally:
        for r in readers:
            r.close()


@pytest.mark.parametrize("seed", [0, -7, 2**40 + 3, -(2**62)])
def test_state_round_trip_replays_across_packages(shard_dirs, seed):
    """A reader state saved by one package as JSON and loaded by the other
    replays the same records, across an epoch wrap, at negative and large
    seeds; ``batches`` yields the same batches and states."""
    j, t, *_ = shard_dirs[("lm", "zlib")]
    src = tshards.ShardReader(t, seed=seed)
    for _ in range(9):
        src.next_record()
    state = json.loads(json.dumps(src.state()))
    dst = jshards.ShardReader(j, seed=0).load_state(state)
    back = tshards.ShardReader(t, seed=1).load_state(json.loads(json.dumps(dst.state())))
    try:
        for _ in range(src.num_records + 2):  # crosses the wrap to epoch 1
            a, b, c = src.next_record(), dst.next_record(), back.next_record()
            _same_record(a[0], b[0])
            _same_record(a[0], c[0])
        assert src.state() == dst.state() == back.state() and src.state()["epoch"] >= 1
        for (ba, na, sa), (bb, nb, sb) in zip(
                _take(tshards.batches(src, B), 3), _take(jshards.batches(dst, B), 3)):
            _same_record(ba, bb)
            assert (na, sa) == (nb, sb)
    finally:
        for r in (src, dst, back):
            r.close()


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_epoch_order_equal_reference():
    for seed, epoch in ((0, 0), (-1, 3), (2**63 - 1, 2), (-(2**63), 1)):
        assert np.array_equal(tshards._epoch_order(seed, epoch, 37),
                              jshards._epoch_order(seed, epoch, 37))


def test_write_cli_twin(tmp_path, capsys):
    from repro_torch.data import write as twrite

    out = twrite.main(["--kind", "feature", "--out", str(tmp_path / "f"), "--records", "5",
                       "--seq", "4", "--dim", "8", "--vocab", "32"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out and out["shards"] == 1 and out["records"] == 5
    j = str(tmp_path / "j")
    jshards.write_feature_shards(j, dim=8, vocab=32, seq=4, num_records=5)
    assert _files(str(tmp_path / "f")) == _files(j)


# ---------------------------------------------------------------------------
# (3) the prefetcher
# ---------------------------------------------------------------------------

# (host_device round_to, vocab): 2-byte ids, 3-byte ids at the full
# vocabulary, raw int32 under an uncompressed policy
PREFETCH_CASES = [(2, VOCAB), (2, FULL_VOCAB), (4, VOCAB), (1, FULL_VOCAB)]


@pytest.mark.parametrize("rt,vocab", PREFETCH_CASES)
def test_prefetcher_equals_reference(tmp_path, rt, vocab):
    d = str(tmp_path / "sh")
    tshards.write_lm_shards(d, vocab=vocab, seq=S, num_records=7)
    jplan = JPlan.build(3, round_to=2, schedule="static")
    tplan = PrecisionPlan.build(3, round_to=2, schedule="static")
    if rt != 2:
        import dataclasses
        jplan = dataclasses.replace(jplan, host_device=JPolicy(round_to=rt))
        tplan = dataclasses.replace(tplan, host_device=CompressionPolicy(round_to=rt))
    steps = 5  # 10 records of 7: an epoch wrap
    jr, tr = jshards.ShardReader(d, seed=2), tshards.ShardReader(d, seed=2)
    want = janalysis.train_ingest_bytes(jplan, vocab, kind="lm", batch=B, seq=S, steps=steps,
                                        reader=jr)
    got = tanalysis.train_ingest_bytes(tplan, vocab, kind="lm", batch=B, seq=S, steps=steps,
                                       reader=tr)
    assert got == want
    jp = jprefetch.Prefetcher(jshards.batches(jr, B), kind="lm", vocab=vocab, plan=jplan)
    tp = tprefetch.Prefetcher(tshards.batches(tr, B), kind="lm", vocab=vocab, plan=tplan,
                              depth=3, device="cpu")
    io = {"shard_read": 0, "host_device": 0}
    try:
        for _ in range(steps):
            (jb, jl), (tb, tl) = jp.next(), tp.next()
            assert tl == jl
            assert sorted(tb) == sorted(jb) == ["labels", "tokens"]
            for k in tb:
                assert tb[k].dtype == torch.int32 and tb[k].device.type == "cpu"
                assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
            io = {k: io[k] + tl[k] for k in io}
    finally:
        jp.close()
        tp.close()
        jr.close()
        tr.close()
    assert io == {"shard_read": got["shard_read"], "host_device": got["ingest_h2d"]}
    width = max(rt, 2 if vocab == VOCAB else 3) if rt < 4 else 4
    assert got["token_width"] == width and got["ingest_h2d"] == steps * B * (S + 1) * width


def test_feature_prefetch_and_ingest_model_equal_reference(tmp_path):
    d = str(tmp_path / "f")
    tshards.write_feature_shards(d, dim=16, vocab=VOCAB, seq=8, num_records=5)
    for q in (2, 4):
        jr, tr = jshards.ShardReader(d, quality=q), tshards.ShardReader(d, quality=q)
        want = janalysis.train_ingest_bytes(None, VOCAB, kind="feature", batch=B, seq=8,
                                            steps=4, dim=16, reader=jr)
        assert tanalysis.train_ingest_bytes(None, VOCAB, kind="feature", batch=B, seq=8,
                                            steps=4, dim=16, reader=tr) == want
        jp = jprefetch.Prefetcher(jshards.batches(jr, B), kind="feature", vocab=VOCAB)
        tp = tprefetch.Prefetcher(tshards.batches(tr, B), kind="feature", vocab=VOCAB,
                                  device="cpu")
        try:
            for _ in range(4):
                (jb, jl), (tb, tl) = jp.next(), tp.next()
                assert tl == jl
                assert tb["features"].dtype == torch.float32
                for k in tb:
                    assert np.asarray(jb[k]).tobytes() == tb[k].numpy().tobytes()
        finally:
            for x in (jp, tp, jr, tr):
                x.close()
    assert tprefetch.staged_ids_per_batch("feature", B, 8) == B * 8
    with pytest.raises(ValueError):
        tprefetch.staged_ids_per_batch("image", B, 8)


def test_prefetcher_surfaces_worker_errors():
    def broken():
        yield {"stream": np.zeros((B, S + 1), np.int32)}, 10, {"pos": 1}
        raise OSError("disk gone")

    p = tprefetch.Prefetcher(broken(), kind="lm", vocab=VOCAB, device="cpu")
    try:
        batch, log = p.next()
        assert log == {"shard_read": 10, "host_device": B * (S + 1) * 4, "data_state": {"pos": 1}}
        with pytest.raises(OSError, match="disk gone"):
            p.next()
    finally:
        p.close()
