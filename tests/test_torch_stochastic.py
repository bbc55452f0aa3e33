"""Stochastic rounding: the port against the JAX reference, bit for bit.

``repro_torch.random.split`` and ``randint`` against ``jax.random`` (jax
0.9.0, the partitionable threefry) over seeds, spans and shapes; the noise
of element ``i`` depends on its flat index alone, so padding does not move
it; ``randint``'s shortcut (for a power-of-two span jax's multiplier is 0
and the result is ``lower % span``) is shown to be jax's formula. The
stochastic planes of ``bitpack_ref``, the transport's quantize and the
reference's padded ``ops.bitpack`` are equal byte for byte. One train step
of reduced qwen3-1.7b at 4 layers (2 groups of 2) with stochastic weights,
``scan_layers`` on and off and ``remat`` on and off, from the same weights
and batch as the reference's ``make_train_step(..., key)``: every
materialization gets the key of the reference's fold index (the
reference's own ``fold_in`` calls, recorded while it traces), the
recomputed layers of ``remat`` the same keys again, and the loss and
update are within the train-step bars of ``tests/test_torch_train_lm.py``
(rtol 1e-6; one ulp of the leaf's largest weight plus 1e-8). The CNN's
stochastic case of ``scenario_plan.py::run_cnn_stochastic_vs_nearest``
runs on the port (4 gloo ranks, the scenario's own bars). The 2×2 mesh
with stochastic weights and gradients is in ``tests/test_torch_tp.py``,
two data-parallel ranks with stochastic gradients in
``tests/test_torch_dist.py``, the one-device CNN in
``tests/test_torch_cnn.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.data.pipeline import synthetic_lm_batch as j_batch
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.init import init_params as j_init_params
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.train import step as jstep
from repro.transport import CompressionPolicy as JPolicy
from repro.transport import transport as jT
from repro_torch import random as tr
from repro_torch.configs.registry import get_config, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree
from repro_torch.kernels import ref as tref
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.train import step as tstep
from repro_torch.transport import CompressionPolicy
from repro_torch.transport import transport as tT

SEEDS = [0, 7, 2**31 - 1, -5]
SPANS = [1 << 8, 1 << 16, 1 << 24]  # the noise spans of round_to 3, 2, 1
LR, B, S = 0.05, 4, 32
LOSS_RTOL, UPDATE_ATOL = 1e-6, 1e-8


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    assert [_key(k) for k in jax.random.split(jk)] == tr.split(tk)
    assert [_key(k) for k in jax.random.split(jk, 5)] == tr.split(tk, 5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("span", SPANS + [3, 1000, 2**31 - 1])
@pytest.mark.parametrize("shape", [(), (7,), (5, 129)])
def test_randint_matches_jax(seed, span, shape):
    """uint32 ``randint`` on ``[lo, lo + span)``, including spans whose
    multiplier is not 0 (3, 1000, 2**31 - 1: both draws are used)."""
    jk, tk = jax.random.fold_in(jax.random.PRNGKey(seed), 3), tr.fold_in(tr.PRNGKey(seed), 3)
    lo = 5 if span < 2**31 - 5 else 0
    want = np.asarray(jax.random.randint(jk, shape, lo, lo + span, dtype=jnp.uint32))
    np.testing.assert_array_equal(tr.randint(tk, shape, lo, lo + span).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("span", SPANS)
def test_randint_shortcut_is_jax_formula(span):
    """jax returns ``((higher % span) * m + lower % span) % span`` with ``m
    = (2**16 % span)**2 % span`` in uint32; for these spans ``m`` is 0, so
    the port draws only ``lower`` (under ``split(key)[1]``)."""
    assert ((2**16 % span) ** 2 % 2**32) % span == 0
    tk = tr.fold_in(tr.PRNGKey(11), 2)
    k_hi, k_lo = tr.split(tk)
    higher, lower = tr.bits(k_hi, (300,)), tr.bits(k_lo, (300,))
    full = (((higher % span) * 0 + lower % span) & 0xFFFFFFFF) % span
    np.testing.assert_array_equal(tr.randint(tk, (300,), 0, span).numpy(), full.numpy())
    want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(11), 2), (300,), 0, span,
                              dtype=jnp.uint32)
    np.testing.assert_array_equal(full.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("span", SPANS)
def test_noise_does_not_depend_on_padding(span):
    """Element ``i``'s noise is the hash of its flat index: a tensor padded
    to the reference kernels' (rows, 128) tiles draws the same noise for
    its first ``n`` elements as the unpadded one."""
    tk = tr.PRNGKey(3)
    n, padded = 1000, 8 * 128
    a = tr.randint(tk, (n,), 0, span)
    b = tr.randint(tk, (padded // 128, 128), 0, span).reshape(-1)[:n]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jax.random.randint(jax.random.PRNGKey(3), (padded // 128, 128), 0, span,
                              dtype=jnp.uint32)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want).reshape(-1)[:n].astype(np.int64))


def test_noise_at_given_indices():
    """``index`` draws each element at the flat index it holds (a
    transposed weight draws what the reference's layout draws)."""
    tk = tr.PRNGKey(9)
    full = tr.randint(tk, (6, 10), 0, 1 << 16)
    idx = torch.arange(60).reshape(6, 10).t().contiguous()
    np.testing.assert_array_equal(tr.randint(tk, (10, 6), 0, 1 << 16, index=idx).numpy(),
                                  full.t().numpy())


# ---------------------------------------------------------------------------
# the planes
# ---------------------------------------------------------------------------


def _words(seed, n=3000):
    """Unit normals and the words where saturation and special values
    live: 0, -0, the largest finite, inf, NaN, and all-ones words."""
    w = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    special = np.array([0x00000000, 0x80000000, 0x7F7FFFFF, 0x7F800000, 0x7FC00000,
                        0xFFFFFFFF, 0x7FFFFFFF, 0xFFFF0000, 0x00FFFFFF], np.uint32)
    return np.concatenate([w, special.view(np.float32)])


@pytest.mark.parametrize("round_to", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_stochastic_bitpack_byte_equal(round_to, seed):
    w = _words(seed)
    jk, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    want = jref.bitpack_ref(jnp.asarray(w), round_to, mode="stochastic", key=jk)
    got = tref.bitpack_ref(torch.from_numpy(w), round_to, mode="stochastic", key=tk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the reference's shape-agnostic wrapper pads to (rows, 128) tiles first
    padded = jops.bitpack(jnp.asarray(w), round_to, mode="stochastic", key=jk)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(padded).reshape(round_to, -1)[:, :w.size])


@pytest.mark.parametrize("round_to", [1, 2, 3])
def test_stochastic_quantize_matches_reference(round_to):
    w = _words(5).reshape(-1, 3)
    jk, tk = jax.random.PRNGKey(8), tr.PRNGKey(8)
    want = jT.quantize(jnp.asarray(w), JPolicy(round_to=round_to, mode="stochastic"), jk)
    got = tT.quantize(torch.from_numpy(w), CompressionPolicy(round_to=round_to,
                                                            mode="stochastic"), tk)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_stochastic_rounding_needs_a_key():
    with pytest.raises(ValueError, match="key"):
        tT.quantize(torch.ones(4), CompressionPolicy(round_to=2, mode="stochastic"))


# ---------------------------------------------------------------------------
# the train step: fold order under scan_layers and remat
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduced(j_get_config("qwen3-1.7b"), layers=4)
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    return params, metas, jax.tree_util.tree_map(np.asarray, params)


def _paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


PLAN_KW = dict(round_to=2, mode="stochastic", grad_round_to=2, grad_mode="stochastic")


@pytest.mark.parametrize("scan,remat", [(False, False), (True, False), (True, True),
                                        (False, True)],
                         ids=["unrolled", "scan", "scan-remat", "remat"])
def test_stochastic_step_matches_reference_in_fold_order(weights, monkeypatch, scan, remat):
    """One step at 4 layers in 2 groups (2 repetitions a group): the
    reference's trace folds one index a materialized leaf (norms too),
    embedding first, then the groups' leaves in jax's order, the final
    norm and the head; under ``scan_layers``, and under ``remat`` too
    (``jax.checkpoint`` traces a group's layer body once for all its
    repetitions), a group's repetitions share their indices. The port's
    materializations get exactly those keys; under ``remat`` the
    recomputed layers get the same keys again."""
    params, metas, np_params = weights
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen3-1.7b"), layers=4),
                               scan_layers=scan, remat=remat)
    tcfg = dataclasses.replace(reduced(get_config("qwen3-1.7b"), layers=4),
                               scan_layers=scan, remat=remat)
    nrt = jcfg.num_groups + 1
    jmesh = JMesh(tp=1, dp=1)
    jspec = j_build_spec_tree(params, metas, jmesh)
    tparams = convert_lm_params(tcfg, np_params, device="cpu")
    _, tmetas = init_params(tcfg, device="meta")
    tspec = build_spec_tree(tparams, tmetas, MeshCfg())

    # the reference's trace: (leaf shape, fold index) in call order
    jcalls, folds = [], []
    real_fold, real_mat = jax.random.fold_in, jstep.materialize_leaf
    monkeypatch.setattr(jax.random, "fold_in",
                        lambda k, d: folds.append(int(d)) or real_fold(k, d))
    monkeypatch.setattr(jstep, "materialize_leaf", lambda x, s, m, p, key=None: (
        jcalls.append((tuple(x.shape), folds[-1] if key is not None else None))
        or real_mat(x, s, m, p, key=key)))
    shapes = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    jfn = jstep.make_train_step(jcfg, jmesh, None, jspec,
                                JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes,
                                plan=JPlan.build(nrt, **PLAN_KW))
    tokens, labels = j_batch(jcfg.vocab_size, B, S, 0)
    storage = jax.tree_util.tree_map(jnp.copy, params)
    jnew, _, jm = jfn(storage, j_init_momentum(storage), {"tokens": tokens, "labels": labels},
                      LR, jax.random.PRNGKey(3))
    monkeypatch.undo()
    shared = scan or remat
    n_group = sum(len(jax.tree_util.tree_leaves(g)) * (1 if shared else 2)
                  for g in params["groups"])
    assert len(jcalls) == 3 + n_group  # 11 leaves a layer, the top-level three
    assert [f for _, f in jcalls] == list(range(len(jcalls)))

    tcalls = []
    real_tmat = tstep.materialize_leaf
    monkeypatch.setattr(tstep, "materialize_leaf", lambda x, s, m, p, key=None, group=None: (
        tcalls.append((tuple(x.shape), key)) or real_tmat(x, s, m, p, key=key, group=group)))
    fn = tstep.make_train_step(tcfg, MeshCfg(), None, tspec,
                               SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4),
                               {"tokens": (B, S), "labels": (B, S)},
                               plan=PrecisionPlan.build(nrt, **PLAN_KW))
    tb = {"tokens": torch.from_numpy(np.array(tokens)), "labels": torch.from_numpy(np.array(labels))}
    tnew, _, tm = fn(tparams, init_momentum(tparams), tb, LR, tr.PRNGKey(3))
    monkeypatch.undo()

    k0 = tr.PRNGKey(3)
    want = []  # the reference's calls, a scanned group's once per repetition
    groups = [c for c in jcalls[1:-2]]
    per_group = [groups[:len(groups) // 2], groups[len(groups) // 2:]]
    want.append(jcalls[0])
    for g in per_group:
        want += g * 2 if shared else g
    want += jcalls[-2:]
    forward = [(shape, tr.fold_in(k0, f)) for shape, f in want]
    # the top-level sites in order; a layer's leaves are visited in the
    # port's dict order, so each layer is held as a multiset of (shape,
    # key): a key swapped between two leaves of one shape would move the
    # loss far past its bar below
    n = len(forward)
    assert tcalls[0] == forward[0] and tcalls[n - 2:n] == forward[-2:]
    layer = len(jax.tree_util.tree_leaves(params["groups"][0])) // 2
    for i in range(1, n - 2, layer):
        assert sorted(tcalls[i:i + layer]) == sorted(forward[i:i + layer]), i
    recomputed = tcalls[n:]
    if remat:  # every group leaf again, with its forward key
        assert sorted(recomputed) == sorted(forward[1:-2])
    else:
        assert not recomputed

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    old, jp, tp = _paths(np_params), _paths(jnew), _paths(tnew)
    for k in jp:
        atol = UPDATE_ATOL + float(np.spacing(np.abs(old[k]).max()))
        np.testing.assert_allclose(tp[k] - old[k], jp[k] - old[k], rtol=0, atol=atol,
                                   err_msg=k)


def test_top_level_materializations_are_the_reference_planes(weights):
    """The embedding and a group's leaves, materialized eagerly through
    both packages' ``make_mat_fns`` with the same key: the same bits (the
    planes are the reference's, not only the loss)."""
    params, metas, np_params = weights
    jcfg = j_reduced(j_get_config("qwen3-1.7b"), layers=4)
    tcfg = reduced(get_config("qwen3-1.7b"), layers=4)
    nrt = jcfg.num_groups + 1
    jspec = j_build_spec_tree(params, metas, JMesh(tp=1, dp=1))
    tparams = convert_lm_params(tcfg, np_params, device="cpu")
    _, tmetas = init_params(tcfg, device="meta")
    tspec = build_spec_tree(tparams, tmetas, MeshCfg())
    jg, jt = jstep.make_mat_fns(jspec, JMesh(tp=1, dp=1),
                                JPlan.build(nrt, **PLAN_KW).weight_policies(),
                                rng=jax.random.PRNGKey(4))
    tg, tt = tstep.make_mat_fns(tspec, MeshCfg(), PrecisionPlan.build(nrt, **PLAN_KW)
                                .weight_policies(), rng=tr.PRNGKey(4), cfg=tcfg)
    a, b = np.asarray(jt(params)("embed")), tt(tparams)("embed").numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    rep0 = jax.tree_util.tree_map(lambda x: x[0], params["groups"][0]["p0"])
    jw = jg(0, "p0", rep0)
    tw = tg(0, "p0", jax.tree_util.tree_map(lambda x: x[0], tparams["groups"][0]["p0"]),
            rep=0)
    for (p, x), (_, y) in zip(jax.tree_util.tree_leaves_with_path(jw),
                              jax.tree_util.tree_leaves_with_path(tw)):
        np.testing.assert_array_equal(np.asarray(x).view(np.uint32), y.numpy().view(np.uint32),
                                      jax.tree_util.keystr(p))


# ---------------------------------------------------------------------------
# the CNN case of scenario_plan.py
# ---------------------------------------------------------------------------


def _cnn_rank(rank, grad_mode, steps):
    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import tree_to_local
    from repro_torch.launch.mesh import make_mesh_from_cfg
    from repro_torch.models.cnn import ALEXNET, init_cnn, reduced_cnn
    from repro_torch.train import cnn_step as cs

    cfg = reduced_cnn(ALEXNET, num_classes=10, in_hw=32)
    data = SyntheticImageNet(num_classes=10, hw=32, noise=0.1, device="cpu")
    mcfg = MeshCfg(tp=1, dp=4, compress_min_size=256)
    mesh = make_mesh_from_cfg(mcfg)
    params, metas, gi = init_cnn(cfg, 0, device="cpu")
    spec = cs.build_cnn_spec_tree(params, metas, mcfg)
    st = tree_to_local(cs.cnn_to_storage(params, spec, mcfg), spec, mcfg, rank)
    plan = PrecisionPlan.build(gi[1], round_to=2, grad_round_to=2, grad_mode=grad_mode)
    step = cs.make_cnn_train_step(cfg, mcfg, spec, gi,
                                  SGDConfig(lr=0.05, momentum=0.9, weight_decay=5e-4),
                                  plan=plan, mesh=mesh)
    mom, losses = init_momentum(st), []
    for i in range(steps):
        imgs, labels = data.batch(64, i)
        st, mom, m = step(st, mom, {"images": imgs, "labels": labels}, 0.05, tr.PRNGKey(i))
        losses.append(float(m["loss"]))
    ev = cs.make_cnn_eval(cfg, mcfg, spec, gi, plan=plan, mesh=mesh)
    imgs, labels = data.validation(128)
    return losses, float(ev(st, imgs, labels))


def test_cnn_stochastic_vs_nearest_trains():
    """``scenario_plan.py::run_cnn_stochastic_vs_nearest`` on the port:
    reduced AlexNet on 4 data-parallel gloo ranks, 20 steps at batch 64
    with bf16 gradients rounded nearest and stochastically. Its bars: both
    losses fall, the final losses within 0.2 + 0.1 |nearest|, the top-5
    errors within 0.25."""
    from repro_torch.launch.mesh import spawn_ranks

    ln, en = spawn_ranks(_cnn_rank, 4, "nearest", 20)[0]
    ls, es = spawn_ranks(_cnn_rank, 4, "stochastic", 20)[0]
    assert np.isfinite(ln).all() and np.isfinite(ls).all()
    assert ln[-1] < ln[0] and ls[-1] < ls[0], (ln, ls)
    assert abs(ls[-1] - ln[-1]) < 0.2 + 0.1 * abs(ln[-1]), (ln[-1], ls[-1])
    assert abs(es - en) < 0.25, (en, es)
