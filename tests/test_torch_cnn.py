"""CNN A²DTWP slice: port vs the JAX reference from the same weights.

Both packages start from the same weights: numpy draws at
``repro.models.cnn.init_cnn``'s shapes and scales, carried across by
``repro_torch.convert``. They see the same numpy-seeded batches and the
same dropout keys, and run their ``impl="auto"`` transport, which is the
plain byte-plane path on the CPU.

Tolerances: forward logits rtol 1e-4 / atol 1e-5 (fp32 convolutions sum
in another order in XLA and oneDNN; atol 5e-5 for ResNet, see the test);
per-step loss rtol 2e-4 and ``group_norms_sq`` rtol 1e-4 over five SGD
steps at lr 0.005. Formats, byte counts and AWP histories must be exactly
equal. The AWP threshold (1.0) is far from every observed norm delta, so
a last-bit difference cannot flip a widening.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticImageNet as JData
from repro.dist.spec import DIST as JDIST
from repro.dist.spec import MeshCfg as JMesh
from repro.models import cnn as jc
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.train import cnn_step as jstep
from repro.train.loop import Trainer as JTrainer
from repro_torch import random as tr
from repro_torch.convert import convert_cnn_params
from repro_torch.data.pipeline import SyntheticImageNet
from repro_torch.dist.spec import DIST, MeshCfg
from repro_torch.models import cnn as tc
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.train import cnn_step as tstep
from repro_torch.train.loop import Trainer

NETS = {"alexnet": (jc.ALEXNET, tc.ALEXNET), "vgg": (jc.VGG_A, tc.VGG_A),
        "resnet": (jc.RESNET34, tc.RESNET34)}
MIN_SIZE = 256  # the mini-nets compress everything >= 1 KiB (as the example)


def tree_asdict(metas):
    return {n: {k: dataclasses.asdict(m) for k, m in l.items()}
            for n, l in metas["layers"].items()}


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several workers on shared cores: keep this file's
    small convolutions from claiming all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(net, num_classes=10, in_hw=32):
    jfull, tfull = NETS[net]
    return (jc.reduced_cnn(jfull, num_classes, in_hw),
            tc.reduced_cnn(tfull, num_classes, in_hw))


def _jax_shapes(cfg):
    """``jc.init_cnn``'s param shapes (``jax.eval_shape``: no draw runs),
    metas and group map."""
    box = {}

    def init(k):
        p, box["metas"], box["groups"] = jc.init_cnn(cfg, k)
        return p

    params = jax.eval_shape(init, jax.random.PRNGKey(0))
    return params, box["metas"], box["groups"]


@functools.lru_cache(maxsize=None)
def _reference_weights(jcfg, seed=0):
    """Reference-layout weights at ``jc.init_cnn``'s shapes and scales,
    drawn with numpy: weights N(0, std) with init_cnn's std (0.1 with the
    paper init, He otherwise), biases and norm parameters at its
    constants."""
    shapes, metas, gi = _jax_shapes(jcfg)
    rng = np.random.default_rng(seed)
    const = {"b": 0.1 if jcfg.name.startswith("alexnet") else 0.0,
             "bn_scale": 1.0, "bn_bias": 0.0}

    def draw(k, s):
        if k != "w":
            return np.full(s.shape, const[k], np.float32)
        std = 0.1 if jcfg.paper_init else np.sqrt(2.0 / np.prod(s.shape[:-1]))
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    layers = {n: {k: draw(k, s) for k, s in l.items()}
              for n, l in shapes["layers"].items()}
    return {"layers": layers}, metas, gi


def _weights(jcfg, tcfg, device="cpu"):
    """Fresh copies of the cached reference weights for both packages
    (the JAX step donates its storage; the port updates in place)."""
    as_np, metas, gi = _reference_weights(jcfg)
    params = jax.tree_util.tree_map(jnp.array, as_np)
    return params, metas, gi, convert_cnn_params(tcfg, as_np, device=device)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("train", [False, True])
def test_forward_logits_match(net, train):
    # ResNet normalizes every conv with batch statistics over 4 samples
    # (1x1 spatial in the last stage), which amplifies the summation-order
    # difference of the convolutions to ~2e-5 absolute on logits of ~5
    atol = 5e-5 if net == "resnet" else 1e-5
    jcfg, tcfg = _pair(net)
    params, _, _, tparams = _weights(jcfg, tcfg)
    x = np.random.default_rng(1).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    fwd = jax.jit(lambda p, x, k: jc.cnn_forward(p, x, jcfg, train=train, key=k))
    want = np.asarray(fwd(params["layers"], x, jax.random.PRNGKey(3)))
    got = tc.cnn_forward(
        tparams["layers"], torch.from_numpy(x), tcfg, train=train,
        key=tr.PRNGKey(3),
    ).numpy()
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def test_init_group_map_and_shapes_match():
    jcfg, tcfg = _pair("resnet")
    params, jmetas, (jgroups, jng) = _jax_shapes(jcfg)
    tparams, tmetas, (tgroups, tng) = tc.init_cnn(tcfg, 0, device="cpu")
    assert (tgroups, tng) == (jgroups, jng)
    assert tree_asdict(tmetas) == tree_asdict(jmetas)
    for name, leafs in params["layers"].items():
        for k, v in leafs.items():
            assert tparams["layers"][name][k].numel() == np.prod(v.shape)


LR = 0.005
POLICIES = {
    "baseline": dict(round_to=4),
    "oracle:2": dict(round_to=2),
    "awp": dict(round_to=4, schedule="awp", awp_threshold=1.0, awp_interval=1),
}


def _run_jax(jcfg, params, metas, gi, plan_kw, steps, batch, lr=LR,
             min_size=MIN_SIZE):
    mesh = JMesh(compress_min_size=min_size)
    spec = jstep.build_cnn_spec_tree(params, metas, mesh)
    storage = jstep.cnn_to_storage(params, spec, mesh)
    groups, ng = gi
    elems = [0] * ng
    for name, leafs in spec["layers"].items():
        for s in leafs.values():
            if s.kind == JDIST:
                elems[groups[name]] += s.s_loc
    plan = JPlan.build(ng, **plan_kw)
    opt = JSGD(lr=lr, momentum=0.9, weight_decay=5e-4)

    def builder(rts):
        return jstep.make_cnn_train_step(
            jcfg, mesh, None, spec, gi, opt, {}, plan=plan.with_round_tos(rts)
        )

    trainer = JTrainer(builder, ng, plan=plan, dist_elems_per_group=elems)
    data = JData(num_classes=jcfg.num_classes, hw=jcfg.in_hw, noise=0.1)
    mom = j_init_momentum(storage)
    norms = []
    for i in range(steps):
        imgs, labels = data.batch(batch, i)
        storage, mom, m = trainer.run_step(
            storage, mom, {"images": imgs, "labels": labels}, lr,
            jax.random.PRNGKey(1000 + i),
        )
        norms.append(np.asarray(m["group_norms_sq"]))
    return trainer, norms


def _run_port(tcfg, tparams, metas, gi, plan_kw, steps, batch, lr=LR,
              min_size=MIN_SIZE, device="cpu"):
    mesh = MeshCfg(compress_min_size=min_size)
    spec = tstep.build_cnn_spec_tree(tparams, metas, mesh)
    storage = tstep.cnn_to_storage(tparams, spec, mesh)
    _, ng = gi
    plan = PrecisionPlan.build(ng, **plan_kw)
    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=5e-4)

    def builder(rts):
        return tstep.make_cnn_train_step(
            tcfg, mesh, spec, gi, opt, plan=plan.with_round_tos(rts)
        )

    trainer = Trainer(
        builder, ng, plan=plan,
        dist_elems_per_group=tstep.cnn_dist_elems(spec, gi, mesh),
    )
    data = SyntheticImageNet(
        num_classes=tcfg.num_classes, hw=tcfg.in_hw, noise=0.1, device=device
    )
    mom = init_momentum(storage)
    norms = []
    for i in range(steps):
        imgs, labels = data.batch(batch, i)
        storage, mom, m = trainer.run_step(
            storage, mom, {"images": imgs, "labels": labels}, lr,
            tr.PRNGKey(1000 + i),
        )
        norms.append(m["group_norms_sq"].cpu().numpy())
    return trainer, norms, storage, spec


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_five_step_runs_match(policy):
    jcfg, tcfg = _pair("alexnet")
    params, metas, gi, tparams = _weights(jcfg, tcfg)
    jt, jn = _run_jax(jcfg, params, metas, gi, POLICIES[policy], 5, 16)
    tt, tn, storage, spec = _run_port(tcfg, tparams, metas, gi, POLICIES[policy], 5, 16)
    np.testing.assert_allclose(
        [r.loss for r in tt.records], [r.loss for r in jt.records], rtol=2e-4
    )
    np.testing.assert_allclose(np.stack(tn), np.stack(jn), rtol=1e-4)
    assert [r.round_tos for r in tt.records] == [r.round_tos for r in jt.records]
    assert [r.wire_bytes for r in tt.records] == [r.wire_bytes for r in jt.records]
    assert [r.wire_by_entry for r in tt.records] == [r.wire_by_entry for r in jt.records]
    ts, js = tt.summary(), jt.summary()
    for k in ("bits_history", "recompiles", "wire_bytes", "wire_bytes_fp32",
              "wire_reduction", "wire_by_entry"):
        assert ts[k] == js[k], k
    if policy == "awp":
        # interval 1, threshold above every delta: widen every step
        assert [r.round_tos[0] for r in tt.records] == [1, 1, 2, 3, 4]
        assert len(ts["bits_history"]) == 4


def _nhwc(t):
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).numpy()


def test_activation_rounding_differs_only_by_one_ulp_flips():
    """The activation policy (nearest bf16 at every stage boundary) is not
    among the five-step runs: there the two packages' losses drift apart
    by ~4e-4 relative over five steps. This is why. On the first training
    step's input, both packages' rounded activations are recorded at every
    boundary. The port's quantizer maps the reference's pre-rounding
    activations to the reference's rounded ones bit for bit. The only
    differences come from pre-rounding values that differ by a few 1e-6
    (the convolutions' summation order): they land on either side of a
    rounding midpoint and differ by one bf16 step after rounding."""
    from repro.transport import CompressionPolicy as JPolicy
    from repro.transport import transport as jT
    from repro_torch.transport import CompressionPolicy
    from repro_torch.transport import transport as tT

    jcfg, tcfg = _pair("alexnet")
    params, _, _, tparams = _weights(jcfg, tcfg)
    imgs, labels = JData(num_classes=10, hw=32, noise=0.1).batch(16, 0)
    imgs, labels = np.array(imgs), np.array(labels)
    kw = dict(round_to=2, grad_round_to=2, mode="nearest", grad_mode="nearest")
    jpol, tpol = JPolicy(**kw), CompressionPolicy(**kw)

    def jax_loss(layers, x, y):
        rec = []

        def aq(v):
            rec.append((v, jT.quantize(v, jpol)))
            return rec[-1][1]

        key = jax.random.PRNGKey(1000)
        return jc.cnn_loss(layers, x, y, jcfg, key=key, act_quant=aq), rec

    jloss, jrec = jax.jit(jax_loss)(params["layers"], imgs, labels)
    trec = []

    def aq(v):
        trec.append((v, tT.quantize(v, tpol)))
        return trec[-1][1]

    tloss = tc.cnn_loss(tparams["layers"], torch.from_numpy(imgs),
                        torch.from_numpy(labels), tcfg, key=tr.PRNGKey(1000),
                        act_quant=aq)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-4)
    assert len(trec) == len(jrec) == 8
    flips = []
    for (jv, jq), (tv, tq) in zip(jrec, trec):
        jv, jq, tv, tq = np.asarray(jv), np.asarray(jq), _nhwc(tv), _nhwc(tq)
        requant = tT.quantize(torch.from_numpy(jv.copy()), tpol).numpy()
        np.testing.assert_array_equal(requant.view(np.uint32), jq.view(np.uint32))
        steps = np.abs(jq.view(np.int32).astype(np.int64) - tq.view(np.int32))
        flips.append(int(np.count_nonzero(steps)))
        if not any(flips[:-1]):
            # up to the first boundary that differs, its inputs are the
            # same: only the summation order separates the two sides
            assert np.max(np.abs(jv - tv)) < 1e-5
            assert set(np.unique(steps)) <= {0, 0x10000}  # one bf16 step
            lo, hi = np.minimum(jv, tv), np.maximum(jv, tv)
            mid = (jq.astype(np.float64) + tq) / 2
            flipped = steps != 0
            assert np.all((lo[flipped] <= mid[flipped]) & (mid[flipped] <= hi[flipped]))
        assert flips[-1] <= steps.size // 500
    assert flips[:2] == [0, 0] and any(flips)


def test_published_alexnet_geometry_matches():
    """AlexNet's published geometry at 1/16 of its channels: 224×224
    input, conv0 11×11 stride 4 (XLA "SAME": 3 rows before, 4 after),
    pools 56→28→14→7, fc5 over the 7×7 map (the flatten re-order), 200
    classes, the paper init N(0, 0.1²) and dropout 0.5. The widths are the
    only thing the full-width model adds."""
    def narrow(cfg):
        layers = tuple(
            ("conv", s[1] // 16, s[2], s[3]) if s[0] == "conv"
            else ("fc", s[1] // 64) if s[0] == "fc" else s
            for s in cfg.layers
        )
        return dataclasses.replace(cfg, layers=layers)

    jcfg, tcfg = narrow(jc.ALEXNET), narrow(tc.ALEXNET)
    assert jcfg.in_hw == 224 and jcfg.num_classes == 200 and jcfg.paper_init
    params, _, _, tparams = _weights(jcfg, tcfg)
    imgs, labels = JData(num_classes=200, hw=224).batch(4, 0)
    imgs, labels = np.array(imgs), np.array(labels)
    want_logits, want_loss = jax.jit(
        lambda p, x, y: (jc.cnn_forward(p, x, jcfg, train=False),
                         jc.cnn_loss(p, x, y, jcfg, key=jax.random.PRNGKey(5)))
    )(params["layers"], imgs, labels)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    logits = tc.cnn_forward(tparams["layers"], x, tcfg, train=False)
    loss = tc.cnn_loss(tparams["layers"], x, y, tcfg, key=tr.PRNGKey(5))
    assert logits.shape == (4, 200)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)


def test_eval_matches():
    jcfg, tcfg = _pair("vgg")
    params, metas, gi, tparams = _weights(jcfg, tcfg)
    _, ng = gi
    jmesh, tmesh = JMesh(compress_min_size=MIN_SIZE), MeshCfg(compress_min_size=MIN_SIZE)
    jspec = jstep.build_cnn_spec_tree(params, metas, jmesh)
    tspec = tstep.build_cnn_spec_tree(tparams, metas, tmesh)
    imgs, labels = SyntheticImageNet(num_classes=10, hw=32, device="cpu").validation(64)
    for rt in (1, 2, 4):
        jev = jstep.make_cnn_eval(jcfg, jmesh, None, jspec, gi,
                                  plan=JPlan.build(ng, round_to=rt))
        tev = tstep.make_cnn_eval(tcfg, tmesh, tspec, gi,
                                  plan=PrecisionPlan.build(ng, round_to=rt))
        want = float(jev(params, imgs.numpy(), labels.numpy().astype(np.int32)))
        assert float(tev(tparams, imgs, labels)) == want


def test_full_width_alexnet_spec_tree_matches():
    """Kinds, group map and DIST element count at the published widths,
    with shapes only (jax.eval_shape / meta tensors): no full-width step."""
    params, metas, (jgroups, jng) = _jax_shapes(jc.ALEXNET)
    jspec = jstep.build_cnn_spec_tree(params, metas, JMesh())
    tparams, tmetas, gi = tc.init_cnn(tc.ALEXNET, 0, device="meta")
    tspec = tstep.build_cnn_spec_tree(tparams, tmetas, MeshCfg())
    assert gi == (jgroups, jng) and jng == 9
    kinds = {n: {k: s.kind for k, s in l.items()} for n, l in tspec["layers"].items()}
    assert kinds == {n: {k: s.kind for k, s in l.items()}
                     for n, l in jspec["layers"].items()}
    assert kinds["conv0"]["w"] != DIST  # 23,232 elements < 65,536
    assert tspec["layers"]["conv0"]["w"].meta.compress
    elems = tstep.cnn_dist_elems(tspec, gi, MeshCfg())
    assert sum(elems) == 88_936_448
    assert sum(l["w"].numel() for l in tparams["layers"].values()) == 88_959_680
    assert sum(x.numel() for l in tparams["layers"].values() for x in l.values()) == sum(
        int(np.prod(x.shape)) for l in params["layers"].values() for x in l.values()
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


# name -> (plan, learning rate, steps)
FULL_WIDTH_RUNS = {
    "baseline-lr1e-8": (dict(round_to=4), 1e-8, 3),
    "oracle:2-lr1e-8": (dict(round_to=2), 1e-8, 3),
    "baseline-lr0.01": (dict(round_to=4), 0.01, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("run", sorted(FULL_WIDTH_RUNS))
def test_full_width_alexnet_on_card_matches_reference(cuda_device, run):
    """Full-width AlexNet as published (224×224, 200 classes, the paper
    init N(0, 0.1²) with biases 0.1, dropout 0.5), batch 64, the default
    ``compress_min_size``, from the same weights: the port on the card
    (CUDA kernels, cuDNN, TF32 off) against the JAX package on the host's
    CPU. A full-width step is too large for the CPU test runs, so this
    runs only beside a card:

        PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -m cuda -s tests/test_torch_cnn.py

    At lr 0.01 the paper init diverges: the test holds the first loss to
    the reference and asks that both packages blow up on the same steps.
    """
    plan_kw, lr, steps = FULL_WIDTH_RUNS[run]
    jcfg, tcfg = jc.ALEXNET, tc.ALEXNET
    min_size = JMesh().compress_min_size
    params, metas, gi, tparams = _weights(jcfg, tcfg, device=cuda_device)
    jt, jn = _run_jax(jcfg, params, metas, gi, plan_kw, steps, 64, lr=lr,
                      min_size=min_size)
    del params
    tt, tn, _, _ = _run_port(tcfg, tparams, metas, gi, plan_kw, steps, 64,
                             lr=lr, min_size=min_size, device=cuda_device)
    jl, tl = [r.loss for r in jt.records], [r.loss for r in tt.records]
    print(f"\n{run}: loss JAX (host CPU) {jl}\n{run}: loss port (card)     {tl}")
    assert [r.wire_bytes for r in tt.records] == [r.wire_bytes for r in jt.records]
    if lr < 1e-3:
        np.testing.assert_allclose(tl, jl, rtol=2e-4)
        np.testing.assert_allclose(np.stack(tn), np.stack(jn), rtol=1e-4)
    else:
        np.testing.assert_allclose(tl[0], jl[0], rtol=2e-4)
        blown = [[not np.isfinite(x) or x > 1e20 for x in ls[1:]] for ls in (jl, tl)]
        assert blown[0] == blown[1] and all(blown[0]), blown
