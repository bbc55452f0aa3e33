"""Plain reference of a CNN training step (VGG family): convolutions with
"SAME" padding and ReLU, 2x2 max pools, dense layers with ReLU and
dropout, a classifier head, mean cross-entropy; every weight of at least
``compress_min_size`` elements used after a transfer at the mix's
``round_to`` (straight-through gradient); momentum SGD with weight decay on
the weights; per layer, the sum of squares of its weight after the update.
Images arrive NHWC and run NCHW.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench import inputs
from bench.reference import common, threefry


def _same(n: int, k: int, s: int) -> tuple[int, int]:
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride):
    k = w.shape[-1]
    (t, bo), (le, r) = (_same(d, k, stride) for d in x.shape[-2:])
    if t == bo and le == r:
        return F.conv2d(x, w, b, stride, padding=(t, le))
    return F.conv2d(F.pad(x, (le, r, t, bo)), w, b, stride)


def _pool(x):
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


def loss(doc, weights, images, labels, key, round_to):
    """Mean NLL of one batch; ``key`` the step's dropout key."""
    big = doc["compress_min_size"]

    def w_of(name):
        w = weights[f"{name}.w"]
        return common.transfer(w, round_to) if w.numel() >= big else w

    x, n, p = images.permute(0, 3, 1, 2), 0, doc["dropout"]
    for spec in doc["layers"]:
        if spec[0] == "conv":
            x = F.relu(_conv(x, w_of(f"conv{n}"), weights[f"conv{n}.b"], spec[3]))
            n += 1
        elif spec[0] == "pool":
            x = _pool(x)
        else:
            x = F.relu(x.reshape(x.shape[0], -1) @ w_of(f"fc{n}") + weights[f"fc{n}.b"])
            if p:
                key = threefry.fold_in(key, n)
                keep = threefry.keep_mask(key, 1 - p, x.shape, x.device)
                x = torch.where(keep, x / (1 - p), 0.0)
            n += 1
    logits = x.reshape(x.shape[0], -1) @ w_of("head") + weights["head.b"]
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def decayed(name: str) -> bool:
    return name.endswith(".w")


def train(doc, mix, seed, device, *, steps=3, tf32=False, weights=None) -> dict:
    """The readings of the first ``steps`` steps from ``seed``."""
    batch, pool = mix["batch"]["cnn"]["images"], mix["pool"]
    round_to = mix["round_to"]
    opt = doc["optimizer"]
    w = weights if weights is not None else inputs.cnn_weights(doc, seed, device)
    images, labels = inputs.cnn_batches(doc, batch, pool, seed, device)
    p0 = {k: v.clone() for k, v in w.items()}
    moms = {k: torch.zeros_like(v) for k, v in w.items()}
    names = [k for k in w if k.endswith(".w")]
    out = common.new_readings()
    ks = inputs.dropout_key_seed(seed)
    with common.precision(tf32):
        for i in range(steps):
            live = {k: v.requires_grad_(True) for k, v in w.items()}
            key = threefry.fold_in(threefry.key(ks), i)
            lo = loss(doc, live, images[i % pool], labels[i % pool], key, round_to)
            grads = dict(zip(live, torch.autograd.grad(lo, list(live.values()))))
            out["losses"].append(float(lo.detach()))
            if i == 0:
                out["grad1"] = common.norms(grads)
            w = {k: v.detach() for k, v in live.items()}
            common.sgd(w, grads, moms, decayed, opt, opt["lr"])
            out["monitor"].append([float((w[k].double() ** 2).sum()) for k in names])
    out["update3"] = common.norms({k: w[k] - p0[k] for k in w})
    return out
