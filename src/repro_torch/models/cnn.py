"""The paper's evaluation networks in PyTorch (counterpart of
``repro.models.cnn``): AlexNet (modified, extra FC-4096 — §IV-B), VGG-A and
ResNet-34, plus the reduced variants for CPU runs.

Layouts. The public functions keep the reference's: images are NHWC and
``cnn_forward`` returns ``(B, num_classes)`` logits. Inside, the network
runs NCHW, so convolution weights are stored OIHW and the first
fully-connected layer after the convolutions takes its input rows in
NCHW flatten order ``(c, h, w)``; ``repro_torch.convert`` carries the
reference's HWIO / ``(h, w, c)`` weights across. Fully-connected weights
stay ``(in, out)``, as in the reference.

Padding follows XLA's ``"SAME"``: for stride ``s`` the total padding is
``max((ceil(n/s) - 1)·s + k - n, 0)``, ``total // 2`` before and the rest
after (AlexNet's conv0, k=11 s=4 on 224, pads 3 and 4). The 2×2 max pool
is ``"SAME"`` with a −inf fill. Batch norm uses batch statistics in train
and eval (ddof 0, eps 1e-5). Dropout masks come from
``repro_torch.random`` and are bit-equal to ``jax.random.bernoulli``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.models.meta import ParamMeta
from repro_torch.utils import spans

# layer spec atoms:
#   ("conv", out_ch, kernel, stride)        conv + ReLU
#   ("pool",)                               2x2 max pool
#   ("block", out_ch, stride, repeats)      resnet basic block group
#   ("gap",)                                global average pool
#   ("fc", width)                           fully-connected + ReLU (+dropout)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    layers: tuple
    num_classes: int = 200
    in_hw: int = 224
    in_ch: int = 3
    dropout: float = 0.5
    # paper §IV-B: ResNet adapts precision per *building block*
    awp_granularity: str = "layer"  # "layer" | "block"
    # paper §IV-B initialises every weight N(0, 1e-2); the reduced CPU
    # runs use He init
    paper_init: bool = True
    # ResNet uses batch normalization; norm params are uncompressed
    batch_norm: bool = False


ALEXNET = CNNConfig(
    "alexnet",
    (
        ("conv", 64, 11, 4), ("pool",),
        ("conv", 192, 5, 1), ("pool",),
        ("conv", 384, 3, 1), ("conv", 384, 3, 1), ("conv", 256, 3, 1),
        ("pool",),
        ("fc", 4096), ("fc", 4096), ("fc", 4096),  # extra FC-4096 (paper)
    ),
)

VGG_A = CNNConfig(
    "vgg-a",
    (
        ("conv", 64, 3, 1), ("pool",),
        ("conv", 128, 3, 1), ("pool",),
        ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("pool",),
        ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool",),
        ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool",),
        ("fc", 4096), ("fc", 4096),
    ),
)

RESNET34 = CNNConfig(
    "resnet-34",
    (
        ("conv", 64, 7, 2), ("pool",),
        ("block", 64, 1, 3), ("block", 128, 2, 4),
        ("block", 256, 2, 6), ("block", 512, 2, 3),
        ("gap",),
    ),
    awp_granularity="block",
    batch_norm=True,
)


def reduced_cnn(cfg: CNNConfig, num_classes: int = 10, in_hw: int = 32) -> CNNConfig:
    """CPU-scale variant of the same family (channels /8, fc /32)."""
    out = []
    for spec in cfg.layers:
        if spec[0] == "conv":
            _, ch, k, s = spec
            out.append(("conv", max(8, ch // 8), min(k, 5), min(s, 2)))
        elif spec[0] == "block":
            _, ch, s, n = spec
            out.append(("block", max(8, ch // 8), s, min(n, 2)))
        elif spec[0] == "fc":
            out.append(("fc", max(32, spec[1] // 32)))
        else:
            out.append(spec)
    add_bn = cfg.batch_norm or cfg.name.startswith("vgg")
    return dataclasses.replace(
        cfg, name=cfg.name + "-mini", layers=tuple(out),
        num_classes=num_classes, in_hw=in_hw, dropout=0.1,
        paper_init=False, batch_norm=add_bn,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_cnn(cfg: CNNConfig, seed: int = 0, *, device="cuda"):
    """(params, metas, (group_of_layer, num_groups)).

    params = {"layers": {name: {"w", "b", ...}}} in the port's layouts
    (conv OIHW, fc ``(in, out)``); the group map is the reference's.
    Weights are zero-mean normal (std 0.1 with ``paper_init``, He
    otherwise) drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``; biases 0.1 for AlexNet, 0 otherwise (paper §IV-B).
    ``device="meta"`` gives shapes only.
    """
    dev = torch.device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev)
    if gen is not None:
        gen.manual_seed(seed)
    params, metas = {}, {}
    groups: dict[str, int] = {}
    bias0 = 0.1 if cfg.name.startswith("alexnet") else 0.0
    hw, ch = cfg.in_hw, cfg.in_ch
    gidx = 0
    n = 0

    def normal(shape, std):
        if gen is None:
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return std * torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    def std(fan_in):
        return 0.1 if cfg.paper_init else math.sqrt(2.0 / fan_in)

    def dense_meta():
        return {
            "w": ParamMeta(tp_dim=None, compress=True),
            "b": ParamMeta(tp_dim=None, compress=False),
        }

    def conv_entry(name, cin, cout, k, group):
        params[name] = {
            "w": normal((cout, cin, k, k), std(k * k * cin)),
            "b": full((cout,), bias0),
        }
        metas[name] = dense_meta()
        if cfg.batch_norm:
            params[name]["bn_scale"] = full((cout,), 1.0)
            params[name]["bn_bias"] = full((cout,), 0.0)
            metas[name]["bn_scale"] = ParamMeta(tp_dim=None, compress=False)
            metas[name]["bn_bias"] = ParamMeta(tp_dim=None, compress=False)
        groups[name] = group

    for spec in cfg.layers:
        kind = spec[0]
        if kind == "conv":
            _, cout, k, s = spec
            conv_entry(f"conv{n}", ch, cout, k, gidx)
            ch = cout
            hw = max(1, math.ceil(hw / s))
            n += 1
            if cfg.awp_granularity == "layer":
                gidx += 1
        elif kind == "pool":
            hw = max(1, hw // 2)
        elif kind == "block":
            _, cout, s, reps = spec
            for r in range(reps):
                stride = s if r == 0 else 1
                conv_entry(f"block{n}a", ch, cout, 3, gidx)
                conv_entry(f"block{n}b", cout, cout, 3, gidx)
                if stride != 1 or ch != cout:
                    conv_entry(f"block{n}p", ch, cout, 1, gidx)
                ch = cout
                hw = max(1, math.ceil(hw / stride))
                n += 1
                gidx += 1  # per building block (paper: ResNet granularity)
        elif kind == "gap":
            hw = 1
        elif kind == "fc":
            width = spec[1]
            cin = ch * hw * hw if hw > 1 else ch
            params[f"fc{n}"] = {
                "w": normal((cin, width), std(cin)),
                "b": full((width,), bias0),
            }
            metas[f"fc{n}"] = dense_meta()
            groups[f"fc{n}"] = gidx
            ch, hw = width, 1
            n += 1
            if cfg.awp_granularity == "layer":
                gidx += 1
        else:
            raise ValueError(kind)
    # classifier head
    cin = ch * hw * hw if hw > 1 else ch
    params["head"] = {
        "w": normal((cin, cfg.num_classes), std(cin)),
        "b": full((cfg.num_classes,), 0.0),
    }
    metas["head"] = dense_meta()
    groups["head"] = gidx
    num_groups = gidx + 1
    return {"layers": params}, {"layers": metas}, (groups, num_groups)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA ``"SAME"`` padding (before, after) of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride):
    k = w.shape[-1]
    (ht, hb), (wl, wr) = (same_pads(d, k, stride) for d in x.shape[-2:])
    if ht == hb and wl == wr:
        return F.conv2d(x, w, b, stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, b, stride)


def _bn(x, layer):
    """Batch-statistics normalization (train and eval; running stats are
    omitted, as in the reference)."""
    if "bn_scale" not in layer:
        return x
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + 1e-5)
    return xn * layer["bn_scale"][None, :, None, None] + layer["bn_bias"][None, :, None, None]


def _conv_bn(x, layer, stride):
    return _bn(_conv(x, layer["w"], layer["b"], stride), layer)


def _pool(x):
    """2x2 / stride-2 max pool, ``"SAME"``: odd sizes get one −inf row or
    column at the end."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


def cnn_forward(layers, images, cfg: CNNConfig, *, train: bool, key=None,
                act_quant=None):
    """images (B, H, W, C) -> logits (B, num_classes). ``layers`` is the
    materialized params dict {"convN": {w, b}, ...}; ``key`` is a
    ``repro_torch.random`` key for dropout; ``act_quant`` an optional
    straight-through truncation at stage boundaries."""
    aq = act_quant if act_quant is not None else (lambda v: v)
    x = images.permute(0, 3, 1, 2).contiguous()
    n = 0
    for spec in cfg.layers:
        kind = spec[0]
        if kind == "conv":
            _, cout, k, s = spec
            x = aq(F.relu(_conv_bn(x, layers[f"conv{n}"], s)))
            n += 1
        elif kind == "pool":
            x = _pool(x)
        elif kind == "block":
            _, cout, s, reps = spec
            for r in range(reps):
                stride = s if r == 0 else 1
                ident = x
                y = F.relu(_conv_bn(x, layers[f"block{n}a"], stride))
                y = _conv_bn(y, layers[f"block{n}b"], 1)
                if f"block{n}p" in layers:
                    ident = _conv_bn(x, layers[f"block{n}p"], stride)
                x = aq(F.relu(y + ident))
                n += 1
        elif kind == "gap":
            x = x.mean(dim=(2, 3))
        elif kind == "fc":
            if x.ndim > 2:
                x = x.reshape(x.shape[0], -1)
            x = aq(F.relu(x @ layers[f"fc{n}"]["w"] + layers[f"fc{n}"]["b"]))
            if train and cfg.dropout and key is not None:
                # cumulative fold, as in the reference: key_n = fold(key_{n-1}, n)
                key = jr.fold_in(key, n)
                keep = jr.bernoulli(key, 1 - cfg.dropout, x.shape, device=x.device)
                x = torch.where(keep, x / (1 - cfg.dropout), 0.0)
            n += 1
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    return x @ layers["head"]["w"] + layers["head"]["b"]


def cnn_loss(layers, images, labels, cfg, *, train=True, key=None,
             act_quant=None):
    logits = cnn_forward(
        layers, images, cfg, train=train, key=key, act_quant=act_quant
    )
    with spans.span("model.loss"):
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -logp.gather(1, labels[:, None].to(torch.int64))[:, 0]
        return nll.mean()


def topk_error(layers, images, labels, cfg, k=5):
    logits = cnn_forward(layers, images, cfg, train=False)
    k = min(k, logits.shape[-1])
    top = torch.topk(logits, k, dim=-1).indices
    hit = (top == labels[:, None].to(torch.int64)).any(dim=1)
    return 1.0 - hit.to(torch.float32).mean()
