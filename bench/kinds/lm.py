"""A dense decoder LM configuration (``"kind": "lm"``) on the port:
``repro_torch``'s ``Trainer`` over ``make_train_step`` on one device at the
mix's static formats, fed from the benchmark's pool of token batches.
The configuration's file uses the source's ``config.json`` keys; this
module maps them onto the port's ``ModelConfig``.
"""
from __future__ import annotations

from bench import inputs, yardstick
from bench.kinds.cnn import plan_json
from bench.reference import lm as reference

# (pattern subtree, port leaf) -> the benchmark's leaf name
_LEAVES = {
    ("attn", "wq"): "wq", ("attn", "wk"): "wk", ("attn", "wv"): "wv", ("attn", "wo"): "wo",
    ("attn", "ln"): "attn_ln", ("attn", "q_norm"): "q_norm", ("attn", "k_norm"): "k_norm",
    ("mix", "ln"): "mix_ln", ("mix", "w_gate"): "w_gate", ("mix", "w_up"): "w_up",
    ("mix", "w_down"): "w_down",
}


def model_config(doc: dict):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=doc["name"], arch_type="dense", num_layers=doc["num_hidden_layers"],
        d_model=doc["hidden_size"], num_heads=doc["num_attention_heads"],
        num_kv_heads=doc["num_key_value_heads"], head_dim=doc["head_dim"],
        d_ff=doc["intermediate_size"], vocab_size=doc["vocab_size"], qk_norm=doc["qk_norm"],
        rope_theta=float(doc["rope_theta"]), tie_embeddings=doc["tie_word_embeddings"],
        norm_eps=doc["rms_norm_eps"], num_precision_groups=doc["num_precision_groups"],
        remat=doc["remat"],
    )


def _fill(leaf, value, name: str) -> None:
    if leaf.shape != value.shape:
        raise ValueError(f"{name}: benchmark shape {tuple(value.shape)}, "
                         f"the program's {tuple(leaf.shape)}")
    leaf.copy_(value)


class Program:
    """The training job of one run: weights and batches from ``seed``,
    ``step(i)`` one step of the window's own call."""

    def __init__(self, doc: dict, mix: dict, seed: int, device):
        from repro_torch.dist.spec import MeshCfg, build_spec_tree, dist_elems_per_group
        from repro_torch.models.init import init_params
        from repro_torch.optim.sgd import SGDConfig, init_momentum
        from repro_torch.plan import PrecisionPlan
        from repro_torch.train.loop import Trainer
        from repro_torch.train.step import make_train_step

        if not doc["tie_word_embeddings"]:
            raise ValueError("the benchmark's LM weights tie the embedding and the head")
        cfg = model_config(doc)
        # the program's own tree on the device (its draws are overwritten
        # below): shapes on the meta device would load torch's symbolic
        # shape machinery, seconds of set-up that serve no step
        params, metas = init_params(cfg, 0, device)
        mesh_cfg = MeshCfg(compress_min_size=doc["compress_min_size"])
        spec_tree = build_spec_tree(params, metas, mesh_cfg)
        w = inputs.lm_weights(doc, seed, device)
        R = cfg.layers_per_group
        self.R = R
        top = {k: v for k, v in params.items() if k != "groups"}
        if set(top) != {"embed", "final_norm"} or len(cfg.pattern) != 1:
            raise ValueError(f"unexpected LM tree: top leaves {sorted(top)}, "
                             f"pattern {cfg.pattern}")
        for k, leaf in top.items():
            _fill(leaf, w[k], k)
        for g, grp in enumerate(params["groups"]):
            for sub, leafs in grp["p0"].items():
                for k, leaf in leafs.items():
                    _fill(leaf, w[_LEAVES[sub, k]][g * R:(g + 1) * R], f"{sub}.{k}")
        del w
        self.storage = params
        self.mom = init_momentum(self.storage)
        opt = doc["optimizer"]
        self.lr, self.weight_decay = opt["lr"], opt["weight_decay"]
        sgd = SGDConfig(lr=opt["lr"], momentum=opt["momentum"],
                        weight_decay=opt["weight_decay"])
        nrt = cfg.num_groups + 1
        plan = PrecisionPlan.from_json_dict(plan_json(mix)).broadcast(nrt)
        lm = mix["batch"]["lm"]
        batch_shapes = {"tokens": (lm["sequences"], lm["seq_len"]),
                        "labels": (lm["sequences"], lm["seq_len"])}

        def builder(round_tos):
            return make_train_step(cfg, mesh_cfg, None, spec_tree, sgd, batch_shapes,
                                   plan=plan.with_round_tos(round_tos))

        self.trainer = Trainer(builder, nrt, plan=plan,
                               dist_elems_per_group=dist_elems_per_group(spec_tree, mesh_cfg,
                                                                         nrt))
        self.pool = mix["pool"]
        self.tokens, self.labels = inputs.lm_batches(
            doc, lm["sequences"], lm["seq_len"], self.pool, seed, device)

    def step(self, i: int) -> dict:
        b = {"tokens": self.tokens[i % self.pool], "labels": self.labels[i % self.pool]}
        self.storage, self.mom, metrics = self.trainer.run_step(self.storage, self.mom, b,
                                                                self.lr)
        return metrics

    def _named(self, tree) -> dict:
        out = {}
        for g, grp in enumerate(tree["groups"]):
            for sub, leafs in grp["p0"].items():
                for k, v in leafs.items():
                    for r in range(v.shape[0]):
                        out[f"{_LEAVES[sub, k]}.{g * self.R + r}"] = v[r]
        out.update({k: v for k, v in tree.items() if k != "groups"})
        return out

    def params(self) -> dict:
        return self._named(self.storage)

    def momenta(self) -> dict:
        return self._named(self.mom)


decayed = reference.decayed
train_reference = reference.train


def flops_per_step(doc: dict, mix: dict) -> float:
    lm = mix["batch"]["lm"]
    return yardstick.lm_step_flops(doc, lm["sequences"] * lm["seq_len"])


def transport_bytes_per_step(doc: dict, mix: dict) -> float:
    return yardstick.transport_bytes(yardstick.lm_dist_elems(doc), mix["round_to"])
