"""A CNN configuration (``"kind": "cnn"``) on the port: ``repro_torch``'s
``Trainer`` over ``make_cnn_train_step`` at the mix's static formats, fed
from the benchmark's pool of image batches, with the paper's dropout keys
``fold_in(PRNGKey(seed mod 2**31), step)``.
"""
from __future__ import annotations

from bench import inputs, yardstick
from bench.reference import cnn as reference


def plan_json(mix: dict) -> dict:
    """The program's precision plan of a mix: every weight group at the
    mix's ``round_to``, truncated, static."""
    return {"version": 1, "weights": [{"round_to": mix["round_to"], "mode": "truncate"}],
            "schedule": {"source": mix["schedule"]}}


class Program:
    """The training job of one run: weights and batches from ``seed``,
    ``step(i)`` one step of the window's own call."""

    def __init__(self, doc: dict, mix: dict, seed: int, device):
        from repro_torch import random as jr
        from repro_torch.dist.spec import MeshCfg
        from repro_torch.models.cnn import CNNConfig, init_cnn
        from repro_torch.optim.sgd import SGDConfig, init_momentum
        from repro_torch.plan import PrecisionPlan
        from repro_torch.train.cnn_step import (
            build_cnn_spec_tree,
            cnn_dist_elems,
            make_cnn_train_step,
        )
        from repro_torch.train.loop import Trainer

        self._jr = jr
        cfg = CNNConfig(doc["name"], tuple(tuple(s) for s in doc["layers"]),
                        num_classes=doc["num_classes"], in_hw=doc["image_size"],
                        in_ch=doc["in_channels"], dropout=doc["dropout"], paper_init=False)
        shapes, metas, groups_info = init_cnn(cfg, device="meta")
        mesh_cfg = MeshCfg(compress_min_size=doc["compress_min_size"])
        spec_tree = build_cnn_spec_tree(shapes, metas, mesh_cfg)
        w = inputs.cnn_weights(doc, seed, device)
        self.storage = {"layers": {
            name: {k: w.pop(f"{name}.{k}") for k in leafs}
            for name, leafs in shapes["layers"].items()}}
        if w:
            raise ValueError(f"weights the program has no leaf for: {sorted(w)}")
        for name, leafs in shapes["layers"].items():
            for k, s in leafs.items():
                if tuple(self.storage["layers"][name][k].shape) != tuple(s.shape):
                    raise ValueError(f"{name}.{k}: benchmark shape differs from the program's")
        self.mom = init_momentum(self.storage)
        opt = doc["optimizer"]
        self.lr, self.weight_decay = opt["lr"], opt["weight_decay"]
        sgd = SGDConfig(lr=opt["lr"], momentum=opt["momentum"],
                        weight_decay=opt["weight_decay"])
        _, num_groups = groups_info
        plan = PrecisionPlan.from_json_dict(plan_json(mix)).broadcast(num_groups)

        def builder(round_tos):
            return make_cnn_train_step(cfg, mesh_cfg, spec_tree, groups_info, sgd,
                                       plan=plan.with_round_tos(round_tos))

        self.trainer = Trainer(builder, num_groups, plan=plan,
                               dist_elems_per_group=cnn_dist_elems(spec_tree, groups_info,
                                                                   mesh_cfg))
        self.pool = mix["pool"]
        self.images, self.labels = inputs.cnn_batches(
            doc, mix["batch"]["cnn"]["images"], self.pool, seed, device)
        self.key = jr.PRNGKey(inputs.dropout_key_seed(seed))

    def step(self, i: int) -> dict:
        b = {"images": self.images[i % self.pool], "labels": self.labels[i % self.pool]}
        self.storage, self.mom, metrics = self.trainer.run_step(
            self.storage, self.mom, b, self.lr, self._jr.fold_in(self.key, i))
        return metrics

    def params(self) -> dict:
        return {f"{n}.{k}": v for n, leafs in self.storage["layers"].items()
                for k, v in leafs.items()}

    def momenta(self) -> dict:
        return {f"{n}.{k}": v for n, leafs in self.mom["layers"].items()
                for k, v in leafs.items()}


decayed = reference.decayed
train_reference = reference.train


def flops_per_step(doc: dict, mix: dict) -> float:
    return yardstick.cnn_step_flops(doc, mix["batch"]["cnn"]["images"])


def transport_bytes_per_step(doc: dict, mix: dict) -> float:
    return yardstick.transport_bytes(yardstick.cnn_dist_elems(doc), mix["round_to"])
