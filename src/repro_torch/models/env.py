"""Execution environment threaded through every model function
(counterpart of ``repro.models.env``, the trivial mesh).

The reference's ``Env`` carries the mesh axes and routes the TP-region
collectives through them; on one device each of those boundaries
(``enter`` / ``exit`` / ``psum_enter``) is the identity, which is all
this slice runs. A tensor-parallel degree above 1 and the
sequence-parallel layout raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Env:
    tp: int = 1
    dtype: Any = torch.float32            # compute dtype
    attn_chunk: int = 1024                # attend_tiled chunk (q and kv)
    causal_skip: bool = True              # skip fully masked kv chunks
    seq_parallel: bool = False

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(f"tp={self.tp}: only the trivial mesh is ported")
        if self.seq_parallel:
            raise NotImplementedError("seq_parallel is not ported")

    def enter(self, x, axis: int = 1):
        return x

    def exit(self, x, axis: int = 1):
        return x

    def psum_enter(self, x):
        return x

    def heads_local(self, heads: int) -> int:
        return max(1, heads // self.tp)
