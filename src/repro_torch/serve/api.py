"""The serving request API (counterpart of ``repro.serve.api``).

One frozen :class:`Request` is accepted by every submit surface
(``ServeEngine.run`` / ``admit``, :func:`repro_torch.serve.engine.
generate_static`, the launcher), so a static-vs-engine check compares
identical request objects. A request carries its prompt ids, its stop
conditions and its :class:`~repro_torch.plan.SamplingParams` (greedy, or
seeded sampling under the reference's key-fold contract,
:mod:`repro_torch.serve.sampling`). Vision features (cross-attention
archs, ROADMAP item 11) raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.plan.plan import SamplingParams

__all__ = ["Request", "SamplingParams"]


@dataclasses.dataclass(frozen=True, init=False)
class Request:
    """One generation request: prompt, stop conditions, sampling."""

    rid: int
    prompt_ids: tuple[int, ...]
    max_new: int
    eos_id: int | None = None
    sampling: SamplingParams = SamplingParams()
    image_features: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __init__(self, rid: int, prompt_ids=None, max_new: int | None = None,
                 eos_id: int | None = None, sampling: SamplingParams | None = None,
                 image_features=None):
        if prompt_ids is None:
            raise ValueError(f"request {rid}: no prompt ids")
        prompt_ids = tuple(int(t) for t in prompt_ids)
        if not prompt_ids:
            raise ValueError(f"request {rid}: empty prompt")
        if max_new is None or max_new < 1:
            raise ValueError(f"request {rid}: max_new < 1")
        if sampling is None:
            sampling = SamplingParams()
        if not isinstance(sampling, SamplingParams):
            raise ValueError(f"request {rid}: sampling must be a SamplingParams")
        if image_features is not None:
            raise NotImplementedError(
                f"request {rid}: image features (vision cross-attention) are not ported "
                "(ROADMAP item 11)"
            )
        object.__setattr__(self, "rid", rid)
        object.__setattr__(self, "prompt_ids", prompt_ids)
        object.__setattr__(self, "max_new", int(max_new))
        object.__setattr__(self, "eos_id", eos_id)
        object.__setattr__(self, "sampling", sampling)
        object.__setattr__(self, "image_features", None)

