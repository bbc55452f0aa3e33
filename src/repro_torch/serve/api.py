"""The serving request API (counterpart of ``repro.serve.api``).

One frozen :class:`Request` is accepted by every submit surface
(``ServeEngine.run`` / ``admit``, :func:`repro_torch.serve.engine.
generate_static`, the launcher), so a static-vs-engine check compares
identical request objects. :class:`SamplingParams` has the reference's
fields; only greedy decoding (``temperature == 0``) is ported, and a
sampled request raises ``NotImplementedError`` where it is served.
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["Request", "SamplingParams"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling contract; ``temperature == 0`` is greedy."""

    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "temperature", float(self.temperature))
        object.__setattr__(self, "top_p", float(self.top_p))
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if not isinstance(self.top_k, int) or self.top_k < 0:
            raise ValueError("top_k must be an int >= 0")
        if not isinstance(self.seed, int) or self.seed < 0:
            raise ValueError("seed must be a non-negative int")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def require_greedy(req: "Request") -> None:
    """Sampled decoding (the reference's key-fold sampler) is not ported."""
    if not req.sampling.greedy:
        raise NotImplementedError(
            f"request {req.rid}: sampled decoding (temperature "
            f"{req.sampling.temperature}) is not ported; only greedy"
        )


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
                f"request {rid}: image features (vision cross-attention) are not ported"
            )
        object.__setattr__(self, "rid", rid)
        object.__setattr__(self, "prompt_ids", prompt_ids)
        object.__setattr__(self, "max_new", int(max_new))
        object.__setattr__(self, "eos_id", eos_id)
        object.__setattr__(self, "sampling", sampling)
        object.__setattr__(self, "image_features", None)

