"""Decode-time sampling configuration — port of ``SamplingParams`` and
``_NEG_INF`` from ``ssi_tpu/generate/engine.py``. The dense ``DecodeEngine``
is not ported yet (ROADMAP queue A)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

_NEG_INF = -1.0e30


@dataclass(frozen=True)
class SamplingParams:
    """vLLM-compatible sampling surface (ref: conf/generate.yaml:21-31)."""

    n: int = 1
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = -1
    max_tokens: int = 256
    stop_token_ids: tuple[int, ...] = field(default_factory=tuple)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0

    @classmethod
    def from_cfg(cls, node: Any, stop_token_ids: list[int]) -> "SamplingParams":
        return cls(
            n=int(node.get("n", 1)),
            temperature=float(node.get("temperature", 0.0)),
            top_p=float(node.get("top_p", 1.0)),
            top_k=int(node.get("top_k", -1)),
            max_tokens=int(node.get("max_tokens", 256)),
            stop_token_ids=tuple(stop_token_ids),
            presence_penalty=float(node.get("presence_penalty", 0.0)),
            frequency_penalty=float(node.get("frequency_penalty", 0.0)),
            repetition_penalty=float(node.get("repetition_penalty", 1.0)),
        )

    @property
    def uses_penalties(self) -> bool:
        return self.presence_penalty != 0.0 or self.frequency_penalty != 0.0 or self.repetition_penalty != 1.0
