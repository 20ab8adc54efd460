"""Compression telemetry (port of ``framefusion_tpu.runtime.telemetry``): a
structured per-prefill record of every compression event plus summary
statistics, serialisable to JSON."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


@dataclasses.dataclass
class CompressionEvent:
    layer: int  # decoder layer index; -1 for the layer-0 pre-attention event
    kind: str  # "merge" | "merge_capped" | "prune"
    tokens_removed: int
    tokens_after: int
    above_ratio: Optional[float] = None  # merge events
    budget: Optional[float] = None
    bucket: Optional[int] = None


@dataclasses.dataclass
class PrefillTelemetry:
    original_length: int
    image_token_length: int
    events: list = dataclasses.field(default_factory=list)
    sparsity_list: list = dataclasses.field(default_factory=list)
    final_length: int = 0
    final_image_tokens: int = 0
    tail_start_layer: int = 0

    @property
    def vision_token_reduction(self) -> float:
        if self.image_token_length == 0:
            return 0.0
        return 1.0 - self.final_image_tokens / self.image_token_length

    def summary(self) -> dict[str, Any]:
        return {
            "original_length": self.original_length,
            "final_length": self.final_length,
            "image_token_length": self.image_token_length,
            "final_image_tokens": self.final_image_tokens,
            "vision_token_reduction": round(self.vision_token_reduction, 4),
            "num_events": len(self.events),
            "tail_start_layer": self.tail_start_layer,
            "sparsity_list": [round(s, 4) for s in self.sparsity_list],
            "events": [dataclasses.asdict(e) for e in self.events],
        }

    def to_json(self) -> str:
        return json.dumps(self.summary())
