"""Assigned input shapes (same 4 for every LM architecture).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a
KV/SSM cache of ``seq_len``); ``train_*`` / ``prefill_*`` lower the
training / prefill forward.  ``long_500k`` requires sub-quadratic decode
and only applies to SSM/hybrid archs (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg) -> list[ShapeSpec]:
    """The shape cells that apply to an architecture (skips noted in DESIGN)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.supports_long_context:
        out.append(SHAPES["long_500k"])
    return out
