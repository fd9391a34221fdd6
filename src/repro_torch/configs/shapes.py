"""Assigned input shapes and their lowering mode (the JAX package's
``repro/configs/shapes.py``).

train_4k    -> train_step   (forward + backward + optimizer update)
prefill_32k -> prefill_step (forward, writes KV/SSM caches)
decode_32k  -> serve_step   (ONE new token against a seq_len cache)
long_500k   -> serve_step   (sub-quadratic archs only)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def applicable(cfg, shape: InputShape) -> bool:
    """long_500k requires sub-quadratic attention."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True
