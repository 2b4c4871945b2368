"""Architecture registry + assigned input shapes.

``get_config(arch_id)`` returns the full production ModelConfig;
``get_config(arch_id).reduced()`` is the CPU smoke variant.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, str] = {
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "gemma2-2b": "gemma2_2b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "gemma-7b": "gemma_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen3-14b": "qwen3_14b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch_id]}")
    return mod.CONFIG


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable pair; reason if not (DESIGN.md §4)."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure global attention: long-context decode skipped"
    return True, ""


def all_pairs() -> List[Tuple[str, str, bool, str]]:
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_supported(cfg, s)
            out.append((a, s.name, ok, why))
    return out
