"""Model configuration for every assigned architecture family.

One frozen dataclass covers dense / MoE / SSM / hybrid / VLM-backbone /
audio-encoder families.  Layer heterogeneity (gemma2 local/global
alternation, jamba 1:7 mamba:attn interleave, MoE strides) is expressed as a
repeating *group pattern* so the layer stack can be executed with a single
``lax.scan`` over stacked parameter groups — essential to keep HLO size and
compile time bounded for 72-layer models on the 512-chip dry-run mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating group pattern."""

    mixer: str = "attn"  # "attn" | "mamba"
    attn_kind: str = "global"  # "global" | "local" (sliding window) | "chunked"
    moe: bool = False

    def __post_init__(self):
        assert self.mixer in ("attn", "mamba")
        assert self.attn_kind in ("global", "local", "chunked")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads

    # --- layer pattern -----------------------------------------------------
    # The stack is ``num_layers / len(pattern)`` repetitions of ``pattern``.
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # --- attention variants -------------------------------------------------
    causal: bool = True  # False => encoder-only (hubert)
    use_rope: bool = True
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    sliding_window: int = 4096  # used by "local" layers
    attn_chunk: int = 8192  # used by "chunked" layers (llama4 iRoPE-style)
    attn_logit_softcap: Optional[float] = None  # gemma2
    final_logit_softcap: Optional[float] = None  # gemma2
    qk_norm: bool = False  # qwen3
    attn_scale: Optional[float] = None  # override 1/sqrt(head_dim)

    # --- MLP variants -------------------------------------------------------
    mlp_act: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU)

    # --- MoE ------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False  # llama4: always-on shared expert
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- embeddings / io --------------------------------------------------------
    embed_inputs: bool = False  # vlm/audio: inputs are (B,S,D) embeddings
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # gemma-style sqrt(d) embedding scaling
    scale_embeddings: bool = False

    citation: str = ""

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern period {len(self.pattern)}"
        )
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def group_size(self) -> int:
        return len(self.pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def has_mixer(self, mixer: str) -> bool:
        return any(s.mixer == mixer for s in self.pattern)

    @property
    def supports_decode(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer needs an unbounded full-attention KV cache, or the
        full-attention layers are sparse enough for 500k decode (hybrid /
        alternating patterns keep O(S) global layers bounded)."""
        kinds = {
            (s.mixer, s.attn_kind if s.mixer == "attn" else "-") for s in self.pattern
        }
        full = ("attn", "global") in kinds
        non_full = len(kinds - {("attn", "global")}) > 0
        return (not full) or non_full  # pure-global-attention stacks excluded

    def reduced(self, **over) -> "ModelConfig":
        """A small same-family variant for CPU smoke tests."""
        period = len(self.pattern)
        d_model = min(self.d_model, 256)
        head_dim = 32 if self.head_dim >= 32 else self.head_dim
        n_heads = max(2, min(4, d_model // head_dim))
        kv = max(1, min(self.num_kv_heads, n_heads // 2)) if self.num_kv_heads < self.num_heads else n_heads
        kw = dict(
            num_layers=2 * period if period <= 4 else period,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=16,
            sliding_window=64,
            attn_chunk=64,
        )
        if self.mrope_sections is not None:
            half = (32 if self.head_dim >= 32 else self.head_dim) // 2
            t = half // 4
            kw["mrope_sections"] = (t, (half - t) // 2, half - t - (half - t) // 2)
        kw.update(over)
        return dataclasses.replace(self, name=self.name + "-smoke", **kw)
