"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e
top-2 on every second layer [arXiv:2403.19887].

Period-8 block: attention at offset 4 (attn_layer_period=8, offset=4), MoE at
odd offsets (e:2 stride).  We use Mamba2/SSD mixers (this repo's SSM
substrate) in place of Jamba's Mamba1 — noted in DESIGN.md; no explicit
positional encoding (Jamba relies on the SSM for position).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

def _spec(i: int) -> LayerSpec:
    mixer = "attn" if i == 4 else "mamba"
    return LayerSpec(mixer=mixer, attn_kind="global", moe=(i % 2 == 1))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=tuple(_spec(i) for i in range(8)),
    use_rope=False,          # Jamba: no explicit PE
    num_experts=16,
    experts_per_token=2,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=False,
    citation="arXiv:2403.19887",
)
