"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    pattern=(LayerSpec(mixer="attn", attn_kind="local", moe=True),),
    sliding_window=4096,
    num_experts=8,
    experts_per_token=2,
    tie_embeddings=False,
    citation="arXiv:2401.04088",
)
