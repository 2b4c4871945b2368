"""qwen3-14b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", attn_kind="global"),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    citation="hf:Qwen/Qwen3-8B",
)
