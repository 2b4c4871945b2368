"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone only: the ViT/SigLIP frontend is a stub — ``input_specs()`` feeds
precomputed patch embeddings of shape (B, S, d_model).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,          # GQA kv=2
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    pattern=(LayerSpec(mixer="attn", attn_kind="global"),),
    mrope_sections=(16, 24, 24),  # M-RoPE (t,h,w) over head_dim/2=64
    rope_theta=1_000_000.0,
    embed_inputs=True,       # stub frontend provides embeddings
    tie_embeddings=False,
    citation="arXiv:2409.12191",
)
