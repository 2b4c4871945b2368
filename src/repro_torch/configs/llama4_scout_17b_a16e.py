"""llama4-scout-17b-a16e [moe] — MoE 16e top-1 + shared expert, early fusion,
iRoPE-style chunked-local attention (3 of 4 layers, 8k chunks)
[hf:meta-llama/Llama-4-Scout-17B-16E].
"""
from repro_torch.models.config import LayerSpec, ModelConfig

_chunk = LayerSpec(mixer="attn", attn_kind="chunked", moe=True)
_glob = LayerSpec(mixer="attn", attn_kind="global", moe=True)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,               # per-expert FFN width
    vocab_size=202048,
    pattern=(_chunk, _chunk, _chunk, _glob),
    attn_chunk=8192,
    rope_theta=500_000.0,
    num_experts=16,
    experts_per_token=1,     # top-1 routing
    shared_expert=True,      # always-on shared expert
    tie_embeddings=False,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
