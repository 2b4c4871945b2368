"""gemma-7b [dense] — GeGLU, head_dim=256, MHA (kv=16) [arXiv:2403.08295]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    pattern=(LayerSpec(mixer="attn", attn_kind="global"),),
    mlp_act="gelu",
    scale_embeddings=True,
    citation="arXiv:2403.08295",
)
