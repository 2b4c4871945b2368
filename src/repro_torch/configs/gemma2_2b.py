"""gemma2-2b [dense] — alternating local(4k SWA)/global attention, logit
softcaps, GeGLU, sqrt(d) embedding scaling [arXiv:2408.00118]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    pattern=(LayerSpec(mixer="attn", attn_kind="local"),
             LayerSpec(mixer="attn", attn_kind="global")),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="gelu",
    scale_embeddings=True,
    citation="arXiv:2408.00118",
)
