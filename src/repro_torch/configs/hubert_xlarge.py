"""hubert-xlarge [audio] — encoder-only transformer (wav2vec2-style backbone)
[arXiv:2106.07447].

Backbone only: the mel-spectrogram + conv feature extractor is a stub —
``input_specs()`` feeds precomputed frame embeddings (B, S, d_model).
Encoder-only => no decode shapes (noted in DESIGN.md).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,          # masked-prediction cluster targets
    pattern=(LayerSpec(mixer="attn", attn_kind="global"),),
    causal=False,            # bidirectional encoder
    mlp_act="gelu",
    embed_inputs=True,
    tie_embeddings=False,
    citation="arXiv:2106.07447",
)
