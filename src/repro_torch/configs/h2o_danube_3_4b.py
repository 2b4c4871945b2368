"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    arch_type="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    pattern=(LayerSpec(mixer="attn", attn_kind="local"),),
    sliding_window=4096,
    citation="arXiv:2401.16818",
)
