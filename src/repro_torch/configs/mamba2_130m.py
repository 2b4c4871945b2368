"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,            # unused (attention-free); kept for cost model
    num_kv_heads=24,
    head_dim=64,
    d_ff=0,                  # pure mamba stack, no FFN
    vocab_size=50280,
    pattern=(LayerSpec(mixer="mamba"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    use_rope=False,
    citation="arXiv:2405.21060",
)
