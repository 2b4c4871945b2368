"""A model held outside the port's registry, as a model that the
reference's pinned list lacks would be: its own module, whose ``CONFIG``
is a subclass of ``ModelConfig`` with a field of its own, named by a
configuration file's ``module``."""

import dataclasses

from repro_torch.models.config import LayerSpec, ModelConfig


@dataclasses.dataclass(frozen=True)
class ScaledConfig(ModelConfig):
    residual_multiplier: float = 1.0  # a field that ModelConfig lacks


CONFIG = ScaledConfig(
    name="scaled-dense",
    arch_type="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    pattern=(LayerSpec(mixer="attn", attn_kind="global"),),
    qk_norm=True,
    tie_embeddings=False,
)
