from repro_torch.serving.base import EngineConfig, EngineStats
from repro_torch.serving.engine import CoachEngine

__all__ = ["CoachEngine", "EngineConfig", "EngineStats"]
