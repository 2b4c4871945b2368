from repro_torch.serving.base import EngineConfig, EngineStats
from repro_torch.serving.engine import CoachEngine
from repro_torch.serving.generate import generate

__all__ = ["CoachEngine", "EngineConfig", "EngineStats", "generate"]
