"""Observability: span tracing, bubble attribution, export and the metrics
registry, copied from ``repro.obs``."""

from repro_torch.obs import bubbles, export, metrics, trace  # noqa: F401

__all__ = ["trace", "bubbles", "export", "metrics"]
