"""Observability: span tracing, bubble attribution, export and the metrics
registry, copied from ``repro.obs``; and the port's own wall-clock spans
of its runtime (``runtime``)."""

from repro_torch.obs import bubbles, export, metrics, runtime, trace  # noqa: F401

__all__ = ["trace", "bubbles", "export", "metrics", "runtime"]
