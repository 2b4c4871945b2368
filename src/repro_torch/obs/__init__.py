"""Observability: span tracing, bubble attribution and export, copied from
``repro.obs`` (the metrics registry is not ported yet, ROADMAP queue 1
item 8)."""

from repro_torch.obs import bubbles, export, trace  # noqa: F401

__all__ = ["trace", "bubbles", "export"]
