"""Training utilities, ported from ``repro.training``."""
