"""The COACH system (planner, simulator, scheduler, collaborative
runtime), ported module for module from ``repro.core``."""
