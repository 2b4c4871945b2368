"""One reader per metric, ``<name before the first dot>.py``, each with
``read(run) -> float | None`` over a finished run (``harness/run``'s
``Run``).  A reader that finds nothing to read returns None, and the
metric is left out of the result line."""
