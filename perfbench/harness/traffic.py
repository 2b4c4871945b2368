"""The one traffic generator.  A traffic mix is a data file,
``perfbench/traffic/<name>.json``, of parameters:

  arrivals        the arrival kind, ``perfbench/traffic/kinds/<arrivals>.py``
                  ("open_poisson", "closed")
  rate            tasks/s of an open loop
  schedule_seed   an open loop's arrival schedule, drawn once
  seq_len         tokens a task (a pipelined step's: a sequence)
  n_micro, batch  a pipelined step's microbatches, and its sequences a
                  microbatch
  correlation     the task stream's temporal correlation
                  ("low" | "medium" | "high")
  n_labels        labels of the task stream
  bandwidth_mbps  the end device's uplink
  why             one line"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import List, Optional

HERE = Path(__file__).resolve().parent.parent / "traffic"


def load(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def due_times(traffic: dict, seconds: float) -> Optional[List[float]]:
    """The due times of the window's tasks (s from its start), or None
    for a closed loop: the arrival kind's, found by name."""
    kind = importlib.import_module(
        f"perfbench.traffic.kinds.{traffic['arrivals']}")
    return kind.due_times(traffic, seconds)
