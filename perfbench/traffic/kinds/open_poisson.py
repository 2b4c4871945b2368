"""Open loop, Poisson arrivals at ``rate`` tasks/s, as one schedule that
every run replays: the ``N = rate * seconds`` quantiles of the
exponential distribution, in the order ``schedule_seed`` draws, scaled
to span the window.  The run's ``--seed`` draws the tasks, not the
arrivals: at 0.8 of capacity the tail of a FIFO queue swings by a fifth
from one order of the same gaps to another (a simulation of this queue:
15-25% between the quartiles of 12 orders, even over 50 s), which would
hide any change of the program, while over one schedule it moves with
the service times only."""

from typing import List

import numpy as np


def due_times(traffic: dict, seconds: float) -> List[float]:
    n = max(1, int(round(traffic["rate"] * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps = np.random.default_rng(traffic["schedule_seed"]).permutation(gaps)
    gaps *= seconds / gaps.sum()
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due.tolist()
