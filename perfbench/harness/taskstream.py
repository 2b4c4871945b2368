"""Frozen copy of ``repro_torch.data.pipeline.CorrelatedTaskStream`` and
``Task`` (the task stream that ``launch/serve.py`` serves), kept here so
that a change to the program cannot move the benchmark's inputs.  The
draws, their order and the defaults are the original's."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Task:
    id: int
    label: int
    features: np.ndarray  # frontend features (the end segment's input)
    hop_features: Optional[np.ndarray] = None


class TaskStream:
    """Classification tasks with temporal locality: "low" draws labels
    iid, "medium" in runs of ~5, "high" in runs of ~20; class c's features
    are N(mu_c, sigma_c I) plus a drifting scene offset per run."""

    RUN = {"low": 1, "medium": 5, "high": 20}

    def __init__(self, n_labels: int = 20, dim: int = 64,
                 correlation: str = "medium", seed: int = 0,
                 label_skew: float = 1.2, drift: float = 0.1):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.n_labels = n_labels
        self.dim = dim
        self.mu = rng.normal(size=(n_labels, dim)) * 1.0
        self.sigma = rng.uniform(1.5, 3.5, size=n_labels)
        self.drift = drift
        self.run = self.RUN[correlation]
        w = 1.0 / np.arange(1, n_labels + 1) ** label_skew  # long-tail
        self.label_p = w / w.sum()
        self._cur_label: Optional[int] = None
        self._left = 0
        self._id = 0

    def _next_label(self) -> int:
        if self._left <= 0:
            self._cur_label = int(self.rng.choice(self.n_labels,
                                                  p=self.label_p))
            self._left = max(1, int(self.rng.poisson(self.run)))
            self._scene = self.rng.normal(size=self.dim) \
                * self.sigma[self._cur_label]
        self._left -= 1
        return self._cur_label

    def next_task(self) -> Task:
        j = self._next_label()
        self._scene += self.rng.normal(size=self.dim) * self.drift
        disp = self._scene + self.rng.normal(size=self.dim) * 0.3 \
            * self.sigma[j]
        f = self.mu[j] + disp
        t = Task(self._id, j, f.astype(np.float32))
        self._id += 1
        return t

    def tasks(self, n: int):
        return [self.next_task() for _ in range(n)]


def task_tokens(task: Task, seq_len: int, vocab: int) -> np.ndarray:
    """``launch/serve.py``'s ``task_input`` rule at length ``seq_len``:
    the first ``seq_len`` features, times 1000, absolute, modulo the
    vocabulary."""
    if seq_len > task.features.shape[0]:
        raise ValueError(f"a task of {seq_len} tokens needs that many "
                         f"features; the stream has {task.features.shape[0]}")
    return (np.abs((task.features[:seq_len] * 1000).astype(np.int64))
            % vocab).astype(np.int32)
