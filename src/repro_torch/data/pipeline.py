"""Data pipeline: synthetic-but-structured streams.

``SyntheticLM``      — deterministic Zipf-ish token stream with Markov
                       structure (a model can actually learn it, so the
                       train examples show decreasing loss).
``CorrelatedTaskStream`` — classification-task stream with controllable
                       temporal correlation (the paper's low/medium/high
                       levels, §IV-B Table II) and Gaussian class clusters
                       whose spread controls quantization sensitivity
                       (the §II-B spatial-locality observation).
``make_calibration_set`` — the offline calibration set D used to warm up
                       semantic centers and thresholds.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


class SyntheticLM:
    """Order-1 Markov token generator over a Zipf vocabulary."""

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab_size
        self.branch = branch
        # each token transitions to one of `branch` successors
        self.next_tok = rng.integers(0, vocab_size, size=(vocab_size, branch))
        zipf = 1.0 / np.arange(1, branch + 1)
        self.next_p = zipf / zipf.sum()
        self.rng = rng

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch_size, seq_len), np.int32)
        cur = self.rng.integers(0, self.vocab, size=batch_size)
        for t in range(seq_len):
            out[:, t] = cur
            choice = self.rng.choice(self.branch, size=batch_size, p=self.next_p)
            cur = self.next_tok[cur, choice]
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.batch(8, 256)


@dataclasses.dataclass
class Task:
    id: int
    label: int
    features: np.ndarray  # frontend features (the end segment's input)
    # per-boundary activations for hop-level probes: row k feeds the
    # semantic probe at segment k (row 0 == ``features``); None when the
    # stream models a single probe depth
    hop_features: Optional[np.ndarray] = None


class CorrelatedTaskStream:
    """Streams classification tasks with temporal locality.

    correlation:  "low"    — iid label draws (random frames)
                  "medium" — runs of ~5 same-label tasks (random videos)
                  "high"   — runs of ~20 (sequential videos)
    Class c's features ~ N(mu_c, sigma_c I); sigma varies per class so some
    tasks need higher quantization precision (Fig. 1b clusters).

    ``n_probe_depths > 1`` additionally emits per-boundary activations
    (``Task.hop_features``): depth ``k``'s features shrink the scene/noise
    displacement by ``depth_decay ** k`` — deeper layers concentrate class
    evidence (the SPINN-style progressive-inference observation), so
    deeper semantic probes separate tasks the shallow probe could not.
    Depth 0 is bit-identical to ``features`` and the rng draw sequence
    does not depend on ``n_probe_depths`` (seeded streams stay exactly
    reproducible across the classic and hop-level configurations).
    """

    RUN = {"low": 1, "medium": 5, "high": 20}

    def __init__(self, n_labels: int = 20, dim: int = 64,
                 correlation: str = "medium", seed: int = 0,
                 label_skew: float = 1.2, drift: float = 0.1,
                 n_probe_depths: int = 1, depth_decay: float = 0.5):
        rng = np.random.default_rng(seed)
        self.rng = rng
        self.n_labels = n_labels
        self.dim = dim
        self.mu = rng.normal(size=(n_labels, dim)) * 1.0
        self.mu0 = self.mu.copy()
        self.sigma = rng.uniform(1.5, 3.5, size=n_labels)
        # class centers drift (scene/lighting change through a video):
        # with temporal correlation the semantic cache tracks the drift and
        # stays separable; uncorrelated streams leave centers stale
        self.drift = drift
        assert n_probe_depths >= 1 and 0.0 < depth_decay <= 1.0
        self.n_probe_depths = n_probe_depths
        self.depth_decay = depth_decay
        self.run = self.RUN[correlation]
        w = 1.0 / np.arange(1, n_labels + 1) ** label_skew  # long-tail
        self.label_p = w / w.sum()
        self._cur_label: Optional[int] = None
        self._left = 0
        self._id = 0

    def _next_label(self) -> int:
        if self._left <= 0:
            self._cur_label = int(self.rng.choice(self.n_labels, p=self.label_p))
            self._left = max(1, int(self.rng.poisson(self.run)))
            # new "video": a scene offset shared by the whole run — frames
            # within a run are near-duplicates (Fig. 1a temporal locality)
            self._scene = self.rng.normal(size=self.dim) * self.sigma[self._cur_label]
        self._left -= 1
        return self._cur_label

    def next_task(self) -> Task:
        j = self._next_label()
        self._scene += self.rng.normal(size=self.dim) * self.drift  # pan/zoom
        disp = self._scene + self.rng.normal(size=self.dim) * 0.3 * self.sigma[j]
        f = self.mu[j] + disp
        hop_feats = None
        if self.n_probe_depths > 1:
            hop_feats = np.stack([
                (self.mu[j] + disp * self.depth_decay ** k).astype(np.float32)
                for k in range(self.n_probe_depths)])
        t = Task(self._id, j, f.astype(np.float32), hop_features=hop_feats)
        self._id += 1
        return t

    def tasks(self, n: int):
        return [self.next_task() for _ in range(n)]


def make_calibration_set(stream: CorrelatedTaskStream, n: int = 500,
                         seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Offline calibration set D (features, labels) drawn iid."""
    saved = (stream._cur_label, stream._left)
    stream._cur_label, stream._left = None, 0
    rng = np.random.default_rng(seed)
    feats, labels = [], []
    for _ in range(n):
        j = int(rng.choice(stream.n_labels, p=stream.label_p))
        f = stream.mu0[j] + rng.normal(size=stream.dim) * stream.sigma[j]
        feats.append(f.astype(np.float32))
        labels.append(j)
    stream._cur_label, stream._left = saved
    return np.stack(feats), np.asarray(labels)


def make_hop_calibration_sets(stream: CorrelatedTaskStream, n: int = 500,
                              n_depths: Optional[int] = None, seed: int = 1):
    """Per-boundary calibration sets for hop-level probes: one
    ``(features, labels)`` pair per probe depth, drawn iid with the same
    depth attenuation the stream applies (depth 0 reproduces
    ``make_calibration_set`` exactly for the same seed, so the end
    device's classic calibration is the ``n_depths = 1`` special case)."""
    if n_depths is None:
        n_depths = stream.n_probe_depths
    assert n_depths >= 1
    rng = np.random.default_rng(seed)
    feats = [[] for _ in range(n_depths)]
    labels = []
    for _ in range(n):
        j = int(rng.choice(stream.n_labels, p=stream.label_p))
        disp = rng.normal(size=stream.dim) * stream.sigma[j]
        for k in range(n_depths):
            feats[k].append(
                (stream.mu0[j] + disp * stream.depth_decay ** k
                 ).astype(np.float32))
        labels.append(j)
    labels = np.asarray(labels)
    return [(np.stack(f), labels) for f in feats]
