"""COACH online component (§III-C): label semantic centers with a caching
mechanism, task separability, early exit, and adaptive quantization
adjustment under dynamic bandwidth.

All math follows the paper:
  Eq. 7  running-mean center update
  Eq. 8  cosine similarity degrees  T = {t_j}
  Eq. 9  task separability          S = ||T||_2 (t_H - t_SH) t_H / t_SH
  Eq. 10 early-exit result          R = argmax_j t_j
  Eq. 11 bubble-minimizing precision Q_c >= Q_r
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def gap_features(x: np.ndarray, layout: Optional[str] = None) -> np.ndarray:
    """Global Average Pooling: (C,H,W) -> (C,)  or (S,D) -> (D,)  or batched
    (B,...) -> (B,C|D).  Concentrates intermediate data into task features F.

    ``layout`` names the channel axis of rank-3/4 maps explicitly:
    ``"CHW"`` (channels first, batched form ``(B,C,H,W)``) or ``"HWC"``
    (channels last, ``(B,H,W,C)``).  ``None`` falls back to the legacy
    shape heuristic — smaller leading axis means channels-first — which is
    only a guess: a deep channels-first map like ``(512, 7, 7)`` has
    ``shape[0] > shape[-1]`` and gets pooled over its *channel* axis,
    returning 7 spatial means instead of 512 channel means.  Callers that
    know their runtime's layout should always pass it."""
    x = np.asarray(x)
    if layout is not None and layout not in ("CHW", "HWC"):
        raise ValueError(f"layout must be 'CHW' or 'HWC', got {layout!r}")
    if x.ndim == 2:
        return x.mean(axis=0)
    if x.ndim == 3:
        if layout is None:  # legacy heuristic (documented fallback)
            layout = "CHW" if x.shape[0] < x.shape[-1] else "HWC"
        return x.mean(axis=(1, 2)) if layout == "CHW" else x.mean(axis=(0, 1))
    if x.ndim == 4:
        if layout is None:  # batched maps historically assumed (B,C,H,W)
            layout = "CHW"
        return x.mean(axis=(2, 3)) if layout == "CHW" else x.mean(axis=(1, 2))
    raise ValueError(f"unsupported feature rank {x.ndim}")


def cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    num = a @ b.T if b.ndim == 2 else a @ b
    den = (np.linalg.norm(a, axis=-1, keepdims=b.ndim == 2) *
           np.linalg.norm(b, axis=-1))
    sim = num / np.maximum(den, 1e-12)
    return (sim + 1.0) / 2.0  # map [-1,1] -> [0,1] per Eq. 8 range


def separability(sims: np.ndarray,
                 counts: Optional[np.ndarray] = None) -> float:
    """Eq. 9 on one similarity-degree vector T.

    ``counts`` (the cache's per-label update counts) restricts the
    statistic to *trained* centers: ``SemanticCache.similarities`` emits
    exactly 0.0 for an untrained center, so with a single warmed label
    the second-highest degree t_SH is an artificial 0 and Eq. 9 blows up
    through ``t_H / max(t_SH, 1e-12)`` — every warm-up task looks
    maximally separable and exits spuriously.  Fewer than two trained
    centers have no genuine second-highest degree at all, so the
    separability is 0 (never exit-eligible)."""
    sims = np.asarray(sims, dtype=float)
    if counts is not None:
        sims = sims[np.asarray(counts) > 0]
    if len(sims) < 2:
        return 0.0
    t = np.sort(sims)[::-1]
    t_h, t_sh = float(t[0]), float(t[1])
    return float(np.linalg.norm(sims) * (t_h - t_sh) * t_h / max(t_sh, 1e-12))


@dataclasses.dataclass
class OnlineDecision:
    """One task's online outcome.

    ``early_exit`` keeps its classic meaning — the probe on the *end
    device* exited the task, nothing is ever transmitted.  ``exit_hop``
    generalizes it to hop-level semantic exits: ``exit_hop = k >= 1``
    means the task was transmitted (``bits`` chosen by Eq. 11 for the
    uplink), probes at boundaries ``1..k-1`` declined, and the probe at
    boundary ``k`` (an intermediate tier) exited it with ``result`` —
    the task occupies compute ``0..k`` / links ``0..k-1`` only.
    ``early_exit`` is True iff ``exit_hop == 0``."""
    early_exit: bool
    result: Optional[int]       # label if early-exited (Eq. 10)
    separability: float
    bits: Optional[int]         # chosen Q_c if transmitted
    required_bits: Optional[int]  # Q_r from separability thresholds
    exit_hop: Optional[int] = None

    def __post_init__(self):
        if self.early_exit and self.exit_hop is None:
            self.exit_hop = 0


class SemanticCache:
    """Label semantic centers T_c = {T_j^c} with running-mean updates.

    ``max_count`` bounds m_j in Eq. 7, turning the running mean into a
    sliding semantic window so centers keep tracking non-stationary task
    streams (video scenes drift); max_count=None is the paper's literal
    unbounded mean."""

    def __init__(self, n_labels: int, dim: int, max_count: Optional[int] = 16):
        self.centers = np.zeros((n_labels, dim), np.float64)
        self.counts = np.zeros((n_labels,), np.int64)
        self.max_count = max_count

    def warm_up(self, feats: np.ndarray, labels: np.ndarray):
        for f, j in zip(feats, labels):
            self.update(f, int(j))

    def update(self, feat: np.ndarray, label: int):
        m = self.counts[label]
        if self.max_count is not None:
            m = min(m, self.max_count)
        self.centers[label] = (m * self.centers[label] + feat) / (m + 1)  # Eq. 7
        self.counts[label] += 1

    @property
    def n_warm(self) -> int:
        """Labels whose center has seen at least one update.  Separability
        (Eq. 9) needs a genuine second-highest degree, so exit decisions
        are only eligible once ``n_warm >= 2``."""
        return int(np.count_nonzero(self.counts > 0))

    def similarities(self, feat: np.ndarray) -> np.ndarray:
        valid = self.counts > 0
        sims = np.zeros(len(self.centers))
        if valid.any():
            sims[valid] = cosine(feat[None], self.centers[valid])[0]
        return sims

    def trained_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(centers[counts > 0], their label indices)`` — the matrix a
        fused boundary pass (``kernels.boundary``) probes against.  An
        untrained center is all-zeros; its cosine against anything would
        read ~0.5 after the [0, 1] mapping whereas ``similarities``
        defines it as exactly 0, so the kernel only ever sees trained
        centers and ``ProbeResult.from_fused`` scatters the results back
        into the full label space."""
        valid = np.flatnonzero(self.counts > 0)
        return self.centers[valid], valid


@dataclasses.dataclass
class ProbeResult:
    """One task's precomputed semantic-probe outputs (Eq. 8-10), e.g.
    from the fused boundary pass, in the *full* label space of the cache
    that will consume it.  ``OnlineScheduler.step`` / ``probe_hop``
    accept it in place of recomputing similarities from the feature —
    the decision math (thresholds, Eq. 11) is unchanged."""
    sims: np.ndarray   # (n_labels,) similarity degrees; untrained = 0.0
    sep: float         # Eq. 9 over the trained centers
    best: int          # Eq. 10 argmax label (full label space)

    @classmethod
    def from_fused(cls, sims, sep, best, valid: np.ndarray,
                   n_labels: int) -> "ProbeResult":
        """Lift one task's fused-kernel outputs (computed against
        ``cache.trained_view()`` centers) back into the full label
        space.  ``valid`` is the trained-label index map; with fewer
        than two trained centers there is no genuine second-highest
        degree, so the separability is forced to 0 (never
        exit-eligible), matching ``separability``."""
        full = np.zeros(n_labels)
        valid = np.asarray(valid)
        if valid.size:
            full[valid] = np.asarray(sims, dtype=float)
        b = int(valid[int(best)]) if valid.size else 0
        s = float(sep) if valid.size >= 2 else 0.0
        return cls(sims=full, sep=s, best=b)


@dataclasses.dataclass
class Thresholds:
    s_ext: float                       # early-exit threshold
    s_adj: Tuple[Tuple[float, int], ...]  # (separability floor, Q_r bits), desc

    def required_bits(self, s: float, default: int = 8) -> int:
        for floor, bits in self.s_adj:
            if s >= floor:
                return bits
        return default


def calibrate_thresholds(cache: SemanticCache, feats: np.ndarray,
                         labels: np.ndarray, eps: float = 0.005,
                         bit_levels: Sequence[int] = (3, 4, 5, 6, 8)) -> Thresholds:
    """One-time threshold calibration on the calibration set D (§III-C).

    s_ext: smallest separability quantile whose early-exit error <= eps.
    s_adj: separability floors assigning lower bits to more separable tasks
    (spatial-locality observation, Fig. 1b)."""
    seps, correct = [], []
    for f, y in zip(feats, labels):
        sims = cache.similarities(f)
        seps.append(separability(sims, cache.counts))
        correct.append(int(np.argmax(sims)) == int(y))
    seps = np.asarray(seps)
    correct = np.asarray(correct, bool)

    order = np.argsort(-seps)  # most separable first
    s_ext = float("inf")
    errs = np.cumsum(~correct[order])
    for k in range(len(order), 0, -1):
        if errs[k - 1] <= eps * k:
            s_ext = float(seps[order[k - 1]])
            break

    qs = np.quantile(seps, np.linspace(0.9, 0.1, len(bit_levels)))
    s_adj = tuple((float(q), int(b)) for q, b in zip(qs, bit_levels))
    return Thresholds(s_ext=s_ext, s_adj=s_adj)


@dataclasses.dataclass
class HopProbe:
    """Semantic probe state of one intermediate tier: its own label
    centers and calibrated thresholds, keyed by that boundary's
    activations (deeper boundaries are more discriminative, so their
    calibrated exit thresholds admit more of the stream)."""
    cache: SemanticCache
    thresholds: Thresholds


def build_hop_probes(calib_sets: Sequence[Tuple[np.ndarray, np.ndarray]],
                     n_labels: int, eps: float = 0.005,
                     bit_levels: Sequence[int] = (3, 4, 5, 6, 8),
                     max_count: Optional[int] = 16) -> List[HopProbe]:
    """Calibrate one ``HopProbe`` per boundary from per-boundary
    calibration sets ``[(feats, labels), ...]`` (§III-C run once per
    tier: warm the centers, then pick the eps-bounded exit threshold on
    that boundary's own separability distribution)."""
    probes = []
    for feats, labels in calib_sets:
        cache = SemanticCache(n_labels, feats.shape[1], max_count=max_count)
        cache.warm_up(feats, labels)
        th = calibrate_thresholds(cache, feats, labels, eps=eps,
                                  bit_levels=bit_levels)
        probes.append(HopProbe(cache=cache, thresholds=th))
    return probes


def choose_bits(required: int, elems: int, bandwidth_bps: float,
                T_e: float, T_c: float,
                levels: Sequence[int] = (3, 4, 5, 6, 8, 12, 16)) -> int:
    """Eq. 11: among Q_c >= Q_r, minimize |T_t' - max{T_e, T_t', T_c}|.

    Read non-degenerately: once T_t' itself becomes the max the paper's
    expression is 0 for *any* larger precision, which would let the link
    saturate; the intent is to fill idle link time up to the other stages'
    bound.  So we minimize the distance to target = max(T_e, T_c),
    preferring not to exceed it, and break ties toward higher precision
    (free accuracy margin)."""
    target = max(T_e, T_c)
    best = None
    for b in levels:
        if b < required:
            continue
        t_t = elems * b / bandwidth_bps
        key = (abs(t_t - target), t_t > target, -b)
        if best is None or key < best[0]:
            best = (key, b)
    return best[1] if best is not None else max(required, levels[-1])


class OnlineScheduler:
    """Per-task online decision pipeline (Alg. 1 online component).

    ``hop_elems`` / ``stage_compute`` activate the per-hop view of the
    adaptive-precision rule: hop ``k`` carries ``hop_elems[k]`` boundary
    elements between compute stages ``k`` and ``k+1``, and Eq. 11 is
    applied per hop against that pair's busy times, each hop chasing its
    own bandwidth EMA.  Omitting them keeps the classic single-uplink
    scheduler (hop 0 = the end device's uplink)."""

    def __init__(self, cache: SemanticCache, thresholds: Thresholds,
                 boundary_elems: int, T_e: float, T_c: float,
                 update_centers: bool = True,
                 hop_elems: Optional[Sequence[int]] = None,
                 stage_compute: Optional[Sequence[float]] = None,
                 hop_probes: Optional[Sequence[HopProbe]] = None):
        self.cache = cache
        self.th = thresholds
        self.elems = boundary_elems
        self.T_e, self.T_c = T_e, T_c
        self.update_centers = update_centers
        self.bw_ema: Optional[float] = None
        # semantic probes of the intermediate tiers (segment k >= 1 maps
        # to hop_probes[k - 1]); empty = probe only on the end device
        self.hop_probes: Tuple[HopProbe, ...] = tuple(hop_probes or ())
        self.hop_elems: Tuple[int, ...] = tuple(int(e) for e in hop_elems) \
            if hop_elems else (int(boundary_elems),)
        sc = tuple(stage_compute) if stage_compute else (T_e, T_c)
        assert len(sc) == len(self.hop_elems) + 1, \
            "need one compute stage per hop endpoint"
        self.stage_compute: Tuple[float, ...] = sc
        # per-hop bandwidth EMAs for hops >= 1 (hop 0 is ``bw_ema``)
        self.hop_bw_ema: Dict[int, float] = {}

    @property
    def n_hops(self) -> int:
        return len(self.hop_elems)

    def observe_bandwidth(self, bps: float, alpha: float = 0.5):
        self.bw_ema = bps if self.bw_ema is None else \
            alpha * bps + (1 - alpha) * self.bw_ema

    def observe_hop_bandwidth(self, hop: int, bps: float, alpha: float = 0.5):
        """Per-hop bandwidth measurement (hop 0 feeds the classic EMA)."""
        assert 0 <= hop < self.n_hops, hop
        if hop == 0:
            self.observe_bandwidth(bps, alpha)
            return
        cur = self.hop_bw_ema.get(hop)
        self.hop_bw_ema[hop] = bps if cur is None else \
            alpha * bps + (1 - alpha) * cur

    def hop_bandwidth(self, hop: int) -> Optional[float]:
        """Best bandwidth estimate for ``hop``; a hop whose EMA is missing
        degrades gracefully to the end uplink's EMA (the only measurement
        the classic engine takes)."""
        if hop == 0:
            return self.bw_ema
        return self.hop_bw_ema.get(hop, self.bw_ema)

    def choose_hop_bits(self, required: int,
                        levels: Sequence[int] = (3, 4, 5, 6, 8, 12, 16)
                        ) -> Tuple[int, ...]:
        """Eq. 11 per hop: each ``WirePacket`` hop fills its link's idle
        time up to the ceiling of its adjacent compute stages, using that
        hop's own bandwidth EMA."""
        out = []
        for k in range(self.n_hops):
            bw = self.hop_bandwidth(k) or 1e6
            out.append(choose_bits(required, self.hop_elems[k], bw,
                                   self.stage_compute[k],
                                   self.stage_compute[k + 1], levels=levels))
        return tuple(out)

    def probe_centers(self, segment: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Trained-center view of the probe at ``segment`` (0 = the end
        device's cache): the ``(centers, label index map)`` a fused
        boundary pass runs against; lift its outputs back with
        ``ProbeResult.from_fused``."""
        cache = self.cache if segment == 0 \
            else self.hop_probes[segment - 1].cache
        return cache.trained_view()

    def step(self, feat: np.ndarray, bandwidth_bps: Optional[float] = None,
             probe: Optional[ProbeResult] = None) -> OnlineDecision:
        """``probe`` supplies precomputed Eq. 8-10 outputs (the fused
        boundary pass): the similarity/separability math is skipped —
        one HBM read served both the wire packet and this decision —
        while threshold logic and Eq. 7/11 run unchanged (``feat`` still
        feeds the center updates)."""
        if bandwidth_bps is not None:
            self.observe_bandwidth(bandwidth_bps)
        if probe is not None:
            sims, s = probe.sims, probe.sep
        else:
            sims = self.cache.similarities(feat)
            s = separability(sims, self.cache.counts)
        # exit eligibility needs >= 2 warmed labels: with a single warm
        # center the separability statistic has no second-highest degree
        # and a cold cache must never terminate tasks (Eq. 9 over trained
        # centers only; see ``separability``)
        if self.cache.n_warm >= 2 and s > self.th.s_ext:
            j = probe.best if probe is not None else int(np.argmax(sims))
            if self.update_centers:
                self.cache.update(feat, j)
            return OnlineDecision(True, j, s, None, None)
        q_r = self.th.required_bits(s)
        bw = self.bw_ema or 1e6
        q_c = choose_bits(q_r, self.elems, bw, self.T_e, self.T_c)
        return OnlineDecision(False, None, s, q_c, q_r)

    # -------------------------------------------------- hop-level probes
    def probe_hop(self, segment: int, feat: np.ndarray,
                  probe: Optional[ProbeResult] = None) -> OnlineDecision:
        """Run the semantic probe of intermediate tier ``segment`` (>= 1)
        on its boundary activation: Eq. 8-10 against that tier's own
        centers and calibrated exit threshold.  On exit, the tier's
        centers refresh with the probe's own result (Eq. 7), exactly like
        the end device's classic exit path.  ``probe`` supplies the
        tier's fused-pass outputs in place of the recompute."""
        assert 1 <= segment <= len(self.hop_probes), \
            f"no probe calibrated for segment {segment}"
        hp = self.hop_probes[segment - 1]
        if probe is not None:
            sims, s = probe.sims, probe.sep
        else:
            sims = hp.cache.similarities(feat)
            s = separability(sims, hp.cache.counts)
        if hp.cache.n_warm >= 2 and s > hp.thresholds.s_ext:
            j = probe.best if probe is not None else int(np.argmax(sims))
            if self.update_centers:
                hp.cache.update(feat, j)
            return OnlineDecision(False, j, s, None, None,
                                  exit_hop=segment)
        return OnlineDecision(False, None, s, None,
                              hp.thresholds.required_bits(s))

    def step_cascade(self, hop_feats: Sequence[np.ndarray],
                     bandwidth_bps: Optional[float] = None,
                     probes: Optional[Sequence[Optional[ProbeResult]]]
                     = None) -> OnlineDecision:
        """Full hop-level decision cascade (SPINN-style progressive
        inference on the COACH probe): the classic end-device step first
        (exit / Eq. 11 uplink precision), then the intermediate tiers'
        probes in chain order — the first tier whose probe clears its own
        threshold terminates the task there (``exit_hop``).  The merged
        decision keeps the uplink ``bits``: a task exiting at tier k >= 1
        was still transmitted over hops ``0..k-1``.

        ``hop_feats[k]`` is the boundary activation feeding the probe at
        segment ``k``; a shorter list reuses its last entry.  ``probes``
        optionally carries one precomputed ``ProbeResult`` per segment
        (fused boundary passes); a shorter list (or ``None`` entries)
        falls back to recomputing from the features."""
        feat0 = hop_feats[0]
        p0 = probes[0] if probes else None
        dec = self.step(feat0, bandwidth_bps=bandwidth_bps, probe=p0)
        if dec.early_exit or not self.hop_probes:
            return dec
        for seg in range(1, len(self.hop_probes) + 1):
            feat = hop_feats[min(seg, len(hop_feats) - 1)]
            pk = probes[seg] if probes is not None \
                and seg < len(probes) else None
            hd = self.probe_hop(seg, feat, probe=pk)
            if hd.exit_hop is not None:
                return dataclasses.replace(
                    dec, result=hd.result, exit_hop=hd.exit_hop,
                    separability=hd.separability)
        return dec

    def report_label(self, feat: np.ndarray, label: int):
        """Cloud returned the true result: refresh the semantic center."""
        if self.update_centers:
            self.cache.update(feat, label)

    def report_label_hops(self, hop_feats: Sequence[np.ndarray], label: int,
                          upto: Optional[int] = None):
        """A result label flowed back down the chain: refresh the end
        device's centers *and* every intermediate tier's that the task
        passed (each saw its boundary activation and declined to exit).
        ``upto = k`` limits the refresh to segments ``< k`` (the tiers a
        task exiting at segment ``k`` actually crossed — the exiting
        tier itself already self-updated in ``probe_hop``); ``None``
        refreshes the whole cascade (full-pipeline task, true label)."""
        if not self.update_centers:
            return
        last = len(self.hop_probes) if upto is None \
            else min(upto - 1, len(self.hop_probes))
        if upto is None or upto > 0:
            self.cache.update(np.asarray(hop_feats[0]), label)
        for seg in range(1, last + 1):
            feat = hop_feats[min(seg, len(hop_feats) - 1)]
            self.hop_probes[seg - 1].cache.update(np.asarray(feat), label)
