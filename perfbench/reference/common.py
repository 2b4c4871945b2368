"""The parts of the served split that every architecture shares, written
out plainly: RMSNorm, the embedding and the head, the boundary's
row-wise uniform quantization (UAQ) and its int4 packing, the GAP
feature and the semantic probe (the paper's Eq. 8-10), and the online
scheduler (semantic cache with running-mean centers, Eq. 7; the
calibrated exit and precision thresholds; early exit; Eq. 11's choice
of bits)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

BIT_LEVELS = (3, 4, 5, 6, 8)            # calibrated precisions
CHOICE_LEVELS = (3, 4, 5, 6, 8, 12, 16)  # Eq. 11's candidates
EXIT_EPS = 0.005                        # exit error budget
MAX_COUNT = 16                          # sliding window of Eq. 7


def rms_norm(x, w, eps):
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * w.to(torch.float32)).to(x.dtype)


def head(params, model, h, dtype):
    """Final norm, then the head of the last token: (B, V) float32."""
    h = rms_norm(h[:, -1], params["final_norm"]["scale"], model["norm_eps"])
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return (h @ w.to(dtype)).to(torch.float32)


def embed(params, tokens, dtype):
    return params["embed"].to(dtype)[tokens.long()]


# ------------------------------------------------------------- the wire
def quantize(h, bits):
    """(M, N) -> (payload (M, N or ceil(N/2)) uint8, scale (M, 1),
    zp (M, 1)), all arithmetic in float32: each row mapped onto
    [0, 2**bits - 1] by its own min and max."""
    qmax = (1 << bits) - 1
    x = h.to(torch.float32)
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-8) * (1.0 / qmax)
    zp = torch.round(-lo / scale)
    q = torch.clamp(torch.round(x / scale + zp), 0, qmax).to(torch.uint8)
    if bits == 4:
        if q.shape[1] % 2:
            q = F.pad(q, (0, 1))
        q = q[:, 0::2] | (q[:, 1::2] << 4)
    return q, scale, zp


def dequantize(payload, scale, zp, bits, n):
    q = payload
    if bits == 4:
        q = torch.stack([q & 0xF, q >> 4], dim=-1).reshape(q.shape[0], -1)
    return (q[:, :n].to(torch.float32) - zp) * scale


def gap(h):
    """(B, S, D) -> (B, D) float32: sum over the tokens, then / S."""
    return torch.sum(h.to(torch.float32), dim=1) / h.shape[1]


def probe(feat, centers, dtype=torch.float32):
    """Eq. 8-9 of one GAP feature against the trained centers, computed
    in ``dtype``: (sims in [0, 1], separability, best index)."""
    f = torch.as_tensor(feat).to(dtype)
    c = torch.as_tensor(centers).to(dtype)
    fn = f / torch.clamp(torch.sqrt(torch.sum(f * f)), min=1e-12)
    cn = c / torch.clamp(torch.sqrt(torch.sum(c * c, dim=1, keepdim=True)),
                         min=1e-12)
    sims = (cn @ fn + 1.0) * 0.5
    best = int(torch.argmax(sims))
    t_h = sims[best]
    rest = torch.cat([sims[:best], sims[best + 1:]])
    t_sh = torch.max(rest) if len(rest) else torch.tensor(-math.inf)
    sep = torch.sqrt(torch.sum(sims * sims)) * (t_h - t_sh) * t_h \
        / torch.clamp(t_sh, min=1e-12)
    return sims.to(torch.float64).numpy(), float(sep), best


# ------------------------------------------------------------ scheduler
class Scheduler:
    """The online component on the end device, in float64 NumPy."""

    def __init__(self, n_labels, calib_feats, calib_labels, elems, t_e, t_c,
                 bandwidth_bps):
        dim = calib_feats.shape[1]
        self.n_labels = n_labels
        self.centers = np.zeros((n_labels, dim))
        self.counts = np.zeros(n_labels, np.int64)
        for f, y in zip(calib_feats, calib_labels):
            self.update(f, int(y))
        self.elems, self.t_e, self.t_c = elems, t_e, t_c
        self.bw = bandwidth_bps
        seps, right = [], []
        for f, y in zip(calib_feats, calib_labels):
            sims = self._sims(f)
            seps.append(self._sep(sims[self.counts > 0]))
            right.append(int(np.argmax(sims)) == int(y))
        seps, right = np.asarray(seps), np.asarray(right)
        order = np.argsort(-seps)
        errs = np.cumsum(~right[order])
        self.s_ext = math.inf
        for k in range(len(order), 0, -1):
            if errs[k - 1] <= EXIT_EPS * k:
                self.s_ext = float(seps[order[k - 1]])
                break
        qs = np.quantile(seps, np.linspace(0.9, 0.1, len(BIT_LEVELS)))
        self.floors = [(float(q), b) for q, b in zip(qs, BIT_LEVELS)]

    def update(self, f, label):
        m = min(self.counts[label], MAX_COUNT)
        self.centers[label] = (m * self.centers[label] + f) / (m + 1)
        self.counts[label] += 1

    def _sims(self, f):
        sims = np.zeros(self.n_labels)
        v = self.counts > 0
        a, c = f[None], self.centers[v]
        cos = (a @ c.T) / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True)
                                     * np.linalg.norm(c, axis=-1), 1e-12)
        sims[v] = (cos[0] + 1.0) / 2.0
        return sims

    @staticmethod
    def _sep(sims):
        if len(sims) < 2:
            return 0.0
        t = np.sort(sims)[::-1]
        return float(np.linalg.norm(sims) * (t[0] - t[1]) * t[0]
                     / max(t[1], 1e-12))

    def trained(self):
        """(trained centers, their labels)."""
        valid = np.flatnonzero(self.counts > 0)
        return self.centers[valid], valid

    def bits_for(self, required):
        target = max(self.t_e, self.t_c)
        best = None
        for b in CHOICE_LEVELS:
            if b < required:
                continue
            t = self.elems * b / self.bw
            key = (abs(t - target), t > target, -b)
            if best is None or key < best[0]:
                best = (key, b)
        return best[1]

    def serve(self, feat, sep, best_label, n_valid, label):
        """One task's decision from its probe, and the cache's update:
        (exit, bits); bits 0 on exit."""
        if n_valid < 2:
            sep = 0.0
        if np.count_nonzero(self.counts) >= 2 and sep > self.s_ext:
            self.update(feat, best_label)
            return True, 0
        required = next((b for floor, b in self.floors if sep >= floor), 8)
        bits = self.bits_for(required)
        self.update(feat, label)
        return False, bits
