"""COACH collaborative execution in PyTorch, mirroring
``repro.core.collab``: the model's group stack is split at one or more
partition points; segment 0 runs on the "end" device, each boundary
activation is UAQ-quantized (Hopper kernel), transferred over its hop as a
``WirePacket``, dequantized and continued on the next tier — the last
segment (the "cloud") finishes with norm + head.  The classic end->cloud
deployment is the single-cut case of the same machinery.

Two realizations:

  1. ``CollabRuntime`` runs ``n_hops + 1`` stage functions with an
     explicit wire format between them (one ``WirePacket`` per hop).
  2. ``make_collab_pipeline_step`` is the two-pod form: the layer groups
     split in half between two pods, a microbatched software pipeline in
     which pod 1 completes microbatch i while pod 0 computes i+1 (Fig. 2
     scheme 3), the boundary quantized (K3) on the way out and
     dequantized (K2) on the way in.  The pods are two ranks of a
     ``torch.distributed`` group, or two CUDA streams of one card
     (``PodMesh``).

``CollabRuntime``'s segment functions are ``core.jit``'ed, as the
reference ``jax.jit``s them: on the card each is one CUDA graph a shape,
and the boundary kernels (dequantize before a segment, quantize or the
fused boundary pass after it) launch between the graphs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.jit import jit
from repro_torch.kernels import ops as KOPS
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import runtime as RT


# ---------------------------------------------------------------- splitting
def split_params_multi(params, cfg: ModelConfig,
                       cut_groups: Sequence[int]) -> List[Dict]:
    """Split stacked group params at each cut in ``cut_groups`` (strictly
    increasing group indices) into ``len(cut_groups) + 1`` per-device
    segments: segment k runs groups ``[cut_{k-1}, cut_k)``.  Segment 0 owns
    the embedding; the last segment owns final norm + head (and the tied
    embedding when the head is tied).  Leaves are views, not copies."""
    cuts = list(cut_groups)
    assert all(0 < c < cfg.num_groups for c in cuts), cuts
    assert all(a < b for a, b in zip(cuts, cuts[1:])), "cuts must increase"
    bounds = [0] + cuts + [cfg.num_groups]
    segs: List[Dict] = [
        {"groups": M.group_slice(params["groups"],
                                 slice(bounds[k], bounds[k + 1]))}
        for k in range(len(bounds) - 1)]
    segs[-1]["final_norm"] = params["final_norm"]
    if "embed" in params:
        segs[0]["embed"] = params["embed"]
        if "lm_head" not in params:  # tied head lives on the cloud too
            segs[-1]["embed"] = params["embed"]
    if "lm_head" in params:
        segs[-1]["lm_head"] = params["lm_head"]
    return segs


def split_params(params, cfg: ModelConfig, cut_group: int):
    """Classic 2-device split at ``cut_group`` (end gets [0, cut))."""
    end, cloud = split_params_multi(params, cfg, (cut_group,))
    return end, cloud


# ---------------------------------------------------------------- runtime
@dataclasses.dataclass
class WirePacket:
    """Quantized boundary activation as transmitted over one hop."""
    payload: torch.Tensor  # uint8 (B,S,ceil(D*bits/8))
    scale: torch.Tensor
    zp: torch.Tensor
    bits: int
    hop: int = 0  # which link this packet crosses (0 = end's uplink)
    # true channel count when the 4-bit payload carries an odd-D
    # zero-nibble pad (None = the payload width is exact)
    channels: Optional[int] = None

    @property
    def wire_bytes(self) -> int:
        return (self.payload.numel() + self.scale.numel() * 4
                + self.zp.numel() * 4)

    def dequantize(self, out_dtype=torch.float32) -> torch.Tensor:
        return KOPS.dequantize_activation(
            self.payload, self.scale, self.zp, self.bits,
            out_dtype=out_dtype, channels=self.channels)


@dataclasses.dataclass
class BoundaryProbe:
    """Semantic-probe outputs of one fused boundary pass (Eq. 8-9 on the
    GAP feature, computed in the same read that quantized the wire
    packet).  ``best`` indexes into the ``centers`` matrix the pass was
    given (the caller's trained-center view, not the full label space)."""
    feat: torch.Tensor  # (B, D) GAP features (feeds Eq. 7 center updates)
    sep: torch.Tensor   # (B,)  task separability (Eq. 9)
    best: torch.Tensor  # (B,)  int32 argmax similarity (Eq. 10)
    sims: torch.Tensor  # (B, L) similarity degrees in [0, 1] (Eq. 8)


# per-segment forwards (the reference's ``CollabRuntime`` methods)
def _first_forward(cfg: ModelConfig, p, inputs):
    B, S = inputs.shape[:2]
    h = M._embed(p, cfg, inputs)
    return M.run_groups(p["groups"], h, cfg, M.positions_for(B, S, h.device))


def _mid_forward(cfg: ModelConfig, p, h):
    B, S = h.shape[:2]
    return M.run_groups(p["groups"], h, cfg, M.positions_for(B, S, h.device))


def _last_forward(cfg: ModelConfig, p, h):
    B, S = h.shape[:2]
    h = M.run_groups(p["groups"], h, cfg, M.positions_for(B, S, h.device))
    h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
    return M._lm_head(p, cfg, h[:, -1])


class CollabRuntime:
    """Staged executor for one model + (multi-)partition decision.

    ``cut_group`` may be a single group index (classic end->cloud split)
    or an increasing sequence of indices (end -> edge tiers -> cloud, one
    ``WirePacket`` per hop).  ``default_bits`` is likewise an int or a
    per-hop sequence.  All segments run on the device that holds
    ``params``."""

    def __init__(self, cfg: ModelConfig, params,
                 cut_group: Union[int, Sequence[int]],
                 default_bits: Union[int, Sequence[int]] = 8):
        self.cfg = cfg
        self.cuts: Tuple[int, ...] = tuple(cut_group) \
            if isinstance(cut_group, (tuple, list)) else (int(cut_group),)
        self.cut = self.cuts[0]
        bits = tuple(default_bits) \
            if isinstance(default_bits, (tuple, list)) else \
            (int(default_bits),) * self.n_hops
        assert len(bits) == self.n_hops, "need one default_bits per hop"
        self.default_bits_per_hop = bits
        self.default_bits = bits[0]
        self.p_segments = split_params_multi(params, cfg, self.cuts)
        # the jitted functions hold the config, not the runtime: a dropped
        # runtime is freed at once with its CUDA graphs, not later by the
        # cycle collector, which may run during another capture and would
        # spoil it by freeing a graph there
        first, mid, last = (jit(functools.partial(f, cfg)) for f in (
            _first_forward, _mid_forward, _last_forward))
        self._seg_fns = [first] + [mid] * (self.n_hops - 1) + [last]
        self._probe = KOPS.probe_cache

    @property
    def n_hops(self) -> int:
        return len(self.cuts)

    @property
    def n_segments(self) -> int:
        return self.n_hops + 1

    # classic 2-segment views
    @property
    def p_end(self):
        return self.p_segments[0]

    @property
    def p_cloud(self):
        return self.p_segments[-1]

    @property
    def _end_fn(self):
        return self._seg_fns[0]

    @property
    def _cloud_fn(self):
        return self._seg_fns[-1]

    def _quantize(self, h, hop: int, bits: Optional[int]) -> WirePacket:
        bits = bits or self.default_bits_per_hop[hop]
        payload, scale, zp = KOPS.quantize_activation(h, bits)
        return WirePacket(payload, scale, zp, bits, hop=hop,
                          channels=h.shape[-1])

    def segment_step(self, k: int, x, bits: Optional[int] = None,
                     centers=None):
        """Run segment ``k``.  ``x`` is the raw model input for ``k = 0``,
        else the ``WirePacket`` delivered over hop ``k-1``.  Intermediate
        segments return ``(WirePacket for hop k, boundary activation)``;
        the last segment returns the logits.

        ``centers`` (an (L, D) trained-center matrix) switches an
        intermediate segment to the *fused* boundary path: quantize +
        pack + semantic probe in a single read of the boundary activation
        (``kernels.boundary``), returning ``(WirePacket, BoundaryProbe)``
        instead — the probe outputs replace the raw activation, which the
        fused pass consumes.

        While ``obs.runtime`` records, the step is a ``segment`` span
        (argument ``k``) around the ``dequantize`` (K2), ``boundary`` (K1)
        or ``quantize`` (K3) launch and the segment's ``jit`` call."""
        rec = RT.recording()
        if rec is not None:
            rec.begin("segment", k)
        try:
            if k > 0:
                assert isinstance(x, WirePacket) and x.hop == k - 1, \
                    f"segment {k} consumes the hop-{k - 1} packet"
                if rec is not None:
                    rec.step("dequantize")
                x = x.dequantize()
                if rec is not None:
                    rec.step(None)
            h = self._seg_fns[k](self.p_segments[k], x)
            if k == self.n_hops:
                return h
            if centers is not None:
                bits = bits or self.default_bits_per_hop[k]
                if rec is not None:
                    rec.step("boundary")
                payload, scale, zp, feat, sep, best, sims = \
                    KOPS.boundary_pass(h, centers, bits)
                pkt = WirePacket(payload, scale, zp, bits, hop=k,
                                 channels=self.cfg.d_model)
                return pkt, BoundaryProbe(feat, sep, best, sims)
            if rec is not None:
                rec.step("quantize")
            return self._quantize(h, k, bits), h
        finally:
            if rec is not None:
                rec.end()

    def segment_handle(self, k: int, probe_centers=None, on_probe=None):
        """Bound per-segment callable for hop-queue workers.

        Worker ``k`` applies the handle to the payload it dequeued (the
        raw model input for ``k = 0``, else the hop-``k-1`` ``WirePacket``)
        and forwards the result: intermediate segments yield the hop-``k``
        packet, the last segment yields the logits.

        ``probe_centers`` (a zero-arg callable returning the current
        trained-center matrix for this boundary) switches intermediate
        segments to the fused single-read path; each pass's
        ``BoundaryProbe`` is delivered through ``on_probe(k, probe)`` —
        the forwarded payload stays the plain ``WirePacket`` the next
        hop-queue worker expects."""
        assert 0 <= k <= self.n_hops, k

        def handle(x, bits: Optional[int] = None):
            if probe_centers is not None and k < self.n_hops:
                pkt, probe = self.segment_step(k, x, bits=bits,
                                               centers=probe_centers())
                if on_probe is not None:
                    on_probe(k, probe)
                return pkt
            out = self.segment_step(k, x, bits=bits)
            return out[0] if isinstance(out, tuple) else out

        return handle

    # ---- stage A (end device)
    def end_step(self, inputs, bits: Optional[int] = None
                 ) -> Tuple[WirePacket, torch.Tensor]:
        """Returns (hop-0 wire packet, boundary activation pre-quant)."""
        return self.segment_step(0, inputs, bits=bits)

    def end_step_fused(self, inputs, centers, bits: Optional[int] = None
                       ) -> Tuple[WirePacket, BoundaryProbe]:
        """Fused end step: forward + quantize + pack + semantic probe
        with a single read of the boundary activation.  Returns the hop-0
        wire packet and the probe outputs (GAP feature included), instead
        of the raw activation the classic ``end_step`` hands back for a
        second probe read."""
        return self.segment_step(0, inputs, bits=bits, centers=centers)

    def probe(self, h, centers):
        """Fused GAP+cosine+separability on the boundary activation."""
        return self._probe(h, centers)

    # ---- stage B (cloud / last segment); for multi-cut runtimes this
    # relays the packet through the remaining tiers.
    def cloud_step(self, packet: WirePacket) -> torch.Tensor:
        out = packet
        for k in range(packet.hop + 1, self.n_segments):
            out = self.segment_step(k, out)
            if isinstance(out, tuple):
                out = out[0]
        return out

    def run(self, inputs, bits: Optional[Sequence[Optional[int]]] = None):
        """Full multi-hop forward: returns (logits, per-hop packets)."""
        bits = tuple(bits) if bits is not None else (None,) * self.n_hops
        assert len(bits) == self.n_hops
        packets: List[WirePacket] = []
        pkt, _ = self.segment_step(0, inputs, bits=bits[0])
        packets.append(pkt)
        for k in range(1, self.n_hops):
            pkt, _ = self.segment_step(k, pkt, bits=bits[k])
            packets.append(pkt)
        logits = self.segment_step(self.n_segments - 1, pkt)
        return logits, packets

    # ---- reference: monolithic forward (accuracy-loss measurement)
    def monolithic(self, params, inputs):
        h, _, _ = M.forward(params, self.cfg, inputs)
        return M._lm_head(params, self.cfg, h[:, -1])


# ------------------------------------------------------- two-pod pipeline
@dataclasses.dataclass(frozen=True)
class PodMesh:
    """The two pods of ``make_collab_pipeline_step``: pod 0 (the end) runs
    the first half of the layer groups, pod 1 (the cloud) the second.

    * ``PodMesh(rank=r)``: this process is pod ``r`` (rank ``r``) of a
      ``torch.distributed`` world of 2.  Pod 0 sends each packet's
      payload, scale and zp to pod 1, and an ``all_reduce`` (sum) stands
      in for the reference's ``psum``; both ranks return the logits.
    * ``PodMesh.on_card(device)``: both pods in this process, each on a
      CUDA stream of its own; a packet goes from pod 0's stream to pod 1's
      on an event, so pod 0's tick t+1 runs beside pod 1's tick t.
      ``overlap=False`` puts both pods on the current stream, one after
      the other (the same function, serialized).  ``core.jit`` of the
      two-stream step (as the reference test jits its step) captures
      both streams in one CUDA graph: they fork from the capture stream
      and join it again, and the packets' events are recorded in the
      graph."""
    rank: Optional[int] = None
    streams: Optional[Tuple[Any, Any]] = None

    @staticmethod
    def on_card(device="cuda", overlap: bool = True) -> "PodMesh":
        if overlap:
            return PodMesh(streams=(torch.cuda.Stream(device),
                                    torch.cuda.Stream(device)))
        s = torch.cuda.current_stream(device)
        return PodMesh(streams=(s, s))


def make_collab_pipeline_step(cfg: ModelConfig, mesh: PodMesh, *,
                              bits: int = 8, n_micro: int = 2,
                              use_kernel: bool = True):
    """Two-pod software pipeline (``repro.core.collab``'s SPMD step).

    ``step(params, tokens)`` takes the whole parameter tree and tokens
    (n_micro, B_mb, S) int32 (or embeds (..., D)) and returns the logits
    of each microbatch's last token, (n_micro, B_mb, V).  On tick t of
    ``n_micro + 1`` pod 0 embeds microbatch t and runs its groups, the
    boundary is quantized (``wire_quantize``: K3 at 4 or 8 bits) and
    handed to pod 1, which dequantizes it into the params' dtype
    (``wire_dequantize``: K2) and runs its groups on it; at the end the
    final norm and the head run on pod 1's outputs.  The reference also
    runs the two ticks whose results it throws away (pod 1 on zeros at
    tick 0, pod 0 repeating the last microbatch at tick ``n_micro``);
    they are skipped here, and the outputs are the reference's.
    ``use_kernel=False`` runs the plain versions of K3 and K2."""
    if cfg.num_groups % 2:
        raise ValueError(f"num_groups={cfg.num_groups}: the two pods each "
                         f"take half of the groups, so it must be even")
    half = cfg.num_groups // 2
    D = cfg.d_model

    def pod_fwd(params, pod, h):
        groups = M.group_slice(params["groups"],
                               slice(pod * half, (pod + 1) * half))
        B, S = h.shape[:2]
        return M.run_groups(groups, h, cfg, M.positions_for(B, S, h.device))

    def send(params, tok, dt):
        """Pod 0's tick: (payload, scale, zp) of the boundary."""
        h = pod_fwd(params, 0, M._embed(params, cfg, tok).to(dt))
        return KOPS.wire_quantize(h.reshape(-1, D), bits,
                                  use_kernel=use_kernel)

    def receive(params, packet, dt, shape):
        """Pod 1's tick on a packet: its groups' output."""
        h = KOPS.wire_dequantize(*packet, bits, out_dtype=dt, channels=D,
                                 use_kernel=use_kernel).reshape(shape)
        return pod_fwd(params, 1, h)

    def head(params, outs):
        h = L.rms_norm(outs, params["final_norm"], cfg.norm_eps)
        return M._lm_head(params, cfg, h[:, :, -1])

    def step_distributed(params, tokens):
        dt = params["groups"][0]["norm1"]["scale"].dtype
        B, S = tokens.shape[1], tokens.shape[2]
        if mesh.rank == 0:
            for t in range(n_micro):
                for x in send(params, tokens[t], dt):
                    dist.send(x.contiguous(), 1)
            outs = torch.zeros((n_micro, B, S, D), dtype=dt,
                               device=tokens.device)
        else:
            P = (D + 1) // 2 if bits == 4 else D
            outs = []
            for t in range(n_micro):
                packet = (torch.empty((B * S, P), dtype=torch.uint8),
                          torch.empty((B * S, 1)), torch.empty((B * S, 1)))
                for x in packet:
                    dist.recv(x, 0)
                outs.append(receive(params, packet, dt, (B, S, D)))
            outs = torch.stack(outs)
        dist.all_reduce(outs, op=dist.ReduceOp.SUM)
        return head(params, outs)

    def step_on_card(params, tokens):
        dt = params["groups"][0]["norm1"]["scale"].dtype
        B, S = tokens.shape[1], tokens.shape[2]
        main = torch.cuda.current_stream(tokens.device)
        s0, s1 = mesh.streams
        s0.wait_stream(main)
        s1.wait_stream(main)
        outs = []
        for t in range(n_micro):
            with torch.cuda.stream(s0):
                packet = send(params, tokens[t], dt)
                ready = torch.cuda.Event()
                ready.record(s0)
            with torch.cuda.stream(s1):
                s1.wait_event(ready)
                # made on pod 0's stream, read on pod 1's: the allocator
                # must not hand their memory out again before s1 is done
                for x in packet:
                    x.record_stream(s1)
                outs.append(receive(params, packet, dt, (B, S, D)))
        with torch.cuda.stream(s1):
            logits = head(params, torch.stack(outs))
        main.wait_stream(s0)
        main.wait_stream(s1)
        logits.record_stream(main)
        return logits

    return step_on_card if mesh.streams is not None else step_distributed
