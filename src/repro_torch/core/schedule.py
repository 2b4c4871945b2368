"""Single-task stage-time evaluation (grounds Eq. 2-5 in an executable
event semantics).

Given a partition — classically an end set + per-boundary-edge quant bits,
generally an ordered multi-cut over ``n_hops + 1`` devices — simulate one
task through the alternating compute/link resources of
``repro_torch.core.sim`` and extract the paper's quantities:

  T_e, T_t, T_c        stage busy times (Eq. 2); per-hop in ``compute``/``link``
  T_t_par              transmission overlapped with upstream compute (Fig. 4)
  T_c_par              downstream compute overlapped with transmission
  B_c, B_t             bubble functions (Eq. 5), summed over hops

The classic end->link->cloud evaluation (``evaluate_partition``) is the
``n_hops = 1`` case of ``evaluate_multihop``; both delegate to the shared
event core in ``repro_torch.core.sim``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Sequence, Tuple

from repro_torch.core import sim
from repro_torch.core.costs import DeviceProfile, LinkProfile, ModelGraph

Edge = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class PartitionDecision:
    """A partition of the model DAG across ``n_hops + 1`` devices.

    The classic 2-device form sets ``end_set``/``bits`` only.  The general
    form is an ordered multi-cut: ``frontiers`` is a nested chain of
    downward-closed node sets ``F_1 ⊆ F_2 ⊆ ...`` (device ``k`` runs
    ``F_{k+1} - F_k``; the last device runs the rest), and ``hop_bits[k]``
    holds the quantization precision of every boundary tensor crossing
    link ``k``.  ``end_set``/``bits`` always mirror the first frontier/hop
    for backward compatibility."""
    end_set: FrozenSet[int]
    bits: Dict[Edge, int]  # quantization precision per hop-0 boundary edge
    name: str = "coach"
    frontiers: Tuple[FrozenSet[int], ...] = ()
    hop_bits: Tuple[Dict[Edge, int], ...] = ()

    @classmethod
    def multihop(cls, frontiers: Sequence[FrozenSet[int]],
                 hop_bits: Sequence[Dict[Edge, int]],
                 name: str = "coach") -> "PartitionDecision":
        frontiers = tuple(frozenset(f) for f in frontiers)
        hop_bits = tuple(dict(b) for b in hop_bits)
        assert len(frontiers) == len(hop_bits) >= 1
        return cls(end_set=frontiers[0], bits=hop_bits[0], name=name,
                   frontiers=frontiers, hop_bits=hop_bits)

    @property
    def cuts(self) -> Tuple[FrozenSet[int], ...]:
        return self.frontiers if self.frontiers else (self.end_set,)

    @property
    def all_hop_bits(self) -> Tuple[Dict[Edge, int], ...]:
        return self.hop_bits if self.hop_bits else (self.bits,)

    @property
    def n_hops(self) -> int:
        return len(self.cuts)

    def segments(self, graph: ModelGraph) -> List[frozenset]:
        """Ordered per-device node sets (length ``n_hops + 1``)."""
        cuts = self.cuts
        segs, prev = [], frozenset()
        for f in cuts:
            assert prev <= f, "frontiers not nested"
            segs.append(f - prev)
            prev = f
        segs.append(frozenset(n.id for n in graph.nodes) - prev)
        return segs

    def boundary_bits_total(self, graph: ModelGraph) -> float:
        total = 0.0
        for (u, v), b in self.bits.items():
            elems = graph.node(v).out_elems if u < 0 else graph.node(u).out_elems
            total += elems * b
        return total


@dataclasses.dataclass
class StageTimes:
    """Stage busy times / overlaps of one simulated task.

    The first eight fields are the classic 3-resource view (and remain
    exact for ``n_hops = 1``); the tuple fields carry the generalized
    per-resource view.  For multi-hop timelines ``T_t`` is the total link
    busy time and ``T_c`` the last (cloud) segment."""
    T_e: float
    T_t: float
    T_c: float
    T_t_par: float
    T_c_par: float
    latency: float           # single-task end-to-end
    first_tx_offset: float   # end-start -> first boundary tensor ready
    cloud_start_offset: float  # first tx start -> cloud can begin
    # ---- generalized N-hop view (empty tuples => classic 2-segment case)
    compute: Tuple[float, ...] = ()
    link: Tuple[float, ...] = ()
    link_par: Tuple[float, ...] = ()
    compute_par: Tuple[float, ...] = ()
    tx_offsets: Tuple[float, ...] = ()   # per hop, relative to its segment start
    rx_offsets: Tuple[float, ...] = ()   # per hop, relative to its tx start

    def __post_init__(self):
        if not self.compute:
            self.compute = (self.T_e, self.T_c)
            self.link = (self.T_t,)
            self.link_par = (self.T_t_par,)
            self.compute_par = (self.T_c_par,)
            self.tx_offsets = (self.first_tx_offset,)
            self.rx_offsets = (self.cloud_start_offset,)

    @classmethod
    def from_timeline(cls, tl: sim.TaskTimeline) -> "StageTimes":
        tx_rel = tuple(max(0.0, tl.first_tx[k] - tl.seg_start[k])
                       for k in range(tl.n_hops))
        rx_rel = tuple(max(0.0, tl.next_start[k] - tl.first_tx[k])
                       for k in range(tl.n_hops))
        return cls(
            T_e=tl.compute_busy[0], T_t=sum(tl.link_busy),
            T_c=tl.compute_busy[-1],
            T_t_par=sum(tl.link_par), T_c_par=sum(tl.compute_par),
            latency=tl.latency,
            first_tx_offset=tl.first_tx[0],
            cloud_start_offset=rx_rel[0],
            compute=tl.compute_busy, link=tl.link_busy,
            link_par=tl.link_par, compute_par=tl.compute_par,
            tx_offsets=tx_rel, rx_offsets=rx_rel)

    @property
    def n_hops(self) -> int:
        return len(self.link)

    @property
    def B_c(self) -> float:
        """Eq. 5 compute bubble, summed over adjacent compute pairs."""
        return sum(abs(self.compute[k] - self.compute[k + 1])
                   for k in range(self.n_hops))

    @property
    def B_t(self) -> float:
        """Eq. 5 transmission bubble, per hop against its effective ceiling."""
        tot = 0.0
        for k in range(self.n_hops):
            m = max(self.compute[k],
                    self.link[k] - self.link_par[k],
                    self.compute[k + 1] - self.compute_par[k])
            tot += abs(self.link[k] - m)
        return tot

    @property
    def max_stage(self) -> float:
        return max(self.compute + self.link)

    @property
    def stage_sum(self) -> float:
        """Serial sum of all stage times (Eq. 3 latency budget input)."""
        return sum(self.compute) + sum(self.link)

    def objective(self) -> float:
        """Eq. 6: B_c + B_t + max stage (bubble sums over hops)."""
        return self.B_c + self.B_t + self.max_stage

    def satisfies_parallel_constraint(self) -> bool:
        """Eq. 4 per hop (tolerance for float noise)."""
        m = self.max_stage * (1 + 1e-9)
        return all(self.link_par[k] + self.compute_par[k] <= m
                   for k in range(self.n_hops))


def evaluate_multihop(graph: ModelGraph, decision: PartitionDecision,
                      devices: Sequence[DeviceProfile],
                      links: Sequence[LinkProfile],
                      input_bits_per_elem: int = 8) -> StageTimes:
    """Simulate one task through an ordered multi-cut partition over
    ``len(links) + 1`` devices (shared event core: ``repro_torch.core.sim``)."""
    cuts = decision.cuts
    assert len(links) == len(cuts), \
        f"decision has {len(cuts)} hops but {len(links)} links given"
    assert len(devices) == len(links) + 1
    prev = frozenset()
    for f in cuts:
        assert graph.valid_end_set(f), "frontier not downward-closed"
        assert prev <= f, "frontiers not nested"
        prev = f
    segments = decision.segments(graph)
    tl = sim.simulate_partitioned_task(
        graph, segments, decision.all_hop_bits, devices, links,
        input_bits_per_elem=input_bits_per_elem)
    return StageTimes.from_timeline(tl)


def evaluate_partition(graph: ModelGraph, decision: PartitionDecision,
                       end_dev: DeviceProfile, cloud_dev: DeviceProfile,
                       link: LinkProfile,
                       input_bits_per_elem: int = 8) -> StageTimes:
    """Classic end->link->cloud evaluation: ``n_hops = 1`` of the general
    machinery."""
    assert decision.n_hops == 1, "multi-cut decision needs evaluate_multihop"
    return evaluate_multihop(graph, decision, (end_dev, cloud_dev), (link,),
                             input_bits_per_elem=input_bits_per_elem)
