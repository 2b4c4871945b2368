"""The paper's four baselines, implemented on the same cost substrate and
scored by the same event simulator — so Table I / Figs. 5-7 comparisons are
apples-to-apples.

  NS    (Neurosurgeon [5])  min single-task latency, chain cut, no quant.
  DADS  [2]                 min-cut style partition for pipeline load,
                            optimizes max(T_e, T_c); no quantization.
  SPINN [25]                partition + fixed 8-bit quantization + early
                            exit at a fixed confidence threshold.
  JPS   [10]                layer-level pipeline schedule balancing the end
                            computation and transmission stages (cloud stage
                            neglected — the paper's critique of it).

Every baseline is expressed over the generalized multi-hop machinery
(``baseline_multihop``): the classic 2-device form is the ``n_hops = 1``
case, and the same selection criteria extend to end->edge->cloud chains
(each baseline sweeps ordered multi-cut tuples with its own objective).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.core.costs import DeviceProfile, LinkProfile, ModelGraph
from repro_torch.core.partitioner import (chain_flow, chain_prefixes,
                                    strided_positions)
from repro_torch.core.schedule import (PartitionDecision, StageTimes,
                                 evaluate_multihop, evaluate_partition)


@dataclasses.dataclass
class BaselineResult:
    decision: PartitionDecision
    times: StageTimes
    extra: Dict = dataclasses.field(default_factory=dict)


def _eval_multi(graph, frontiers: Sequence[frozenset], bits_all: int,
                devices, links, name: str):
    hop_bits = [{e: bits_all for e in graph.boundary_edges(f) if e[0] >= 0}
                for f in frontiers]
    dec = PartitionDecision.multihop(frontiers, hop_bits, name=name)
    return dec, evaluate_multihop(graph, dec, devices, links)


# selection key per baseline: smaller is better, evaluated per candidate.
# JPS balances every stage *except* the cloud (the paper's critique).
_CRITERIA: Dict[str, Tuple[int, Callable[[StageTimes], tuple], bool]] = {
    # name -> (wire bits, key fn, require non-empty end segment)
    "ns": (32, lambda st: (st.latency,), False),
    "dads": (32, lambda st: (st.max_stage, st.latency), False),
    "spinn": (8, lambda st: (st.latency,), True),
    "jps": (8, lambda st: (max(st.compute[:-1] + st.link), st.latency),
            False),
}


def baseline_multihop(name: str, graph: ModelGraph,
                      devices: Sequence[DeviceProfile],
                      links: Sequence[LinkProfile],
                      chain_stride: int = 1) -> BaselineResult:
    """Run one baseline's selection rule over ordered multi-cut chains on
    an ``len(links)``-hop deployment (shared event core)."""
    tag = name.lower()
    bits, key_fn, nonempty = _CRITERIA[tag]
    n_hops = len(links)
    assert len(devices) == n_hops + 1
    prefixes = chain_prefixes(graph)
    positions = strided_positions(len(prefixes), chain_stride)
    best = None
    for combo in itertools.combinations_with_replacement(positions, n_hops):
        frontiers = [frozenset(prefixes[i]) for i in combo]
        if nonempty and not frontiers[0]:
            continue
        dec, st = _eval_multi(graph, frontiers, bits, devices, links, tag)
        key = key_fn(st)
        if best is None or key < best[2]:
            best = (dec, st, key)
    return BaselineResult(best[0], best[1])


def neurosurgeon(graph: ModelGraph, end_dev: DeviceProfile,
                 cloud_dev: DeviceProfile, link: LinkProfile) -> BaselineResult:
    """Min end-to-end single-task latency; fp32 transfers."""
    return baseline_multihop("ns", graph, (end_dev, cloud_dev), (link,))


def dads(graph: ModelGraph, end_dev, cloud_dev, link) -> BaselineResult:
    """Heavy-load mode: min max stage (pipeline throughput) over all three
    stages, fp32 transfers (no quantization), latency tie-break."""
    return baseline_multihop("dads", graph, (end_dev, cloud_dev), (link,))


def spinn(graph: ModelGraph, end_dev, cloud_dev, link,
          exit_ratio_hint: float = 0.0) -> BaselineResult:
    """Latency-min partition with fixed 8-bit quantization; early exit at a
    fixed threshold (its exit ratio is data-dependent and supplied by the
    driver as ``exit_ratio_hint``).  Progressive device-first inference =>
    non-empty end segment."""
    r = baseline_multihop("spinn", graph, (end_dev, cloud_dev), (link,))
    return BaselineResult(r.decision, r.times,
                          {"exit_ratio": exit_ratio_hint})


def jps(graph: ModelGraph, end_dev, cloud_dev, link) -> BaselineResult:
    """Near-optimal end/transmission pipeline schedule: min max(T_e, T_t)
    with 8-bit transfers; the cloud stage is not balanced (per the paper's
    critique, it may become the pipeline bottleneck)."""
    return baseline_multihop("jps", graph, (end_dev, cloud_dev), (link,))


BASELINES = {
    "NS": neurosurgeon,
    "DADS": dads,
    "SPINN": spinn,
    "JPS": jps,
}
