"""Batched incremental scorer for the offline planner (pure speedup).

``partitioner.coach_offline_multihop`` sweeps ordered multi-cut tuples
over the chain flow, and historically paid a full Python event
simulation (``sim.simulate_partitioned_task``) — times the 5-level relax
ladder — for *every* candidate, plus a fresh dichotomous quantization
search per frontier per tuple.  This module makes candidate evaluation
O(boundary events) arithmetic instead of O(graph) simulation while
keeping the event simulator as ground truth:

``build_tables``
    Precomputes, once per (graph, devices, links, eps): per-device
    cumulative compute times over the chain prefixes (numpy prefix
    sums), the boundary-edge set of every chain-cut position with
    per-relax-level bit volumes (each producer's Eq. 1 minimum priced
    once, via the caller's memoized dichotomous search), and the
    *serial-cut* flags of the vectorized fast path.

``chain_sweep`` / ``chain_shortlist``
    Score **all** chain-cut tuples at once: numpy prefix-sum lookups
    give every (tuple, relax level) its per-segment compute busy,
    per-hop link busy, compute bubble ``B_c``, ``max_stage`` and the
    Eq. 3 stage-time sum.  Tuples whose cuts are provably serial (a
    single tail→head boundary tensor per hop, so no Fig. 4 overlap) get
    exact objectives fully vectorized; the rest replay only their
    boundary events — gate stalls, FIFO transfers, overlap windows — in
    O(edges) per candidate (``_replay_chain``).

``stage_times_chain`` / ``stage_times_frontiers``
    Exact fast evaluation of a single candidate: reproduces
    ``schedule.evaluate_multihop`` field-for-field at 1e-9
    (differentially pinned by ``tests/test_plan_fast.py``).  The
    frontier form accepts arbitrary nested downward-closed cuts (block
    recursion refinement, brute force) and explicit per-hop bit maps.

The planner rescores the shortlisted top-K candidates with the real
event simulator and returns *that* argmin, so the fast path is a pure
speedup: the chosen ``PartitionDecision`` and objective are identical
to the naive per-candidate simulation search (argmin-equality tested).

Links carrying a bandwidth *trace* are first-class: every boundary
transfer is re-priced at its actual start instant through
``LinkProfile.transfer_time`` inside the sparse replay — exactly the
event simulator's integration — so ``stage_times_chain`` /
``stage_times_frontiers`` stay trace-exact.  The vectorized closed
forms of ``chain_sweep`` are only valid at constant bandwidth, so a
traced sweep scores every candidate through the replay instead
(exhaustive and exact, hence the shortlist trivially contains the
naive argmin).  ``retime_tables`` rebinds existing tables to new link
profiles without re-running the Eq. 1 pricing — the warm-start used by
online re-planning (``repro_torch.scenarios.replan``).
"""

from __future__ import annotations

import dataclasses
import itertools
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import sim
from repro_torch.core.costs import DeviceProfile, LinkProfile, ModelGraph
from repro_torch.core.schedule import Edge, StageTimes

#: Relax ladder of the offline search: the Eq. 1 minimum plus the extra
#: precision trials of ``partitioner._relax_bits`` (kept in lockstep).
RELAX_EXTRAS: Tuple[int, ...] = (0, 1, 2, 4, 8)
HI_BITS = 16
#: Relative tolerance of ``_relax_bits``'s pipeline-ceiling acceptance.
CEIL_TOL = 1e-9

#: Per-hop pricer type: (bit volume, start instant) -> transfer duration.
HopPricer = Callable[[float, float], float]


def _hop_pricers(links: Sequence[LinkProfile]
                 ) -> Optional[List[Optional[HopPricer]]]:
    """Per-hop start-time pricers for traced links; ``None`` when every
    hop is constant-bandwidth (the vectorized closed forms apply)."""
    if all(lk.trace is None for lk in links):
        return None
    return [(lambda vol, start, lk=lk: lk.transfer_time(vol, start))
            if lk.trace is not None else None
            for lk in links]


# ==================================================================== tables
@dataclasses.dataclass
class PlannerTables:
    """Precomputed per-(graph, devices, links, eps) scoring substrate."""
    graph: ModelGraph
    devices: Tuple[DeviceProfile, ...]
    links: Tuple[LinkProfile, ...]
    input_bits_per_elem: int
    dt: np.ndarray         # [n_dev, V] per-node compute time per device
    cum: np.ndarray        # [n_dev, V+1] cumulative node time per device (id order)
    bw: Tuple[float, ...]  # per-hop bandwidth (bits/s)
    node_bits: Callable[[int], int]  # Eq. 1 minimal precision of a producer
    # global edge table: graph edges + raw-input pseudo edges (-1, v)
    edge_u: np.ndarray     # [E] producer id (-1 = raw model input)
    edge_v: np.ndarray     # [E] consumer id
    edge_elems: np.ndarray  # [E] elements carried by the edge
    edge_vol: np.ndarray   # [L, E] bit volume per relax level (elems * bits);
                           # priced lazily — see ``ensure_priced``
    priced: np.ndarray     # [E] bool: edge_vol column is valid
    # chain-cut structure (None when built without chain prefixes)
    pref_cnt: Optional[np.ndarray] = None      # [P] ids in each chain prefix
    pos_edges: Optional[List[list]] = None     # [P] -> [(u, v, vols tuple)]
    pos_vol: Optional[np.ndarray] = None       # [L, P] total crossing volume
    pos_has_bits: Optional[np.ndarray] = None  # [P] any quantized (u>=0) edge
    pos_serial: Optional[np.ndarray] = None    # [P] single tail->head edge
    # per-hop start-time pricers (None everywhere constant-bandwidth)
    hop_price: Optional[List[Optional[HopPricer]]] = None

    @property
    def n_hops(self) -> int:
        return len(self.links)

    def ensure_priced(self, idx: np.ndarray) -> None:
        """Run the (possibly expensive) Eq. 1 oracle search only for the
        producers of edges a candidate actually exposes — edges that never
        cross a swept cut never pay for it (matching the naive search's
        on-demand quantization)."""
        for i in idx:
            if self.priced[i]:
                continue
            u = int(self.edge_u[i])
            if u < 0:
                bits = float(self.input_bits_per_elem)
                self.edge_vol[:, i] = self.edge_elems[i] * bits
            else:
                b = self.node_bits(u)
                for li, extra in enumerate(RELAX_EXTRAS):
                    self.edge_vol[li, i] = self.edge_elems[i] \
                        * min(HI_BITS, b + extra)
            self.priced[i] = True


def graph_edges(graph: ModelGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All data edges incl. raw-input pseudo edges, as (u, v, elems) arrays
    (mirrors the per-edge arrival bookkeeping of the event simulator)."""
    eu: List[int] = []
    ev: List[int] = []
    elems: List[float] = []
    for n in graph.nodes:
        if n.deps:
            for d in n.deps:
                eu.append(d)
                ev.append(n.id)
                elems.append(float(graph.node(d).out_elems))
        else:
            eu.append(-1)
            ev.append(n.id)
            elems.append(float(graph.input_elems))
    return (np.asarray(eu, dtype=np.int64), np.asarray(ev, dtype=np.int64),
            np.asarray(elems, dtype=np.float64))


def build_tables(graph: ModelGraph, devices: Sequence[DeviceProfile],
                 links: Sequence[LinkProfile],
                 node_bits: Callable[[int], int],
                 pref_counts: Optional[Sequence[int]] = None,
                 input_bits_per_elem: int = 8) -> PlannerTables:
    """``node_bits(u)`` must return the Eq. 1 minimal precision of node
    ``u``'s output (the planner passes its memoized dichotomous search —
    boundary bits depend only on the producer, so each node is priced
    exactly once across every frontier that exposes it)."""
    n_dev = len(devices)
    assert n_dev == len(links) + 1
    dt = np.array([[d.layer_time(n.flops, n.util) for n in graph.nodes]
                   for d in devices], dtype=np.float64)
    cum = np.zeros((n_dev, len(graph) + 1))
    np.cumsum(dt, axis=1, out=cum[:, 1:])

    eu, ev, elems = graph_edges(graph)
    n_lvl = len(RELAX_EXTRAS)
    tables = PlannerTables(
        graph=graph, devices=tuple(devices), links=tuple(links),
        input_bits_per_elem=input_bits_per_elem, dt=dt, cum=cum,
        bw=tuple(lk.bandwidth_bps for lk in links), node_bits=node_bits,
        edge_u=eu, edge_v=ev, edge_elems=elems,
        edge_vol=np.zeros((n_lvl, len(eu))),
        priced=np.zeros(len(eu), dtype=bool),
        hop_price=_hop_pricers(links))

    if pref_counts is not None:
        pref_cnt = np.asarray(pref_counts, dtype=np.int64)
        n_pos = len(pref_cnt)
        pos_edges: List[list] = []
        pos_vol = np.zeros((n_lvl, n_pos))
        pos_has = np.zeros(n_pos, dtype=bool)
        pos_serial = np.zeros(n_pos, dtype=bool)
        for p in range(n_pos):
            cnt = int(pref_cnt[p])
            mask = (eu < cnt) & (ev >= cnt)
            idx = np.nonzero(mask)[0]
            order = np.lexsort((ev[idx], eu[idx]))
            idx = idx[order]
            tables.ensure_priced(idx)  # only grid-crossing edges pay Eq. 1
            pos_edges.append([(int(eu[i]), int(ev[i]),
                               tuple(tables.edge_vol[:, i])) for i in idx])
            pos_vol[:, p] = tables.edge_vol[:, idx].sum(axis=1)
            pos_has[p] = bool((eu[idx] >= 0).any())
            pos_serial[p] = (len(idx) == 1 and int(eu[idx[0]]) == cnt - 1
                             and int(ev[idx[0]]) == cnt)
        tables.pref_cnt = pref_cnt
        tables.pos_edges = pos_edges
        tables.pos_vol = pos_vol
        tables.pos_has_bits = pos_has
        tables.pos_serial = pos_serial
    return tables


def retime_tables(tables: PlannerTables,
                  links: Sequence[LinkProfile]) -> PlannerTables:
    """Rebind existing tables to new link profiles (warm start).

    Everything bandwidth-independent is shared by reference: the compute
    prefix sums, the chain-cut structure and the Eq. 1 edge *volumes*
    (``edge_vol`` is bits — pricing an edge under one link set prices it
    for all).  Only the per-hop bandwidths and traced-link pricers are
    replaced, so an online re-plan after a regime shift skips the whole
    oracle/table build (``repro_torch.scenarios.replan``).
    """
    assert len(links) == len(tables.links), \
        "retimed links must keep the hop count"
    return dataclasses.replace(
        tables, links=tuple(links),
        bw=tuple(lk.bandwidth_bps for lk in links),
        hop_price=_hop_pricers(links))


# ============================================================= event replay
# replay interval lists are sorted & disjoint by construction, so the
# simulator's merge scan applies directly (one shared implementation)
_overlap_sorted = sim.overlap_sorted_disjoint


def _replay(n_seg: int,
            seg_pos: Sequence[Callable[[int], int]],
            seg_cum: Sequence[Callable[[int], float]],
            seg_size: Sequence[int],
            hop_edges: Sequence[Sequence[Tuple[int, int, float]]],
            in_seg: Callable[[int, int], bool],
            hop_price: Optional[Sequence[Optional[HopPricer]]] = None
            ) -> sim.TaskTimeline:
    """Shared sparse event core: replay only the boundary events of one
    candidate partition, exactly as ``sim.simulate_partitioned_task``.

    ``seg_pos[k](id)`` maps a node id to its execution position inside
    segment ``k`` (nodes run serially in id order), ``seg_cum[k](pos)``
    is the cumulative compute time of the segment's first ``pos`` nodes,
    ``hop_edges[k]`` the boundary tensors crossing link ``k`` as
    ``(u, v, duration)``, and ``in_seg(k, u)`` whether producer ``u``
    lives in segment ``k``.  With ``hop_price`` set, a hop whose pricer
    is non-``None`` carries *bit volumes* instead of durations and each
    transfer is priced at its actual FIFO start instant (bandwidth
    traces — the simulator's re-integration).
    """
    n_hops = n_seg - 1
    recv: Dict[Edge, float] = {}
    seg_fin = [0.0] * n_seg
    link_fin = [0.0] * n_hops
    compute_busy = [0.0] * n_seg
    link_busy = [0.0] * n_hops
    first_tx: List[Optional[float]] = [None] * n_hops
    comp_runs: List[List[Tuple[float, float]]] = [[] for _ in range(n_seg)]
    link_iv: List[List[Tuple[float, float]]] = [[] for _ in range(n_hops)]
    gates_next: Dict[int, float] = {}

    for k in range(n_seg):
        pos_of, cum_at, size = seg_pos[k], seg_cum[k], seg_size[k]
        compute_busy[k] = cum_at(size) - cum_at(0)
        gates = sorted(gates_next.items())
        runs = comp_runs[k]
        cur: Optional[List[float]] = None
        t = 0.0
        last = 0  # segment-local position: nodes [0, last) processed
        gate_pos: List[int] = []
        gate_t: List[float] = []
        for v, ready in gates:
            pv = pos_of(v)
            if pv > last:  # ungated run before the gate
                e = t + cum_at(pv) - cum_at(last)
                if cur is None:
                    cur = [t, e]
                else:
                    cur[1] = e  # contiguous with the open run
                t = e
            s = ready if ready > t else t
            e = s + cum_at(pv + 1) - cum_at(pv)
            if cur is None:
                cur = [s, e]
            elif s == cur[1]:
                cur[1] = e
            else:
                runs.append((cur[0], cur[1]))
                cur = [s, e]
            t = e
            last = pv + 1
            gate_pos.append(pv)
            gate_t.append(t)
        if size > last:
            e = t + cum_at(size) - cum_at(last)
            if cur is None:
                cur = [t, e]
            else:
                cur[1] = e
            t = e
        if cur is not None:
            runs.append((cur[0], cur[1]))
        seg_fin[k] = t

        if k == n_hops:
            break

        def done(u: int) -> float:
            pu = pos_of(u)
            j = bisect_right(gate_pos, pu) - 1
            if j < 0:
                return cum_at(pu + 1) - cum_at(0)
            return gate_t[j] + cum_at(pu + 1) - cum_at(gate_pos[j] + 1)

        entries = []
        for (u, v, dur) in hop_edges[k]:
            if u < 0:
                when = 0.0 if k == 0 else recv[(u, v)]
            elif in_seg(k, u):
                when = done(u)
            else:  # relayed from an earlier hop
                when = recv[(u, v)]
            entries.append((when, u, v, dur))
        entries.sort(key=lambda r: (r[0], r[1], r[2]))
        price = hop_price[k] if hop_price is not None else None
        free = 0.0
        for (when, u, v, dur) in entries:
            start = when if when > free else free
            if price is not None:  # entry carried a bit volume
                dur = price(dur, start)
            if first_tx[k] is None:
                first_tx[k] = start
            free = start + dur
            link_busy[k] += dur
            link_iv[k].append((start, free))
            recv[(u, v)] = free
        link_fin[k] = free
        gates_next = {}
        for (_, u, v, _) in entries:
            if in_seg(k + 1, v):
                r = recv[(u, v)]
                if r > gates_next.get(v, -1.0):
                    gates_next[v] = r

    latency = max(seg_fin + link_fin)
    # fallback mirrors the simulator: a hop with nothing to transmit
    # collapses "first tx" to the upstream finish time
    ftx: List[float] = []
    upstream = 0.0
    for k in range(n_hops):
        upstream = max(upstream, seg_fin[k])
        ftx.append(first_tx[k] if first_tx[k] is not None else upstream)
        upstream = max(upstream, link_fin[k])
    seg_start = tuple(
        comp_runs[k][0][0] if comp_runs[k] else (ftx[k - 1] if k else 0.0)
        for k in range(n_seg))
    next_start = tuple(
        comp_runs[k + 1][0][0] if comp_runs[k + 1] else ftx[k]
        for k in range(n_hops))
    link_par = tuple(_overlap_sorted(link_iv[k], comp_runs[k])
                     for k in range(n_hops))
    compute_par = tuple(_overlap_sorted(comp_runs[k + 1], link_iv[k])
                        for k in range(n_hops))
    return sim.TaskTimeline(
        compute_busy=tuple(compute_busy), link_busy=tuple(link_busy),
        link_par=link_par, compute_par=compute_par, latency=latency,
        first_tx=tuple(ftx), seg_start=seg_start, next_start=next_start)


def _replay_chain(tables: PlannerTables, positions: Sequence[int],
                  level: int) -> sim.TaskTimeline:
    """Exact boundary-event replay of one chain-cut tuple: segments are
    contiguous id ranges, so position/cumsum lookups hit the global
    prefix tables directly (no per-candidate O(graph) work)."""
    cnts = [int(tables.pref_cnt[p]) for p in positions]
    bounds = [0] + cnts + [len(tables.graph)]
    n_seg = len(bounds) - 1
    seg_pos, seg_cum, seg_size = [], [], []
    for k in range(n_seg):
        lo = bounds[k]
        cum_k = tables.cum[k]
        seg_pos.append(lambda u, lo=lo: u - lo)
        seg_cum.append(lambda pos, cum_k=cum_k, lo=lo: cum_k[lo + pos])
        seg_size.append(bounds[k + 1] - lo)
    hp = tables.hop_price
    hop_edges = [[(u, v, vols[level] if hp is not None and hp[k] is not None
                   else vols[level] / tables.bw[k])
                  for (u, v, vols) in tables.pos_edges[positions[k]]]
                 for k in range(n_seg - 1)]
    return _replay(n_seg, seg_pos, seg_cum, seg_size, hop_edges,
                   lambda k, u: bounds[k] <= u < bounds[k + 1],
                   hop_price=hp)


def _chain_overlaps(tables: PlannerTables, positions: Sequence[int],
                    level: int) -> Tuple[List[float], List[float]]:
    """Lean inner loop of the batched sweep: the per-hop
    ``(link_par, compute_par)`` overlap windows of one chain-cut tuple,
    with the same event semantics as ``_replay`` but none of its
    timeline bookkeeping (every other ``StageTimes`` field of the sweep
    comes from the vectorized prefix-sum arrays)."""
    pref = tables.pref_cnt
    pos_edges = tables.pos_edges
    bw = tables.bw
    n = len(positions)
    bounds = [0] + [int(pref[p]) for p in positions] + [len(tables.graph)]
    recv: Dict[Edge, float] = {}
    gates: List[Tuple[int, float]] = []
    link_pars: List[float] = []
    compute_pars: List[float] = []
    prev_link_iv: List[Tuple[float, float]] = []
    for k in range(n + 1):
        lo, hi = bounds[k], bounds[k + 1]
        cum_k = tables.cum[k]
        runs: List[Tuple[float, float]] = []
        cs = ce = 0.0
        has_run = False
        t = 0.0
        last = lo - 1
        gate_ids: List[int] = []
        gate_t: List[float] = []
        for (v, r) in gates:
            if v > last + 1:
                e = t + cum_k[v] - cum_k[last + 1]
                if not has_run:
                    cs, has_run = t, True
                ce = e
                t = e
            s = r if r > t else t
            e = s + cum_k[v + 1] - cum_k[v]
            if not has_run:
                cs, ce, has_run = s, e, True
            elif s == ce:
                ce = e
            else:
                runs.append((cs, ce))
                cs, ce = s, e
            t = e
            last = v
            gate_ids.append(v)
            gate_t.append(t)
        if hi > last + 1:
            e = t + cum_k[hi] - cum_k[last + 1]
            if not has_run:
                cs, has_run = t, True
            ce = e
            t = e
        if has_run:
            runs.append((cs, ce))
        if k:
            compute_pars.append(_overlap_sorted(runs, prev_link_iv))
        if k == n:
            break
        entries = []
        for (u, v, vols) in pos_edges[positions[k]]:
            if u < 0:
                when = 0.0 if k == 0 else recv[(u, v)]
            elif u >= lo:  # produced in this segment (u < hi by crossing)
                j = bisect_right(gate_ids, u) - 1
                when = (cum_k[u + 1] - cum_k[lo]) if j < 0 \
                    else gate_t[j] + cum_k[u + 1] - cum_k[gate_ids[j] + 1]
            else:  # relayed from an earlier hop
                when = recv[(u, v)]
            entries.append((when, u, v, vols[level]))
        entries.sort()
        free = 0.0
        ivs: List[Tuple[float, float]] = []
        nb = bw[k]
        nlo, nhi = bounds[k + 1], bounds[k + 2]
        ngates: Dict[int, float] = {}
        for (when, u, v, vol) in entries:
            s = when if when > free else free
            free = s + vol / nb
            ivs.append((s, free))
            if nlo <= v < nhi:
                if free > ngates.get(v, -1.0):
                    ngates[v] = free
            else:
                recv[(u, v)] = free
        link_pars.append(_overlap_sorted(ivs, runs))
        prev_link_iv = ivs
        gates = sorted(ngates.items())
    return link_pars, compute_pars


def stage_times_chain(tables: PlannerTables, positions: Sequence[int],
                      extra: int = 0) -> StageTimes:
    """Fast exact ``StageTimes`` of a chain-cut tuple at relax level
    ``extra`` (an entry of ``RELAX_EXTRAS``)."""
    return StageTimes.from_timeline(
        _replay_chain(tables, positions, RELAX_EXTRAS.index(extra)))


def _crossing_idx(tables: PlannerTables, frontier: frozenset,
                  cache: Optional[Dict[frozenset, np.ndarray]] = None
                  ) -> np.ndarray:
    """Edge indices crossing one frontier: produced inside, consumed
    outside (raw input counts as upstream)."""
    if cache is not None:
        got = cache.get(frontier)
        if got is not None:
            return got
    eu, ev = tables.edge_u, tables.edge_v
    inside = np.zeros(len(tables.graph) + 1, dtype=bool)
    inside[list(frontier)] = True
    um = np.where(eu >= 0, inside[eu], True)
    idx = np.nonzero(um & ~inside[ev])[0]
    if cache is not None:
        cache[frontier] = idx
    return idx


class _FrontierScorer:
    """Per-candidate replay substrate for arbitrary nested multi-cuts
    (block-refined cuts, brute-force end sets): the segment layout and
    sorted boundary-edge lists are built once, then replayed per relax
    level (or per explicit bit map)."""

    def __init__(self, tables: PlannerTables,
                 frontiers: Sequence[frozenset],
                 crossing_cache: Optional[Dict[frozenset, np.ndarray]] = None,
                 level_pricing: bool = True):
        self.tables = tables
        self.frontiers = [frozenset(f) for f in frontiers]
        n = len(self.frontiers)
        seg_id = np.full(len(tables.graph), n, dtype=np.int64)
        for k in range(n - 1, -1, -1):
            seg_id[list(self.frontiers[k])] = k
        self.seg_id = seg_id
        members = [np.nonzero(seg_id == k)[0] for k in range(n + 1)]
        self.seg_pos, self.seg_cum, self.seg_size = [], [], []
        self.compute = np.empty(n + 1)
        for k in range(n + 1):
            mem = members[k]
            local = np.zeros(len(mem) + 1)
            if len(mem):
                np.cumsum(tables.dt[k][mem], out=local[1:])
            self.compute[k] = local[-1]
            self.seg_pos.append(
                lambda u, mem=mem: int(np.searchsorted(mem, u)))
            self.seg_cum.append(lambda pos, local=local: local[pos])
            self.seg_size.append(len(mem))
        eu, ev = tables.edge_u, tables.edge_v
        self.hop_idx = []
        for k in range(n):
            idx = _crossing_idx(tables, self.frontiers[k], crossing_cache)
            order = np.lexsort((ev[idx], eu[idx]))
            idx = idx[order]
            if level_pricing:
                tables.ensure_priced(idx)
            self.hop_idx.append(idx)
        self.hop_uv = [[(int(eu[i]), int(ev[i])) for i in idx]
                       for idx in self.hop_idx]
        self.has_bits = any((eu[idx] >= 0).any() for idx in self.hop_idx)
        # per-level, per-hop link busy (vectorized volume sums); only
        # meaningful when the Eq. 1 level pricing ran
        self.link = np.stack(
            [tables.edge_vol[:, idx].sum(axis=1) / tables.bw[k]
             for k, idx in enumerate(self.hop_idx)], axis=1) \
            if level_pricing else None  # [L, n]

    def timeline(self, level: Optional[int] = None,
                 hop_bits: Optional[Sequence[Dict[Edge, int]]] = None
                 ) -> sim.TaskTimeline:
        t = self.tables
        hp = t.hop_price
        hop_edges = []
        for k, idx in enumerate(self.hop_idx):
            if hop_bits is None:
                vols = t.edge_vol[level, idx]
            else:
                vols = [t.edge_elems[i]
                        * (t.input_bits_per_elem if u < 0
                           else hop_bits[k].get((u, v), 32))
                        for i, (u, v) in zip(idx, self.hop_uv[k])]
            if hp is not None and hp[k] is not None:
                durs = vols  # priced at start time inside the replay
            else:
                durs = [v / t.bw[k] for v in vols]
            hop_edges.append([(u, v, float(d))
                              for (u, v), d in zip(self.hop_uv[k], durs)])
        return _replay(len(self.frontiers) + 1, self.seg_pos, self.seg_cum,
                       self.seg_size, hop_edges,
                       lambda k, u: self.seg_id[u] == k,
                       hop_price=hp)


def stage_times_frontiers(tables: PlannerTables,
                          frontiers: Sequence[frozenset],
                          hop_bits: Optional[Sequence[Dict[Edge, int]]] = None,
                          extra: int = 0) -> StageTimes:
    """Fast exact ``StageTimes`` of an arbitrary nested multi-cut.

    With ``hop_bits`` the per-hop boundary precisions are taken from the
    given maps (missing edges default to fp32, raw input to the fixed
    input precision — the simulator's pricing); otherwise each edge is
    priced at its Eq. 1 minimum plus ``extra`` (clipped to 16)."""
    scorer = _FrontierScorer(tables, frontiers,
                             level_pricing=hop_bits is None)
    level = None if hop_bits is not None else RELAX_EXTRAS.index(extra)
    return StageTimes.from_timeline(
        scorer.timeline(level=level, hop_bits=hop_bits))


# ====================================================== batched chain sweep
@dataclasses.dataclass
class SweepResult:
    """Per-tuple relax-ladder representatives over the whole chain sweep.

    With pruning on, a tuple whose boundary-event replay was provably
    unnecessary carries its *lower bound* ``B_c + min max_stage`` as the
    objective and its stage-sum feasibility upper bound — both
    conservative for ranking (every pruned tuple is strictly dominated
    by the exactly-scored incumbent), so the shortlist still provably
    contains the naive argmin."""
    combos: List[Tuple[int, ...]]    # scored tuples, in naive (lex) order
    objective: np.ndarray            # [T] representative Eq. 6 objective
    feasible: np.ndarray             # [T] representative feasibility
    n_scored: int                    # candidate evaluations performed
    n_pruned: int = 0                # non-serial replays skipped via bound


def _chain_sweep_traced(tables: PlannerTables, positions: Sequence[int],
                        n_hops: int, min_end_nodes: int,
                        T_max: float) -> SweepResult:
    """Traced-link chain sweep: the vectorized closed forms assume
    constant bandwidth, so every tuple is scored *exactly* through the
    boundary-event replay (start-time pricing) and the ladder replicates
    ``partitioner._relax_bits`` verbatim.  Exact representatives mean
    the shortlist trivially contains the naive argmin — no pruning
    bounds are attempted (a trace invalidates them too)."""
    combos = [c for c in itertools.combinations_with_replacement(
        positions, n_hops)
        if tables.pref_cnt[c[0]] >= min_end_nodes]
    if not combos:
        return SweepResult([], np.empty(0), np.empty(0, bool), 0, 0)
    n_lvl = len(RELAX_EXTRAS)
    rep_obj = np.empty(len(combos))
    rep_feas = np.empty(len(combos), dtype=bool)
    n_scored = 0
    for ti, combo in enumerate(combos):
        has_bits = bool(tables.pos_has_bits[list(combo)].any())

        def exact(li):
            st = StageTimes.from_timeline(_replay_chain(tables, combo, li))
            fe = (st.stage_sum <= T_max) \
                and st.satisfies_parallel_constraint()
            return st.objective(), fe, st.max_stage

        r_obj, r_feas, r_ms = exact(0)
        n_scored += 1
        if has_bits:
            for li in range(1, n_lvl):
                o, fe, ms = exact(li)
                n_scored += 1
                if o < r_obj and fe >= r_feas \
                        and ms <= r_ms * (1 + CEIL_TOL):
                    r_obj, r_feas, r_ms = o, fe, ms
        rep_obj[ti], rep_feas[ti] = r_obj, r_feas
    return SweepResult(combos, rep_obj, rep_feas, n_scored, 0)


def chain_sweep(tables: PlannerTables, positions: Sequence[int],
                n_hops: int, min_end_nodes: int = 1,
                T_max: float = float("inf"),
                prune: bool = False) -> SweepResult:
    """Score every ordered chain-cut tuple at every relax level.

    Vectorized numpy prefix-sum lookups produce each (tuple, level)'s
    per-segment compute, per-hop link busy, ``B_c``, ``max_stage`` and
    stage sum in one shot; serial tuples finish fully vectorized, the
    rest replay their O(edges) boundary events.  The per-tuple
    representative replicates ``partitioner._relax_bits``'s acceptance
    rule exactly, so ranking matches the naive search.

    With ``prune=True`` the non-serial replays run in ascending
    lower-bound order (``B_c + min-over-levels max_stage``, with
    possibly-feasible tuples first) against an exactly-scored incumbent;
    once every remaining tuple is provably dominated — it cannot be
    feasible while the incumbent is, and its bound already exceeds the
    incumbent's near-tie band — the tail is skipped wholesale.  Skipped
    tuples keep their bound as representative, which by construction
    sorts strictly after the incumbent, so ``_shortlist``'s best /
    near-tie selection (and hence the rescored argmin) is unchanged.
    Representative *values* for pruned tuples differ from the
    ``prune=False`` sweep, which is why the exhaustive form stays the
    default.

    Tables built over traced links route to the exhaustive exact replay
    sweep (``_chain_sweep_traced``); ``prune`` is ignored there."""
    if tables.hop_price is not None:
        return _chain_sweep_traced(tables, positions, n_hops,
                                   min_end_nodes, T_max)
    combos = [c for c in itertools.combinations_with_replacement(
        positions, n_hops)
        if tables.pref_cnt[c[0]] >= min_end_nodes]
    if not combos:
        return SweepResult([], np.empty(0), np.empty(0, bool), 0, 0)
    P = np.asarray(combos, dtype=np.int64)          # [T, n]
    T = len(combos)
    cnt = tables.pref_cnt[P]                        # [T, n]
    n_lvl = len(RELAX_EXTRAS)
    lo = np.concatenate([np.zeros((T, 1), np.int64), cnt], axis=1)
    hi = np.concatenate([cnt, np.full((T, 1), len(tables.graph))], axis=1)
    compute = np.stack([tables.cum[k][hi[:, k]] - tables.cum[k][lo[:, k]]
                        for k in range(n_hops + 1)], axis=1)   # [T, n+1]
    link = np.stack([tables.pos_vol[:, P[:, k]] / tables.bw[k]
                     for k in range(n_hops)], axis=2)          # [L, T, n]
    B_c = np.abs(np.diff(compute, axis=1)).sum(axis=1)         # [T]
    max_stage = np.maximum(compute.max(axis=1)[None, :], link.max(axis=2))
    stage_sum = compute.sum(axis=1)[None, :] + link.sum(axis=2)
    has_bits = tables.pos_has_bits[P].any(axis=1)              # [T]
    serial = (tables.pos_serial[P].all(axis=1)
              & (np.diff(cnt, axis=1) > 0).all(axis=1))

    # serial tuples: no Fig. 4 overlap is possible, so B_t (and Eq. 4)
    # close vectorized — build every tuple's relax-ladder representative
    # from the closed form first (``_relax_bits`` acceptance, vectorized)
    obj = np.empty((n_lvl, T))
    feas = np.empty((n_lvl, T), dtype=bool)
    ceiling = np.maximum(np.maximum(compute[:, :-1], compute[:, 1:])[None],
                         link)                                 # [L, T, n]
    B_t = np.abs(link - ceiling).sum(axis=2)                   # [L, T]
    obj[:] = B_c[None, :] + B_t + max_stage
    feas[:] = stage_sum <= T_max
    rep_obj = obj[0].copy()
    rep_feas = feas[0].copy()
    rep_ms = max_stage[0].copy()
    for li in range(1, n_lvl):
        acc = (has_bits & (obj[li] < rep_obj) & (feas[li] >= rep_feas)
               & (max_stage[li] <= rep_ms * (1 + CEIL_TOL)))
        rep_obj = np.where(acc, obj[li], rep_obj)
        rep_feas = np.where(acc, feas[li], rep_feas)
        rep_ms = np.where(acc, max_stage[li], rep_ms)

    # non-serial tuples: replay their boundary events for the exact
    # overlap windows; levels that provably cannot be accepted (Eq. 6
    # objective >= its bound B_c + max_stage, or the ceiling rule) skip
    # the replay without changing the representative
    nonserial = list(np.nonzero(~serial)[0])
    n_pruned = 0
    inc_obj, inc_feas = np.inf, False
    if prune and nonserial:
        # B_t >= 0, so every level's objective >= B_c + max_stage and
        # the ladder representative >= B_c + min over scored levels;
        # stage-sum feasibility is replay-independent, so feas.any is a
        # true upper bound on any level's exact (ceiling-rule) outcome
        lb = B_c + np.where(has_bits, max_stage.min(axis=0), max_stage[0])
        pfeas = feas.any(axis=0)
        nonserial.sort(key=lambda ti: (not pfeas[ti], lb[ti]))
        ser = np.nonzero(serial)[0]
        if len(ser):
            si = min(ser, key=lambda ti: (not rep_feas[ti], rep_obj[ti]))
            inc_obj, inc_feas = float(rep_obj[si]), bool(rep_feas[si])
    for pos, ti in enumerate(nonserial):
        if prune:
            can_f = bool(pfeas[ti])
            bound = float(lb[ti])
            # the (~pfeas, lb) order makes both conditions monotone: the
            # first dominated tuple dominates the whole tail.  Dominated
            # means it can never rank at or near the incumbent under the
            # naive (infeasible, objective) order, whatever its replay
            # would have said
            if (inc_feas and not can_f) or (
                    (inc_feas or not can_f)
                    and bound > inc_obj * (1 + 1e-9) + 1e-300):
                for tj in nonserial[pos:]:
                    rep_obj[tj] = lb[tj]
                    rep_feas[tj] = pfeas[tj]
                n_pruned = len(nonserial) - pos
                break
        combo = combos[ti]
        bc = B_c[ti]

        def exact(li):
            lp, cp = _chain_overlaps(tables, combo, li)
            bt = 0.0
            for k in range(n_hops):
                m = max(compute[ti, k], link[li, ti, k] - lp[k],
                        compute[ti, k + 1] - cp[k])
                d = link[li, ti, k] - m
                bt += d if d >= 0 else -d
            ms = max_stage[li, ti]
            ok = bool(stage_sum[li, ti] <= T_max) and all(
                lp[k] + cp[k] <= ms * (1 + CEIL_TOL)
                for k in range(n_hops))
            return bc + bt + ms, ok

        r_obj, r_feas = exact(0)
        r_ms = max_stage[0, ti]
        if has_bits[ti]:
            for li in range(1, n_lvl):
                ms = max_stage[li, ti]
                if ms > r_ms * (1 + CEIL_TOL) or bc + ms >= r_obj:
                    continue  # acceptance impossible: obj >= B_c + max_stage
                o, fe = exact(li)
                if o < r_obj and fe >= r_feas:
                    r_obj, r_feas, r_ms = o, fe, ms
        rep_obj[ti], rep_feas[ti], rep_ms[ti] = r_obj, r_feas, r_ms
        if r_feas > inc_feas or (r_feas == inc_feas and r_obj < inc_obj):
            inc_obj, inc_feas = float(r_obj), bool(r_feas)
    n_scored = int(np.where(has_bits, n_lvl, 1).sum())
    return SweepResult(combos, rep_obj, rep_feas, n_scored, n_pruned)


def _shortlist(objective: np.ndarray, feasible: np.ndarray,
               top_k: int) -> np.ndarray:
    """Indices of the ``top_k`` best representatives by (infeasible,
    objective, sequence), plus every exact near-tie of the best — so the
    event-sim rescoring pass provably contains the naive argmin (and its
    first-seen tie-break).  Returned in sequence order."""
    order = np.lexsort((np.arange(len(objective)), objective, ~feasible))
    pick = list(order[:top_k])
    best = order[0]
    ties = np.nonzero((feasible == feasible[best])
                      & (objective <= objective[best]
                         * (1 + 1e-9) + 1e-300))[0]
    pick.extend(ties[:256])
    return np.unique(np.asarray(pick, dtype=np.int64))


def chain_shortlist(tables: PlannerTables, positions: Sequence[int],
                    n_hops: int, min_end_nodes: int, T_max: float,
                    top_k: int) -> Tuple[List[Tuple[int, ...]], int]:
    """Fast-score the whole chain sweep and return the tuples worth an
    exact event-sim rescore, in naive sweep order.  Runs the sweep with
    lower-bound pruning: dominated non-serial replays are skipped.  The
    shortlist's *tail* may then differ from the exhaustive sweep's (a
    pruned tuple ranks by its bound), but the best candidate and its
    near-tie band are always exactly scored, so the event-sim rescore
    still returns the naive argmin (see ``chain_sweep``)."""
    res = chain_sweep(tables, positions, n_hops, min_end_nodes, T_max,
                      prune=True)
    if not res.combos:
        return [], 0
    pick = _shortlist(res.objective, res.feasible, top_k)
    return [res.combos[i] for i in pick], res.n_scored


def frontier_shortlist(tables: PlannerTables,
                       candidates: Sequence[Sequence[frozenset]],
                       min_end_nodes: int, T_max: float,
                       top_k: int) -> Tuple[List[int], int]:
    """Fast-score arbitrary nested-frontier candidates (block recursion
    refinement, brute force) and return the indices worth an exact
    event-sim rescore, in candidate order."""
    graph = tables.graph
    seqs: List[int] = []
    objs: List[float] = []
    feats: List[bool] = []
    n_scored = 0
    valid_memo: Dict[frozenset, bool] = {}
    xcache: Dict[frozenset, np.ndarray] = {}
    n_lvl = len(RELAX_EXTRAS)
    for seq, fr in enumerate(candidates):
        frontiers = [frozenset(f) for f in fr]
        if len(frontiers[0]) < min_end_nodes:
            continue
        prev: frozenset = frozenset()
        ok = True
        for f in frontiers:
            valid = valid_memo.get(f)
            if valid is None:
                valid = graph.valid_end_set(f)
                valid_memo[f] = valid
            if not prev <= f or not valid:
                ok = False
                break
            prev = f
        if not ok:
            continue
        sc = _FrontierScorer(tables, frontiers, crossing_cache=xcache)
        n_hops = len(frontiers)
        if tables.hop_price is not None:
            # traced links: nominal-bandwidth busy vectors are invalid,
            # so score every level exactly from the replayed timeline
            # (ladder acceptance identical to ``_relax_bits``)
            def exact_traced(li):
                st = StageTimes.from_timeline(sc.timeline(level=li))
                fe = (st.stage_sum <= T_max) \
                    and st.satisfies_parallel_constraint()
                return st.objective(), fe, st.max_stage

            best_obj, best_feas, best_ms = exact_traced(0)
            n_scored += 1
            if sc.has_bits:
                for li in range(1, n_lvl):
                    o, fe, ms = exact_traced(li)
                    n_scored += 1
                    if o < best_obj and fe >= best_feas \
                            and ms <= best_ms * (1 + CEIL_TOL):
                        best_obj, best_feas, best_ms = o, fe, ms
            seqs.append(seq)
            objs.append(best_obj)
            feats.append(best_feas)
            continue
        max_stage = np.maximum(sc.compute.max(), sc.link.max(axis=1))  # [L]
        stage_sum = sc.compute.sum() + sc.link.sum(axis=1)             # [L]

        def exact(li):
            tl = sc.timeline(level=li)
            bc = bt = 0.0
            for k in range(n_hops):
                bc += abs(sc.compute[k] - sc.compute[k + 1])
                m = max(sc.compute[k], sc.link[li, k] - tl.link_par[k],
                        sc.compute[k + 1] - tl.compute_par[k])
                bt += abs(sc.link[li, k] - m)
            ms = max_stage[li]
            fe = bool(stage_sum[li] <= T_max) and all(
                tl.link_par[k] + tl.compute_par[k] <= ms * (1 + CEIL_TOL)
                for k in range(n_hops))
            return bc + bt + ms, fe

        best_obj, best_feas = exact(0)
        best_ms = max_stage[0]
        n_scored += n_lvl if sc.has_bits else 1
        if sc.has_bits:
            bc0 = sum(abs(sc.compute[k] - sc.compute[k + 1])
                      for k in range(n_hops))
            for li in range(1, n_lvl):
                ms = max_stage[li]
                if ms > best_ms * (1 + CEIL_TOL) or bc0 + ms >= best_obj:
                    continue  # acceptance impossible (obj >= B_c + max_stage)
                o, fe = exact(li)
                if o < best_obj and fe >= best_feas:
                    best_obj, best_feas, best_ms = o, fe, ms
        seqs.append(seq)
        objs.append(best_obj)
        feats.append(best_feas)
    if not seqs:
        return [], n_scored
    pick = _shortlist(np.asarray(objs), np.asarray(feats), top_k)
    return [seqs[i] for i in pick], n_scored
