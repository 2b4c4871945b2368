"""COACH offline component — Algorithm 1, generalized to multi-hop chains.

Recursive divide-and-conquer over the model DAG:

  1. cluster parallel branches into *virtual blocks*, reducing the DAG to a
     chain flow  B = {b_1 .. b_n}  (Fig. 4);
  2. sweep chain-level cuts — for an ``n_hops``-link deployment, ordered
     multi-cut tuples (non-decreasing chain positions, one frontier per
     hop); per boundary tensor and hop, pick quantization precision by
     dichotomous search against the accuracy oracle (Eq. 1) and then relax
     bits upward if that lowers the bubble objective;
  3. recurse into virtual blocks crossing the best cuts: per hop, each
     internal branch is cut independently at a shared flop-ratio grid
     (this is what turns the O(c^n) joint branch search into O(c·n));
  4. keep the argmin of Eq. 6 subject to Eq. 1/3/4.

Every *returned* strategy is scored with the executable event semantics
in ``repro_torch.core.schedule`` / ``repro_torch.core.sim`` (no closed-form
approximations), so the chosen strategy is exactly what the pipeline
executor will see.  By default the sweep itself runs through the batched
incremental scorer of ``repro_torch.core.plan_fast`` — an exact O(boundary
events) reformulation of the same event semantics, differentially pinned
to the simulator — and only the shortlisted top-K candidates are
rescored with the full simulation, so the argmin is identical to the
naive per-candidate search at a fraction of the cost (``fast=False``
recovers the naive path).  The classic end->cloud search
(``coach_offline``) is the ``n_hops = 1`` case of
``coach_offline_multihop``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import plan_fast
from repro_torch.core.costs import DeviceProfile, LinkProfile, LayerNode, ModelGraph
from repro_torch.core.schedule import (Edge, PartitionDecision, StageTimes,
                                 evaluate_multihop, evaluate_partition)

AccOracle = Callable[[LayerNode, int], float]  # (node, bits) -> accuracy loss


def analytic_acc_loss(node: LayerNode, bits: int) -> float:
    """Default oracle: UAQ error decays ~2x per extra bit (§II-B clusters at
    3–5 bits for eps=0.5%); per-layer sensitivity scales it."""
    return node.sensitivity * (2.0 ** (-(bits - 2)))


def dichotomous_bits(node: LayerNode, eps: float, oracle: AccOracle,
                     lo: int = 2, hi: int = 16) -> int:
    """Minimal precision meeting Eq. 1, by dichotomous (binary) search —
    valid because oracle loss is monotone non-increasing in bits."""
    if oracle(node, hi) > eps:
        return hi
    while lo < hi:
        mid = (lo + hi) // 2
        if oracle(node, mid) <= eps:
            hi = mid
        else:
            lo = mid + 1
    return hi


# ------------------------------------------------------------ virtual blocks
@dataclasses.dataclass
class ChainElem:
    """Either a single node or a virtual block [entry..join) of parallel
    branches (branch = list of node ids)."""
    node: Optional[int] = None
    block_nodes: Tuple[int, ...] = ()
    branches: Tuple[Tuple[int, ...], ...] = ()

    @property
    def is_block(self) -> bool:
        return bool(self.block_nodes)

    def ids(self) -> Tuple[int, ...]:
        return self.block_nodes if self.is_block else (self.node,)


def _reachable(graph: ModelGraph, src: int) -> set:
    seen, stack = set(), [src]
    while stack:
        u = stack.pop()
        for w in graph.children(u):
            if w not in seen:
                seen.add(w)
                stack.append(w)
    return seen


def chain_flow(graph: ModelGraph,
               ids: Optional[Sequence[int]] = None) -> List[ChainElem]:
    """Cluster parallel layers into virtual blocks (Alg. 1 line 3).

    Assumes series-parallel structure with topologically contiguous ids
    (true of our CNN/transformer graph builders).
    """
    ids = list(ids) if ids is not None else [n.id for n in graph.nodes]
    elems: List[ChainElem] = []
    i = 0
    idset = set(ids)
    pos = {nid: j for j, nid in enumerate(ids)}  # id -> chain position
    while i < len(ids):
        u = ids[i]
        kids = [c for c in graph.children(u) if c in idset]
        if len(kids) <= 1:
            elems.append(ChainElem(node=u))
            i += 1
            continue
        # parallel region opens at u: find the join = smallest node reachable
        # from (or equal to) every child
        reach = [({k} | _reachable(graph, k)) & idset for k in kids]
        common = set.intersection(*reach)
        join = min(common)
        block_ids = tuple(x for x in ids if u < x < join)
        blockset = set(block_ids)
        # branches: connected chains inside the block starting at each child
        branches = []
        for k in kids:
            if k == join:
                continue  # skip-edge branch (no layers)
            br, cur = [], k
            while cur != join and cur in blockset:
                br.append(cur)
                nxt = [c for c in graph.children(cur) if c in idset]
                cur = nxt[0] if nxt else join
            branches.append(tuple(br))
        elems.append(ChainElem(node=u))
        if block_ids:
            elems.append(ChainElem(block_nodes=block_ids,
                                   branches=tuple(branches)))
        i = pos[join]
    return elems


def chain_prefixes(graph: ModelGraph,
                   elems: Optional[List[ChainElem]] = None
                   ) -> List[Tuple[int, ...]]:
    """Cumulative node-id prefixes after each chain element (first entry is
    the empty prefix = everything downstream)."""
    elems = elems if elems is not None else chain_flow(graph)
    prefixes: List[Tuple[int, ...]] = [()]
    cur: List[int] = []
    for e in elems:
        cur.extend(e.ids())
        prefixes.append(tuple(cur))
    return prefixes


def strided_positions(n_prefixes: int, stride: int) -> List[int]:
    """Chain-cut grid subsampled at ``stride``, always keeping the full
    (all-nodes) prefix so degenerate cuts stay reachable."""
    positions = list(range(0, n_prefixes, max(1, stride)))
    if positions[-1] != n_prefixes - 1:
        positions.append(n_prefixes - 1)
    return positions


# ---------------------------------------------------------------- optimizer
@dataclasses.dataclass
class OfflineResult:
    decision: PartitionDecision
    times: StageTimes
    objective: float
    candidates: int
    feasible: bool


class QuantCache:
    """Memoized Eq. 1 quantization search.

    The dichotomous precision of a boundary tensor depends only on its
    *producer* node, and the same frontier recurs across every multi-cut
    tuple containing it — so both layers are cached: per-node minimal
    bits (one oracle search per producer, ever) and per-frontier
    boundary-bit maps (one dict per distinct frontier).  One instance is
    scoped to one (eps, oracle, hi_bits) search."""

    def __init__(self, graph: ModelGraph, eps: float, oracle: AccOracle,
                 hi_bits: int = 16):
        self.graph = graph
        self.eps = eps
        self.oracle = oracle
        self.hi_bits = hi_bits
        self._node: Dict[int, int] = {}
        self._frontier: Dict[frozenset, Dict[Edge, int]] = {}

    def node_bits(self, u: int) -> int:
        b = self._node.get(u)
        if b is None:
            b = dichotomous_bits(self.graph.node(u), self.eps, self.oracle,
                                 hi=self.hi_bits)
            self._node[u] = b
        return b

    def boundary_bits(self, end_set: frozenset) -> Dict[Edge, int]:
        """Eq. 1 minimal precisions of a frontier's boundary tensors.
        Returns the cached dict — callers must copy before mutating."""
        got = self._frontier.get(end_set)
        if got is None:
            got = {(u, v): self.node_bits(u)
                   for (u, v) in self.graph.boundary_edges(end_set)
                   if u >= 0}  # raw input: fixed input precision
            self._frontier[end_set] = got
        return got


def _quantize_boundary(graph: ModelGraph, end_set: frozenset, eps: float,
                       oracle: AccOracle, hi_bits: int = 16,
                       cache: Optional[QuantCache] = None) -> Dict[Edge, int]:
    if cache is not None:
        # a cache answers for exactly one search configuration — reject a
        # mismatched one instead of silently returning wrong precisions
        assert (cache.graph is graph and cache.eps == eps
                and cache.oracle is oracle and cache.hi_bits == hi_bits), \
            "QuantCache built for a different (graph, eps, oracle, hi_bits)"
        return cache.boundary_bits(end_set)
    bits: Dict[Edge, int] = {}
    for (u, v) in graph.boundary_edges(end_set):
        if u < 0:
            continue  # raw input edge: transmitted at fixed input precision
        bits[(u, v)] = dichotomous_bits(graph.node(u), eps, oracle, hi=hi_bits)
    return bits


def _score(graph, frontiers: Sequence[frozenset],
           hop_bits: Sequence[Dict[Edge, int]], devices, links, T_max):
    dec = PartitionDecision.multihop(frontiers, hop_bits)
    st = evaluate_multihop(graph, dec, devices, links)
    feasible = (st.stage_sum <= T_max) and st.satisfies_parallel_constraint()
    return dec, st, st.objective(), feasible


def _relax_bits(graph, frontiers, bits_min, devices, links, T_max,
                hi_bits=16):
    """Offline Eq.11 analogue: raising precision above the Eq.1 minimum is
    free accuracy margin whenever transmission is not the bottleneck."""
    best = _score(graph, frontiers, [dict(b) for b in bits_min],
                  devices, links, T_max)
    cands = 1
    if any(bits_min):
        for extra in (1, 2, 4, 8):
            trial = [{e: min(hi_bits, b + extra) for e, b in bm.items()}
                     for bm in bits_min]
            cand = _score(graph, frontiers, trial, devices, links, T_max)
            cands += 1
            # extra precision may only fill *idle* link time: it must not
            # raise the pipeline ceiling (else Eq.5's B_t is being gamed)
            if cand[2] < best[2] and cand[3] >= best[3] \
                    and cand[1].max_stage <= best[1].max_stage * (1 + 1e-9):
                best = cand
    return best, cands


def _branch_ratio_cut(graph: ModelGraph, branches, r: float) -> List[int]:
    """Cut every branch of a virtual block at flop-ratio ``r`` (shared grid
    point: the O(c·n) joint branch search of Alg. 1 l.13-14)."""
    take_ids: List[int] = []
    for br in branches:
        if not br:
            continue
        total = sum(graph.node(x).flops for x in br)
        acc = 0.0
        for x in br:
            if total == 0 or (acc + graph.node(x).flops) / max(total, 1e-12) \
                    <= r + 1e-12:
                take_ids.append(x)
                acc += graph.node(x).flops
            else:
                break
    return take_ids


def coach_offline_multihop(graph: ModelGraph,
                           devices: Sequence[DeviceProfile],
                           links: Sequence[LinkProfile],
                           eps: float = 0.005, T_max: float = math.inf,
                           oracle: AccOracle = analytic_acc_loss,
                           ratio_grid: int = 8,
                           min_end_nodes: int = 1,
                           chain_stride: int = 1,
                           fast: bool = True,
                           shortlist_k: int = 16,
                           tables: Optional[plan_fast.PlannerTables] = None
                           ) -> OfflineResult:
    """Algorithm 1 offline component over an ``len(links)``-hop chain of
    devices (end, edge tiers..., cloud).

    ``min_end_nodes``: COACH's workflow (Fig. 3) requires the end device to
    produce intermediate data — both for privacy and because the online
    component's task features F are GAP'd from it — so the degenerate
    all-cloud partition is excluded by default.  ``chain_stride``
    subsamples the chain-cut grid for large graphs × many hops (the block
    recursion still refines around the best coarse cuts; the default
    ``fast`` batched scorer makes full-stride sweeps cheap, so ``1`` is
    the normal setting).

    ``fast`` routes candidate scoring through ``repro_torch.core.plan_fast``:
    all chain-cut tuples are scored at once from numpy prefix-sum tables
    (exact O(boundary-events) reformulation of the event semantics) and
    only the top-``shortlist_k`` candidates per phase are rescored with
    the full event simulator — the returned decision and objective are
    identical to ``fast=False``, which keeps the naive per-candidate
    simulation sweep.  Links carrying a bandwidth trace stay on the fast
    path: the batched scorer re-prices every boundary transfer at its
    actual start instant (exhaustive exact sweep, no vectorized bounds).

    ``tables`` warm-starts the fast path with previously built
    ``PlannerTables`` — they must come from ``plan_fast.build_tables``
    (with chain prefixes) or ``plan_fast.retime_tables`` over this same
    graph, device tuple and quantization search, and their bandwidths
    must match ``links``.  Online re-planning passes retimed tables so a
    regime shift never re-runs the Eq. 1 oracle pricing.
    """
    n_hops = len(links)
    assert len(devices) == n_hops + 1, "need one device per segment"
    elems = chain_flow(graph)
    prefixes = chain_prefixes(graph, elems)
    qcache = QuantCache(graph, eps, oracle)
    n_cands = 0
    best: Optional[Tuple] = None
    use_fast = fast and len(graph) > 0
    if tables is not None:
        assert (tables.graph is graph and len(tables.links) == n_hops
                and tables.pref_cnt is not None
                and tables.bw == tuple(lk.bandwidth_bps for lk in links)), \
            "warm tables must be built/retimed for this graph and links"

    def get_tables() -> plan_fast.PlannerTables:
        nonlocal tables
        if tables is None:
            tables = plan_fast.build_tables(
                graph, devices, links, qcache.node_bits,
                pref_counts=[len(p) for p in prefixes])
        return tables

    def consider(frontier_ids: Sequence[Tuple[int, ...]]):
        nonlocal best, n_cands
        frontiers = [frozenset(f) for f in frontier_ids]
        if len(frontiers[0]) < min_end_nodes:
            return
        prev: frozenset = frozenset()
        for f in frontiers:
            if not prev <= f or not graph.valid_end_set(f):
                return
            prev = f
        bits_min = [_quantize_boundary(graph, f, eps, oracle, cache=qcache)
                    for f in frontiers]
        (dec, st, obj, feas), c = _relax_bits(
            graph, frontiers, bits_min, devices, links, T_max)
        n_cands += c
        key = (not feas, obj)
        if best is None or key < (not best[3], best[2]):
            best = (dec, st, obj, feas)

    # ---- chain-level multi-cuts: non-decreasing tuples of chain positions
    # (cut after element i; position 0 => nothing upstream of that hop)
    positions = strided_positions(len(prefixes), chain_stride)
    n_combos = math.comb(len(positions) + n_hops - 1, n_hops)
    if use_fast and n_combos > shortlist_k:
        # batched scoring of the whole sweep; exact event-sim rescoring of
        # the shortlist, in sweep order (first-seen tie-break preserved)
        short, n_fast = plan_fast.chain_shortlist(
            get_tables(), positions, n_hops, min_end_nodes, T_max,
            shortlist_k)
        n_cands += n_fast
        for combo in short:
            consider([prefixes[i] for i in combo])
    else:
        for combo in itertools.combinations_with_replacement(
                positions, n_hops):
            consider([prefixes[i] for i in combo])

    assert best is not None, "no valid partition candidate"
    chain_best_cuts: Tuple[frozenset, ...] = best[0].cuts

    # ---- recurse into virtual blocks: refine each hop's cut inside the
    # blocks at a shared flop-ratio grid, holding the other hops at their
    # best chain-level frontiers (Alg.1 l.13-14)
    refined_cands: List[List[frozenset]] = []
    for k in range(n_hops):
        prefix: List[int] = []
        for e in elems:
            if e.is_block and e.branches:
                base = tuple(prefix)  # everything before the block upstream
                for g in range(1, ratio_grid):
                    r = g / ratio_grid
                    cut_ids = list(base) + _branch_ratio_cut(
                        graph, e.branches, r)
                    refined = [frozenset(c) for c in chain_best_cuts]
                    refined[k] = frozenset(cut_ids)
                    refined_cands.append(refined)
            prefix.extend(e.ids())
    if use_fast and len(refined_cands) > shortlist_k:
        picks, n_fast = plan_fast.frontier_shortlist(
            get_tables(), refined_cands, min_end_nodes, T_max, shortlist_k)
        n_cands += n_fast
        for i in picks:
            consider(refined_cands[i])
    else:
        for refined in refined_cands:
            consider(refined)

    dec, st, obj, feas = best
    return OfflineResult(decision=dec, times=st, objective=obj,
                         candidates=n_cands, feasible=feas)


def coach_offline(graph: ModelGraph, end_dev: DeviceProfile,
                  cloud_dev: DeviceProfile, link: LinkProfile,
                  eps: float = 0.005, T_max: float = math.inf,
                  oracle: AccOracle = analytic_acc_loss,
                  ratio_grid: int = 8,
                  min_end_nodes: int = 1,
                  fast: bool = True) -> OfflineResult:
    """Classic end->cloud offline search: ``n_hops = 1`` of the multi-hop
    divide-and-conquer."""
    return coach_offline_multihop(
        graph, (end_dev, cloud_dev), (link,), eps=eps, T_max=T_max,
        oracle=oracle, ratio_grid=ratio_grid, min_end_nodes=min_end_nodes,
        fast=fast)


# ------------------------------------------------------- brute-force oracle
def brute_force(graph: ModelGraph, end_dev, cloud_dev, link,
                eps: float = 0.005, T_max: float = math.inf,
                oracle: AccOracle = analytic_acc_loss,
                min_end_nodes: int = 1,
                fast: bool = True,
                shortlist_k: int = 16) -> OfflineResult:
    """Exponential reference for tests: all downward-closed end sets.

    ``fast`` ranks the (exponentially many) end sets with the batched
    scorer and rescores the shortlist with the event simulator — the
    same pure-speedup funnel as ``coach_offline_multihop``."""
    n = len(graph)
    assert n <= 18, "brute force limited to small graphs"
    qcache = QuantCache(graph, eps, oracle)
    best = None
    cands = 0
    end_sets = []
    for mask in range(1 << n):
        end_ids = frozenset(i for i in range(n) if mask >> i & 1)
        if len(end_ids) < min_end_nodes:
            continue
        if not graph.valid_end_set(end_ids):
            continue
        end_sets.append(end_ids)

    def score(end_ids: frozenset):
        nonlocal best, cands
        bits = _quantize_boundary(graph, end_ids, eps, oracle, cache=qcache)
        (dec, st, obj, feas), c = _relax_bits(
            graph, [end_ids], [bits], (end_dev, cloud_dev), (link,), T_max)
        cands += c
        key = (not feas, obj)
        if best is None or key < (not best[3], best[2]):
            best = (dec, st, obj, feas)

    if fast and len(end_sets) > shortlist_k:
        tables = plan_fast.build_tables(
            graph, (end_dev, cloud_dev), (link,), qcache.node_bits)
        picks, n_fast = plan_fast.frontier_shortlist(
            tables, [[s] for s in end_sets], min_end_nodes, T_max,
            shortlist_k)
        cands += n_fast
        for i in picks:
            score(end_sets[i])
    else:
        for end_ids in end_sets:
            score(end_ids)
    dec, st, obj, feas = best
    return OfflineResult(dec, st, obj, cands, feas)
