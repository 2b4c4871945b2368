"""The port's async hop-queue executor (``repro_torch.serving.async_engine``),
multi-tenant admission (``tenancy``), replicated pools and their routers
(``routing``), micro-batching (``batching``) and the metrics registry
(``obs.metrics``) against the JAX package's on the same plans, seeds and
arrivals.

Every run happens twice, once through each package, on inputs made from
one numpy seed.  The two ``StreamResult``s (pool and multi-tenant results
included) must be equal and their span traces must match at 1e-6
(``assert_traces_match``); each port executor must also stay pinned to the
port's own ``core.sim`` at 1e-6, as the reference's executors are to
theirs.  On top: the engines' decisions and timelines, real segments of
the port's runtime through the executor's workers, and the fused-probe
engine differential.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.costs as JCO  # noqa: E402
import repro.core.pipeline as JPL  # noqa: E402
import repro.core.schedule as JSC  # noqa: E402
import repro.core.sim as JS  # noqa: E402
import repro.data.pipeline as JD  # noqa: E402
import repro.obs.metrics as JME  # noqa: E402
import repro.obs.trace as JTR  # noqa: E402
import repro.serving.async_engine as JA  # noqa: E402
import repro.serving.base as JBA  # noqa: E402
import repro.serving.batching as JB  # noqa: E402
import repro.serving.engine as JE  # noqa: E402
import repro.serving.routing as JR  # noqa: E402
import repro.serving.tenancy as JT  # noqa: E402
import repro_torch.core.costs as TCO  # noqa: E402
import repro_torch.core.pipeline as TPL  # noqa: E402
import repro_torch.core.schedule as TSC  # noqa: E402
import repro_torch.core.sim as TS  # noqa: E402
import repro_torch.data.pipeline as TD  # noqa: E402
import repro_torch.obs.metrics as TME  # noqa: E402
import repro_torch.obs.trace as TTR  # noqa: E402
import repro_torch.serving.async_engine as TA  # noqa: E402
import repro_torch.serving.base as TBA  # noqa: E402
import repro_torch.serving.batching as TB  # noqa: E402
import repro_torch.serving.engine as TE  # noqa: E402
import repro_torch.serving.routing as TR  # noqa: E402
import repro_torch.serving.tenancy as TT  # noqa: E402

TOL = 1e-6
# fp32 logits of the two packages on the same packet (test_torch_collab's)
CROSS_TOL = dict(rtol=1e-4, atol=1e-4)
JAXP = SimpleNamespace(CO=JCO, PL=JPL, SC=JSC, S=JS, D=JD, ME=JME, TR=JTR,
                       A=JA, BA=JBA, B=JB, E=JE, R=JR, T=JT)
PORT = SimpleNamespace(CO=TCO, PL=TPL, SC=TSC, S=TS, D=TD, ME=TME, TR=TTR,
                       A=TA, BA=TBA, B=TB, E=TE, R=TR, T=TT)
ROUTERS = sorted(TR.ROUTER_POLICIES)
ADMISSION = ["fifo", "rr", "wdrr"]


# ----------------------------------------------------------------- inputs
def _task_plans(P, seed, n_hops, n=40, fixed_frac=None, period=2e-3):
    """Random multi-hop ``TaskPlan``s of package ``P`` from one numpy seed:
    end-device exits, mid-pipeline exits, Fig. 4 overlap offsets and, with
    ``fixed_frac``, per-segment fixed costs and staleness deadlines."""
    rng = np.random.RandomState(seed)
    plans = []
    for i in range(n):
        comp = rng.uniform(1e-3, 4e-3, n_hops + 1)
        tx = rng.uniform(0.2e-3, 3e-3, n_hops)
        kw = {}
        if fixed_frac is not None:
            kw = dict(t_fixed=tuple(fixed_frac * c for c in comp),
                      deadline=i * period + 20e-3
                      if rng.rand() < 0.5 else None)
        if rng.rand() < 0.15:
            plans.append(P.PL.TaskPlan(
                comp[0], 0.0, 0.0, True,
                t_fixed=kw["t_fixed"][:1] if kw else (),
                deadline=kw.get("deadline")))
            continue
        txo = [rng.uniform(0, comp[k]) if rng.rand() < 0.5 else None
               for k in range(n_hops)]
        rxo = [rng.uniform(0, tx[k]) if rng.rand() < 0.5 else None
               for k in range(n_hops)]
        exit_hop = int(rng.randint(1, n_hops)) \
            if n_hops >= 2 and rng.rand() < 0.25 else None
        plans.append(P.PL.TaskPlan.multihop(comp, tx, txo, rxo,
                                            exit_hop=exit_hop, **kw))
    return plans


def _plans(P, seed, n_hops, **kw):
    """``_task_plans`` as the ``SimPlan``s the executors take."""
    return [p.as_sim_plan(n_hops) for p in _task_plans(P, seed, n_hops, **kw)]


def _links(P, n_hops, traced):
    up = P.CO.LinkProfile("up", 40e6, trace=P.PL.bandwidth_step_trace(
        [(0.0, 40.0), (0.02, 6.0), (0.08, 60.0)])) if traced else None
    return [up] + [None] * (n_hops - 1)


def _equal(a, b):
    """Two results of the two packages: equal field for field."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _close_stream(a, b, tol=TOL):
    """Two ``StreamResult``s of one package's sim and executor: the same
    timeline at ``tol``."""
    assert len(a.done) == len(b.done)
    assert all(abs(x - y) <= tol for x, y in zip(a.done, b.done))
    assert a.exit_hop == b.exit_hop
    for ia, ib in zip(a.compute_intervals + a.link_intervals,
                      b.compute_intervals + b.link_intervals):
        assert len(ia) == len(ib)
        assert all(abs(s0 - s1) <= tol and abs(e0 - e1) <= tol
                   for (s0, e0), (s1, e1) in zip(ia, ib))
    for x, y in zip(a.compute_busy + a.link_busy,
                    b.compute_busy + b.link_busy):
        assert abs(x - y) <= tol


# ------------------------------------------------------------ chain path
def _chain(P, n_hops, seed, variant):
    batched = variant == "batched"
    sps = _plans(P, seed, n_hops, fixed_frac=0.6 if batched else None)
    links = _links(P, n_hops, variant == "traced")
    caps = [1, 4] + [2] * (n_hops - 1) if batched else None
    arrivals = [i * 2e-3 for i in range(len(sps))]
    rec = P.TR.TraceRecorder()
    res = P.A.AsyncHopPipeline(
        n_hops, links=links, clock=P.A.VirtualClock(), batch_caps=caps,
        sink=rec).run(lambda i, _a: sps[i], len(sps), arrivals)
    srec = P.TR.TraceRecorder()
    ref = P.S.simulate_stream(sps, arrivals, links=links, batch_caps=caps,
                              sink=srec)
    return res, rec, ref, srec


@pytest.mark.parametrize("variant", ["plain", "traced", "batched"])
@pytest.mark.parametrize("n_hops", [1, 2, 3])
def test_chain_executor_equals_jax_and_is_pinned_to_sim(n_hops, variant):
    j, jrec, _, _ = _chain(JAXP, n_hops, 10 + n_hops, variant)
    t, trec, ref, srec = _chain(PORT, n_hops, 10 + n_hops, variant)
    _equal(j, t)
    TTR.assert_traces_match(jrec, trec)
    _close_stream(ref, t)
    TTR.assert_traces_match(srec, trec)
    if variant == "batched":
        assert any(b > 1 for bs in t.compute_batch_sizes for b in bs)


def test_run_pipeline_async_equals_jax_with_irregular_arrivals():
    rng = np.random.RandomState(42)
    arrivals = np.cumsum(rng.uniform(0, 4e-3, 30)).tolist()
    j, t = (P.A.run_pipeline_async(_task_plans(P, 7, 2, n=30),
                                   arrivals=arrivals) for P in (JAXP, PORT))
    _equal(j, t)
    ref = TPL.run_pipeline(_task_plans(PORT, 7, 2, n=30), arrivals=arrivals)
    assert abs(ref.makespan - t.makespan) <= TOL
    assert all(abs(a.done - b.done) <= TOL for a, b in zip(ref.tasks, t.tasks))


# ------------------------------------------------------------- pool path
def _pool(P, policy, pools, batched):
    n_hops = 2
    sps = _plans(P, 21, n_hops, n=48, fixed_frac=0.5 if batched else None)
    caps = [2, 3, 2] if batched else None
    arrivals = [i * 1e-3 for i in range(len(sps))]
    rec = P.TR.TraceRecorder()
    res = P.A.AsyncHopPipeline(
        n_hops, clock=P.A.VirtualClock(), pools=pools, batch_caps=caps,
        router=P.R.make_router(policy, seed=3), sink=rec).run(
            lambda i, _a: sps[i], len(sps), arrivals)
    srec = P.TR.TraceRecorder()
    ref = P.S.simulate_pool_stream(sps, arrivals, pools,
                                   P.R.make_router(policy, seed=3),
                                   batch_caps=caps, sink=srec)
    return res, rec, ref, srec


@pytest.mark.parametrize("pools", ["m2", "hetero", "batched"])
@pytest.mark.parametrize("policy", ROUTERS)
def test_pool_executor_equals_jax_for_every_router(policy, pools):
    spec = {"m2": [1, 2, 1], "hetero": [(1.0, 1.6), (1.0, 1.3, 2.0), 1],
            "batched": [2, 2, 1]}[pools]
    j, jrec, _, _ = _pool(JAXP, policy, spec, pools == "batched")
    t, trec, ref, srec = _pool(PORT, policy, spec, pools == "batched")
    assert isinstance(t, TS.PoolStreamResult)
    _equal(j, t)
    TTR.assert_traces_match(jrec, trec)
    assert ref.routes == t.routes
    _close_stream(ref.as_stream_result(), t.as_stream_result())
    for ia, ib in zip((iv for tier in ref.replica_intervals for iv in tier),
                      (iv for tier in t.replica_intervals for iv in tier)):
        assert len(ia) == len(ib)
        assert all(abs(s0 - s1) <= TOL and abs(e0 - e1) <= TOL
                   for (s0, e0), (s1, e1) in zip(ia, ib))
    TTR.assert_traces_match(srec, trec)
    # the pool really spreads work over its replicas
    assert len({r[1] for r in t.routes}) > 1


# ------------------------------------------------------ multi-tenant path
def _tenants(P, n_hops, batched):
    plans = [_task_plans(P, 30 + t, n_hops, n=n,
                         fixed_frac=0.5 if batched else None)
             for t, n in enumerate((20, 16, 12))]
    arrivals = [[i * 4e-3 for i in range(20)], [0.0] * 16,
                [1e-3 + i * 6e-3 for i in range(12)]]
    return plans, arrivals


def _multitenant(P, policy, pools, batched):
    n_hops = 2
    plans, arrivals = _tenants(P, n_hops, batched)
    weights = [4.0, 1.0, 2.0]
    caps = [1, 3, 2] if batched else None
    router = (lambda: P.R.make_router("jsq")) if pools else (lambda: None)
    rec = P.TR.TraceRecorder()
    res = P.T.run_multitenant_async(
        plans, arrivals, policy=policy,
        weights=weights, links=[None] * n_hops, clock=P.A.VirtualClock(),
        batch_caps=caps, pools=pools, router=router(), sink=rec)
    srec = P.TR.TraceRecorder()
    pol = P.T.make_policy(policy, weights=weights)
    sps = [[p.as_sim_plan(n_hops) for p in ps] for ps in plans]
    if pools:
        ref = P.S.simulate_multitenant_pool_stream(
            sps, arrivals, pol, pools, router(), batch_caps=caps, sink=srec)
    else:
        ref = P.S.simulate_multitenant_stream(sps, arrivals, pol,
                                              batch_caps=caps, sink=srec)
    return res, rec, ref, srec


@pytest.mark.parametrize("variant", ["chain", "batched", "pools"])
@pytest.mark.parametrize("policy", ADMISSION)
def test_multitenant_executor_equals_jax_for_every_policy(policy, variant):
    pools = [2, 1, 1] if variant == "pools" else None
    batched = variant == "batched"
    j, jrec, _, _ = _multitenant(JAXP, policy, pools, batched)
    t, trec, ref, srec = _multitenant(PORT, policy, pools, batched)
    _equal(j, t)
    TTR.assert_traces_match(jrec, trec)
    assert ref.order == t.order
    _close_stream(ref.stream, t.stream)
    TTR.assert_traces_match(srec, trec)
    for k in range(3):
        assert all(abs(a - b) <= TOL for a, b in
                   zip(ref.tenant_latencies(k), t.tenant_latencies(k)))


# ------------------------------------------------------------- batching
@pytest.mark.parametrize("slack", [0.0, 3e-3, 12e-3, 40e-3])
def test_batch_cap_finders_equal_jax(slack):
    compute, fixed = [2e-3, 1.5e-3, 3e-3], [1.2e-3, 0.6e-3, 2.4e-3]
    for ingress in (None, 1):
        assert TB.auto_batch_caps(compute, fixed, slack, 16,
                                  ingress_cap=ingress) == \
            JB.auto_batch_caps(compute, fixed, slack, 16,
                               ingress_cap=ingress)
    measure = lambda n: 1e-3 + 0.4e-3 * n  # noqa: E731
    assert TB.find_batch_cap(measure, slack, 64) == \
        JB.find_batch_cap(measure, slack, 64)


# ------------------------------------------------------------- engines
def _engine_inputs(P, n_hops, seed, hop_exit):
    SC, CO = P.SC, P.CO
    if n_hops == 1:
        st = SC.StageTimes(T_e=2e-3, T_t=3e-3, T_c=2e-3, T_t_par=0,
                           T_c_par=0, latency=7e-3, first_tx_offset=2e-3,
                           cloud_start_offset=3e-3)
        links = None
    else:
        st = SC.StageTimes(
            T_e=2e-3, T_t=4e-3, T_c=2e-3, T_t_par=0.0, T_c_par=0.0,
            latency=9e-3, first_tx_offset=2e-3, cloud_start_offset=3e-3,
            compute=(2e-3, 1.5e-3, 2e-3), link=(3e-3, 1e-3),
            link_par=(0.0, 0.0), compute_par=(0.0, 0.0),
            tx_offsets=(2e-3, 1.5e-3), rx_offsets=(3e-3, 1e-3))
        links = [CO.LinkProfile("uplink", 20e6),
                 CO.LinkProfile("backhaul", 900e6)]
    stream = P.D.CorrelatedTaskStream(
        n_labels=30, dim=48, correlation="medium", seed=seed,
        n_probe_depths=n_hops if hop_exit else 1)
    if hop_exit:
        sets = P.D.make_hop_calibration_sets(stream, 300, n_depths=n_hops)
        (feats, labels), hop_calib = sets[0], sets[1:]
    else:
        feats, labels = P.D.make_calibration_set(stream, 300)
        hop_calib = None

    def classify(task):
        d = np.linalg.norm(stream.mu - task.features[None], axis=1)
        f = task.hop_features if task.hop_features is not None \
            else task.features
        return f, int(np.argmin(d))

    kw = dict(n_labels=30, calib_feats=feats, calib_labels=labels,
              boundary_elems=50_000, links=links, hop_calib=hop_calib)
    return st, stream, classify, kw


ENGINE_CASES = {
    "async-1hop": (1, False, dict(per_hop_bits=False, queue_capacity=0)),
    "async-2hop-exit": (2, True, {}),
    "async-pools": (2, False, dict(pool_sizes=(1, 2, 2), router="po2")),
    "async-batched-metrics": (2, True, dict(batch_caps=(1, 3, 2),
                                            batch_fixed_frac=0.5)),
}


def _run_engine(P, case):
    """(async stats, its config, sync stats) of package ``P`` on one
    seeded stream; each engine gets a fresh stream with the same seed."""
    n_hops, hop_exit, cfg_kw = ENGINE_CASES[case]
    out = []
    acfg = P.BA.EngineConfig(trace=P.TR.TraceRecorder(),
                             metrics=P.ME.MetricsRegistry(), **cfg_kw)
    for cls, cfg in ((P.A.AsyncCoachEngine, acfg),
                     (P.E.CoachEngine, P.BA.EngineConfig(**cfg_kw))):
        st, stream, classify, kw = _engine_inputs(P, n_hops, 4, hop_exit)
        eng = cls(None, st, P.CO.DeviceProfile("end", 1e9),
                  P.CO.LinkProfile("wifi", 20e6),
                  P.CO.DeviceProfile("cloud", 8e9), cfg=cfg, **kw)
        out.append(eng.run_stream(stream.tasks(150), arrival_period=2.5e-3,
                                  classify=classify))
    return out[0], out[1], acfg


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_async_engine_equals_jax_and_sync(case):
    """The port's async engine: the JAX package's stats, pipeline, trace
    and metrics on the same stream, and the port's sync engine's
    decisions."""
    j, _, jcfg = _run_engine(JAXP, case)
    t, s, tcfg = _run_engine(PORT, case)
    for f in ("exit_ratio", "mean_bits", "wire_kb_per_task", "accuracy"):
        assert getattr(t, f) == getattr(j, f) == getattr(s, f), f
    assert t.exit_hops == j.exit_hops == s.exit_hops
    _equal(j.pipeline, t.pipeline)
    TTR.assert_traces_match(jcfg.trace, tcfg.trace)
    assert tcfg.metrics.snapshot() == jcfg.metrics.snapshot()
    assert len(tcfg.metrics.snapshot()["counters"]) > 0
    if case == "async-1hop":  # the sync reference's timeline at 1e-6
        assert abs(s.pipeline.makespan - t.pipeline.makespan) < TOL
        assert all(abs(a.done - b.done) < TOL
                   for a, b in zip(s.pipeline.tasks, t.pipeline.tasks))
    if case == "async-2hop-exit":
        assert t.exit_hops.get(1, 0) > 0, t.exit_hops


def _run_mt_engine(P, policy, tenants_kw, hop_exit, solo=None):
    st, stream, classify, kw = _engine_inputs(P, 2, 6, hop_exit)
    tenants = [P.T.TenantSpec(**k) for k in tenants_kw]
    tasks = [list(stream.tasks(k["n_tasks"])) for k in tenants_kw]
    if solo is not None:
        tenants, tasks = [tenants[solo]], [tasks[solo]]
    eng = P.T.MultiTenantCoachEngine(
        None, st, P.CO.DeviceProfile("end", 1e9),
        P.CO.LinkProfile("wifi", 20e6), P.CO.DeviceProfile("cloud", 8e9),
        tenants=tenants, policy=policy, **kw)
    return eng.run_streams(tasks, classify), eng


TENANTS = [dict(name="interactive", n_tasks=50, arrival_period=4e-3,
                weight=4.0, slo_latency=30e-3),
           dict(name="burst", n_tasks=40, arrivals=(0.0,) * 40, weight=1.0)]


@pytest.mark.parametrize("policy", ADMISSION)
def test_multitenant_engine_equals_jax_and_keeps_solo_decisions(policy):
    j, _ = _run_mt_engine(JAXP, policy, TENANTS, hop_exit=True)
    t, eng = _run_mt_engine(PORT, policy, TENANTS, hop_exit=True)
    assert t.order == j.order
    _equal(j.pipeline, t.pipeline)
    ref = TS.simulate_multitenant_stream(
        t.plans, t.arrivals, TT.make_policy(policy, weights=[4.0, 1.0]),
        links=eng.links)
    assert ref.order == t.order
    assert all(abs(a.done - b) < TOL
               for a, b in zip(t.pipeline.tasks, ref.stream.done))
    for k in range(len(TENANTS)):
        a, b = t.reports[k], j.reports[k]
        assert a.slo_attainment == b.slo_attainment
        _equal(b.stats.pipeline, a.stats.pipeline)
        solo, _ = _run_mt_engine(PORT, policy, TENANTS, True, solo=k)
        for f in ("exit_ratio", "mean_bits", "accuracy"):
            assert getattr(a.stats, f) == getattr(b.stats, f) == \
                getattr(solo.reports[0].stats, f), f
    assert t.pipeline.exit_hop_counts().get(1, 0) > 0
    assert t.worst_tenant_p99 == j.worst_tenant_p99


# ------------------------------------------- fused 3-tuple probes (engine)
def _fused_classify(P, stream):
    mu = stream.mu / np.linalg.norm(stream.mu, axis=1, keepdims=True)
    ON = P.ON

    def f(task):
        fn = task.features / max(np.linalg.norm(task.features), 1e-12)
        sims = (mu @ fn + 1.0) * 0.5
        order = np.argsort(-sims)
        t_h, t_sh = float(sims[order[0]]), float(sims[order[1]])
        sep = (t_h - t_sh) * t_h / max(t_sh, 1e-12)
        pr = ON.ProbeResult(sims=sims, sep=sep, best=int(order[0]))
        return task.features, int(order[0]), pr
    return f


def test_async_engine_decisions_identical_with_fused_probes():
    """Twin of the reference's fused-probe engine differential: with the
    3-tuple classify protocol, the port's sync and async engines give
    equal ``EngineStats``, and so does the JAX package."""
    import repro.core.online as JON
    import repro_torch.core.online as TON
    out = {}
    for name, P, ON in (("jax", JAXP, JON), ("port", PORT, TON)):
        P = SimpleNamespace(**vars(P), ON=ON)
        st = P.SC.StageTimes(T_e=2e-3, T_t=3e-3, T_c=2e-3, T_t_par=0,
                             T_c_par=0, latency=7e-3, first_tx_offset=2e-3,
                             cloud_start_offset=3e-3)
        stream = P.D.CorrelatedTaskStream(n_labels=12, dim=32,
                                          correlation="high", seed=11)
        feats, labels = P.D.make_calibration_set(stream, 300)
        mk = lambda cls: cls(  # noqa: E731
            None, st, P.CO.JETSON_NX, P.CO.WIFI_5GHZ(20),
            P.CO.A6000_SERVER, n_labels=12, calib_feats=feats,
            calib_labels=labels, boundary_elems=50_000)
        classify = _fused_classify(P, stream)
        tasks = list(stream.tasks(200))
        out[name] = [mk(cls).run_stream(list(tasks), arrival_period=3e-3,
                                        classify=classify)
                     for cls in (P.E.CoachEngine, P.A.AsyncCoachEngine)]
    (js, ja), (s, a) = out["jax"], out["port"]
    for f in ("exit_ratio", "mean_bits", "accuracy", "wire_kb_per_task"):
        assert getattr(s, f) == getattr(a, f) == getattr(js, f) == \
            getattr(ja, f), f
    assert abs(s.pipeline.makespan - a.pipeline.makespan) < TOL
    assert 0 < s.exit_ratio < 1
    _equal(ja.pipeline, a.pipeline)


# --------------------------------------------- real segments in workers
def test_segment_handles_execute_real_model_through_workers():
    """Twin of the reference test: the port's ``CollabRuntime`` segment
    handles, run by the executor's compute workers, give ``rt.run``'s
    logits, on weights converted from the JAX package's ``init_params``;
    and those logits are the JAX runtime's on the same tokens."""
    from repro.configs import get_config
    from repro.core.collab import CollabRuntime as JRuntime
    from repro.models import model as JM
    from repro_torch.core.collab import CollabRuntime
    from repro_torch.models import model as M

    cfg = get_config("gemma2-2b").reduced(num_layers=8)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
    cuts = (1, 3)
    rt, jrt = CollabRuntime(cfg, params, cuts), JRuntime(cfg, jparams, cuts)
    xs = [np.random.default_rng(i).integers(0, cfg.vocab_size, (1, 8))
          .astype(np.int32) for i in range(3)]
    handles = [rt.segment_handle(k) for k in range(rt.n_segments)]
    plans = [TPL.TaskPlan.multihop((1e-3,) * 3, (1e-3,) * 2) for _ in xs]
    pipe = TA.AsyncHopPipeline(
        2, clock=TA.VirtualClock(),
        segment_fn=lambda k, idx, payload: handles[k](payload))
    res = pipe.run(lambda i, _arr: plans[i].as_sim_plan(2), len(xs),
                   [0.0, 1e-3, 2e-3], payloads=[torch.from_numpy(x)
                                                for x in xs])
    assert not any(res.early_exit)
    for i, x in enumerate(xs):
        want, _ = rt.run(torch.from_numpy(x))
        np.testing.assert_allclose(pipe.outputs[i].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert_runs_agree_across_packages(rt, jrt, x)


def assert_runs_agree_across_packages(rt, jrt, x):
    """``rt.run`` of the port against the JAX runtime's on tokens ``x``.
    The two forwards round in other places, so a code at a hop may round
    the other way: every hop's dequantized values agree within a quantum,
    and the port's last segment on the JAX package's last packet gives
    its logits within fp32 tolerance (``CROSS_TOL``)."""
    from repro_torch.core.collab import WirePacket
    logits, pkts = rt.run(torch.from_numpy(x))
    jlogits, jpkts = jrt.run(jax.numpy.asarray(x))
    assert len(pkts) == len(jpkts)
    for p, jp in zip(pkts, jpkts):
        assert p.bits == jp.bits and p.hop == jp.hop
        deq, jdeq = p.dequantize().numpy(), np.asarray(jp.dequantize())
        assert (np.abs(deq - jdeq) <= np.asarray(jp.scale) * 1.001).all()
    last = jpkts[-1]
    same = WirePacket(*(torch.from_numpy(np.array(a)) for a in
                        (last.payload, last.scale, last.zp)), last.bits,
                      hop=last.hop, channels=last.channels)
    np.testing.assert_allclose(
        rt.segment_step(rt.n_segments - 1, same).numpy(),
        np.asarray(jlogits), **CROSS_TOL)
    assert logits.shape == jlogits.shape
