"""The port's scenario layer (``repro_torch.scenarios``) and baseline
schedulers (``repro_torch.core.baselines``) against the JAX package's on
the same graphs, timelines and seeds.

``runner.run_dual`` asserts its own 1e-6 sim/executor pin inside each
package; on top, the port's ``ScenarioResult`` (both engines' pipelines,
traces, migrations, plan versions) must equal the JAX package's.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import repro.core.baselines as JBL  # noqa: E402
import repro.core.costs as JCO  # noqa: E402
import repro.core.sim as JS  # noqa: E402
import repro.models.cnn as JCNN  # noqa: E402
import repro.scenarios as JSC  # noqa: E402
import repro.scenarios.replan as JRP  # noqa: E402
import repro_torch.core.baselines as TBL  # noqa: E402
import repro_torch.core.costs as TCO  # noqa: E402
import repro_torch.core.sim as TS  # noqa: E402
import repro_torch.models.cnn as TCNN  # noqa: E402
import repro_torch.scenarios as TSC  # noqa: E402
import repro_torch.scenarios.replan as TRP  # noqa: E402
from repro_torch.obs.bubbles import (REPLANNING, attribute,  # noqa: E402
                                     chain_resources)
from repro_torch.obs.trace import assert_traces_match  # noqa: E402

JAXP = dict(CO=JCO, S=JS, CNN=JCNN, SC=JSC, RP=JRP)
PORT = dict(CO=TCO, S=TS, CNN=TCNN, SC=TSC, RP=TRP)


def _base(P):
    devices = (P["CO"].JETSON_NX, P["CO"].A6000_SERVER)
    links = (P["CO"].WIFI_5GHZ(50.0),)
    graph = P["CNN"].vgg16()
    versions, _ = P["RP"].replan_timeline(graph, devices, list(links),
                                          arrivals=[])
    return graph, devices, links, versions[0], \
        versions[0].times.max_stage * 1.05


def _scenario(P, case):
    SC = P["SC"]
    graph, devices, links, v0, period = _base(P)
    if case == "zero":
        n = 30
        return SC.run_chain_scenario(graph, devices, links,
                                     SC.Timeline([], horizon=(n + 5) * period),
                                     n_tasks=n)
    if case in ("replan", "static"):
        n = 90
        tl = SC.Timeline([SC.LinkShift(20 * period, 0, 12.0),
                          SC.LinkShift(60 * period, 0, 50.0)],
                         horizon=(n + 5) * period)
        return SC.run_chain_scenario(graph, devices, links, tl, n_tasks=n,
                                     replan=case == "replan",
                                     min_gap=10 * period,
                                     degraded_tx_scale=0.5)
    # churn on pools under a degraded, then recovered, uplink
    tl = SC.Timeline([SC.LinkShift(15 * period, 0, 20.0),
                      SC.ReplicaDown(10 * period, 1, 0),
                      SC.ReplicaUp(40 * period, 1, 0),
                      SC.ReplicaDown(20 * period, 0, 1),
                      SC.ReplicaUp(35 * period, 0, 1),
                      SC.LinkShift(45 * period, 0, 50.0)],
                     horizon=70 * period)
    pools = [P["S"].PoolSpec((1.0, 1.0)), P["S"].PoolSpec((1.0, 1.0, 1.0))]
    return SC.run_churn_scenario([v0.plan], tl, period, pools,
                                 links=tl.link_profiles(list(links)),
                                 n_tasks=60)


@pytest.mark.parametrize("case", ["zero", "replan", "static", "churn"])
def test_scenario_result_equals_jax(case):
    j, t = _scenario(JAXP, case), _scenario(PORT, case)
    assert type(t).__name__ == "ScenarioResult"
    assert dataclasses.asdict(t.sim) == dataclasses.asdict(j.sim)
    assert dataclasses.asdict(t.async_) == dataclasses.asdict(j.async_)
    for a, b in zip(t.traces, j.traces):
        assert_traces_match(a, b, tol=1e-6)
    assert (t.max_done_delta, t.n_migrations, t.n_replans) == \
        (j.max_done_delta, j.n_migrations, j.n_replans)
    assert [repr(v) for v in t.versions] == [repr(v) for v in j.versions]
    # the port's own pin (run_dual asserted it at 1e-6 too)
    assert t.max_done_delta <= 1e-6
    assert_traces_match(t.traces[0], t.traces[1], tol=1e-6)
    if case == "replan":
        assert t.n_replans >= 1 and t.n_migrations >= 1
        for rec in t.traces:
            att = attribute(rec, resources=chain_resources(t.sim.n_hops))
            assert att.max_conservation_error() <= 1e-9
            assert REPLANNING in {c for cs in att.by_label().values()
                                  for c in cs}
    if case == "churn":
        assert len(t.sim.tasks) == 60
        assert any(t.sim.link_busy_hops)


def test_replanned_scenario_beats_static_in_the_window():
    _, _, _, _, period = _base(PORT)
    replan, static = _scenario(PORT, "replan"), _scenario(PORT, "static")
    lo, hi = 20 * period, 60 * period

    def p99(pr):
        lat = sorted(t.latency for t in pr.tasks if lo <= t.arrival < hi)
        return lat[min(len(lat) - 1, int(math.ceil(0.99 * len(lat))))]

    assert p99(replan.sim) < p99(static.sim)


@pytest.mark.parametrize("model", ["resnet101", "vgg16"])
@pytest.mark.parametrize("mbps", [20.0, 50.0])
def test_baseline_decisions_equal_jax(model, mbps):
    jg, tg = getattr(JCNN, model)(), getattr(TCNN, model)()
    assert repr(jg.nodes) == repr(tg.nodes)
    jargs = (jg, JCO.JETSON_NX, JCO.A6000_SERVER, JCO.WIFI_5GHZ(mbps))
    targs = (tg, TCO.JETSON_NX, TCO.A6000_SERVER, TCO.WIFI_5GHZ(mbps))
    assert sorted(TBL.BASELINES) == sorted(JBL.BASELINES)
    for name in TBL.BASELINES:
        want, got = JBL.BASELINES[name](*jargs), TBL.BASELINES[name](*targs)
        assert got.decision.end_set == want.decision.end_set, name
        assert got.decision.bits == want.decision.bits, name
        assert dataclasses.asdict(got.times) == \
            dataclasses.asdict(want.times), name
        assert tg.valid_end_set(got.decision.end_set)


def test_multihop_baselines_equal_jax():
    jg, tg = JCNN.vgg16(), TCNN.vgg16()
    jdev = (JCO.JETSON_NX, JCO.EDGE_AGX_ORIN, JCO.A6000_SERVER)
    tdev = (TCO.JETSON_NX, TCO.EDGE_AGX_ORIN, TCO.A6000_SERVER)
    for name in ("ns", "dads", "spinn", "jps"):
        want = JBL.baseline_multihop(name, jg, jdev,
                                     (JCO.WIFI_5GHZ(50.0), JCO.ETH_LAN()))
        got = TBL.baseline_multihop(name, tg, tdev,
                                    (TCO.WIFI_5GHZ(50.0), TCO.ETH_LAN()))
        assert repr(got.decision) == repr(want.decision), name
        assert dataclasses.asdict(got.times) == \
            dataclasses.asdict(want.times), name
