"""Churn storyline walkthrough: ride a link fault with online re-planning.

A VGG16 stream runs the 2-tier end-cloud deployment while hop 0's WiFi
degrades mid-stream (50 -> 12 Mbps) and later recovers — the scripted
``degrade`` storyline of the resilience bench.  The scenario engine
executes it on *both* pipeline engines (the 1e-6 differential pin is
asserted inside the runner), the online re-planner detects the regime
shift from the bandwidth EMA at task arrivals, re-runs the offline
planner with warm tables, and migrates in-flight tasks at hop
boundaries with a precision drop on the degraded hop.

The printout slices the bubble attribution into before / during / after
the fault window, per cause — including the ``replanning`` cause the
migration spans introduce — and closes with the static-vs-replan p99
through the window.

  PYTHONPATH=src python examples_torch/churn_storyline.py [--tasks 120]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from repro_torch.core.costs import A6000_SERVER, JETSON_NX, WIFI_5GHZ
from repro_torch.models.cnn import vgg16
from repro_torch.obs.bubbles import CAUSES, attribute, chain_resources
from repro_torch.scenarios import LinkShift, Timeline, run_chain_scenario
from repro_torch.scenarios.replan import replan_timeline

DEVICES = (JETSON_NX, A6000_SERVER)
LINKS = (WIFI_5GHZ(50.0),)
DEGRADED_MBPS = 12.0
WINDOW = (25, 75)  # fault window, in arrival periods


def _phase_causes(att, lo: float, hi: float):
    """Cause -> seconds, for bubbles clipped to ``[lo, hi)``."""
    out = {}
    for b in att.bubbles:
        d = min(b.t1, hi) - max(b.t0, lo)
        if d > 0:
            out[b.cause] = out.get(b.cause, 0.0) + d
    return out


def _print_phase_table(att, t_deg: float, t_rec: float) -> None:
    phases = (("before", 0.0, t_deg), ("during", t_deg, t_rec),
              ("after", t_rec, att.horizon[1]))
    by_phase = {name: _phase_causes(att, lo, hi)
                for name, lo, hi in phases}
    causes = [c for c in CAUSES
              if any(c in p for p in by_phase.values())]
    print(f"  {'idle by cause (ms)':<22}"
          + "".join(f"{n:>12}" for n, _, _ in phases))
    for c in causes:
        row = "".join(f"{by_phase[n].get(c, 0.0) * 1e3:>12.1f}"
                      for n, _, _ in phases)
        print(f"  {c:<22}{row}")


def _p99_window(pr, lo: float, hi: float) -> float:
    lat = [t.latency for t in pr.tasks if lo <= t.arrival < hi]
    return float(np.percentile(lat, 99)) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="accepted as by the other examples; the "
                         "storyline runs the planner and simulators on "
                         "the host and puts nothing on a device")
    args = ap.parse_args()

    graph = vgg16()
    versions, _ = replan_timeline(graph, DEVICES, list(LINKS),
                                  arrivals=[])
    period = versions[0].times.max_stage * 1.05
    t_deg, t_rec = WINDOW[0] * period, WINDOW[1] * period
    tl = Timeline([LinkShift(t_deg, 0, DEGRADED_MBPS),
                   LinkShift(t_rec, 0, 50.0)],
                  horizon=(args.tasks + 5) * period)
    print(f"{graph.name} on {DEVICES[0].name}->{DEVICES[1].name}, "
          f"hop 0 degrades 50->{DEGRADED_MBPS:.0f} Mbps over "
          f"[{t_deg * 1e3:.0f}, {t_rec * 1e3:.0f}] ms")

    print("\n== static plan rides through the fault ==")
    static = run_chain_scenario(graph, DEVICES, LINKS, tl, args.tasks,
                                replan=False)
    att_s = attribute(static.traces[0],
                      resources=chain_resources(static.sim.n_hops))
    _print_phase_table(att_s, t_deg, t_rec)

    print("\n== online re-planning (EMA detection + migration) ==")
    replan = run_chain_scenario(graph, DEVICES, LINKS, tl, args.tasks,
                                min_gap=10 * period,
                                degraded_tx_scale=0.5)
    att_r = attribute(replan.traces[0],
                      resources=chain_resources(replan.sim.n_hops))
    _print_phase_table(att_r, t_deg, t_rec)
    print(f"\n  re-plans: {replan.n_replans}, in-flight migrations: "
          f"{replan.n_migrations}, sim/async pin delta "
          f"{replan.max_done_delta:.2e} s")

    p99_s = _p99_window(static.sim, t_deg, t_rec)
    p99_r = _p99_window(replan.sim, t_deg, t_rec)
    print(f"\n  p99 through the fault window: static {p99_s:.1f} ms, "
          f"replanned {p99_r:.1f} ms ({p99_s / p99_r:.1f}x better)")


if __name__ == "__main__":
    main()
