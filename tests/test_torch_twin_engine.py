"""CoachEngine integration: offline + online + pipeline over a task stream."""

import numpy as np
import pytest

from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ,
                              transformer_graph)
from repro_torch.core.partitioner import coach_offline
from repro_torch.core.schedule import StageTimes
from repro_torch.data.pipeline import CorrelatedTaskStream, make_calibration_set
from repro_torch.serving.engine import CoachEngine


def _engine(correlation="medium", mbps=20.0, seed=0):
    st = StageTimes(T_e=2e-3, T_t=3e-3, T_c=2e-3, T_t_par=0, T_c_par=0,
                    latency=7e-3, first_tx_offset=2e-3, cloud_start_offset=3e-3)
    stream = CorrelatedTaskStream(n_labels=30, dim=48,
                                  correlation=correlation, seed=seed)
    feats, labels = make_calibration_set(stream, 400)
    eng = CoachEngine(None, st, JETSON_NX, WIFI_5GHZ(mbps), A6000_SERVER,
                      n_labels=30, calib_feats=feats, calib_labels=labels,
                      boundary_elems=50_000)
    return eng, stream


def _classify(stream):
    def f(task):
        # proxy cloud classifier: nearest true (undrifted) class center
        d = np.linalg.norm(stream.mu - task.features[None], axis=1)
        return task.features, int(np.argmin(d))
    return f


def test_engine_runs_and_accounts():
    eng, stream = _engine()
    stats = eng.run_stream(stream.tasks(300), arrival_period=3e-3,
                           classify=_classify(stream))
    assert 0 <= stats.exit_ratio <= 1
    assert stats.accuracy > 0.7
    assert stats.pipeline.throughput > 0
    assert stats.pipeline.mean_latency > 0


def test_exit_ratio_ordering_across_correlation():
    rs = {}
    for corr in ("low", "medium", "high"):
        eng, stream = _engine(corr, seed=3)
        stats = eng.run_stream(stream.tasks(500), arrival_period=3e-3,
                               classify=_classify(stream))
        rs[corr] = stats.exit_ratio
    assert rs["low"] < rs["medium"] < rs["high"]


def test_higher_correlation_lowers_latency_and_wire():
    eng_l, stream_l = _engine("low", seed=5)
    eng_h, stream_h = _engine("high", seed=5)
    s_l = eng_l.run_stream(stream_l.tasks(400), 3e-3, _classify(stream_l))
    s_h = eng_h.run_stream(stream_h.tasks(400), 3e-3, _classify(stream_h))
    assert s_h.pipeline.mean_latency < s_l.pipeline.mean_latency
    assert s_h.wire_kb_per_task < s_l.wire_kb_per_task


def test_bandwidth_drop_raises_bits_pressure():
    """At lower bandwidth Eq. 11 picks fewer bits (link is the bottleneck)."""
    eng_hi, st_hi = _engine(mbps=100.0, seed=7)
    eng_lo, st_lo = _engine(mbps=5.0, seed=7)
    s_hi = eng_hi.run_stream(st_hi.tasks(300), 3e-3, _classify(st_hi))
    s_lo = eng_lo.run_stream(st_lo.tasks(300), 3e-3, _classify(st_lo))
    assert s_lo.mean_bits <= s_hi.mean_bits
