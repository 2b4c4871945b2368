"""Twins of the three JAX-free tests of ``tests/test_boundary.py`` (lines
84-137), with ``repro.`` renamed to ``repro_torch.``: lifting the fused
pass's probe outputs into a ``ProbeResult`` over the full label space
(``core/online.py``), and the scheduler's step taking a supplied
``ProbeResult`` in place of its own cache recompute
(``serving/engine.py``).  The reference file imports JAX at its top, so
the twins live in this JAX-free file and also run on the card's machine.
"""

import numpy as np

from repro_torch.core import online as ON
from repro_torch.core.costs import (A6000_SERVER, JETSON_NX, WIFI_5GHZ)
from repro_torch.core.schedule import StageTimes
from repro_torch.data.pipeline import (CorrelatedTaskStream,
                                       make_calibration_set)
from repro_torch.serving.engine import CoachEngine


# --------------------------------------------------- ProbeResult lifting
def test_probe_result_from_fused_scatters_to_full_label_space():
    sims = np.array([0.9, 0.2, 0.6])
    pr = ON.ProbeResult.from_fused(sims, sep=1.7, best=0,
                                   valid=np.array([3, 5, 8]), n_labels=10)
    full = np.zeros(10)
    full[[3, 5, 8]] = sims
    np.testing.assert_array_equal(pr.sims, full)
    assert pr.best == 3 and pr.sep == 1.7


def test_probe_result_from_fused_cold_cache_never_exits():
    # < 2 trained centers: no genuine second-highest degree, sep forced 0
    pr = ON.ProbeResult.from_fused(np.array([0.9]), sep=5.0, best=0,
                                   valid=np.array([4]), n_labels=6)
    assert pr.sep == 0.0 and pr.best == 4
    pr = ON.ProbeResult.from_fused(np.zeros(0), sep=5.0, best=0,
                                   valid=np.zeros(0, int), n_labels=6)
    assert pr.sep == 0.0 and pr.best == 0 and not pr.sims.any()


def test_scheduler_step_consumes_probe_result():
    """A supplied ProbeResult replaces the cache recompute: an enormous
    separability forces the exit the cache's own sims would not take,
    and sep = 0 blocks exit regardless of the features."""
    stream = CorrelatedTaskStream(n_labels=8, dim=16, correlation="high",
                                  seed=0)
    feats, labels = make_calibration_set(stream, 200)
    eng = CoachEngine(None, StageTimes(
        T_e=2e-3, T_t=3e-3, T_c=2e-3, T_t_par=0, T_c_par=0, latency=7e-3,
        first_tx_offset=2e-3, cloud_start_offset=3e-3), JETSON_NX,
        WIFI_5GHZ(20), A6000_SERVER, n_labels=8, calib_feats=feats,
        calib_labels=labels, boundary_elems=10_000)
    sched = eng.sched
    f = feats[0]
    force = ON.ProbeResult(sims=np.full(8, 0.5), sep=1e9, best=3)
    dec = sched.step(f, probe=force)
    assert dec.early_exit and dec.result == 3
    block = ON.ProbeResult(sims=np.full(8, 0.5), sep=0.0, best=3)
    dec = sched.step(f, probe=block)
    assert not dec.early_exit
