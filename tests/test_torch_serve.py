"""The port's serving launcher (``repro_torch.launch.serve``) against the
JAX package's on the same weights: reduced configs, 24 requests, the
JAX package's ``init_params(PRNGKey(0))`` weights converted for the port.

The cut, the offline bits, the printed summary and every task's online
decision must be equal.  A task may decide differently only when a
threshold lies between the two packages' separability values, which must
agree to ``SEP_TOL`` (the probe tolerance of the kernel tests: rtol 1e-4,
atol 1e-5); none does on these inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core import online as JON  # noqa: E402
from repro.launch.serve import serve as j_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import online as TON  # noqa: E402
from repro_torch.launch import serve as T  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

SEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _record_decisions(monkeypatch, mod):
    """Wrap ``OnlineScheduler.step`` of an ``online`` module to log every
    decision with the thresholds it was taken against."""
    log = []
    step = mod.OnlineScheduler.step

    def wrapped(self, feat, *a, **kw):
        dec = step(self, feat, *a, **kw)
        log.append((dec, self.th))
        return dec

    monkeypatch.setattr(mod.OnlineScheduler, "step", wrapped)
    return log


def _summary(text):
    """The printed lines that carry decisions (drop the wall-clock one)."""
    return [ln for ln in text.splitlines() if "(wall" not in ln]


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-vl-2b", "mamba2-130m",
                                  "mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_serve_makes_the_reference_decisions(arch, monkeypatch, capsys):
    cfg = get_config(arch).reduced()
    jp = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))
    jlog = _record_decisions(monkeypatch, JON)
    tlog = _record_decisions(monkeypatch, TON)
    want = j_serve(arch, requests=24)
    jout = capsys.readouterr().out
    got = T.serve(arch, requests=24, device="cpu",
                  params=M.params_from_numpy(jp, cfg, "cpu"))
    tout = capsys.readouterr().out
    # cut_group and offline bits (first line), exit ratio / mean bits /
    # wire bytes (second line), planner latencies and bubble table
    assert _summary(tout) == _summary(jout)
    assert "cut_group=" in tout.splitlines()[0]
    assert len(jlog) == len(tlog) == 24
    for (jd, jth), (td, tth) in zip(jlog, tlog):
        np.testing.assert_allclose(td.separability, jd.separability,
                                   **SEP_TOL)
        same = (jd.early_exit, jd.bits, jd.result) == \
            (td.early_exit, td.bits, td.result)
        if not same:  # allowed only across a threshold
            lo, hi = sorted((jd.separability, td.separability))
            cuts = [jth.s_ext] + [f for f, _ in jth.s_adj]
            assert any(lo <= c <= hi for c in cuts), (jd, td)
    assert got.exit_ratio == want.exit_ratio
    assert got.mean_bits == want.mean_bits
    assert got.wire_kb_per_task == want.wire_kb_per_task
    assert [t.early_exit for t in got.pipeline.tasks] == \
        [t.early_exit for t in want.pipeline.tasks]


def test_serve_keeps_the_reference_clamp_on_one_group_jamba():
    """Reduced jamba has one group: serve's clamp gives cut 0, which
    ``split_params_multi`` refuses, as the JAX package's does."""
    with pytest.raises(AssertionError, match=r"\[0\]"):
        T.serve("jamba-1.5-large-398b", requests=2, device="cpu")


def test_serve_runs_at_the_depth_of_the_given_weights(capsys):
    """Weights of a depth-cut model (3 gemma2 groups instead of the
    reduced config's 2) serve at their own depth."""
    cfg = get_config("gemma2-2b").reduced(num_layers=6)
    params = M.init_params(cfg, seed=0, device="cpu")
    T.serve("gemma2-2b", requests=2, device="cpu", params=params)
    assert "/3 " in capsys.readouterr().out.splitlines()[0]


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.serve("gemma2-2b", requests=2, verbose=False)


def test_serve_cli_is_the_reference_cli(monkeypatch):
    """``main()`` parses the reference's options and hands them to
    ``serve``, on the CUDA device unless ``--device`` names another, and
    ``--trace PATH``, the port's own, as ``trace_path``."""
    seen = {}
    monkeypatch.setattr(T, "serve", lambda arch, **kw: seen.update(
        arch=arch, **kw))
    argv = ["serve", "--arch", "qwen3-14b", "--requests", "5",
            "--bandwidth", "20", "--correlation", "high"]
    want = {"arch": "qwen3-14b", "requests": 5, "bandwidth_mbps": 20.0,
            "correlation": "high"}
    monkeypatch.setattr("sys.argv", argv)
    T.main()
    assert seen == dict(want, device="cuda", trace_path=None)
    monkeypatch.setattr("sys.argv", argv + ["--device", "cpu"])
    T.main()
    assert seen == dict(want, device="cpu", trace_path=None)
    # the port's own option: the runtime's wall-clock spans to a file
    monkeypatch.setattr("sys.argv", argv + ["--trace", "spans.json"])
    T.main()
    assert seen == dict(want, device="cuda", trace_path="spans.json")
