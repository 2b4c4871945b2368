"""The twins in ``examples_torch/`` of the five examples that need only
ported modules, against the reference examples in ``examples/`` on the
CPU, at small arguments and on the same seeds.  Weights and inputs that
the reference draws with ``jax.random`` reach the twin converted
(``params_from_numpy``, ``torch.from_numpy``), as the port cannot draw
them itself.

What must be equal, and within what:
- the planner's output (cuts, bits, plan times, candidates) and every
  exit / bit decision: exactly;
- the simulated pipeline lines (latencies, bubbles, throughput) and the
  churn storyline's whole printed timeline: exactly, as printed (they
  are the planner's model, computed on the host alike);
- the split-vs-monolithic error and the separabilities, which the
  reference prints rounded to 4 and 3 places: the twin's own value within
  1e-5 of the reference's, so within half a printed unit + 1e-5 of the
  printed figure;
- the training losses: 1e-5 relative (``forward_train``'s loss across
  packages);
- wall-clock figures (the planner's ms, serve's wall) are left out.
No file in ``examples_torch/`` imports JAX or the JAX package.
"""

import ast
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as JCK  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TWINS = ["quickstart", "collaborative_serving", "train_small", "edge_tier",
         "churn_storyline"]


def _load(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_examples_torch_holds_the_five_twins():
    assert sorted(p.stem for p in (ROOT / "examples_torch").glob("*.py")) \
        == sorted(TWINS)
    assert all((ROOT / "examples" / f"{n}.py").exists() for n in TWINS)


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_the_jax_package(name):
    tree = ast.parse((ROOT / "examples_torch" / f"{name}.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots
    assert "repro_torch" in roots


_BLOCKED = r"""
import importlib.util, sys
for m in ("jax", "jaxlib", "repro", "benchmarks"):
    sys.modules[m] = None  # an import of any of them raises
for name in sys.argv[2:]:
    spec = importlib.util.spec_from_file_location(
        name, f"{sys.argv[1]}/examples_torch/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", len(sys.argv) - 2)
"""


def test_twins_import_with_jax_and_the_jax_package_blocked():
    r = subprocess.run([sys.executable, "-c", _BLOCKED, str(ROOT), *TWINS],
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == ["imported", str(len(TWINS))]


# ------------------------------------------------------------ quickstart
COLLAB = re.compile(r"collab: wire=(\d+)B \(fp32 would be (\d+)B\) "
                    r"rel-err=([\d.]+)")
TASK = re.compile(r"task (\d): separability=(-?[\d.]+) -> (.*)")


def test_quickstart_twin_makes_the_reference_plan_and_choices(capsys):
    """``examples/quickstart.py`` against its twin's ``run`` on the
    reference's weights, tokens and centers (its ``PRNGKey(0)``, ``(1)``
    and ``(2)`` draws): the model and plan lines and the candidates equal,
    the wire bytes equal, the split's error and each separability within
    1e-5 of the reference's, and every task's exit or bits equal."""
    _load("examples", "quickstart").main()
    want = capsys.readouterr().out.splitlines()
    jcfg = jget_config("gemma2-2b").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    x = jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0,
                           jcfg.vocab_size)
    centers = jax.random.normal(jax.random.PRNGKey(2), (8, jcfg.d_model))
    cfg = get_config("gemma2-2b").reduced()
    res = _load("examples_torch", "quickstart").run(
        cfg, M.params_from_numpy(_np(jp), cfg, "cpu"),
        torch.from_numpy(np.array(x)), torch.from_numpy(np.array(centers)))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 8
    assert got[:2] == want[:2]  # model, offline plan
    assert got[2].split(" in ")[0] == want[2].split(" in ")[0]
    g, w = COLLAB.match(got[3]).groups(), COLLAB.match(want[3]).groups()
    assert g[:2] == w[:2]
    assert abs(res["rel_err"] - float(w[2])) <= 0.5e-4 + 1e-5
    for line, ref, (sep, *_) in zip(got[4:], want[4:], res["choices"]):
        (i, _, choice), (j, ref_sep, ref_choice) = (
            TASK.match(line).groups(), TASK.match(ref).groups())
        assert (i, choice) == (j, ref_choice)
        assert abs(sep - float(ref_sep)) <= 0.5e-3 + 1e-5
    assert sum(c[1] == "exit" for c in res["choices"]) == 2


# ------------------------------------------------------------- edge_tier
def _without_walls(lines):
    """The printed lines with the planner's wall-clock part cut off."""
    return [ln.split(" in ")[0] if "planner:" in ln else ln for ln in lines]


def test_edge_tier_twin_prints_the_reference_runs(monkeypatch, capsys):
    """``examples/edge_tier.py --requests 6`` and its twin on the
    reference's weights: both deployments' cuts, objective, candidates,
    exit ratio and hops, bits, wire bytes, simulated latencies, bubbles
    and the async engine's agreement, line for line."""
    monkeypatch.setattr("sys.argv", ["edge_tier", "--requests", "6"])
    _load("examples", "edge_tier").main()
    want = capsys.readouterr().out.splitlines()
    base = jget_config("gemma2-2b")
    jp = JM.init_params(base.reduced(num_layers=4 * len(base.pattern)),
                        jax.random.PRNGKey(0))
    cfg = get_config("gemma2-2b").reduced(num_layers=4 * len(base.pattern))
    out = _load("examples_torch", "edge_tier").main(
        ["--requests", "6", "--device", "cpu"],
        params=M.params_from_numpy(_np(jp), cfg, "cpu"))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 10
    assert _without_walls(got) == _without_walls(want)
    assert "decisions_match_sync=True" in got[-1]
    assert out["end->edge->cloud"][0] == (2, 3)


# ------------------------------------------------ collaborative_serving
def test_collaborative_serving_twin_serves_as_the_reference(monkeypatch,
                                                            capsys):
    """``examples/collaborative_serving.py --requests 4`` and its twin
    with ``--device cpu``, the twin's launcher on the reference's weights:
    the plan line, the exit ratio / bits / wire line, the simulated
    latencies and the bubble table equal (the wall-clock part left out)."""
    args = ["--arch", "gemma2-2b", "--requests", "4"]
    monkeypatch.setattr("sys.argv", ["collaborative_serving", *args])
    _load("examples", "collaborative_serving").main()
    want = capsys.readouterr().out.splitlines()
    cfg = get_config("gemma2-2b").reduced()
    weights = M.params_from_numpy(_np(JM.init_params(
        jget_config("gemma2-2b").reduced(), jax.random.PRNGKey(0))), cfg,
        "cpu")
    monkeypatch.setattr(M, "init_params", lambda *a, **kw: weights)
    monkeypatch.setattr("sys.argv", ["collaborative_serving", *args,
                                     "--device", "cpu"])
    twin = _load("examples_torch", "collaborative_serving")
    assert twin.main.__module__ == "repro_torch.launch.serve"
    twin.main()
    got = capsys.readouterr().out.splitlines()

    def summary(lines):  # the port notes in it what is modelled
        return [re.sub(r" \(wall [\d.]+s[^)]*\)", "", ln) for ln in lines]

    assert len(got) == len(want) > 3
    assert summary(got) == summary(want)
    assert got[0].startswith("arch=gemma2-2b-smoke cut_group=")


# ------------------------------------------------------------ train_small
def test_train_small_twin_gives_the_reference_losses(monkeypatch, capsys,
                                                     tmp_path):
    """``examples/train_small.py --steps 3 --batch 2 --seq 32`` and its
    twin with ``--device cpu``, both resuming from the reference's
    initial weights (a step-0 checkpoint of the JAX package, in a
    directory each): the same three losses (1e-5 relative) and the same
    verdict."""
    jcfg = jget_config("gemma2-2b").reduced()
    init = JM.init_params(jcfg, jax.random.PRNGKey(0))
    for side in ("ref", "twin"):
        JCK.save_checkpoint(str(tmp_path / side), 0, init)
    import repro.launch.train as JT
    import repro_torch.launch.train as TT
    losses = {}
    for side, mod, trainer in (("ref", "examples", JT), ("twin",
                                                        "examples_torch", TT)):
        seen = []

        def record(*a, _train=trainer.train, **kw):
            out = _train(*a, **kw)
            seen.extend(out[1])
            return out

        ex = _load(mod, "train_small")
        monkeypatch.setattr(ex, "train", record)
        argv = ["--steps", "3", "--batch", "2", "--seq", "32",
                "--ckpt-dir", str(tmp_path / side)]
        if side == "twin":
            argv += ["--device", "cpu"]
        monkeypatch.setattr("sys.argv", ["train_small", *argv])
        ex.main()
        losses[side] = list(seen)
    out = capsys.readouterr().out.splitlines()
    assert len(losses["twin"]) == len(losses["ref"]) == 3
    np.testing.assert_allclose(losses["twin"], losses["ref"], rtol=1e-5)
    verdicts = [ln.split("(")[-1] for ln in out if ln.startswith("loss: ")]
    assert len(verdicts) == 2 and verdicts[0] == verdicts[1]


# -------------------------------------------------------- churn_storyline
def _churn_text():
    """The twin's text: the reference's with ``repro.`` renamed to
    ``repro_torch.``, its usage line pointing at ``examples_torch/`` and
    the ``--device`` flag after ``--tasks``."""
    text = (ROOT / "examples" / "churn_storyline.py").read_text()
    text = re.sub(r"\brepro\.", "repro_torch.", text).replace(
        "examples/churn_storyline.py", "examples_torch/churn_storyline.py")
    tasks = '    ap.add_argument("--tasks", type=int, default=120)\n'
    device = ('    ap.add_argument("--device", default="cuda",\n'
              '                    help="accepted as by the other examples; '
              'the "\n'
              '                         "storyline runs the planner and '
              'simulators on "\n'
              '                         "the host and puts nothing on a '
              'device")\n')
    assert text.count(tasks) == 1
    return text.replace(tasks, tasks + device)


def test_churn_storyline_twin_is_the_reference_renamed():
    assert (ROOT / "examples_torch" / "churn_storyline.py").read_text() == \
        _churn_text()


def test_churn_storyline_twin_prints_the_reference_timeline(monkeypatch,
                                                            capsys):
    """``--tasks 40``: every printed line equal (the bubble tables by
    cause before / during / after the fault, the re-plans, migrations,
    pin delta and the windowed p99s)."""
    out = []
    for folder, extra in (("examples", []), ("examples_torch",
                                            ["--device", "cpu"])):
        monkeypatch.setattr("sys.argv", ["churn_storyline", "--tasks", "40",
                                         *extra])
        _load(folder, "churn_storyline").main()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "re-plans:" in out[1] and "p99 through the fault window" in out[1]
