"""The port's copies of the JAX package's JAX-free modules (planner,
simulator, scheduler, data, observability, engines, configs) give the
reference's results on the same inputs, and the port stays isolated: no
module of ``src/repro_torch`` imports JAX or the JAX package.
"""

import ast
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import repro_torch  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.core import online as JON  # noqa: E402
from repro.core import partitioner as JP  # noqa: E402
from repro.core import pipeline as JPL  # noqa: E402
from repro.core import sim as JS  # noqa: E402
from repro.core.costs import (A6000_SERVER, EDGE_AGX_ORIN, ETH_LAN,  # noqa: E402
                              JETSON_NX, WIFI_5GHZ, transformer_graph)
from repro.data.pipeline import CorrelatedTaskStream  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import costs as TCO  # noqa: E402
from repro_torch.core import online as TON  # noqa: E402
from repro_torch.core import partitioner as TP  # noqa: E402
from repro_torch.core import pipeline as TPL  # noqa: E402
from repro_torch.core import sim as TS  # noqa: E402
from repro_torch.data.pipeline import CorrelatedTaskStream as TStream  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
COPIES = [
    "models/config.py", "configs/__init__.py", "core/costs.py",
    "core/schedule.py", "core/sim.py", "core/pipeline.py",
    "core/plan_fast.py", "core/partitioner.py", "core/online.py",
    "data/pipeline.py", "data/__init__.py", "obs/trace.py",
    "obs/bubbles.py", "obs/export.py", "serving/base.py",
    "serving/engine.py", "serving/routing.py", "serving/batching.py",
    "obs/metrics.py", "serving/async_engine.py", "serving/tenancy.py",
    "serving/__init__.py", "models/cnn.py", "core/baselines.py",
    "scenarios/events.py", "scenarios/churn.py", "scenarios/replan.py",
    "scenarios/runner.py", "scenarios/__init__.py",
] + [f"configs/{m}.py" for m in JC.ARCHS.values()]


def _renamed(text):
    return re.sub(r"\brepro\.", "repro_torch.", text).replace(
        "from repro import", "from repro_torch import")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_with_imports_renamed(rel):
    want = _renamed((SRC / "repro" / rel).read_text())
    assert (PORT / rel).read_text() == want


# The port's twins of the reference tests of the copied modules: each is
# the reference test with the package and the test modules it imports
# renamed.  The one reference test that reaches the reference's benchmark
# harness gets a renamed copy of it; the one test that runs the JAX model
# is left out (its twin is in test_torch_async.py).  A twin imports a
# twin as a top-level module (pytest puts tests/ on the path), not as
# ``tests.X`` as the reference does: where an installed package is also
# named ``tests``, a directory without ``__init__.py`` loses to it.
TESTS = SRC.parent / "tests"
TWINS = ["sim", "partitioner", "plan_fast", "online", "engine", "pipeline",
         "hop_exit", "obs", "obs_props", "pools", "pool_props", "tenancy",
         "batching", "baselines", "scenarios", "async_engine"]
LEFT_OUT = {"async_engine":
            "test_segment_handles_execute_real_model_through_workers"}
TWIN_FILES = [(f"tests/test_{n}.py", f"tests/test_torch_twin_{n}.py")
              for n in TWINS] + [("benchmarks/common.py",
                                  "tests/torch_twin_bench_common.py")]


def _twin_renamed(text):
    text = re.sub(r"\btests\.test_(\w+)", r"test_torch_twin_\1",
                  _renamed(text))
    return text.replace("benchmarks.common", "torch_twin_bench_common")


def _without_function(text, name):
    node = next(f for f in ast.parse(text).body
                if isinstance(f, ast.FunctionDef) and f.name == name)
    first = min([node.lineno] + [d.lineno for d in node.decorator_list])
    lines = text.splitlines(keepends=True)
    return "".join(lines[:first - 1] + lines[node.end_lineno:])


@pytest.mark.parametrize("ref,twin", TWIN_FILES)
def test_twin_is_the_reference_test_with_imports_renamed(ref, twin):
    text = (SRC.parent / ref).read_text()
    name = Path(ref).stem.removeprefix("test_")
    if name in LEFT_OUT:
        text = _without_function(text, LEFT_OUT[name])
        assert LEFT_OUT[name] not in text
    assert (SRC.parent / twin).read_text() == _twin_renamed(text)


def test_every_reference_test_of_a_copy_has_its_twin():
    want = {f"test_torch_twin_{n}.py" for n in TWINS}
    assert {f.name for f in TESTS.glob("test_torch_twin_*.py")} == want


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_configs_equal_field_for_field(arch):
    for j, t in ((JC.get_config(arch), TC.get_config(arch)),
                 (JC.get_config(arch).reduced(),
                  TC.get_config(arch).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.num_groups, j.group_size) == (t.num_groups, t.group_size)
    assert {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()}
    assert JC.all_pairs() == TC.all_pairs()


def _graph_pair(arch, reduced):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    return (transformer_graph(jc, batch=1, seq=128),
            TCO.transformer_graph(tc, batch=1, seq=128))


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-14b", "mamba2-130m"])
@pytest.mark.parametrize("mbps", [5.0, 50.0])
def test_coach_offline_makes_the_reference_decision(arch, reduced, mbps):
    jg, tg = _graph_pair(arch, reduced)
    want = JP.coach_offline(jg, JETSON_NX, A6000_SERVER, WIFI_5GHZ(mbps))
    got = TP.coach_offline(tg, TCO.JETSON_NX, TCO.A6000_SERVER,
                           TCO.WIFI_5GHZ(mbps))
    assert got.decision.end_set == want.decision.end_set
    assert got.decision.bits == want.decision.bits
    assert dataclasses.asdict(got.times) == dataclasses.asdict(want.times)


def test_multihop_planner_makes_the_reference_decision():
    jg, tg = _graph_pair("gemma2-2b", False)
    want = JP.coach_offline_multihop(
        jg, [JETSON_NX, EDGE_AGX_ORIN, A6000_SERVER],
        [WIFI_5GHZ(50.0), ETH_LAN(100.0)])
    got = TP.coach_offline_multihop(
        tg, [TCO.JETSON_NX, TCO.EDGE_AGX_ORIN, TCO.A6000_SERVER],
        [TCO.WIFI_5GHZ(50.0), TCO.ETH_LAN(100.0)])
    assert repr(got.decision) == repr(want.decision)
    assert dataclasses.asdict(got.times) == dataclasses.asdict(want.times)


def _plans(mod, rng, n, n_hops):
    return [mod.SimPlan(compute=tuple(rng.uniform(1e-3, 5e-3, n_hops + 1)),
                        tx=tuple(rng.uniform(1e-3, 8e-3, n_hops)),
                        exit_hop=int(rng.integers(0, n_hops + 1))
                        if rng.random() < 0.2 else None)
            for _ in range(n)]


@pytest.mark.parametrize("n_hops", [1, 2])
def test_stream_results_equal(n_hops):
    rng_j, rng_t = (np.random.default_rng(n_hops) for _ in range(2))
    arrivals = list(np.arange(40) * 2.5e-3)
    want = JS.simulate_stream(_plans(JS, rng_j, 40, n_hops), arrivals)
    got = TS.simulate_stream(_plans(TS, rng_t, 40, n_hops), arrivals)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    jp = JPL.run_pipeline([JPL.TaskPlan.multihop(p.compute, p.tx) for p in
                           _plans(JS, np.random.default_rng(9), 30, n_hops)],
                          arrival_period=3e-3)
    tp = TPL.run_pipeline([TPL.TaskPlan.multihop(p.compute, p.tx) for p in
                           _plans(TS, np.random.default_rng(9), 30, n_hops)],
                          arrival_period=3e-3)
    assert (tp.mean_latency, tp.p99_latency, tp.throughput, tp.makespan) == \
        (jp.mean_latency, jp.p99_latency, jp.throughput, jp.makespan)


def test_online_scheduler_equal_on_the_same_stream():
    js = CorrelatedTaskStream(n_labels=8, dim=32, correlation="high", seed=3)
    ts = TStream(n_labels=8, dim=32, correlation="high", seed=3)
    jt, tt = js.tasks(200), ts.tasks(200)
    assert all(np.array_equal(a.features, b.features) and a.label == b.label
               for a, b in zip(jt, tt))
    feats = np.stack([t.features for t in jt[:150]])
    labels = np.array([t.label for t in jt[:150]])
    jc, tc = JON.SemanticCache(8, 32), TON.SemanticCache(8, 32)
    jc.warm_up(feats, labels)
    tc.warm_up(feats, labels)
    jth = JON.calibrate_thresholds(jc, feats, labels)
    tth = TON.calibrate_thresholds(tc, feats, labels)
    assert dataclasses.asdict(jth) == dataclasses.asdict(tth)
    jsch = JON.OnlineScheduler(jc, jth, 10_000, 2e-3, 3e-3)
    tsch = TON.OnlineScheduler(tc, tth, 10_000, 2e-3, 3e-3)
    for t in jt[150:]:
        assert dataclasses.asdict(jsch.step(t.features, 20e6)) == \
            dataclasses.asdict(tsch.step(t.features, 20e6))


# ------------------------------------------------------------ isolation
def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _imports(f):
    for node in ast.walk(ast.parse(f.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_twin_imports_jax_the_jax_package_or_a_reference_test():
    files = [SRC.parent / twin for _, twin in TWIN_FILES]
    for f in files:
        for n in _imports(f):
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax",
                               "benchmarks", "tests"), f"{f.name} imports {n}"
            assert not top.startswith("test_") or top.startswith(
                "test_torch_twin_"), f"{f.name} imports {n}"
    mods = [f.stem for f in files]
    code = ("import sys\n"
            "for m in ('jax', 'repro', 'benchmarks'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) "
            "for k in sys.modules if sys.modules[k] is not None)\n"
            "print('IMPORTED', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=TESTS,
                       capture_output=True, text=True, timeout=120)
    assert "IMPORTED" in r.stdout, r.stdout + r.stderr


def test_no_port_module_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 40
    for f in files:
        for n in _imports(f):
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                f"{f.relative_to(SRC)} imports {n}"


def test_every_port_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods and \
        "repro_torch.kernels.boundary" in mods
    assert {f"repro_torch.{rel[:-3].replace('/', '.')}".removesuffix(
        ".__init__") for rel in COPIES} <= set(mods)
    assert {"repro_torch.core.quant", "repro_torch.training.optim",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.checkpoint", "repro_torch.checkpoint.io",
            "repro_torch.models.shardctx", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.launch.hlo_cost",
            "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.dryrun"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') or "
            "k.startswith('repro.') for k in sys.modules "
            "if sys.modules[k] is not None)\n"
            "print('IMPORTED', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert "IMPORTED" in r.stdout, r.stdout + r.stderr
