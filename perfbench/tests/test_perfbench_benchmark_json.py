"""``BENCHMARK.json`` keeps to the contract's shapes and names, and
finds every file it names."""

import importlib
import json
import math
import os
import re

import pytest

from perfbench.tests.tiny import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# keys that name a width, which ``reduced`` may never name
WIDTH = re.compile(r"(_dim|_rank)$|(^|_)(hidden|intermediate|latent|state"
                   r"|projection|head)_size$|^d_(model|state|inner)$"
                   r"|expand|headdim|experts_per_tok|experts_per_token")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_lines():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group in ("configs", "workloads", "per_layer"):
                    v = e[k]
                    assert 1 <= len(v) <= 200 and "\n" not in v \
                        and "\t" not in v, (e["name"], k)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [n for g, n in names if g == group]
        assert len(ns) == len(set(ns)), group
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_cells_configs_and_files():
    from repro_torch.models.config import ModelConfig
    b = bench()
    confs = {c["name"]: c for c in b["configs"]}
    used = set()
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["config"] in confs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        for d in ("traffic", "workloads"):
            key = w["traffic"] if d == "traffic" else w["name"]
            assert os.path.exists(os.path.join(ROOT, "perfbench", d,
                                               f"{key}.json"))
        traffic = json.load(open(os.path.join(
            ROOT, "perfbench", "traffic", f"{w['traffic']}.json")))
        cellf = json.load(open(os.path.join(
            ROOT, "perfbench", "workloads", f"{w['name']}.json")))
        for d, key in (("traffic/kinds", traffic["arrivals"]),
                       ("drivers", cellf["driver"])):
            assert os.path.exists(os.path.join(ROOT, "perfbench", d,
                                               f"{key}.py")), (d, key)
    assert used == set(confs)
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["source"].split(" ")[0] == c["source"]
        assert conf["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
            assert k in conf["config"]
        for k in ("module", "kind", "dtype", "model", "deployment"):
            assert k in conf
        # the port module that holds the model, not the JAX package's
        assert conf["module"].startswith("repro_torch."), conf["module"]
        assert isinstance(importlib.import_module(conf["module"]).CONFIG,
                          ModelConfig), conf["module"]
        for d in ("reference", "flops"):
            assert os.path.exists(os.path.join(ROOT, "perfbench", d,
                                               f"{conf['kind']}.py"))


def test_every_cell_reports_enough_and_per_layer_metrics_follow():
    from perfbench.harness.main import applies
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        c = w["name"]
        ends = [m for m in b["end_to_end"] if applies(m, c)]
        assert "setup_s" in [m["name"] for m in ends] and len(ends) >= 2
        pls = [m for m in b["per_layer"] if applies(m, c)]
        assert pls, c
        for m in pls:
            assert applies(e2e[m["moves"]], c), (m["name"], c)
    for m in b["per_layer"]:
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "metrics",
            m["name"].split(".")[0] + ".py")), m["name"]
    layers = {m["layer"] for m in b["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert f"| {layer} " in perf, layer


def test_run_seconds_fits_the_check_with_24_cells():
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def driver_numbers(cell_file):
    """The numbers that the cell's driver compares."""
    return importlib.import_module(
        f"perfbench.drivers.{cell_file['driver']}").NUMBERS


def limits_follow_the_driver(cell_file):
    lim = cell_file["limits"]
    assert set(lim) == set(driver_numbers(cell_file))
    assert all(math.isfinite(v) and v >= 0 for v in lim.values())


def test_limits_name_every_number_compared():
    from perfbench.harness import judge as J
    b = bench()
    for w in b["workloads"]:
        cellf = json.load(open(os.path.join(ROOT, "perfbench", "workloads",
                                            f"{w['name']}.json")))
        limits_follow_the_driver(cellf)
        if cellf["driver"] == "served_split":
            assert set(cellf["limits"]) == {
                "feat_off", "sims_err", "sep_err", "decisions_off",
                "payload_off", "scale_off", "logits_off"}
    assert J.WIRE_BITS == 8


@pytest.mark.parametrize("driver,limits", [
    ("served_split", {"logits_err": 1e-3, "logits_l2": 1e-3}),
    ("served_split", {"feat_off": 0.05, "sims_err": 1e-4, "sep_err": 3e-4,
                      "decisions_off": 0.0, "payload_off": 0.03,
                      "scale_off": 0.05}),
    ("pipe_step", {"feat_off": 0.05, "logits_off": 0.25}),
    ("pipe_step", {"logits_err": 0.1, "logits_l2": 0.1, "logits_off": 0.2}),
    ("pipe_step", {"logits_err": 0.1, "logits_l2": math.inf})])
def test_limits_that_misname_their_drivers_numbers_fail(driver, limits):
    with pytest.raises(AssertionError):
        limits_follow_the_driver({"driver": driver, "limits": limits})
