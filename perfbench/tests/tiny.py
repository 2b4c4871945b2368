"""Tiny versions of the benchmark's configurations and cells, for the
CPU tests: the real files with the widths cut so that a run takes
seconds on the host, and the deployment the program's planner gives;
and what stands in on the CPU for a driver's path that runs only on the
card."""

import copy
import json
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# one file of widths a kind of architecture, found by the kind's name
WIDTHS = os.path.join(ROOT, "perfbench", "tests", "tiny_widths")


def tiny_widths(kind):
    """The tiny widths of ``kind``: ``tiny_widths/<kind>.json``."""
    path = os.path.join(WIDTHS, f"{kind}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no tiny widths for the kind {kind!r}: "
            f"{os.path.relpath(path, ROOT)} is missing")
    with open(path) as f:
        return json.load(f)


def bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def cell_files(name):
    """(cell entry, configuration, traffic, limits) of a real cell."""
    from perfbench.harness.main import load
    _, cell, conf, traffic, limits = load(ROOT, name)
    return cell, conf, traffic, limits


def tiny_conf(conf):
    """``conf`` with the tiny widths and its deployment at them: a
    served split's planner's cut, or two pods of half the layers each."""
    from perfbench.harness.served import deployment, plan, port_config
    from repro_torch.core.costs import WIFI_5GHZ
    conf = copy.deepcopy(conf)
    conf["model"].update(tiny_widths(conf["kind"]))
    if "layers_per_pod" in conf["deployment"]:
        conf["deployment"]["layers_per_pod"] = \
            conf["model"]["num_layers"] // 2
        return conf
    cut, off = plan(port_config(conf), WIFI_5GHZ(50.0))
    conf["deployment"] = deployment(cut, off)
    return conf


def tiny_traffic(traffic, seq_len=None):
    t = dict(traffic)
    if seq_len is not None:
        t["seq_len"] = seq_len
    if t["arrivals"] == "open_poisson":
        t["rate"] = 40.0
    return t


def composed(cfg, bits):
    """The port's two pods composed as ``make_collab_pipeline_step``
    composes them, from its own pieces, with the plain K3 and K2."""
    from repro_torch.kernels import ops as KOPS
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    half, D = cfg.num_groups // 2, cfg.d_model

    def step(params, tokens):
        outs = []
        for t in range(tokens.shape[0]):
            B, S = tokens[t].shape
            pos = M.positions_for(B, S, tokens.device)
            h = M.run_groups(M.group_slice(params["groups"], slice(0, half)),
                             M._embed(params, cfg, tokens[t]), cfg, pos)
            wire = KOPS.wire_quantize(h.reshape(-1, D), bits,
                                      use_kernel=False)
            h = KOPS.wire_dequantize(*wire, bits, out_dtype=h.dtype,
                                     channels=D, use_kernel=False)
            outs.append(M.run_groups(
                M.group_slice(params["groups"], slice(half, None)),
                h.reshape(B, S, D), cfg, pos))
        h = L.rms_norm(torch.stack(outs), params["final_norm"], cfg.norm_eps)
        return M._lm_head(params, cfg, h[:, :, -1])
    return step


def stand_in(drv, bits):
    from repro_torch.core.jit import jit
    return jit(composed(drv.cfg, bits))


def on_the_cpu(driver, monkeypatch):
    """Put in ``driver``'s place what the CPU cannot run: the pipelined
    step's pods are CUDA streams, so its step is the stand-in."""
    if driver == "pipe_step":
        from perfbench.drivers import pipe_step as PS
        monkeypatch.setattr(PS.Driver, "make_step", stand_in)
