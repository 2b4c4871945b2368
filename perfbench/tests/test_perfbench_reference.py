"""Each reference kind agrees with ``repro_torch`` on the CPU at reduced
sizes, on the benchmark's weights: the whole forward's logits, and the
end segment's boundary activation at the stated cut."""

import pytest
import torch

from perfbench.harness import weights as W
from perfbench.harness.served import port_config
from perfbench.reference import common as RC
from perfbench.tests.tiny import cell_files, tiny_conf

CELLS = {"ssm": "serve-mamba2-130m-s128-closed",
         "moe": "serve-mixtral-8x7b-4l-s128-closed"}


@pytest.mark.parametrize("kind", ["ssm", "moe"])
@pytest.mark.parametrize("seq_len", [8, 48])
def test_reference_agrees_with_the_port(kind, seq_len):
    import importlib

    from repro_torch.core.collab import CollabRuntime
    from repro_torch.models import model as M
    ref = importlib.import_module(f"perfbench.reference.{kind}")
    conf = tiny_conf(cell_files(CELLS[kind])[1])
    cfg = port_config(conf)
    params = W.make(M.init_params(cfg, device="meta"), 11, "cpu")
    model, cut = conf["model"], conf["deployment"]["cut_group"]
    toks = torch.randint(0, model["vocab_size"], (3, seq_len),
                         generator=torch.Generator().manual_seed(seq_len))
    with torch.no_grad():
        h, _, _ = M.forward(params, cfg, toks)
        want = M._lm_head(params, cfg, h[:, -1])
        got = ref.forward(params, model, toks, range(model["num_layers"]),
                          first=True, last=True)
        scale = want.abs().max()
        assert (got - want).abs().max() / scale < 2e-5
        rt = CollabRuntime(cfg, params, cut)
        h_end = rt._seg_fns[0](rt.p_end, toks)
        r_end = ref.forward(params, model, toks, range(cut), first=True)
        assert (h_end - r_end).abs().max() / h_end.abs().max() < 2e-5
        logits = ref.forward(params, model, r_end, range(cut, cfg.num_layers),
                             last=True)
        assert (logits - want).abs().max() / scale < 2e-5


def test_quantization_matches_the_ports_wire():
    from repro_torch.kernels import ref as KR
    x = torch.randn(16, 77, generator=torch.Generator().manual_seed(3)) * 3
    for bits in (4, 8):
        p, s, z = RC.quantize(x, bits)
        kp, ks, kz = KR.uaq_quantize_ref(x, bits)
        assert torch.equal(p, kp) and torch.equal(s, ks) and torch.equal(z, kz)
        back = RC.dequantize(p, s, z, bits, 77)
        assert torch.allclose(back, KR.uaq_dequantize_ref(kp, ks, kz, bits,
                                                          n=77))
