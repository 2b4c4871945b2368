"""Autoregressive generation on top of prefill + decode_step, mirroring
``repro.serving.generate``: the serving substrate's inner loop, greedy or
temperature sampling, ``core.jit``'ed once per (batch, cache) shape.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch import require_device
from repro_torch.core.jit import jit
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def generate(params, cfg: ModelConfig, prompt, max_new_tokens: int,
             *, max_seq: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, device="cuda"):
    """prompt: (B, S0) int tokens.  Returns (B, S0 + max_new_tokens)
    tokens on ``device``, where ``params`` must be.

    ``temperature`` 0 decodes greedily (argmax, the lowest index on ties,
    as the JAX package).  Above 0 it samples from ``softmax(logits / T)``
    with ``generator``, which the caller passes on ``device``; its stream
    differs from ``jax.random``'s, so only greedy output matches the JAX
    package token for token."""
    assert cfg.supports_decode and not cfg.embed_inputs
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    dev = require_device(device)
    prompt = torch.as_tensor(prompt, device=dev)
    S0 = prompt.shape[1]
    max_seq = max_seq or (S0 + max_new_tokens)

    def pick(lg):
        if temperature <= 0.0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    # the position is a device tensor, as the reference's traced
    # jnp.int32: one capture of the step serves every position.  The cache
    # is copied into the step's input buffers each token
    prefill = jit(functools.partial(M.prefill, cfg=cfg, max_seq=max_seq))
    step = jit(functools.partial(M.decode_step, cfg=cfg))
    with torch.no_grad():
        logits, cache = prefill(params, inputs=prompt)
        toks = prompt
        nxt = pick(logits)[:, None].to(prompt.dtype)
        pos = torch.full((), S0, dtype=torch.int32, device=dev)
        for t in range(max_new_tokens):
            toks = torch.cat([toks, nxt], dim=1)
            if t == max_new_tokens - 1:
                break
            logits, cache = step(params, cache=cache, inputs=nxt, pos=pos)
            pos = pos + 1
            nxt = pick(logits)[:, None].to(prompt.dtype)
    return toks
