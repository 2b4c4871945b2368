"""Flops through a Qwen3 dense stack (reference/dense.py): per token and
layer the q, k, v and o projections and the SwiGLU MLP's three products;
per sequence and layer the causal attention's scores and weighted sum
over the keys each query sees; then the head on each sequence's last
token.  Norms, rotary embeddings and the softmax are not counted."""

from perfbench.flops.moe import attended


def task_flops(model: dict, seq_len: int) -> float:
    """One sequence of ``seq_len`` tokens through every layer and the
    head (a served task)."""
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    f = model["d_ff"]
    per_token = 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d + 3 * 2 * d * f
    attn = 4 * H * hd * attended(seq_len, seq_len)
    return float(L * (seq_len * per_token + attn) + 2 * d * V)


def step_flops(model: dict, n_micro: int, batch: int, seq_len: int) -> float:
    """One pipelined step: ``n_micro`` microbatches of ``batch``
    sequences."""
    return n_micro * batch * task_flops(model, seq_len)
