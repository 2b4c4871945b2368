"""Flops of one task through a Mixtral stack (reference/moe.py): per
token and layer the q, k, v and o projections, the router, and k of the
experts' three SwiGLU products; per layer the causal attention's scores
and weighted sum over the keys each query sees (within the window);
then the head on the last token."""


def attended(seq_len: int, window: int) -> int:
    """Query-key pairs of causal attention within ``window``."""
    return sum(min(i + 1, window) for i in range(seq_len))


def task_flops(model: dict, seq_len: int) -> float:
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    E, k, f = model["num_experts"], model["experts_per_token"], model["d_ff"]
    per_token = (2 * d * (H + 2 * KV) * hd + 2 * H * hd * d + 2 * d * E
                 + k * 3 * 2 * d * f)
    attn = 4 * H * hd * attended(seq_len, model["sliding_window"])
    return float(L * (seq_len * per_token + attn) + 2 * d * V)
