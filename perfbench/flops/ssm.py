"""Flops of one task through a Mamba2 stack (reference/ssm.py): per
token and layer the five input projections (one B/C group), the
depthwise convolutions of x, B and C, the scan's two products (the
state's input term dt x B^T and its read-out C h, 2 H P N each) and the
out projection; then the tied head on the last token."""


def task_flops(model: dict, seq_len: int) -> float:
    d, L, V = model["d_model"], model["num_layers"], model["vocab_size"]
    di = model["ssm_expand"] * d
    N, P, K = model["ssm_state"], model["ssm_head_dim"], model["ssm_conv"]
    H = di // P
    per_token = (2 * d * (2 * di + 2 * N + H) + 2 * K * (di + 2 * N)
                 + 4 * H * P * N + 2 * di * d)
    return float(seq_len * L * per_token + 2 * d * V)
