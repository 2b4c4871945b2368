"""Task tokens of every task completed in the window over the window's
seconds (its start to the answer of its last task)."""


def read(run):
    return run.completed() * run.seq_len / run.window_s
