"""One client, back to back: the next task is sent when the last is
answered."""


def due_times(traffic: dict, seconds: float):
    return None
