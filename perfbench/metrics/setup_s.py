"""Process start to the first timed task: imports, the kernel library,
weights, the planner, the calibration, the captures."""


def read(run):
    return run.setup_s
