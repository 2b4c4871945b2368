"""The benchmark of ``repro_torch``: COACH tasks served through the
port's end / cloud split on NVIDIA cards.  ``python3 perfbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
