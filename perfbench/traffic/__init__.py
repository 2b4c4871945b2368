"""Traffic mixes: ``<name>.json`` data files of parameters, read by
``perfbench/harness/traffic.py``; the arrival kinds they name are in
``kinds/``."""
