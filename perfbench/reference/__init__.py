"""Plain references of the served split, one file per kind of
architecture (``ssm.py``, ``moe.py``) and the parts they share
(``common.py``).  Plain PyTorch and NumPy, float32 unless a control asks
for less; nothing of ``repro_torch``, ``repro`` or ``jax`` is imported,
and nothing the program made is read but to judge it."""
