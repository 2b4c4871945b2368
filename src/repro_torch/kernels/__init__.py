"""Hand-written Hopper kernels for the COACH boundary hop (``csrc/``),
their wrappers, and their plain PyTorch versions (``ref``)."""
