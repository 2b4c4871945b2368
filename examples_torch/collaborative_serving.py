"""End-to-end driver: serve a small model with batched requests through the
full COACH system in the PyTorch port (the twin of
``examples/collaborative_serving.py``) — offline partition, the end/cloud
segments with the quantized wire, semantic cache, early exits, adaptive
precision, pipeline accounting.

  PYTHONPATH=src python examples_torch/collaborative_serving.py \
      [--arch gemma2-2b] [--requests 200] [--correlation high] [--device cpu]

Runs on the CUDA device by default; ``--device cpu`` runs the kernels'
plain PyTorch versions on the CPU.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.serve import main  # the launcher IS the driver

if __name__ == "__main__":
    main()
