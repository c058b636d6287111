"""repro_torch: the PyTorch / CUDA port of the distributed-BFS framework.

Mirrors ``repro``'s layout (``repro_torch/core/engine.py`` is the port of
``repro/core/engine.py``, and so on), imports ``torch`` and never ``jax``,
and runs on a CUDA card unless an entry point is given ``device="cpu"``.
The hand-written Hopper kernels live in ``csrc/`` and ``kernels/``.
"""

__version__ = "0.1.0"
