"""The benchmark of the PyTorch/CUDA BFS engine: ``python3 gpubench/run.py``
(see ``README.md``)."""
