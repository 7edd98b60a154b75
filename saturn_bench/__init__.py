"""The benchmark of the PyTorch and CUDA port: Saturn's training jobs on
an NVIDIA H100, cell by cell (``run.py``; ``README.md`` says how to run
and extend it)."""
