"""The benchmark of tulip_tpu_torch, the PyTorch/CUDA port (see
``harness.py``; run a cell with ``python3 portbench/run.py``)."""
