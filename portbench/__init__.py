"""The benchmark of cocodr_tpu_torch, the PyTorch and CUDA port, on NVIDIA
H100 cards. `portbench/run.py` runs one cell once; README.md says how a
cell, a configuration or a metric is added by adding files alone."""
