"""Plain PyTorch and NumPy references of what the benchmark's cells compute.

They import nothing of the program (cocodr_tpu_torch), of JAX or of the
JAX package, and take nothing the program made: the harness hands them the
inputs and weights it made itself, and they work out again whatever the
program derived from those.
"""
