"""Fringe phase math, the RIME reduction and its CUDA kernel, linear
algebra helpers."""
from . import linalg, phase, rime_cuda, rime_kernel
