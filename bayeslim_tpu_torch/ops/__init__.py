"""Fringe phase math, the RIME reduction and its CUDA kernel, linear
algebra helpers, special functions and spherical harmonics."""
from . import linalg, phase, rime_cuda, rime_kernel, special, sph_harm
from .sph_harm import (gen_lm, compute_lm, legendre_func, gen_sph2pix,
                       normalize_Ylm, write_Ylm, load_Ylm, AlmModel,
                       inflate_Ylm)
