"""Fringe phase math, the RIME reduction and its CUDA kernel, linear
algebra helpers, special functions, spherical harmonics and spherical
Fourier-Bessel transforms."""
from . import linalg, phase, rime_cuda, rime_kernel, special, sph_harm
from .sph_harm import (gen_lm, compute_lm, legendre_func, gen_sph2pix,
                       normalize_Ylm, write_Ylm, load_Ylm, AlmModel,
                       inflate_Ylm, gen_bessel2freq, sph_bessel_func,
                       sph_bessel_kln, SFBModel, sfb_binning)
