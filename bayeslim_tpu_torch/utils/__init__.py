"""Substrate: dtype/device policy, ParamDict, Module, indexing, HEALPix,
multi-resolution HEALPix, pixel interpolation, training-state
checkpoints and structured logging."""
from . import (checkpoint, dtypes, healpix, indexing, interp, logging,
               module, multires, paramdict)
from .dtypes import (_float, set_default_dtype, resolve_device,
                     viewreal, viewcomp, isreal_view, D2R, R2D, C_MS)
from .paramdict import ParamDict, load_numpy_pdict, read_pdict, write_pdict
from .module import Module, Sequential, model2pdict
from .indexing import (
    AntposDict, blnum2ants, ants2blnum, make_hex, split_into_groups,
    flatten, white_noise, gauss_taper, tukey_taper, SimpleIndex, Jy_to_KStr,
    colat2lat, stripe_tukey_mask, half_gaussian_taper, voigt_beam,
    fit_zero, get_zeros, conjbl, inflate_bls, freq_interp,
)
from .interp import PixInterp, interp_gather, bipoly_interp_weights
