"""Substrate: dtype/device policy, ParamDict, Module, indexing, HEALPix,
multi-resolution HEALPix, pixel interpolation, training-state
checkpoints and structured logging."""
from . import (checkpoint, dtypes, healpix, indexing, interp, logging,
               module, multires, paramdict)
from .dtypes import (_float, set_default_dtype, resolve_device,
                     viewreal, viewcomp, D2R, R2D, C_MS)
from .paramdict import ParamDict, load_numpy_pdict, read_pdict, write_pdict
from .module import Module, Sequential, model2pdict
from .indexing import (AntposDict, ants2blnum, blnum2ants, make_hex,
                       flatten, gauss_taper)
from .interp import PixInterp, interp_gather, bipoly_interp_weights
