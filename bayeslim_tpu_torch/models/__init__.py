"""Telescope, sky, beam (pixel and Ylm), the RIME forward model, antenna
gains, the cosmology and the linear models' host helpers."""
from . import (beam, beam_ylm, bessel, calibration, cosmology,
               linear_model, rime, sky, telescope)
from .beam import (PixelBeam, AiryResponse, GaussResponse, UniformResponse,
                   PixelResponse)
from .beam_ylm import YlmResponse, AlmBeam
from .cosmology import Cosmology
from .linear_model import gen_poly_A, prep_xarr, whiten_xarr
from .calibration import (JonesModel, JonesResponse, RedVisModel, VisModel,
                          VisModelResponse, vis2JonesModel, vis2RedVisModel)
from .rime import RIME
from .sky import (PixelSky, PixelSkyResponse, PointSky, PointSkyResponse,
                  CompositeModel, Stokes2Coherency, CoherencySky,
                  stokes2coherency, SphHarmSky, pixelsky_Ylm_cut)
from .telescope import TelescopeModel, ArrayModel, build_reds
