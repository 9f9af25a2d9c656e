"""Telescope, sky, beam, the RIME forward model and antenna gains."""
from . import beam, bessel, calibration, rime, sky, telescope
from .beam import (PixelBeam, AiryResponse, GaussResponse, UniformResponse,
                   PixelResponse)
from .calibration import (JonesModel, JonesResponse, RedVisModel, VisModel,
                          VisModelResponse, vis2JonesModel, vis2RedVisModel)
from .rime import RIME
from .sky import (PixelSky, PixelSkyResponse, PointSky, PointSkyResponse,
                  CompositeModel, Stokes2Coherency, CoherencySky,
                  stokes2coherency, SphHarmSky, pixelsky_Ylm_cut)
from .telescope import TelescopeModel, ArrayModel, build_reds
