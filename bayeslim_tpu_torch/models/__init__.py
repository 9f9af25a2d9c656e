"""Telescope, sky, beam, the RIME forward model and antenna gains."""
from . import beam, bessel, calibration, rime, sky, telescope
from .beam import PixelBeam, AiryResponse
from .calibration import JonesModel, JonesResponse
from .rime import RIME
from .sky import PixelSky, PixelSkyResponse
from .telescope import TelescopeModel, ArrayModel, build_reds
