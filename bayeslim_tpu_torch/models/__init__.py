"""Telescope, sky, beam (pixel and Ylm), the RIME forward model, antenna
gains, the cosmology, the linear models, the delay FFT and the
filters."""
from . import (beam, beam_ylm, bessel, calibration, cosmology, fft, filt,
               linear_model, rime, sky, telescope)
from .beam import (PixelBeam, AiryResponse, GaussResponse, UniformResponse,
                   PixelResponse)
from .beam_ylm import YlmResponse, AlmBeam
from .cosmology import Cosmology
from .linear_model import (LinearModel, MultiLM, DictLM, gen_linear_A,
                           gen_poly_A, gen_fourier_A, prep_xarr, whiten_xarr)
from .fft import FFT, PeakDelay, gen_window, vis_wedge
from .filt import (MatFilter, GPFilter, LstSqFilter, WedgeFilter, rbf_cov,
                   exp_cov, sinc_cov, gauss_sinc_cov, phasor_mat,
                   gen_cov_modes)
from .calibration import (JonesModel, JonesResponse, RedVisModel, VisModel,
                          VisModelResponse, vis2JonesModel, vis2RedVisModel)
from .rime import RIME
from .sky import (PixelSky, PixelSkyResponse, PointSky, PointSkyResponse,
                  CompositeModel, Stokes2Coherency, CoherencySky,
                  stokes2coherency, SphHarmSky, pixelsky_Ylm_cut)
from .telescope import TelescopeModel, ArrayModel, build_reds
