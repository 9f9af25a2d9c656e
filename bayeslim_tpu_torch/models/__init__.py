"""Telescope, sky, beam (pixel and Ylm), the RIME forward model, antenna
gains, the cosmology, the linear models, the delay FFT, the filters,
antenna cross-coupling and dirty-map imaging."""
from . import (airy_psky, beam, beam_ylm, bessel, calibration, cosmology,
               coupling, fft, filt, imaging, linear_model, rime, sky,
               telescope)
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
from .coupling import (VisCoupling, RedVisCoupling, CouplingInflate,
                       PartialRedVisInflate, gen_coupling_terms, cut_bl)
from .imaging import (VisMapper, VisData2MapData, make_map, compute_P,
                      deconvolve_map, compute_Am, compute_Pm, get_visdata)
from .rime import RIME
from .sky import (PixelSky, PixelSkyResponse, PointSky, PointSkyResponse,
                  CompositeModel, Stokes2Coherency, CoherencySky,
                  stokes2coherency, SphHarmSky, pixelsky_Ylm_cut, Jy2K,
                  InterpSky, ang_index, eqarea_grid, index_sky_pixels)
from .telescope import TelescopeModel, ArrayModel, build_reds
