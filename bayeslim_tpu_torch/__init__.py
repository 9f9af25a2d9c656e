"""
bayeslim_tpu_torch: the PyTorch/CUDA port of bayeslim_tpu.

A differentiable RIME forward simulator with antenna-gain calibration
and a Gaussian posterior, for NVIDIA GPUs (the fused RIME reduction and
its delay cotangent are hand-written CUDA kernels for Hopper,
csrc/rime_fwd.cu and csrc/rime_dtau.cu). The layout mirrors
bayeslim_tpu module for module:

- utils/     : dtype/device policy, ParamDict, nn.Module base and
               Sequential, indexing, HEALPix (and multi-resolution
               HEALPix), pixel interpolation, training-state
               checkpoints and structured logging
- ops/       : fringe phase math, the RIME reduction, its CUDA kernels,
               linear algebra (least squares, inversion dispatch),
               special functions, spherical harmonics (Ylm, AlmModel)
               and spherical Fourier-Bessel transforms (SFBModel)
- data/      : VisData / MapData / CalData containers, their
               averaging, rephasing and redundancy reductions, the
               chain blocks (RedVisAvg, RedVisInflate, Difference),
               Dataset, and the file layer: HDF5 files and lazy HDF5
               tensors, UVH5 and calfits files, the builders of models
               and posteriors from configs, and pickles (data/io.py)
- models/    : telescope/array, sky (pixel, a_lm and SFB t_lmn), beam
               (pixel and Ylm), RIME, Jones gains, the per-baseline /
               per-group visibility models and the redcal degeneracies,
               the cosmology, linear models (LinearModel, MultiLM,
               DictLM), the delay FFT (FFT, PeakDelay), the filters
               (MatFilter, GPFilter, LstSqFilter, WedgeFilter), antenna
               cross-coupling (VisCoupling, RedVisCoupling) and
               dirty-map imaging (VisMapper)
- inference/ : priors, LogProb (structured covariances, main-param
               sub-slices), the Trainer, BFGS, L-BFGS and its
               approximate covariance, Hessians (compute_hessian,
               FactoredInvHessian), the hmat operators and the
               samplers (HMC, RecycledHMC, NUTS)
- parallel/  : the posterior sharded over the ranks of
               torch.distributed (ShardedLogProb over a mesh's time and
               baseline axes, shard_pixels, multi-process start-up)
- scripts/   : the microbenchmark spikes of scripts/mosaic_spike.py
               (not imported here; run python -m
               bayeslim_tpu_torch.scripts.mosaic_spike on the card)

Device rule: constructors and entry points take device=None, meaning
"cuda", and raise when no GPU is present; pass device="cpu" to run on
the CPU (where the kernel's plain PyTorch version runs). The default
dtype is float32. h5py, yaml and pyuvdata are optional: they are
imported by the calls that read or write their files.
"""

__version__ = "0.1.0"

from . import utils, ops, data, models, inference, parallel
from .utils import (ParamDict, Module, Sequential, model2pdict,
                    load_numpy_pdict, set_default_dtype, resolve_device)
from .data import (VisData, MapData, CalData, Dataset, concat_VisData,
                   concat_MapData, concat_CalData, load_data)
from .models import (RIME, TelescopeModel, ArrayModel, PixelBeam,
                     AiryResponse, GaussResponse, UniformResponse,
                     PixelResponse, YlmResponse, AlmBeam, Cosmology,
                     PixelSky, PixelSkyResponse, PointSky,
                     PointSkyResponse, CompositeModel, Stokes2Coherency,
                     CoherencySky, SphHarmSky, pixelsky_Ylm_cut, JonesModel,
                     JonesResponse, VisModel, VisModelResponse, RedVisModel,
                     vis2JonesModel, vis2RedVisModel, LinearModel,
                     MultiLM, DictLM, FFT, PeakDelay, MatFilter, GPFilter,
                     LstSqFilter, WedgeFilter, VisCoupling, RedVisCoupling,
                     CouplingInflate, PartialRedVisInflate, VisMapper)
from .ops import (AlmModel, SFBModel, gen_bessel2freq, gen_lm,
                  gen_sph2pix)
from .inference import (LogProb, Trainer, BFGS, LBFGS, DiagMat,
                        lbfgs_approx_cov, LogGaussPrior, LogLaplacePrior,
                        LogTaperedUniformPrior, LogUniformPrior, MainParams,
                        HMC, NUTS, RecycledHMC, Potential,
                        compute_hessian, FactoredInvHessian)
