#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (bayeslim_tpu_torch) on one NVIDIA
GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. the card (nvidia-smi name and power limit), versions, and the nvcc
   build of the CUDA kernels from csrc/ (all sources at once); for
   rime_fwd.cu and rime_dtau.cu each kernel's registers and spills
   (ptxas), its FP64 instructions in the SASS (cuobjdump; none
   allowed), and each variant's shared memory and resident blocks per
   SM;
2. the RIME kernel (rime_fwd) against its plain PyTorch version in
   float64 (of the same float32 inputs), every ps / conj / out_imag
   case: small shapes, ragged runs (nstack = 3 at nf = 5 and 1000),
   K = 1, N = 1, K below one slice, delays of at most 1e-9 s, zero
   delays (the output is then the sum over c), hera-stat's longest
   delays, delays past hex-11 (every |tau| within 1 % of 3e-6 s), the
   hera-stat forward and backward shapes, hera-prod's (4 stacked
   rows a channel, R = 4096, complex ps, complex out: the forward
   K = 6144, N = 630 and the role-swapped backward) and hera-alm's
   (R = 128 channels over 100-200 MHz: the forward K = 26,624,
   N = 630 and the role-swapped backward, every case); each case
   launched twice, the two outputs bit-equal;
3. the delay-cotangent kernel (rime_dtau) against its plain version the
   same way, on phase 2's cases: small shapes, ragged passes (nstack = 3
   at nf = 5 and 1000), K = 1, N = 1, N below one block, delays of at
   most 1e-9 s, zero delays, hera-cal's longest delays, delays past
   hex-11 (within 1 % of 3e-6 s) and the hera-cal shape; every ps /
   conj case launched twice, the outputs bit-equal;
4. the autograd Function on the card against the CPU float64 plain
   path: the value and the gradients of psky, blvecs and s_c;
5. main path 1, hera-stat at full width: a 331-antenna hex array (630
   redundant groups), 1024 frequencies, an nside-32 sky cut to the
   180 deg field of view, 2 times, an Airy power beam and a power-law
   sky, fitted to the redundant-group sufficient statistics by 3 Adam
   steps; rime_fwd launches must be exactly 2 x Ntimes x pixel chunks
   per step; the step walls and peak memory beside those from before
   psky's construction was checkpointed per time; then one more step
   under torch.profiler;
6. main path 2, hera-cal at full width: the same array, sky and beam
   (fixed), the 630 groups simulated and expanded to all 54,615 cross
   baselines, then per-antenna complex gains (JonesModel); antenna
   positions and gains are trainable, fitted by 3 L-BFGS steps with a
   strong-Wolfe line search to a target made from moved antennas and
   perturbed gains plus noise; rime_fwd and rime_dtau launches must each
   be exactly Ntimes x pixel chunks x function evaluations; then one
   function evaluation under torch.profiler;
7. small posteriors on the card (float32, kernels) against the port on
   the CPU (float64, plain versions): a small sky/beam posterior, the
   hera-cal chain, the hera-prod chain (its loss and gradients
   accumulated over 2 time batches), the hera-redcal chain (priors
   included), the hera-alm chain (nside 8, lmax 23), the hera-sfb
   chain (the same sky with 8 k modes, a Ylm beam of lmax 8) and the
   hera-filt chain (64 channels, its delay filter at a suppression of
   100), loss and gradients; and one HMC trajectory each of the hera-hmc
   and the hera-hmc-alm chain (end position, end momentum and dU); then
   a hex-2 imaging case (VisMapper's maps, diagonal and row-sum P,
   compute_Am and compute_Pm), the hex-2 hera-coupling chain (at its
   truth and its start) and the whole hex-2 hera-cal Hessian, each on
   the card in float64 against the CPU in float64 at 1e-9, the imaging
   and the coupling also in float32 through the kernels at TOL; then the
   hex-2 hera-avg cases, card float32 (TOL) and float64 (1e-9) against
   the CPU float64: the chain RIME -> RedVisInflate -> JonesModel ->
   RedVisAvg (loss and gradients through the segment sums), Difference
   of two time selections, apply_cal(undo=True) of a 4-pol CalData from
   inflate_to_4pol;
8. kernel and plain-version times at the main paths' shapes (rime_fwd
   also at hera-prod's two and hera-alm's two), each kernel's bound, rime_fwd with its K split against one slice,
   rime_dtau beside the previous design's time, with real and complex
   ps, and
   k_fwd timed at hera-stat's forward shape beside rime_fwd's times at
   both shapes (as a fraction of k_fwd's) and k_fwd's previous
   design's; k_rot there on mk's and unit_m's inputs, with L2 warm and
   emptied before each launch, beside its previous design's time;
9. main path 3, the microbenchmark spikes (bayeslim_tpu_torch/scripts/
   mosaic_spike.py, the seven kernels of csrc/mosaic_spike.cu): the
   ptxas report (registers, spills, static shared memory) of all seven,
   all redesigned (k_nn, k_nt, k_vt, k_lr, k_bd, k_fwd, k_rot), no FP64
   in the SASS of any kernel of the file (in every instance the source
   makes), and the launch plans of the six with a plan
   beside the C launchers'; each kernel against its plain version in
   float64 at the script's sizes and at a size that fills no tile (k_fwd
   there against every chain count G of the plain version); all seven
   also at ragged sizes (4-byte loads; for k_bd and k_fwd NF a multiple
   of G, and NF = 97 with G = 1) and launched twice, bit-equal; k_rot's
   float-float power at NF = 0 ... 16384 on unit_m's inputs at the
   script's, odd and ragged sizes (1e-4, and printed against 1e-6);
   the spike's own entry point, main(), with every kernel's
   launches counted (exactly 1 + 400 each); the plain versions' times,
   the redesigned kernels' beside their library call's (k_bd's also
   beside torch.matmul(ps, m) alone) and the previous design's;
10. the kernel entry points beyond the main paths' on the card against
   the CPU float64 plain path, with their launch counts: the Nmp > 1
   grouped dispatch (a hex-3 array whose antennas carry 2 Gaussian beam
   models, up to 4 model pairs; sky, beams and antenna positions trainable:
   one rime_fwd a pair, time and pass, one rime_dtau a pair and time),
   RimeFused (a delay matrix given: value, psky and tau gradients) and
   rime_pallas_reduce;
11. main path 4, hera-prod at full width
   (bayeslim_tpu_torch/scripts/hera_prod.py): the same array expanded
   to all 54,615 cross baselines, 1024 frequencies, an nside-32 sky of
   4 Stokes planes emitted as a 2x2 coherency, a fixed 2x2 Jones
   PixelResponse beam on the same grid, 2 time batches of 2 times, 4-pol
   complex gains; 3 Adam steps on sky and gains, each accumulating over
   both batches; rime_fwd launches must be exactly 2 x times x batches
   per step and rime_dtau none; the build seconds, step walls, losses
   and peak memory; then one step under torch.profiler;
12. main path 5, hera-redcal at full width (build_redcal): the same
   array, sky (1e4 x hera-stat's) and beam, all fixed, the 630 groups
   expanded to all 54,615 cross baselines; Sequential(RIME ->
   RedVisModel -> JonesModel): a per-group correction (1, 1, 630, 2,
   1024) and 1-pol gains (1, 1, 331, 1, 1024), both real pairs, the
   gains' abs-amp and phase-slope degeneracies projected out, a
   LogGaussPrior on each; 3 L-BFGS steps, then lbfgs_approx_cov (2
   probe steps a leaf), the chi^2 per degree of freedom and the solved
   gains' residual degeneracies; rime_fwd launches must be exactly
   times x pixel chunks x function evaluations and rime_dtau none; then
   one evaluation under torch.profiler;
13. main path 6, hera-hmc at full width (build_hmc), config #4's joint
   posterior: the same array (fixed), sky (1e4 x hera-stat's, 12,288
   pixels of amplitude and index) and Airy beam, both trainable, the 630
   groups expanded to all 54,615 cross baselines, 1-pol gains (real
   pairs), 702,466 parameters, Sequential(RIME -> JonesModel), started
   at its truth; a diagonal mass from lbfgs_approx_cov (2 probe steps a
   leaf), dual averaging (20 HMC steps of 10 at target 0.8 from eps
   1e-3), 10 HMC samples (mean acceptance >= 0.3, no divergence), 3
   NUTS steps (max depth 5), 2 RecycledHMC steps, HMC.sample_chains
   (2 chains of 3), a write_chain / load_chain round trip; every dH,
   acceptance, tree depth, evaluation count and step wall; rime_fwd
   launches must be exactly 2 x times x pixel chunks x evaluations and
   rime_dtau none; U must be a float64 scalar; then the dH check (the
   first three trajectories' ends evaluated by the chain in float64, the
   float32 |r|^2 summed in float32 and in float64) and one HMC step
   under torch.profiler;
14. main path 7, hera-alm at full width (build_alm), config #2's diffuse
   sky: hera-stat's array and its 630 redundant groups (icov = group
   counts), 128 frequencies over 100-200 MHz, 2 times, an nside-64
   HEALPix sky (49,152 pixels) of AlmModel(gen_lm(191)) modes (18,528,
   m >= 0) whose complex Ylm (7.29 GB complex64) is built on the card,
   the a_lm trainable real pairs through PixelSkyResponse(spatial_mode=
   'alm'), the chromatic Airy power beam trainable; the build seconds
   (host Legendre table, device Ylm assembly); the Ylm finite
   everywhere, 64 of its rows within 1e-6 of float64 values of the row
   maximum; the map of the truth's a_lm at 2,048 pixels and 4 channels
   within 1e-4 of a CPU float64 evaluation of the map's rms; 3 Adam
   steps whose losses fall, rime_fwd launches exactly 2 x times x pixel
   chunks a step and rime_dtau none, its shapes those of phases 2 and
   8; peak memory below the Ylm + 2 GiB; the two Ylm products by CUDA
   events against the bound of the complex GEMM and that of the work
   real_output needs (half the operations); then one step under
   torch.profiler with the Ylm products' share;
15. main path 8, hera-sfb at full width (build_sfb), config #2's widths
   with the spherical Fourier-Bessel radial basis: hera-alm's array,
   times, target form and sky (phase 14's Ylm, taken through setup_Ylm)
   through PixelSkyResponse(freq_mode='bessel'), the t_lmn (1, 1, 128,
   18,528) real pairs over the ball's Neumann k modes (gen_bessel2freq
   at the kmax that gives at most 128 an l, printed), and a Ylm power
   beam (YlmResponse(gen_lm(64)) on an nside-64 grid, 2,145 modes, a
   0.79 GiB Ylm; its truth the Airy beam fitted per channel); the
   build split into host gen_bessel2freq, the beam's Ylm and the rest;
   the sky and beam maps at the truth at 2,048 pixels and 4 channels
   within 1e-4 of a CPU float64 evaluation of each map's rms; 3 Adam
   steps whose losses fall, rime_fwd launches exactly 2 x times a step
   and rime_dtau none, the shapes those of ALM_SHAPES; peak memory below
   the two Ylm + 2 GiB; the SFB transform and its gradient by CUDA
   events beside their bounds and the per-l plain loop's; then one step
   under torch.profiler;
16. main path 9, hera-hmc-alm at full width (build_hmc_alm),
   BASELINE.json config #4 as written: hera-hmc's chain over hera-alm's
   a_lm sky and hera-sfb's Ylm beam (both Ylm shared), 128 channels,
   5,377,024 parameters, started at its truth; a diagonal mass from
   lbfgs_approx_cov, dual averaging (10 steps of 10), 10 HMC samples, 3
   NUTS steps (max depth 5); acceptance, every dH, evaluations, step
   walls, each leaf's share moved; rime_fwd launches exactly 2 x times
   an evaluation and rime_dtau none; the dH check against the chain in
   float64 (its own float64 Ylm, 13.6 GiB for the sky) with its peak;
   then one evaluation under torch.profiler;
17. main path 10, hera-filt at full width (build_filt), config #5's
   baseline-dependent delay filter over hera-cal's chain:
   Sequential(RIME -> JonesModel -> WedgeFilter), hera-cal's array
   (antenna positions trainable), sky and beam, 54,615 baselines, 1024
   channels, 2 times; gains smooth in frequency (JonesResponse(freq_mode=
   'linear'), 16 Legendre coefficients an antenna); the WedgeFilter of 8
   GPFilter(residual=True), one a bin of baseline length (sinc
   covariance of half-width tau = the bin's longest b / c + 100 ns, Cn =
   1e-9 I); the target the chain at a seeded truth plus unit noise,
   filtered; 3 L-BFGS steps whose loss falls, rime_fwd and rime_dtau
   launches exactly times x chunks x evaluations; build seconds (of
   them the host float64 inversions), peak memory, chi^2/dof; the
   float32 filtered cube within 1e-5 of the input's rms of the float64
   filter on the card (and with G in float32), each bin's in-band
   suppression of the noise-free foregrounds in each, PeakDelay before
   and after; the filter by CUDA events beside its bound (one G
   as a real product over the two planes and as a complex product); one
   evaluation under torch.profiler;
18. main path 11, hera-img at full width, config #5's imaging:
   hera-filt's chain at its truth plus noise, the 54,615-baseline,
   1024-channel cube before and after its WedgeFilter, imaged by one
   VisMapper onto the nside-32 HEALPix grid (12,288 pixels; ~6,144 in
   each time's FOV) with unit weights, 'A2w' and the Airy power beam,
   through rime_fwd (the delay factored as blvecs @ s / c; A is never
   built): make_map(return_P=True, contract='diag') of both cubes,
   compute_Am and compute_Pm of the unfiltered map, each by CUDA events
   with its launches (exactly times x pixel chunks a launch kind; no
   rime_dtau); peak memory; the filtered map's summed |m| below half the
   unfiltered one's; both maps at 2,048 FOV pixels and 4 channels
   within TOL of the map's rms of the float64 plain version (the same
   beam values); rime_fwd at hera-img's two shapes (K = 54,615 in the
   role-swapped one) against its float64 plain version on 64 columns,
   bit-equal twice, timed beside its bound;
19. main path 12, hera-coupling at full width (build_coupling):
   Sequential(RIME -> RedVisCoupling -> JonesModel), the 630 groups
   inflated onto all 54,615 cross baselines and coupled to first and
   second order by terms within COUPLING_MAX_LEN (one complex amplitude
   a redundant separation, CouplingInflate), 1-pol gains; 3 Adam steps
   whose loss falls, rime_fwd launches exactly steps x times x chunks
   and no rime_dtau, step walls, peak memory; the coupling's forward by
   CUDA events beside its four products' bound; one step under
   torch.profiler with the GEMMs' share;
20. main path 13, hera-hess: hera-cal's chain through 3 L-BFGS steps,
   FactoredInvHessian.from_lbfgs over its 678,881 parameters on the card
   (<w, Hv> = <v, Hw>, <v, Hv> > 0, lvp finite; nothing dense); a double
   backward through the fused kernels raises the error naming
   force_chunked; compute_hessian(keys=[antenna positions], Nstart=0,
   Nrows=6) in float64 on the card inside force_chunked (no launch),
   its 6 x 6 block symmetric, its rows within 1e-6 of central
   differences of the float64 gradient, beside the float32 chain's rows;
   wall time and peak memory;
21. main path 14, hera-avg, HERA's reduction before a sky fit
   (build_avg): hera-cal's array, sky (trainable) and 1-pol gains at 4
   times, Sequential(RIME over the 630 groups -> RedVisInflate onto all
   54,615 cross baselines -> JonesModel) at its truth plus unit noise
   (icov ones); JonesModel.to_CalData and VisData.apply_cal(undo=True),
   the noise-free calibrated cube within TOL of its rms of the group
   output inflated; time_average of the bins [[0, 1], [2, 3]] with LST
   rephasing; reduce_by_redundancy onto the 630 groups (icov = 2 x the
   member counts); bl_average and time_average on 2,048 baselines x 4
   channels card vs CPU float64 at TOL; the sufficient-statistics
   identity in float64 on the card (chi^2 and the sky / beam gradients
   within 1e-9) and the float32 route's (chi^2 within its bar, the
   gradients within AVG_G32_TOL); a Dataset of the two averaged times
   fitted by 3 Adam steps (losses fall, rime_fwd exactly 2 x times x
   chunks a step, times x chunks for the simulation, no rime_dtau); the
   fitted parameters written into the model, RedVisInflate of its output
   and its chi^2 against the averaged cube, below the start's by at least
   the losses' fall and equal within the bar to the statistics' chi^2
   plus const; each data operation by CUDA events beside
   its bytes bound; build seconds, step walls, peak memory;
22. main path 15, hera-io, the file layer at hera-cal's width
   (io_seq_dict): the pixel sky saved by data/io.write_pkl, the chain
   built by build_prob(seq_dict=...) from that pickle path and kwargs
   dicts of the beam, telescope, array, RIME and JonesModel, against a
   simulated VisData target (the chain at cal_truth plus unit noise);
   one evaluation's rime_fwd / rime_dtau launches equal to phase 6's
   (times x chunks each); whether two evaluations give the same bits
   with PyTorch's default algorithms; then, under
   torch.use_deterministic_algorithms, IO_STEPS Adam steps by a Trainer
   with Metrics, a JSON-lines logger and CheckpointManager(every=1,
   max_to_keep=2) (the kept steps checked), and the same fit
   interrupted after IO_SPLIT steps, rebuilt from the same dicts,
   restore_latest into the fresh build and resumed: losses and final
   parameters bit-equal to the uninterrupted run's; the fitted chain
   through write_pkl / read_pkl(device='cuda'): the same loss bit for
   bit; the fitted gains as a CalData (to_CalData, complex128, both
   times) through write_calfits / read_calfits on the card, exact; the
   bundled demo_hex7_gains.calfits read onto the card equal to the CPU
   read; where yaml is present, the chain from a YAML config
   (io_yaml_chains: the bundled demo_powerlaw_cat.yaml as a PointSky,
   the gains a pickle) by load_yaml and build_prob on the card, its
   loss bit-equal to the kwargs build's; an HDF5 write raising
   ImportError naming h5py where h5py is absent; step walls (CUDA events), the checkpoint and pickle write /
   read times and sizes, the calfits round trip's time, peak memory and
   the card's name and power limit;
23. main path 16, hera-shard, config #5 run whole over ranks
   (bayeslim_tpu_torch/parallel/ on torch.distributed): ranks spawned
   on the card, sharing it over gloo (a file:// store under build/shard/,
   a timeout on every collective; a rank that fails or hangs fails the
   phase, the others killed), each building the whole posterior and
   keeping its shard, rank 0 also evaluating it whole for the
   reference. Stage A, 2 ranks on {'data': 2}: hera-filt's chain at
   hera-avg's 4 times, 2 a rank (its filter's noise SHARD_FILT_NOISE,
   a suppression of 100: stage A checks the sharding, not config #5's
   own filter of 1e9, where the float32 gradient is at its rounding
   noise, ROADMAP C10), under
   torch.use_deterministic_algorithms (two whole evaluations the same
   bits): the sharded loss within SHARD_LOSS_TOL and each gradient leaf
   within TOL of its max of the whole evaluation, SHARD_EVALS timed
   evaluations, SHARD_STEPS L-BFGS steps through ShardedLogProb (losses
   and a digest of the parameters after each step the same on every
   rank), then the filtered cube imaged by VisMapper with the channels
   split over the ranks, the gathered maps within TOL of the whole
   map's max. Stages B and C, 3 ranks: B hera-cal's chain on {'model':
   3} (210 of the 630 groups simulated a rank, the cube gathered and
   expanded onto its 18,205 of the 54,615 baselines, the Jones indices
   pinned and cut) to the same bars; C build_nmp's hex-3 posterior (3
   model pairs) baseline-sharded on {'model': 3} (each rank regroups its
   baselines by pair on the host), with the device baseline -> pair map
   pinned (the dispatch's device branch, against the host grouping),
   and shard_pixels over the 3 ranks (the kernel on a third of the
   pixels). Each rank's rime_fwd and rime_dtau launches equal to its
   local times x pixel chunks x evaluations (by model pair in C), its
   walls, the collectives' host time and bytes and its peak memory;
   with two or more cards stage A again over NCCL, one rank a card.
   Then the JSON line of all nine kernels.

Each torch.profiler run launches PROFILE_MARKS spin kernels before the
profiled function and prints how many the profiler kept: it often drops
the first kernels of a session (see profile).

The last line is {"ok": true, "device": {...}}. Exits non-zero without
printing a result when no CUDA device or no package is present.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4
LOC = (21.428305555, -30.72152777, 1073.0)
ANTVECS = "models.rime.array.antvecs"
GAINS = "models.cal.params"
REDVIS = "models.redvis.params"
SKY = "models.rime.sky.params"
BEAM = "models.rime.beam.params"
COUPLING = "models.coupling.coupling.params"
# hera-io (phase 22): Adam steps of the fit, the step after which the
# second run is interrupted and resumed, and Adam's learning rate
IO_STEPS, IO_SPLIT, IO_LR = 4, 2, 1e-3
# phase 7's hex-2 HMC trajectory: leapfrog steps and step size
HMC_STEPS, HMC_EPS = 5, 1e-5
# phase 13: the largest first trial step of lbfgs_approx_cov's probe in
# each leaf (sky amplitudes ~1e4-1e5 and indices -2.5 share a leaf; beam
# widths 14 deg; gains ~1)
HMC_PROBE = {SKY: 1e-3, BEAM: 1e-4, GAINS: 1e-4}
# the full-width configuration of both main paths
HERA = dict(hexN=11, nside=32, nfreq=1024, fmax=200e6, ntime=2,
            pix_chunk=2048)
# config #2 at full width (hera-alm, phase 14): hera-stat's array, an
# nside-64 a_lm sky of lmax 191, 128 channels over 100-200 MHz
ALM = dict(hexN=11, nside=64, lmax=191, nfreq=128, fmax=200e6, ntime=2,
           pix_chunk=2048)
# hera-sfb (phase 15): hera-alm's sky with the SFB radial basis of at most
# 128 k modes an l, and a Ylm power beam of lmax 64 on an nside-64 grid
SFB = dict(ALM, beam_lmax=64, beam_nside=64, nn=128)
# hera-hmc-alm (phase 16), config #4 as written: hera-hmc's chain over
# hera-alm's a_lm sky and hera-sfb's Ylm beam
HMC_ALM = dict(ALM, beam_lmax=64, beam_nside=64)
# rime_dtau's previous design at the hera-cal shape (real ps), and a
# hera-cal function evaluation's device time with it (chip_smoke.py on
# an NVIDIA H100 80GB HBM3 at 700 W)
DTAU_BEFORE_MS, CAL_EVAL_BEFORE_MS = 3.7004, 29.05
# hera-stat before psky's construction was checkpointed: the second and
# third step walls (ms) and the peak device memory (GiB), chip_smoke.py
# on an NVIDIA H100 80GB HBM3 at 700 W
STAT_STEPS_BEFORE_MS, STAT_PEAK_BEFORE_GIB = (22.8, 19.4), 2.15
# hera-filt (phase 17): Legendre coefficients of a gain, bins of
# baseline length, and the delay [s] each bin's filter keeps beyond its
# longest horizon delay
FILT_NDEG, FILT_BINS, FILT_BUFFER = 16, 8, 100e-9
# hera-coupling (phase 19): the longest antenna separation [m] that
# couples (three hex spacings of 15 m, plus a margin)
COUPLING_MAX_LEN = 46.0
# hera-avg (phase 21): hera-cal's size at 4 times (hera-stat's spacing),
# the time bins averaged, the baselines and channels on which bl_average
# and time_average are held against the CPU in float64, and float32's
# unit roundoff (the bar of the float32 sufficient-statistics identity)
AVG = dict(HERA, ntime=4)
# hera-shard (phase 23), config #5 sharded over ranks that share the card
# over gloo: stage A hera-filt's chain at hera-avg's 4 times on {'data':
# 2}, stage B hera-cal's chain on {'model': 3}, stage C the hex-3 Nmp > 1
# posterior on {'data': 2, 'model': 2}; the loss's bar against the
# single-process evaluation (the gradients': TOL of each leaf's max), the
# sharded evaluations and L-BFGS steps timed, and the limits [s] of a
# stage's ranks and of one collective
SHARD = AVG
SHARD_LOSS_TOL, SHARD_EVALS, SHARD_STEPS = 1e-6, 3, 3
# stage A's filter noise (a suppression of 100, as phase 7's hera-filt
# case): at hera-filt's 1e-9 the float32 gradient is at its rounding
# noise (phase 17 prints two evaluations' difference), and the times'
# sums in another order move it by tens of per cent; so stage A checks
# the sharding, not config #5's own filter (ROADMAP C10)
SHARD_FILT_NOISE = 1e-2
SHARD_STAGE_S, SHARD_COLL_S = 300, 120
AVG_BINS = [[0, 1], [2, 3]]
AVG_SUB_BLS, AVG_SUB_FREQS = 2048, (0, 341, 682, 1023)
AVG_F64_CHUNK = 256
EPS32 = 2.0 ** -24
# hera-avg's float32 sufficient-statistics gradients against the full
# per-baseline ones (rel of their largest; 2.25e-8 measured on an H100)
AVG_G32_TOL = 1e-6
# the redesigned spikes' previous designs at the script's sizes, ms a
# launch (the same card): k_nn's, k_nt's and k_bd's 64 x 64 SGEMM tile,
# k_vt's serial column walk per output, k_lr's one row a block with a
# 32-lane butterfly per output, k_fwd's G chains a thread with atomics,
# k_rot's NF-step loop a thread
BEFORE_MS = {"k_nn": 0.0251, "k_nt": 0.0287, "k_vt": 0.0275,
             "k_lr": 0.0238, "k_bd": 0.0233, "k_fwd": 0.0371,
             "k_rot": 0.0132}
# k_fwd's and k_rot's previous designs at hera-stat's forward shape (the
# same card)
SPIKE_BEFORE_MS = {"k_fwd": 2.0162, "k_rot": 0.6652}
# the NF at which phase 9 holds k_rot's float-float power to float64
ROT_NF = (0, 1, 2, 3, 7, 1023, 1024, 4096, 16384)
# delays past hex-11's longest (~1.0e-6 s) that phases 2 and 3 hold to
# the same bar: |tau| within 1 % of this
FAR_DELAY = 3e-6
# hera-stat's and hera-cal's steps in PR 9 (chip_smoke.py, NVIDIA H100
# 80GB HBM3 at 700 W): hera-stat's second and third step walls (ms), a
# hera-cal function evaluation's device time (ms)
PR9_STAT_STEPS_MS, PR9_CAL_EVAL_MS = (20.8, 18.9), 24.55
# hera-prod's rime_fwd launches (4 stacked rows a channel, 1024 channels,
# complex ps and output): (label, K, N, conj) of the forward (K the FOV
# pixels, N the redundant groups) and the role-swapped backward
PROD_SHAPES = (("hera-prod fwd", 6144, 630, False),
               ("hera-prod bwd", 630, 6144, True))
# hera-alm's rime_fwd launches (one row a channel, 128 channels over
# 100-200 MHz; the whole nside-64 FOV of 26,624 pixels in one launch a
# pass and time, phase 14 checks that): (label, K, N, ps_real, conj,
# out_imag) of the forward (K the FOV pixels, N the redundant groups)
# and the role-swapped backward
ALM_SHAPES = (("hera-alm fwd", 26624, 630, True, False, True),
              ("hera-alm bwd", 630, 26624, False, True, False))
# spin kernels launched as torch.profiler starts, before the profiled
# function (see profile; 64 once kept only one)
PROFILE_MARKS = 1024
# the TPU kernel each spike replaces (scripts/mosaic_spike.py)
SPIKE_LINES = {"k_nn": 46, "k_nt": 65, "k_vt": 84, "k_lr": 100, "k_bd": 119,
               "k_rot": 147, "k_fwd": 180}


def check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def relerr(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def build_sky_beam(bt, hexN, nside, nfreq, fmax, redtol, antpos_param,
                   device, dtype, rng, amp=1.0, sky_beam_param=None):
    """Telescope, array, power-law pixel sky (amplitudes amp x U(1, 10)
    from the numpy Generator rng) and Airy power beam through the port's
    public API; the sky and the beam are trainable unless the antenna
    positions are, or as sky_beam_param says. Returns (T, arr, sky,
    beam, freqs)."""
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, fmax, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs,
                        redtol=redtol, parameter=antpos_param, device=device,
                        dtype=dtype)
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    params = np.zeros((1, 1, 2, npix))
    params[0, 0, 0] = amp * rng.uniform(1, 10, npix)
    params[0, 0, 1] = -2.5
    R = bt.PixelSkyResponse(freqs, spatial_mode="pixel",
                            freq_mode="powerlaw", f0=float(freqs[0]),
                            device=device, dtype=dtype)
    if sky_beam_param is None:
        sky_beam_param = not antpos_param
    sky = bt.PixelSky(params, angs, hp.nside2pixarea(nside), R=R,
                      parameter=sky_beam_param, device=device, dtype=dtype)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, parameter=sky_beam_param, device=device,
                        dtype=dtype)
    return T, arr, sky, beam, freqs


def build_posterior(bt, hexN, nside, nfreq, fmax, ntime, stat, pix_chunk,
                    device, dtype, seed=0):
    """The hera-stat (stat=True) or the small all-baseline posterior
    through the port's public API. Returns (prob, sim_bls)."""
    import torch
    device = bt.resolve_device(device)
    rng = np.random.default_rng(seed)
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, hexN, nside, nfreq, fmax, 0.5 if stat else 1.0, False, device,
        dtype, rng)
    times = 2458168.3 + np.arange(ntime) * 5e-4
    if stat:
        reds = [r for r in arr.reds if r[0][0] != r[0][1]]
        bls = [r[0] for r in reds]
    else:
        bls = arr.get_bls(keep_autos=False)
    rime = bt.RIME(sky, T, beam, arr, bls, times, freqs,
                   pix_chunk=pix_chunk)
    shp = (1, 1, len(bls), ntime, nfreq)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    if stat:
        noise = rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
        data = torch.as_tensor(noise, dtype=cdt, device=device)
        counts = np.asarray([len(r) for r in reds], dtype=np.float64)
        icov = torch.as_tensor(np.broadcast_to(
            counts[None, None, :, None, None], shp).copy(), dtype=dtype,
            device=device)
    else:
        with torch.no_grad():
            data = rime().data
        icov = None
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=data, icov=icov)
    return bt.LogProb(rime, tgt), bls


def cal_truth(ants, antvecs, nfreq, ant_sigma, gain_sigma, seed=1):
    """Truth of the hera-cal chain (numpy): antenna positions moved by
    N(0, ant_sigma) [m] in E and N, gains 1 + gain_sigma (N + iN) as real
    pairs with the first antenna's phase zeroed (it is the refant)."""
    rng = np.random.default_rng(seed)
    av = np.array(antvecs, dtype=np.float64)
    av[:, :2] += ant_sigma * rng.standard_normal((len(ants), 2))
    g = 1 + gain_sigma * (rng.standard_normal((1, 1, len(ants), 1, nfreq))
                          + 1j * rng.standard_normal((1, 1, len(ants), 1,
                                                      nfreq)))
    g = g * np.exp(-1j * np.angle(g[:, :, :1]))
    return {ANTVECS: av, GAINS: np.stack([g.real, g.imag], axis=-1)}


def build_cal(bt, hexN, nside, nfreq, fmax, ntime, pix_chunk, device,
              dtype, ant_sigma=0.01, gain_sigma=0.05, amp=1e4, seed=0):
    """The hera-cal chain through the port's public API:
    Sequential(RIME -> JonesModel) with trainable antenna positions and
    per-antenna complex gains (1 pol, real pairs, refant the first
    antenna), the redundant groups simulated and expanded to every cross
    baseline. The target is the chain's forward at cal_truth plus complex
    noise of unit variance (E|n|^2 = 1, from a seeded torch.Generator),
    which is what icov = ones says. The sky is amp times the hera-stat
    sky, so that the visibilities stand well above that noise (amp=1e4:
    an rms of ~1e2 at hex-11). The start is the construction layout and
    unit gains. Returns (prob, truth)."""
    import torch
    device = bt.resolve_device(device)
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, hexN, nside, nfreq, fmax, 0.5, True, device, dtype,
        np.random.default_rng(seed), amp=amp)
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=arr.get_bls(keep_autos=False),
                   pix_chunk=pix_chunk)
    gains = np.zeros((1, 1, len(arr.ants), 1, nfreq, 2))
    gains[..., 0] = 1.0
    cal = bt.JonesModel(gains, arr.ants, refant=arr.ants[0],
                        R=bt.JonesResponse(param_type="com"), device=device,
                        dtype=dtype)
    seq = bt.Sequential({"rime": rime, "cal": cal})
    truth = cal_truth(arr.ants, arr.to_antpos().asnumpy(), nfreq, ant_sigma,
                      gain_sigma)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        data = seq.updated(bt.ParamDict({
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in truth.items()}))().data
        for part in (data.real, data.imag):
            part += np.sqrt(0.5) * torch.randn(
                data.shape, generator=gen, dtype=dtype, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=data,
                   icov=torch.ones(data.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt), truth


def build_redcal(bt, hexN, nside, nfreq, fmax, ntime, pix_chunk, device,
                 dtype, err=0.05, gain_sigma=0.05, amp=1e4, seed=0):
    """The hera-redcal chain through the port's public API: a redundant
    array's calibration against an imperfect sky model,
    Sequential(RIME -> RedVisModel -> JonesModel). The array, the sky
    (amp times hera-stat's) and the Airy beam are fixed; the RIME
    simulates the redundant groups and expands them to every cross
    baseline. vis2RedVisModel (redtol 0.5) adds a per-group correction,
    starting at zero; vis2JonesModel of the first time gives 1-pol gains
    per antenna and channel (one time bin), real pairs starting at
    unity, refant the first antenna, the abs-amp and phase-slope
    degeneracies projected out. Priors: LogGaussPrior on the correction
    (mean 0, sigma 4 x the truth's error scale on each real part) and
    on the gain pairs (mean (1, 0), sigma 0.2).

    Truth: the sky model's error, err x the group's rms x complex
    N(0, 1) of unit variance per (group, time, channel) from numpy seed
    seed, and gains 1 + gain_sigma (N + iN) (cal_truth, no antenna
    moved). Target: the chain at the truth plus complex noise of unit
    variance from a seeded torch.Generator; icov ones.

    Returns (prob, truth, rms): numpy truth keyed like the parameters,
    and each group's rms."""
    import torch
    device = bt.resolve_device(device)
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, hexN, nside, nfreq, fmax, 0.5, False, device, dtype,
        np.random.default_rng(seed), amp=amp, sky_beam_param=False)
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=arr.get_bls(keep_autos=False),
                   pix_chunk=pix_chunk)
    with torch.no_grad():
        vd = rime()
    redvis = bt.vis2RedVisModel(vd, redtol=0.5, device=device, dtype=dtype)
    first = vd.copy()
    first.times, first.data = vd.times[:1], vd.data[:, :, :, :1]
    cal = bt.vis2JonesModel(first, refant=arr.ants[0], device=device,
                            dtype=dtype)
    cal.R.setup_projection(abs_amp_gain=True, phs_slope_gain=True)
    # each group's rms, from its first baseline
    red_idx = redvis.red_index(vd.blnums)
    rep = np.zeros(red_idx.max() + 1, dtype=np.int64)
    rep[red_idx[::-1]] = np.arange(len(red_idx))[::-1]
    rows = vd.data[0, 0].index_select(0, torch.as_tensor(rep, device=device))
    rms = torch.sqrt(torch.mean(torch.abs(rows.to(torch.complex128)) ** 2,
                                dim=(-2, -1))).cpu().numpy()
    rng = np.random.default_rng(seed)
    shp = (len(rms), ntime, nfreq)
    z = (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)) \
        / np.sqrt(2)
    dv = err * rms[:, None, None] * z
    truth = {REDVIS: np.stack([dv.real, dv.imag], axis=-1)[None, None],
             GAINS: cal_truth(arr.ants, arr.to_antpos().asnumpy(), nfreq,
                              0.0, gain_sigma)[GAINS]}
    sig = 4 * err * rms[None, None, :, None, None, None]
    redvis.set_priors(priors_inp_params=bt.LogGaussPrior(0.0, sig ** 2))
    cal.set_priors(priors_inp_params=bt.LogGaussPrior(np.array([1.0, 0.0]),
                                                      0.2 ** 2))
    seq = bt.Sequential({"rime": rime, "redvis": redvis, "cal": cal})
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        data = seq.updated(bt.ParamDict({
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in truth.items()}))().data
        for part in (data.real, data.imag):
            part += np.sqrt(0.5) * torch.randn(
                data.shape, generator=gen, dtype=dtype, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=data,
                   icov=torch.ones(data.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt), truth, rms


def build_hmc(bt, hexN, nside, nfreq, fmax, ntime, pix_chunk, device,
              dtype, gain_sigma=0.05, amp=1e4, seed=0):
    """The hera-hmc chain through the port's public API: config #4's
    joint posterior over sky, beam and gains, Sequential(RIME ->
    JonesModel). The array is fixed; the sky (amp times hera-stat's
    power-law pixel sky: amplitude and index per pixel) and the Airy
    beam are trainable; the RIME simulates the redundant groups and
    expands them to every cross baseline; 1-pol gains per antenna and
    channel (real pairs, refant the first antenna). Truth: the sky and
    beam as built and gains 1 + gain_sigma (N + iN) (cal_truth, no
    antenna moved); the chain starts there. Target: the chain at the
    truth plus complex noise of unit variance from a seeded
    torch.Generator; icov ones. Returns (prob, numpy truth of the
    gains)."""
    import torch
    device = bt.resolve_device(device)
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, hexN, nside, nfreq, fmax, 0.5, False, device, dtype,
        np.random.default_rng(seed), amp=amp, sky_beam_param=True)
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=arr.get_bls(keep_autos=False),
                   pix_chunk=pix_chunk)
    gains = cal_truth(arr.ants, arr.to_antpos().asnumpy(), nfreq, 0.0,
                      gain_sigma)[GAINS]
    cal = bt.JonesModel(gains, arr.ants, refant=arr.ants[0],
                        R=bt.JonesResponse(param_type="com"), device=device,
                        dtype=dtype)
    seq = bt.Sequential({"rime": rime, "cal": cal})
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        data = seq().data
        for part in (data.real, data.imag):
            part += np.sqrt(0.5) * torch.randn(
                data.shape, generator=gen, dtype=dtype, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=data,
                   icov=torch.ones(data.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt), gains


def alm_truth(l, m, freqs, seed=0):
    """Truth a_lm of the hera-alm sky as real pairs (1, 1, Nfreqs,
    Ncoeff, 2), numpy seed seed: a_00 = 50 sqrt(4 pi) (f / 150 MHz)^-2.5
    (a map monopole of 50), the other modes one complex Gaussian draw
    each of E|a|^2 = sigma_l^2, sigma_l = 5 / (l + 1), times
    (f / 150 MHz)^-2.5, the m = 0 imaginary parts zero."""
    rng = np.random.default_rng(seed)
    spec = (np.asarray(freqs) / 150e6) ** -2.5
    z = (rng.standard_normal(len(l)) + 1j * rng.standard_normal(len(l))) \
        / np.sqrt(2)
    a = 5.0 / (l + 1.0) * z
    a[m == 0] = a[m == 0].real
    a[(l == 0) & (m == 0)] = 50 * np.sqrt(4 * np.pi)
    a = spec[:, None] * a[None, :]
    return np.stack([a.real, a.imag], axis=-1)[None, None]


def build_alm(bt, hexN, nside, lmax, nfreq, fmax, ntime, pix_chunk, device,
              dtype, perturb=0.1, seed=0):
    """The hera-alm posterior through the port's public API, config #2's
    diffuse sky: hera-stat's array (its redundant groups, icov = group
    counts), nfreq channels over 100 MHz-fmax, an nside HEALPix sky of
    AlmModel(gen_lm(lmax)) modes (m >= 0, complex Ylm generated on the
    device, alm_mult doubling m > 0) through PixelSkyResponse(
    spatial_mode='alm', comp_params=True, real_output=True), the a_lm
    trainable real pairs, and the chromatic Airy power beam, trainable.
    Target: the RIME at alm_truth plus complex noise of unit variance
    (numpy seed seed + 1). Start: every truth value times 1 + perturb N(0,
    1) (numpy seed seed + 2).

    Returns (prob, truth, info): truth the numpy real pairs; info the
    AlmModel, the pixels' (theta, phi) [rad], generate_Ylm's seconds and
    the seconds of its host Legendre table (its call of
    sph_harm._sphere_legendre, timed in place)."""
    import torch
    from bayeslim_tpu_torch.ops import sph_harm
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
    device = bt.resolve_device(device)
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, fmax, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=False, device=device, dtype=dtype)
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    l, m = bt.gen_lm(lmax)
    alm = bt.AlmModel(l, m, device=device, dtype=dtype)
    legendre, host = sph_harm._sphere_legendre, []

    def timed(*args):
        t1 = time.time()
        out = legendre(*args)
        host.append(time.time() - t1)
        return out
    sph_harm._sphere_legendre = timed
    try:
        t0 = time.time()
        alm.generate_Ylm(theta, phi, method="sphere", high_prec=False)
        if device.type == "cuda":
            torch.cuda.synchronize()
        gen_s = time.time() - t0
    finally:
        sph_harm._sphere_legendre = legendre
    host_s = sum(host)
    R = bt.PixelSkyResponse(freqs, comp_params=True, spatial_mode="alm",
                            freq_mode="channel", real_output=True,
                            spat_LM=alm, device=device, dtype=dtype)
    truth = alm_truth(l, m, freqs, seed)
    start = truth * (1 + perturb * np.random.default_rng(seed + 2)
                     .standard_normal(truth.shape))
    sky = bt.PixelSky(start, angs, hp.nside2pixarea(nside), R=R,
                      device=device, dtype=dtype)
    beam = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, freqs,
                        R=bt.AiryResponse(), pol="e", powerbeam=True,
                        fov=180.0, device=device, dtype=dtype)
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    bls = [r[0] for r in reds]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, bls, times, freqs,
                   pix_chunk=pix_chunk)
    with torch.no_grad():
        data = rime.updated(bt.ParamDict({"sky.params": torch.as_tensor(
            truth, dtype=dtype, device=device)}))().data
    rng = np.random.default_rng(seed + 1)
    shp = tuple(data.shape)
    noise = np.sqrt(0.5) * (rng.standard_normal(shp)
                            + 1j * rng.standard_normal(shp))
    data = data + torch.as_tensor(noise, dtype=data.dtype, device=device)
    counts = np.asarray([len(r) for r in reds], dtype=np.float64)
    icov = torch.as_tensor(np.broadcast_to(
        counts[None, None, :, None, None], shp).copy(), dtype=dtype,
        device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=data, icov=icov)
    info = dict(alm=alm, theta=theta, phi=phi, gen_s=gen_s, host_s=host_s)
    return bt.LogProb(rime, tgt), truth, info


def sfb_kmax(bt, r, nn):
    """The kmax [1/Mpc] at which no l of the ball's Neumann modes over
    comoving distances r has more than nn k modes: halfway between the
    nn-th and (nn + 1)-th root of the l whose (nn + 1)-th root is the
    smallest (l = 1: its roots run one ahead of l = 0's; those of higher
    l start later)."""
    from bayeslim_tpu_torch.ops.sph_harm import sph_bessel_kln
    r_min, r_max = float(np.min(r)), float(np.max(r))
    ks = [sph_bessel_kln(ll, r_min, r_max, (nn + 3) * np.pi / r_max)
          for ll in (0.0, 1.0, 2.0, 3.0)]
    k = min((k for k in ks if len(k) > nn), key=lambda k: k[nn])
    return 0.5 * (k[nn - 1] + k[nn])


def airy_beam_alm(l, m, freqs, nside, D=14.0):
    """Real pairs (1, 1, 1, Nfreqs, Ncoeff, 2) of the Airy power beam of
    an aperture D [m] (models/beam.airy_disk's form, sin(zen) held at 1
    past the horizon), fitted per channel on the host in float64 by
    weighted least squares on the nside HEALPix rings (weights their
    pixel counts). The beam is axisymmetric about the zenith, so only
    the m = 0 modes, Y_l0 = sqrt((2l + 1) / 4 pi) P_l(cos zen), are
    fitted; the others are 0."""
    from scipy.special import eval_legendre, j1
    from bayeslim_tpu_torch.utils import healpix as hp
    from bayeslim_tpu_torch.utils.dtypes import C_MS
    theta, _ = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    rings, counts = np.unique(theta, return_counts=True)
    szen = np.where(rings > np.pi / 2, 1.0, np.sin(rings))
    x = 2 * np.pi * np.asarray(freqs)[:, None] * (D / 2) / C_MS * szen
    xs = np.where(x < 1e-8, 1.0, x)
    b = np.where(x < 1e-8, 1.0, 2 * j1(xs) / xs) ** 2
    cols = np.flatnonzero(np.asarray(m) == 0)
    ls = np.asarray(l)[cols]
    Y = np.sqrt((2 * ls[None] + 1) / (4 * np.pi)) \
        * eval_legendre(ls[None], np.cos(rings)[:, None])
    w = np.sqrt(counts)[:, None]
    c = np.linalg.lstsq(Y * w, (b * w.T).T, rcond=None)[0]
    out = np.zeros((1, 1, 1, len(freqs), len(l), 2))
    out[0, 0, 0, :, cols, 0] = c
    return out


def ylm_beam(bt, freqs, lmax, nside, device, dtype, R=None, perturb=0.1,
             seed=0):
    """A PixelBeam of YlmResponse(gen_lm(lmax), 'interpolate' on an
    nside HEALPix grid, power beam, real beam, real-pair params) whose
    truth is the fitted Airy power beam (airy_beam_alm), started
    perturb N(0, 1) off it (numpy seed seed); R: a response to share
    (its grid Ylm is then not built again). Returns (beam, numpy truth,
    the seconds of the response's build)."""
    import torch
    t0 = time.time()
    if R is None:
        lb, mb = bt.gen_lm(lmax)
        R = bt.YlmResponse(lb, mb, freqs, mode="interpolate",
                           pixtype="healpix", nside=nside, powerbeam=True,
                           realbeam=True, comp_params=True,
                           Ylm_kwargs=dict(method="sphere", high_prec=False),
                           device=device, dtype=dtype)
        if device.type == "cuda":
            torch.cuda.synchronize()
    secs = time.time() - t0
    truth = airy_beam_alm(R.alm.l, R.alm.m, freqs, R.interp.nside)
    start = truth * (1 + perturb * np.random.default_rng(seed)
                     .standard_normal(truth.shape))
    beam = bt.PixelBeam(start, freqs, R=R, pol="e", powerbeam=True,
                        fov=180.0, device=device, dtype=dtype)
    return beam, truth, secs


def alm_sky_model(bt, lmax, nside, device, dtype, sky_ylm=None):
    """AlmModel(gen_lm(lmax)) of the nside HEALPix sky: its Ylm given as
    sky_ylm = (Ylm, alm_mult) through setup_Ylm, or generated. Returns
    (alm, theta, phi, angs [deg], the seconds of the Ylm)."""
    import torch
    from bayeslim_tpu_torch.utils import healpix as hp
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    angs = np.stack([phi * 180 / np.pi, 90 - theta * 180 / np.pi])
    l, m = bt.gen_lm(lmax)
    alm = bt.AlmModel(l, m, device=device, dtype=dtype)
    t0 = time.time()
    if sky_ylm is not None:
        alm.setup_Ylm(sky_ylm[0], alm_mult=sky_ylm[1])
    else:
        alm.generate_Ylm(theta, phi, method="sphere", high_prec=False)
        if device.type == "cuda":
            torch.cuda.synchronize()
    return alm, theta, phi, angs, time.time() - t0


def sfb_truth(alm, gln, freqs, nn, seed=0):
    """Truth t_lmn of the hera-sfb sky as real pairs (1, 1, nn, Ncoeff,
    2): alm_truth's a_lm at 150 MHz spread over n, t_lmn = a_lm z_n /
    rms_f |g_l(f, :)| for n < Nk(l) (z_n ~ N(0, 1), numpy seed seed + 3),
    0 past Nk(l); so that E|a_lm(f)|^2 ~ |a_lm(150 MHz)|^2."""
    l, m = alm.l, alm.m
    a = alm_truth(l, m, [150e6], seed)[0, 0, 0]
    z = np.random.default_rng(seed + 3).standard_normal((nn, len(l)))
    t = np.zeros((1, 1, nn, len(l), 2))
    for ll, g in gln.items():
        g = g.double().cpu().numpy()
        cols = np.flatnonzero(l == ll)
        nk = g.shape[1]
        scale = 1.0 / np.sqrt(np.mean(np.sum(g ** 2, axis=1)))
        t[0, 0, :nk][:, cols] = a[cols][None] * scale \
            * z[:nk, cols][..., None]
    return t


def build_sfb(bt, hexN, nside, lmax, nfreq, fmax, ntime, pix_chunk, device,
              dtype, beam_lmax, beam_nside, nn, perturb=0.1, seed=0,
              sky_ylm=None, beam_R=None):
    """The hera-sfb posterior through the port's public API: hera-alm's
    array, times and target form (redundant groups, icov = group counts,
    the RIME at the truth plus unit complex noise, numpy seed seed + 1);
    an nside sky of AlmModel(gen_lm(lmax)) modes (its Ylm sky_ylm = (Ylm,
    alm_mult) if given) through PixelSkyResponse(freq_mode='bessel',
    transform_order=1, spatial_mode='alm', comp_params=True,
    real_output=True), the radial matrices from gen_bessel2freq(unique l,
    freqs, cosmo=Cosmology(), method='ball', bc_type=2, renorm=True) at
    the kmax that gives at most nn k modes an l (sfb_kmax), the t_lmn
    real pairs (1, 1, nn, Ncoeff, 2) trainable (truth sfb_truth, start
    perturb N(0, 1) off it, numpy seed seed + 2); and a Ylm power beam
    (ylm_beam: gen_lm(beam_lmax) on an nside beam_nside grid, the fitted
    Airy beam, start perturb off it; beam_R a response to share),
    trainable. Returns (prob, truth {sky, beam: numpy}, info)."""
    import torch
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
    device = bt.resolve_device(device)
    t_all = time.time()
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, fmax, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=False, device=device, dtype=dtype)
    alm, theta, phi, angs, ylm_s = alm_sky_model(bt, lmax, nside, device,
                                                 dtype, sky_ylm)
    cosmo = bt.Cosmology()
    t0 = time.time()
    kmax = sfb_kmax(bt, cosmo.f2r(freqs), nn)
    gln, kbins = bt.gen_bessel2freq(np.unique(alm.l), freqs, cosmo=cosmo,
                                    kmax=kmax, method="ball", bc_type=2,
                                    renorm=True, device="cpu",
                                    dtype=torch.float64)
    bessel_s = time.time() - t0
    nk = {ll: g.shape[1] for ll, g in gln.items()}
    check(max(nk.values()) == nn, f"hera-sfb's largest Nk {max(nk.values())}"
          f" is not {nn}")
    R = bt.PixelSkyResponse(freqs, comp_params=True, spatial_mode="alm",
                            freq_mode="bessel", transform_order=1,
                            real_output=True, spat_LM=alm, gln=gln,
                            kbins=kbins, cosmo=cosmo, device=device,
                            dtype=dtype)
    truth = sfb_truth(alm, gln, freqs, nn, seed)
    start = truth * (1 + perturb * np.random.default_rng(seed + 2)
                     .standard_normal(truth.shape))
    sky = bt.PixelSky(start, angs, hp.nside2pixarea(nside), R=R,
                      device=device, dtype=dtype)
    beam, beam_truth, beam_s = ylm_beam(bt, freqs, beam_lmax, beam_nside,
                                        device, dtype, R=beam_R,
                                        perturb=perturb, seed=seed + 4)
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    bls = [r[0] for r in reds]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, bls, times, freqs,
                   pix_chunk=pix_chunk)
    with torch.no_grad():
        data = rime.updated(bt.ParamDict({
            "sky.params": torch.as_tensor(truth, dtype=dtype, device=device),
            "beam.params": torch.as_tensor(beam_truth, dtype=dtype,
                                           device=device)}))().data
    rng = np.random.default_rng(seed + 1)
    shp = tuple(data.shape)
    noise = np.sqrt(0.5) * (rng.standard_normal(shp)
                            + 1j * rng.standard_normal(shp))
    data = data + torch.as_tensor(noise, dtype=data.dtype, device=device)
    counts = np.asarray([len(r) for r in reds], dtype=np.float64)
    icov = torch.as_tensor(np.broadcast_to(
        counts[None, None, :, None, None], shp).copy(), dtype=dtype,
        device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=data, icov=icov)
    if device.type == "cuda":
        torch.cuda.synchronize()
    info = dict(alm=alm, theta=theta, phi=phi, kmax=kmax, nk=nk, gln=gln,
                kbins=kbins, ylm_s=ylm_s, bessel_s=bessel_s, beam_s=beam_s,
                total_s=time.time() - t_all, freqs=freqs)
    return bt.LogProb(rime, tgt), dict(sky=truth, beam=beam_truth), info


def build_hmc_alm(bt, hexN, nside, lmax, nfreq, fmax, ntime, pix_chunk,
                  device, dtype, beam_lmax, beam_nside, gain_sigma=0.05,
                  seed=0, sky_ylm=None, beam_R=None):
    """The hera-hmc-alm chain, BASELINE.json config #4 as written ("sky
    a_lm + beam + gains sampled end-to-end"), through the port's public
    API: hera-hmc's chain (build_hmc: Sequential(RIME -> JonesModel),
    the array fixed, the redundant groups simulated and expanded to every
    cross baseline, 1-pol gains per antenna and channel as real pairs,
    refant the first antenna, the target the chain at the truth plus unit
    complex noise from a seeded torch.Generator, icov ones) with
    hera-alm's a_lm sky (alm_truth through PixelSkyResponse(spatial_mode=
    'alm', comp_params=True, real_output=True); its Ylm sky_ylm if given)
    and hera-sfb's Ylm power beam (ylm_beam; beam_R a response to share),
    all three trainable and started at the truth. Returns (prob, numpy
    truth {sky, beam, gains})."""
    import torch
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
    device = bt.resolve_device(device)
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, fmax, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs, redtol=0.5,
                        parameter=False, device=device, dtype=dtype)
    alm, _, _, angs, _ = alm_sky_model(bt, lmax, nside, device, dtype,
                                       sky_ylm)
    R = bt.PixelSkyResponse(freqs, comp_params=True, spatial_mode="alm",
                            freq_mode="channel", real_output=True,
                            spat_LM=alm, device=device, dtype=dtype)
    truth = alm_truth(alm.l, alm.m, freqs, seed)
    sky = bt.PixelSky(truth, angs, hp.nside2pixarea(nside), R=R,
                      device=device, dtype=dtype)
    beam, beam_truth, _ = ylm_beam(bt, freqs, beam_lmax, beam_nside, device,
                                   dtype, R=beam_R, perturb=0.0)
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=arr.get_bls(keep_autos=False),
                   pix_chunk=pix_chunk)
    gains = cal_truth(arr.ants, arr.to_antpos().asnumpy(), nfreq, 0.0,
                      gain_sigma)[GAINS]
    cal = bt.JonesModel(gains, arr.ants, refant=arr.ants[0],
                        R=bt.JonesResponse(param_type="com"), device=device,
                        dtype=dtype)
    seq = bt.Sequential({"rime": rime, "cal": cal})
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        data = seq().data
        for part in (data.real, data.imag):
            part += np.sqrt(0.5) * torch.randn(
                data.shape, generator=gen, dtype=dtype, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=data,
                   icov=torch.ones(data.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt), dict(sky=truth, beam=beam_truth,
                                      gains=gains)


def filt_wedge(bt, freqs, bls, antpos, device, noise=1e-9):
    """config #5's baseline-dependent delay filter through the port's
    public API: the baselines bls (antenna pairs) in FILT_BINS equal bins
    of length up to the longest; for each bin that holds any, a
    GPFilter(residual=True) over frequency with Cs = sinc_cov(freqs, ls
    = 1 / (2 tau)) (a top-hat of half-width tau in delay), tau the bin's
    longest horizon delay b / c plus FILT_BUFFER, and Cn = noise x I (a
    suppression of 1 / noise, as DAYENU-style filters take), Cs and Cn
    made in float64 on the host, G (float64, the filters' default) on
    device. Returns (WedgeFilter, bin info, seconds of the host
    inversions)."""
    from bayeslim_tpu_torch.utils.dtypes import C_MS
    av = antpos.asnumpy() if hasattr(antpos, "asnumpy") else antpos
    ants = list(antpos.ants)
    L = np.asarray([np.linalg.norm(av[ants.index(b)] - av[ants.index(a)])
                    for a, b in bls])
    Lmax = float(L.max())
    nbins = FILT_BINS
    ib = np.clip(np.ceil(L / Lmax * nbins).astype(int) - 1, 0, nbins - 1)
    Cn = np.eye(len(freqs)) * noise
    filters, filt2bls, taus, counts = [], {}, [], []
    t0 = time.time()
    for b in range(nbins):
        rows = np.where(ib == b)[0]
        if not len(rows):
            continue
        tau = float(L[rows].max()) / C_MS + FILT_BUFFER
        Cs = bt.models.filt.sinc_cov(freqs, ls=1.0 / (2 * tau),
                                     device="cpu")
        filt2bls[len(filters)] = [bls[r] for r in rows]
        filters.append(bt.GPFilter(Cs, Cn, dim=-1, residual=True,
                                   device=device))
        taus.append(tau)
        counts.append(len(rows))
    secs = time.time() - t0
    info = dict(edges=np.linspace(0, Lmax, nbins + 1), tau=np.asarray(taus),
                counts=counts, bin_of=ib, lengths=L)
    return bt.WedgeFilter(filters, filt2bls), info, secs


def filt_truth(ants, antvecs, ndeg, seed=1):
    """Truth of the hera-filt chain (numpy): antenna positions moved by
    N(0, 1 cm) in E and N, and gains in the polynomial span: ndeg
    Legendre coefficients c_k = 0.05 z_k (z complex N(0, 1)) plus
    1 for c_0, real pairs, the first antenna's (the refant's) real. Every
    degree draws the same scale, so that the high ones put the gains'
    errors beyond the filter's band edge, where the filtered chain sees
    them."""
    rng = np.random.default_rng(seed)
    av = np.array(antvecs, dtype=np.float64)
    av[:, :2] += 0.01 * rng.standard_normal((len(ants), 2))
    shp = (1, 1, len(ants), 1, ndeg)
    z = (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)) \
        / np.sqrt(2)
    c = 0.05 * z
    c[..., 0] += 1.0
    c[:, :, 0] = c[:, :, 0].real
    return {ANTVECS: av, GAINS: np.stack([c.real, c.imag], axis=-1)}


def build_filt(bt, hexN, nside, nfreq, fmax, ntime, pix_chunk, device,
               dtype, noise=1e-9):
    """The hera-filt chain, config #5's delay filter inside hera-cal's
    calibration chain, through the port's public API:
    Sequential(RIME -> JonesModel -> WedgeFilter). hera-cal's array (its
    antenna positions trainable), sky (1e4 times hera-stat's) and Airy
    beam, the redundant groups simulated and expanded to every cross
    baseline; 1-pol gains smooth in frequency: JonesResponse(freq_mode=
    'linear') with a LinearModel('poly', dim=4, Ndeg=FILT_NDEG, basis=
    'legendre', whiten=True) over the channels, FILT_NDEG complex
    coefficients per antenna (one time bin) as real pairs, refant the
    first antenna, starting at unit gains; then filt_wedge's delay
    filter (Cn = noise x I; its products in float64, its output in
    dtype). The target: the unfiltered chain at filt_truth plus complex
    noise of unit variance (a seeded torch.Generator), filtered once by
    the same WedgeFilter; icov ones.
    Returns (prob, numpy truth, info: the WedgeFilter, its bins, the
    inversions' seconds, the unfiltered target as a VisData, the
    construction's antenna positions)."""
    import torch
    device = bt.resolve_device(device)
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, hexN, nside, nfreq, fmax, 0.5, True, device, dtype,
        np.random.default_rng(0), amp=1e4)
    sim_bls = [r[0] for r in arr.reds if r[0][0] != r[0][1]]
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   data_bls=arr.get_bls(keep_autos=False),
                   pix_chunk=pix_chunk)
    LM = bt.LinearModel("poly", dim=4, x=freqs, Ndeg=FILT_NDEG,
                        basis="legendre", whiten=True, device=device,
                        dtype=dtype)
    gains = np.zeros((1, 1, len(arr.ants), 1, FILT_NDEG, 2))
    gains[..., 0, 0] = 1.0
    cal = bt.JonesModel(gains, arr.ants, refant=arr.ants[0],
                        R=bt.JonesResponse(param_type="com",
                                           freq_mode="linear", freq_LM=LM,
                                           freqs=freqs),
                        device=device, dtype=dtype)
    antpos = arr.to_antpos()
    wedge, bins, inv_s = filt_wedge(bt, freqs, rime.data_bls, antpos, device,
                                    noise=noise)
    truth = filt_truth(arr.ants, antpos.asnumpy(), FILT_NDEG)
    gen = torch.Generator(device=device).manual_seed(2)
    unf = bt.Sequential({"rime": rime, "cal": cal})
    with torch.no_grad():
        vd = unf.updated(bt.ParamDict({
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in truth.items()}))()
        for part in (vd.data.real, vd.data.imag):
            part += np.sqrt(0.5) * torch.randn(
                vd.data.shape, generator=gen, dtype=dtype, device=device)
        data = wedge(vd).data
    seq = bt.Sequential({"rime": rime, "cal": cal, "filt": wedge})
    tgt = bt.VisData()
    tgt.setup_meta(T, antpos)
    tgt.setup_data(rime.data_bls, times, freqs, pol="ee", data=data,
                   icov=torch.ones(data.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt), truth, dict(wedge=wedge, bins=bins,
                                              inv_s=inv_s, unfiltered=vd,
                                              antpos=antpos)


def coupling_layout(arr):
    """The redundant groups' representatives (the RIME's simulated
    baselines, autos left out), each cross baseline's group row and
    every cross baseline."""
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    bl2red = {bl: i for i, red in enumerate(reds) for bl in red}
    return [r[0] for r in reds], bl2red, arr.get_bls(keep_autos=False)


def coupling_truth(ants, nterms, nfreq, seed=1):
    """Truth of the hera-coupling chain (numpy): each coupling term a
    complex amplitude 0.01 (N + iN) / sqrt(2), gains 1 + 0.05 (N + iN) /
    sqrt(2) as real pairs with the refant's imaginary part zero."""
    rng = np.random.default_rng(seed)
    shp = (1, 1, nterms, 1, 1)
    X = 0.01 * (rng.standard_normal(shp) + 1j * rng.standard_normal(shp)) \
        / np.sqrt(2)
    gshp = (1, 1, len(ants), 1, nfreq)
    g = 1 + 0.05 * (rng.standard_normal(gshp)
                    + 1j * rng.standard_normal(gshp)) / np.sqrt(2)
    g[:, :, 0] = g[:, :, 0].real
    return {COUPLING: X, GAINS: np.stack([g.real, g.imag], axis=-1)}


def build_coupling(bt, hexN, nside, nfreq, fmax, ntime, pix_chunk, device,
                   dtype, max_len=COUPLING_MAX_LEN, amp=1e4, seed=0):
    """The hera-coupling chain through the port's public API:
    Sequential(RIME -> RedVisCoupling -> JonesModel). hera-redcal's
    array, sky (amp times hera-stat's) and Airy beam, all fixed; the
    RIME simulates the redundant groups, RedVisCoupling inflates them
    onto every cross baseline and couples them (first and second order,
    Vc = V + X V + V X^H + X V X^H); then 1-pol gains (real pairs, refant
    the first antenna). The coupling terms are gen_coupling_terms(antpos,
    max_len=max_len, compress_to_red=True): one complex amplitude per
    redundant antenna separation within max_len, constant in time and
    channel (the frequency structure is the fixed inter-antenna delay
    phasor), spread onto the (Nant, Nant) matrix by CouplingInflate,
    starting at zero. The target: the chain at coupling_truth plus
    complex noise of unit variance (a seeded torch.Generator); icov
    ones. Returns (prob, numpy truth, coupling terms)."""
    import torch
    device = bt.resolve_device(device)
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, hexN, nside, nfreq, fmax, 0.5, False, device, dtype,
        np.random.default_rng(seed), amp=amp, sky_beam_param=False)
    sim_bls, bl2red, out_bls = coupling_layout(arr)
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, sim_bls, times, freqs,
                   pix_chunk=pix_chunk)
    antpos = arr.to_antpos()
    terms, cidx = bt.models.coupling.gen_coupling_terms(
        antpos, max_len=max_len, compress_to_red=True)
    R = bt.VisModelResponse(LM=bt.CouplingInflate(arr.ants, terms, cidx))
    coupling = bt.RedVisCoupling(np.zeros((1, 1, len(terms), 1, 1),
                                          dtype=np.complex128), freqs,
                                 antpos, sim_bls, bl2red, out_bls, R=R,
                                 device=device, dtype=dtype)
    gains = np.zeros((1, 1, len(arr.ants), 1, nfreq, 2))
    gains[..., 0] = 1.0
    cal = bt.JonesModel(gains, arr.ants, refant=arr.ants[0],
                        R=bt.JonesResponse(param_type="com"), device=device,
                        dtype=dtype)
    seq = bt.Sequential({"rime": rime, "coupling": coupling, "cal": cal})
    truth = coupling_truth(arr.ants, len(terms), nfreq)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        data = seq.updated(bt.ParamDict({
            k: torch.as_tensor(v, device=device).to(seq[k].dtype)
            for k, v in truth.items()}))().data
        for part in (data.real, data.imag):
            part += np.sqrt(0.5) * torch.randn(
                data.shape, generator=gen, dtype=dtype, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(T, antpos)
    tgt.setup_data(out_bls, times, freqs, pol="ee", data=data,
                   icov=torch.ones(data.shape, dtype=dtype, device=device))
    return bt.LogProb(seq, tgt), truth, terms


def build_avg(bt, hexN, nside, nfreq, fmax, ntime, pix_chunk, device,
              dtype, gain_sigma=0.05, amp=1e4, seed=0, avg=False):
    """hera-avg's chain through the port's public API: hera-cal's array
    (the antennas at their layout positions, so the baselines of a group
    see one sky), its sky (amp x hera-stat's) and Airy beam, both
    trainable, and its 1-pol gains (cal_truth; refant the first antenna)
    as Sequential(RIME over the redundant groups -> RedVisInflate onto
    every cross baseline -> JonesModel): hera-cal's chain with the
    groups' expansion as its own block, so that the group output is at
    hand; avg=True ends it with RedVisAvg back onto the groups. Returns
    (seq, info): info has the telescope, the array, the cross-baseline
    groups (reds), the data baselines, times, freqs and the host antpos."""
    from bayeslim_tpu_torch.data.containers import RedVisAvg, RedVisInflate
    from bayeslim_tpu_torch.utils import AntposDict
    device = bt.resolve_device(device)
    T, arr, sky, beam, freqs = build_sky_beam(
        bt, hexN, nside, nfreq, fmax, 0.5, False, device, dtype,
        np.random.default_rng(seed), amp=amp)
    reds = [r for r in arr.reds if r[0][0] != r[0][1]]
    data_bls = arr.get_bls(keep_autos=False)
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, [r[0] for r in reds], times, freqs,
                   pix_chunk=pix_chunk)
    truth = cal_truth(arr.ants, arr.to_antpos().asnumpy(), nfreq, 0.0,
                      gain_sigma)
    cal = bt.JonesModel(truth[GAINS], arr.ants, refant=arr.ants[0],
                        R=bt.JonesResponse(param_type="com"), device=device,
                        dtype=dtype)
    blocks = {"rime": rime, "inflate": RedVisInflate(
        data_bls, bl2red={b: i for i, r in enumerate(reds) for b in r}),
        "cal": cal}
    if avg:
        blocks["avg"] = RedVisAvg(reds=reds)
    info = dict(T=T, arr=arr, reds=reds, data_bls=data_bls, times=times,
                freqs=freqs, antpos=AntposDict(arr.ants, arr._antvecs_np))
    return bt.Sequential(blocks), info


def simulate_avg(bt, torch, seq, info, seed=0):
    """The per-baseline cube of build_avg's chain: the groups simulated
    (one rime_fwd a time and pixel chunk on the card), inflated, the
    gains applied, plus complex noise of unit variance (E|n|^2 = 1, a
    seeded torch.Generator) as a VisData with icov ones. Returns (the
    group VisData, the noise-free cube, the noisy VisData)."""
    dtype = seq.cal.params.dtype
    device = seq.cal.params.device
    with torch.no_grad():
        groups = seq.rime()
        clean = seq.cal(seq.inflate(groups)).data
        gen = torch.Generator(device=device).manual_seed(seed + 2)
        noise = torch.complex(*(np.sqrt(0.5) * torch.randn(
            clean.shape, generator=gen, dtype=dtype, device=device)
            for _ in range(2)))
    vd = bt.VisData()
    vd.setup_meta(info["T"], info["antpos"])
    vd.setup_data(info["data_bls"], info["times"], info["freqs"], pol="ee",
                  data=clean + noise,
                  icov=torch.ones(clean.shape, dtype=dtype, device=device))
    return groups, clean, vd


def build_avg_chain(bt, torch, device, dtype, hexN=2, nside=8, nfreq=8,
                    fmax=120e6, ntime=2, pix_chunk=512, seed=0):
    """build_avg's chain ended by RedVisAvg, against its simulated cube
    averaged over the groups (icov = the member counts), started from
    unit gains: Sequential(RIME -> RedVisInflate -> JonesModel ->
    RedVisAvg) with the sky, the beam and the gains trainable. Returns
    the LogProb."""
    seq, info = build_avg(bt, hexN, nside, nfreq, fmax, ntime, pix_chunk,
                          device, dtype, seed=seed, avg=True)
    _, _, vd = simulate_avg(bt, torch, seq, info, seed)
    tgt = vd.bl_average(reds=info["reds"])
    with torch.no_grad():
        seq.cal.params.zero_()
        seq.cal.params[..., 0] = 1.0
    return bt.LogProb(seq, tgt)


def hmc_trajectory(bt, torch, prob, start, momenta, eps, nstep):
    """One HMC step of the port's sampler from the numpy start with the
    given numpy momenta (no draw; the Metropolis uniform comes from the
    sampler's CPU generator, the same on every device). Returns the end
    position and momentum (numpy dicts), dU and dH."""
    dev = prob.target[0].data.device
    rdt = prob.target[0].data.real.dtype
    bt.load_numpy_pdict(prob.model, start)
    x0 = prob.collect_main_params().detach()
    hmc = bt.HMC(bt.Potential(prob), x0, eps=eps, Nstep=nstep, seed=0)
    hmc.p = bt.ParamDict({k: torch.as_tensor(v, dtype=rdt, device=dev)
                          for k, v in momenta.items()})
    hmc.step(sample_p=False)
    q1, p1, U0, U1 = hmc.last_proposal
    return ({k: v.double().cpu().numpy() for k, v in q1.items()},
            {k: v.double().cpu().numpy() for k, v in p1.items()},
            U1 - U0, hmc.dHs[-1])


def first_step_H0(bt, torch, grads, steps):
    """Diagonal starting inverse Hessian for LBFGS: each parameter block
    k gets steps[k] / max|g_k|, so the first trial step (lr = 1) moves
    that block by at most steps[k]."""
    return bt.DiagMat(bt.ParamDict({
        k: torch.full_like(g, steps[k] / float(g.abs().max()))
        for k, g in grads.items()}).ravel())


def rand_case(rng, R, K, N, ps_real, tau_max=1e-6):
    ps = rng.standard_normal((R, K))
    if not ps_real:
        ps = ps + 1j * rng.standard_normal((R, K))
    tauT = rng.uniform(-tau_max, tau_max, (K, N))
    return ps, tauT


def longest_delay():
    """hera-stat's longest delay [s]: its longest baseline over c."""
    from bayeslim_tpu_torch.utils import make_hex
    from bayeslim_tpu_torch.utils.dtypes import C_MS
    _, av = make_hex(HERA["hexN"], D=15.0)
    av = np.asarray(av)
    return float(np.linalg.norm(av[:, None] - av[None], axis=-1).max()
                 / C_MS)


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_bound_ms(rime_cuda, R, K, N, ps_real, out_imag):
    """Least time for one rime_fwd call: each input read once and each
    output written once at the memory rate, against the contraction's
    FP32 multiply-adds at the FP32 rate (the phasor evaluation is left
    out, so this is a lower bound)."""
    fma = (1 if ps_real else 2) * (2 if out_imag else 1)
    return rime_cuda.roofline_ms(2.0 * fma * R * K * N,
                                 4.0 * (R * K * (1 if ps_real else 2) + K * N
                                        + R * N * (2 if out_imag else 1)))


def dtau_bound_ms(rime_cuda, R, K, N, ps_real):
    """Least time for one rime_dtau call, by the same rule: per (r, c, n)
    triple the contraction p Im(u E) costs 3 FP32 multiply-adds for real
    ps and 6 for complex ps (u p is a complex product); bytes are ct
    (complex), ps, tauT and the real output once each."""
    fma = 3 if ps_real else 6
    return rime_cuda.roofline_ms(2.0 * fma * R * K * N,
                                 4.0 * (2 * R * N + R * K * (1 if ps_real
                                                             else 2)
                                        + 2 * K * N))


def profile(torch, fn, label, match=None):
    """Run fn once under torch.profiler: device time by kernel and the
    device's busy share of the wall time. Returns the device time in ms,
    or None when the profiler saw none; with match, (that, the device
    time of the kernels whose name holds match, case ignored).

    Past the first seconds of a process, the profiler often drops the
    first kernels of a session: up to 63 in
    bayeslim_tpu_torch/scripts/profiler_probe.py, where every trial's
    counts fit the loss of a prefix of the session; late in this run,
    the first GEMM of a hera-alm step. So PROFILE_MARKS spin kernels are
    launched first, and the line says how many the profiler kept: one or
    more means that the drop ended on them and no kernel of fn was lost.
    They are not counted in the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_MARKS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device-side events only (CPU ops also carry their kernels' time)
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    marks = sum(r[1] for r in rows if "spin_kernel" in r[2])
    rows = [r for r in rows if "spin_kernel" not in r[2]]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        print(f"{label}: the profiler saw no device time (not measured)",
              flush=True)
        return None if match is None else (None, None)
    print(f"{label}: wall {wall * 1e3:.1f} ms under the profiler, device "
          f"busy {busy:.2f} ms ({busy / (wall * 1e3):.1%} of wall), "
          f"{len(rows)} kernel names; spin markers kept {marks} of "
          f"{PROFILE_MARKS} launched before the function"
          + ("" if marks else ": the profile may lack the function's "
             "first kernels"), flush=True)
    for ms, n, key in rows[:10]:
        print(f"{label}:   {ms:9.3f} ms {n:5d}x {key[:90]}", flush=True)
    if match is None:
        return busy
    if isinstance(match, str):
        return busy, sum(r[0] for r in rows if match.lower() in r[2].lower())
    return busy, [sum(r[0] for r in rows if m.lower() in r[2].lower())
                  for m in match]


def ptxas_by_function(report):
    """{mangled kernel name: 'registers, barriers, static shared memory;
    spills'} from nvcc -Xptxas -v."""
    out, name = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = ""
        elif name and "spill stores" in ln:
            out[name] = ln.strip()
        elif name and "Used" in ln and "registers" in ln:
            out[name] = ln.split(":", 1)[1].strip() + "; " + out[name]
    return out


def fp64_by_function(lib):
    """{kernel: FP64 instructions (DADD/DMUL/DFMA/DSETP/..., any .F64
    conversion)} in the SASS of a built library, or None where the
    toolkit has no cuobjdump."""
    import re
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    pat = re.compile(r"\bD(ADD|MUL|FMA|SETP|MNMX)\b|\.F64\b")
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            out[name] = 0
        elif name and pat.search(ln):
            out[name] += 1
    return out


def phase_build(torch, rime_cuda, dev, built):
    """Phase 1, rime_fwd.cu and rime_dtau.cu: each kernel's registers and
    spills (ptxas), FP64 instructions in its SASS (none allowed), and
    for each variant its shared memory per block and resident blocks per
    SM."""
    for src in ("rime_fwd.cu", "rime_dtau.cu"):
        path, _, report = built[src]
        for name, line in ptxas_by_function(report).items():
            print(f"phase 1 {src} ptxas: {name}: {line}", flush=True)
        fp64 = fp64_by_function(path)
        if fp64 is None:
            print(f"phase 1 {src} SASS: no cuobjdump, FP64 not counted",
                  flush=True)
            continue
        print(f"phase 1 {src} SASS: FP64 instructions by kernel {fp64}",
              flush=True)
        check(fp64 and not any(fp64.values()),
              f"{src} runs FP64 instructions: {fp64}")
    variants = [("rime_fwd", dict(ps_real=r, out_imag=o),
                 rime_cuda.fwd_info(dev, r, o))
                for r in (True, False) for o in (True, False)]
    variants += [("rime_dtau", dict(ps_real=r), rime_cuda.dtau_info(dev, r))
                 for r in (True, False)]
    for kernel, flags, (regs, smem, per_sm, sms) in variants:
        print(f"phase 1 {kernel} kernel "
              + " ".join(f"{k}={v}" for k, v in flags.items())
              + f": {regs} registers, {smem} bytes of shared memory a "
              f"block, {per_sm} blocks per SM on {sms} SMs", flush=True)
        check(per_sm >= 1, f"{kernel} kernel cannot be resident")


def phase_fwd_vs_plain(torch, rime_cuda, dev, rng, f0, df):
    """Phase 2; returns the worst abs error by shape label."""
    tmax = longest_delay()
    every = [(r, c, o) for r in (True, False) for c in (False, True)
             for o in (True, False)]
    # (label, nf, R, K, N, delays drawn uniform in +-tau_max, the
    # (ps_real, conj, out_imag) cases)
    shapes = [("small", 5, 2 * 5, 300, 70, 1e-6, every),   # runs of 5 rows
              ("small", 24, 3 * 24, 100, 45, 1e-6, every),
              ("ragged runs", 5, 3 * 5, 300, 70, 1e-6, every),
              ("ragged runs", 1000, 3 * 1000, 100, 45, 1e-6, every),
              ("K=1", 24, 3 * 24, 1, 45, 1e-6, every),
              ("N=1", 24, 3 * 24, 100, 1, 1e-6, every),
              ("K below one slice", 1024, 1024, 100, 630, 1e-6, every),
              ("delays <= 1e-9 s", 24, 3 * 24, 300, 45, 1e-9, every),
              ("zero delays", 24, 3 * 24, 300, 45, 0.0, every),
              (f"hera-stat longest delays (+-{tmax:.4e} s)", 1024, 1024,
               256, 64, tmax, every),
              (f"delays past hex-11 (+-{FAR_DELAY:g} s)", 1024, 1024, 256,
               64, FAR_DELAY, every),
              ("hera-fwd", 1024, 1024, 6144, 630, 1e-6, every),
              ("hera-bwd", 1024, 1024, 630, 6144, 1e-6, every)]
    shapes += [(label, 1024, 4096, K, N, 1e-6, [(False, conj, True)])
               for label, K, N, conj in PROD_SHAPES]
    # hera-alm's: R = nf = 128 channels over 100-200 MHz, its own spacing
    nfa = ALM["nfreq"]
    dfa = (ALM["fmax"] - f0) / (nfa - 1)
    shapes += [(label, nfa, nfa, K, N, 1e-6, every, dfa)
               for label, K, N, *_ in ALM_SHAPES]
    worst, worst_rel = {}, {}
    for label, nf, R, K, N, tau_max, cases, *spacing in shapes:
        dfs = spacing[0] if spacing else df
        for ps_real in (True, False):
            if not any(c[0] == ps_real for c in cases):
                continue
            ps, tauT = rand_case(rng, R, K, N, ps_real, tau_max)
            if label.startswith(("hera-stat longest", "delays past")):
                # every delay within 1 % of the largest, either sign
                tauT = np.sign(tauT) * tau_max * rng.uniform(0.99, 1,
                                                             tauT.shape)
            ps32 = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                                   else torch.complex64, device=dev)
            tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
            for _, conj, out_imag in [c for c in cases if c[0] == ps_real]:
                _, _, per_sm, sms = rime_cuda.fwd_info(dev, ps_real,
                                                       out_imag)
                S = rime_cuda.fwd_plan(R, K, N, nf, sms, per_sm)[0]
                a = rime_cuda.rime_fwd(ps32, tau32, f0, dfs, nf, conj,
                                       out_imag)
                b = rime_cuda.rime_fwd_plain(
                    ps32.to(torch.complex128 if not ps_real
                            else torch.float64),
                    tau32.double(), f0, dfs, nf, conj, out_imag)
                if tau_max == 0.0:
                    # exp(0) = 1: the output is the sum over c
                    s = ps32.to(torch.complex128 if not ps_real
                                else torch.float64).sum(1, keepdim=True)
                    b = (s.real if s.is_complex() and not out_imag
                         else s).expand(R, N)
                again = rime_cuda.rime_fwd(ps32, tau32, f0, dfs, nf, conj,
                                           out_imag)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, again))
                a, b = a.cpu().numpy(), b.cpu().numpy()
                err = relerr(a, b)
                abs_err = float(np.abs(a - b).max())
                case = (f"{label} R={R} K={K} N={N} nf={nf} "
                        f"ps_real={ps_real} conj={conj} "
                        f"out_imag={out_imag}")
                print(f"phase 2 rime_fwd vs plain: {case}: rel "
                      f"{err:.2e} (tol {TOL:g}) abs {abs_err:.2e}; "
                      f"K slices {S}; a second launch "
                      f"{'bit-equal' if same else 'DIFFERS'}",
                      flush=True)
                check(a.shape == (R, N) and np.isfinite(err)
                      and err <= TOL,
                      f"rime_fwd vs plain {case}: {err:.2e}")
                check(same, f"rime_fwd {case}: two launches differ")
                worst[label] = max(worst.get(label, 0.0), abs_err)
                worst_rel[label] = max(worst_rel.get(label, 0.0), err)
    far = [k for k in worst_rel if k.startswith("delays past")][0]
    print(f"phase 2 rime_fwd worst error at {far}: rel "
          f"{worst_rel[far]:.2e}, abs {worst[far]:.2e}", flush=True)
    return worst


def phase_dtau_vs_plain(torch, rime_cuda, dev, rng, f0, df):
    """Phase 3; returns the worst abs error at the hera-cal shape."""
    tmax = longest_delay()
    # (label, nf, R, K, N, delays drawn uniform in +-tau_max)
    shapes = [("small", 5, 2 * 5, 300, 70, 1e-6),     # passes of 5 rows
              ("small", 24, 3 * 24, 100, 45, 1e-6),
              ("ragged passes", 5, 3 * 5, 300, 70, 1e-6),
              ("ragged passes", 1000, 3 * 1000, 100, 45, 1e-6),
              ("K=1", 24, 3 * 24, 1, 45, 1e-6),
              ("N=1", 24, 3 * 24, 100, 1, 1e-6),
              ("N below one block", 24, 2 * 24, 100, 30, 1e-6),
              ("delays <= 1e-9 s", 24, 3 * 24, 300, 45, 1e-9),
              ("zero delays", 24, 3 * 24, 300, 45, 0.0),
              (f"hera-cal longest delays (+-{tmax:.4e} s)", 1024, 1024,
               256, 64, tmax),
              (f"delays past hex-11 (+-{FAR_DELAY:g} s)", 1024, 1024, 256,
               64, FAR_DELAY),
              ("hera-cal", 1024, 1024, 6144, 630, 1e-6)]
    worst, far = 0.0, [0.0, 0.0]
    for label, nf, R, K, N, tau_max in shapes:
        for ps_real in (True, False):
            ps, tauT = rand_case(rng, R, K, N, ps_real, tau_max)
            if label.startswith(("hera-cal longest", "delays past")):
                # every delay within 1 % of the largest, either sign
                tauT = np.sign(tauT) * tau_max * rng.uniform(0.99, 1,
                                                             tauT.shape)
            ct = rng.standard_normal((R, N)) + 1j * rng.standard_normal((R, N))
            ps32 = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                                   else torch.complex64, device=dev)
            tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
            ct32 = torch.as_tensor(ct, dtype=torch.complex64, device=dev)
            for conj in (False, True):
                a = rime_cuda.rime_dtau(ct32, ps32, tau32, f0, df, nf, conj)
                again = rime_cuda.rime_dtau(ct32, ps32, tau32, f0, df, nf,
                                            conj)
                b = rime_cuda.rime_dtau_plain(
                    ct32.to(torch.complex128),
                    ps32.to(torch.complex128 if not ps_real
                            else torch.float64),
                    tau32.double(), f0, df, nf, conj)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, again))
                a, b = a.cpu().numpy(), b.cpu().numpy()
                err = relerr(a, b)
                abs_err = float(np.abs(a - b).max())
                case = (f"{label} R={R} K={K} N={N} nf={nf} "
                        f"ps_real={ps_real} conj={conj}")
                print(f"phase 3 rime_dtau vs plain: {case}: rel {err:.2e} "
                      f"(tol {TOL:g}) abs {abs_err:.2e}; a second launch "
                      f"{'bit-equal' if same else 'DIFFERS'}", flush=True)
                check(a.shape == (K, N) and np.isfinite(err) and err <= TOL,
                      f"rime_dtau vs plain {case}: {err:.2e}")
                check(same, f"rime_dtau {case}: two launches differ")
                if label == "hera-cal":
                    worst = max(worst, abs_err)
                if label.startswith("delays past"):
                    far = [max(far[0], err), max(far[1], abs_err)]
    print(f"phase 3 rime_dtau worst error at delays past hex-11 "
          f"(+-{FAR_DELAY:g} s): rel {far[0]:.2e}, abs {far[1]:.2e}",
          flush=True)
    return worst


def phase_function(torch, rime_cuda, dev, rng, f0, df):
    """Phase 4: RimeFusedBS on the card vs the CPU float64 plain path."""
    nf, npx, nb = 16, 700, 37
    for ps_real in (True, False):
        for conj in (False, True):
            ps, _ = rand_case(rng, 2 * nf, npx, 1, ps_real)
            blvecs = rng.uniform(-30, 30, (nb, 3))
            s = rng.standard_normal((3, npx))
            s_c = s / np.linalg.norm(s, axis=0) / 2.99792458e8
            d = rng.standard_normal((2 * nf, nb)) * 10
            res, counts = [], []
            for device, rdt in ((dev, torch.float32), ("cpu", torch.float64)):
                cdt = torch.complex64 if rdt == torch.float32 \
                    else torch.complex128
                args = [torch.as_tensor(x, dtype=dt, device=device)
                        .requires_grad_(True) for x, dt in (
                            (ps, rdt if ps_real else cdt), (blvecs, rdt),
                            (s_c, rdt))]
                out = rime_cuda.rime_fused_bs(*args, f0, df, nf, conj)
                loss = torch.sum(torch.abs(out - torch.as_tensor(
                    d, dtype=rdt, device=device)) ** 2)
                loss.backward()
                res.append([out.detach().cpu().numpy()]
                           + [a.grad.cpu().numpy() for a in args])
            errs = [relerr(a, b) for a, b in zip(*res)]
            print(f"phase 4 autograd Function: ps_real={ps_real} "
                  f"conj={conj}: value rel {errs[0]:.2e}, psky grad rel "
                  f"{errs[1]:.2e}, blvecs grad rel {errs[2]:.2e}, s_c grad "
                  f"rel {errs[3]:.2e} (tol {TOL:g})", flush=True)
            check(all(e <= TOL for e in errs), "autograd Function vs plain")


def phase_hera_stat(bt, torch, rime_cuda, pix_chunks):
    """Phase 5: main path 1 at full width. Returns (rime, sim_bls,
    launches)."""
    t0 = time.time()
    prob, sim_bls = build_posterior(bt, stat=True, device=None,
                                    dtype=torch.float32, **HERA)
    rime = prob.model
    torch.cuda.synchronize()
    print(f"phase 5 hera-stat build: {len(rime.array.ants)} antennas, "
          f"{len(sim_bls)} redundant groups, {rime.Nfreqs} freqs, "
          f"{len(rime.sim_times)} times, {rime.Npix_cut} FOV pixels; "
          f"{time.time() - t0:.1f} s", flush=True)
    trainer = bt.Trainer(prob, lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    nchunks = len(pix_chunks(len(sim_bls), rime.Npix_cut))
    expect = 3 * 2 * len(rime.sim_times) * nchunks
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses, step_s = [], []
    for _ in range(3):
        t1 = time.time()
        loss = trainer.step()
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
        losses.append(float(loss))
    launches = rime_cuda.launches
    dtau = rime_cuda.dtau_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 5 hera-stat main path: losses {losses}; step wall first "
          f"{step_s[0] * 1e3:.1f} ms, median of 3 "
          f"{np.median(step_s) * 1e3:.1f} ms (steps {step_s}); rime_fwd "
          f"launches {launches} (expected {expect}), rime_dtau launches "
          f"{dtau} (expected 0: antenna positions are fixed); peak device "
          f"memory {peak:.2f} GiB", flush=True)
    print(f"phase 5 hera-stat with psky checkpointed per time: steps 2 and "
          f"3 {step_s[1] * 1e3:.1f} / {step_s[2] * 1e3:.1f} ms (before: "
          f"{STAT_STEPS_BEFORE_MS[0]} / {STAT_STEPS_BEFORE_MS[1]} ms), peak "
          f"device memory {peak:.2f} GiB (before: {STAT_PEAK_BEFORE_GIB} "
          f"GiB), both before-values on an NVIDIA H100 80GB HBM3 at 700 W; "
          f"PR 9's steps 2 and 3 there: {PR9_STAT_STEPS_MS[0]} / "
          f"{PR9_STAT_STEPS_MS[1]} ms", flush=True)
    check(all(np.isfinite(losses)), "non-finite hera-stat loss")
    check(launches == expect, f"launch count {launches} != {expect}")
    check(dtau == 0, f"hera-stat launched rime_dtau {dtau} times")
    profile(torch, trainer.step, "phase 5 profile of one step")
    return rime, sim_bls, launches


def phase_hera_cal(bt, torch, rime_cuda, pix_chunks, size=HERA):
    """Phase 6: main path 2, at full width unless given another size.
    Returns (launches of rime_fwd, launches of rime_dtau)."""
    t0 = time.time()
    prob, truth = build_cal(bt, device=None, dtype=torch.float32, **size)
    seq = prob.model
    rime = seq.rime
    nsim, ndata = len(rime.sim_bls), len(rime.data_bls)
    nparams = sum(p.numel() for p in seq.parameters())
    torch.cuda.synchronize()
    print(f"phase 6 hera-cal build: {len(rime.array.ants)} antennas, "
          f"{nsim} redundant groups simulated, expanded to {ndata} data "
          f"baselines, {rime.Nfreqs} freqs, {len(rime.sim_times)} times, "
          f"{rime.Npix_cut} FOV pixels, {nparams} trainable parameters "
          f"(antenna positions and gains); target "
          f"{tuple(prob.target[0].data.shape)} {prob.target[0].data.dtype}; "
          f"{time.time() - t0:.1f} s", flush=True)
    start = {k: v.detach().clone() for k, v in seq.named_parameters()}

    def ant_rms(av):
        d = av.detach().cpu().double().numpy() - truth[ANTVECS]
        return float(np.sqrt(np.mean(d[:, :2] ** 2)))
    # starting inverse Hessian from the gradient at the start: the first
    # trial step moves antennas by at most 1 mm and gains by at most 1e-3
    loss0, g0 = prob.value_and_grad()
    steps = {ANTVECS: 1e-3, GAINS: 1e-3}
    opt = bt.LBFGS(prob, H0=first_step_H0(bt, torch, g0, steps))
    nchunks = len(pix_chunks(nsim, rime.Npix_cut))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses, step_s, evals = [], [], []
    for _ in range(3):
        t1 = time.time()
        losses.append(float(opt.step()))
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
        evals.append(opt.func_evals)
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    expect = len(rime.sim_times) * nchunks * opt.func_evals
    av = seq.rime.array.antvecs.detach()
    moved = float((av - start[ANTVECS]).abs().max())
    print(f"phase 6 hera-cal main path: L-BFGS (strong Wolfe, lr 1, H0 a "
          f"DiagMat giving a first trial step of at most {steps[ANTVECS] * 1e3:g} "
          f"mm for antennas and {steps[GAINS]:g} for gains): start loss "
          f"{float(loss0)}, losses {losses}; step walls {step_s} s; "
          f"function evaluations after each step {evals}; rime_fwd launches "
          f"{fwd}, rime_dtau launches {dtau} (each expected "
          f"{len(rime.sim_times)} times x {nchunks} chunks x {opt.func_evals} evaluations = "
          f"{expect}); antennas moved at most {moved * 1e3:.3f} mm, E/N rms "
          f"error vs truth {ant_rms(start[ANTVECS]) * 1e3:.3f} -> "
          f"{ant_rms(av) * 1e3:.3f} mm; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(np.isfinite(float(loss0)) and all(np.isfinite(losses)),
          "non-finite hera-cal loss")
    check(losses[-1] < float(loss0), "hera-cal loss did not decrease")
    check(torch.cuda.max_memory_allocated() < 10 * 2**30,
          "hera-cal step took 10 GiB or more of device memory")
    check(fwd == expect and dtau == expect,
          f"hera-cal launches rime_fwd {fwd}, rime_dtau {dtau} != {expect}")
    busy = profile(torch, prob.value_and_grad,
                   "phase 6 profile of one function evaluation")
    if busy is not None:
        print(f"phase 6 device time of one function evaluation {busy:.2f} ms "
              f"(with rime_dtau's previous design: {CAL_EVAL_BEFORE_MS} ms; "
              f"PR 9: {PR9_CAL_EVAL_MS} ms, both on an NVIDIA H100 80GB "
              f"HBM3 at 700 W)", flush=True)
    return fwd, dtau


def phase_small(bt, torch, rime_cuda, dev, hera_prod):
    """Phase 7: small posteriors, card (float32) vs CPU (float64)."""
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, stat=False,
              pix_chunk=512)
    cpu_prob, _ = build_posterior(bt, device="cpu", dtype=torch.float64, **kw)
    gpu_prob, _ = build_posterior(bt, device=dev, dtype=torch.float32, **kw)
    gpu_prob.target[0].data = cpu_prob.target[0].data.to(torch.complex64).to(
        dev)
    prng = np.random.default_rng(1)
    pert = {k: v.detach().numpy() * (1 + 0.2 * prng.standard_normal(v.shape))
            for k, v in cpu_prob.collect_main_params().items()}
    # (label, CPU prob, card prob, parameters, antenna positions train)
    pairs = [("sky/beam posterior", cpu_prob, gpu_prob, pert, False)]

    # the hera-cal chain at hex-2: truth 5 cm / 10 % away from the start
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512,
              ant_sigma=0.05, gain_sigma=0.1)
    cpu_cal, _ = build_cal(bt, device="cpu", dtype=torch.float64, **kw)
    gpu_cal, _ = build_cal(bt, device=dev, dtype=torch.float32, **kw)
    gpu_cal.target[0].data = cpu_cal.target[0].data.to(torch.complex64).to(
        dev)
    start = {k: v.detach().numpy() for k, v in
             cpu_cal.collect_main_params().items()}
    pairs.append(("hera-cal chain", cpu_cal, gpu_cal, start, True))

    # the hera-prod chain at hex-2: 2 batches of 2 times, accumulated
    kw = dict(hexN=2, nside=8, nfreq=16, fmax=120e6, ntime=2, nbatch=2,
              pix_chunk=512)
    cpu_prod, _ = hera_prod.build(bt, device="cpu", dtype=torch.float64, **kw)
    gpu_prod, _ = hera_prod.build(bt, device=dev, dtype=torch.float32, **kw)
    for g, c in zip(gpu_prod.target, cpu_prod.target):
        g.data = c.data.to(torch.complex64).to(dev)
    start = {k: v.detach().numpy() for k, v in
             cpu_prod.collect_main_params().items()}
    pairs.append(("hera-prod chain", cpu_prod, gpu_prod, start, False))

    # the hera-redcal chain at hex-2, priors included, at its start (the
    # residual is then the sky model's error and the gains', well above
    # float32's rounding of the visibilities)
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512)
    cpu_red, _, _ = build_redcal(bt, device="cpu", dtype=torch.float64, **kw)
    gpu_red, _, _ = build_redcal(bt, device=dev, dtype=torch.float32, **kw)
    gpu_red.target[0].data = cpu_red.target[0].data.to(torch.complex64).to(
        dev)
    start = {k: v.detach().numpy() for k, v in
             cpu_red.collect_main_params().items()}
    pairs.append(("hera-redcal chain", cpu_red, gpu_red, start, False))

    # config #2's a_lm chain at hex-2 (nside 8, lmax 23) at its start
    kw = dict(hexN=2, nside=8, lmax=23, nfreq=8, fmax=120e6, ntime=2,
              pix_chunk=512)
    cpu_alm, _, _ = build_alm(bt, device="cpu", dtype=torch.float64, **kw)
    gpu_alm, _, _ = build_alm(bt, device=dev, dtype=torch.float32, **kw)
    gpu_alm.target[0].data = cpu_alm.target[0].data.to(torch.complex64).to(
        dev)
    start = {k: v.detach().numpy() for k, v in
             cpu_alm.collect_main_params().items()}
    pairs.append(("hera-alm chain", cpu_alm, gpu_alm, start, False))

    # the hera-sfb chain at hex-2 (nside 8, lmax 23, 8 k modes, a Ylm beam
    # of lmax 8 on an nside-8 grid) at its start
    kw = dict(hexN=2, nside=8, lmax=23, nfreq=8, fmax=120e6, ntime=2,
              pix_chunk=512, beam_lmax=8, beam_nside=8, nn=8)
    cpu_sfb, _, _ = build_sfb(bt, device="cpu", dtype=torch.float64, **kw)
    gpu_sfb, _, _ = build_sfb(bt, device=dev, dtype=torch.float32, **kw)
    gpu_sfb.target[0].data = cpu_sfb.target[0].data.to(torch.complex64).to(
        dev)
    start = {k: v.detach().numpy() for k, v in
             cpu_sfb.collect_main_params().items()}
    pairs.append(("hera-sfb chain", cpu_sfb, gpu_sfb, start, False))

    # the hera-filt chain at hex-2 (64 channels over 100-200 MHz, 16
    # Legendre coefficients a gain) at its start, with a suppression of
    # 100 (Cn = 1e-2 I): at hera-filt's 1e9 the filtered gradient is the
    # out-of-band remnant of in-band-dominated visibilities, and the
    # kernels' float32 error moves it by 1e-3 (gains) to 3e-2 (antenna
    # positions) (card vs CPU at hex-2)
    kw = dict(hexN=2, nside=8, nfreq=64, fmax=200e6, ntime=2, pix_chunk=512,
              noise=1e-2)
    cpu_filt, _, _ = build_filt(bt, device="cpu", dtype=torch.float64, **kw)
    gpu_filt, _, _ = build_filt(bt, device=dev, dtype=torch.float32, **kw)
    gpu_filt.target[0].data = cpu_filt.target[0].data.to(
        torch.complex64).to(dev)
    start = {k: v.detach().numpy() for k, v in
             cpu_filt.collect_main_params().items()}
    pairs.append(("hera-filt chain (suppression 100)", cpu_filt, gpu_filt,
                  start, True))
    for label, cpu, gpu, params, antpos in pairs:
        bt.load_numpy_pdict(cpu.model, params)
        bt.load_numpy_pdict(gpu.model, params)
        rime_cuda.launches = rime_cuda.dtau_launches = 0
        vg, gg = gpu.value_and_grad()
        n = (rime_cuda.launches, rime_cuda.dtau_launches)
        check(n[0] > 0 and (n[1] > 0) == antpos,
              f"small {label}: launches rime_fwd {n[0]}, rime_dtau {n[1]}")
        vc, gc = cpu.value_and_grad()
        errs = {"loss": abs(float(vg) - float(vc)) / abs(float(vc))}
        errs.update({k: relerr(gg[k].cpu().numpy(), gc[k].numpy())
                     for k in gc})
        print(f"phase 7 card vs CPU, {label} (launches rime_fwd {n[0]}, "
              f"rime_dtau {n[1]}): " + ", ".join(
                  f"{k} rel {v:.2e}" for k, v in errs.items())
              + f" (tol {TOL:g})", flush=True)
        check(all(v <= TOL for v in errs.values()), f"card vs CPU {label}")
    phase_small_hmc(bt, torch, rime_cuda, dev)
    phase_small_hmc(bt, torch, rime_cuda, dev, alm=True)
    phase_small_img_coupling_hess(bt, torch, rime_cuda, dev)
    phase_small_avg(bt, torch, rime_cuda, dev)


def phase_small_img_coupling_hess(bt, torch, rime_cuda, dev):
    """Phase 7, end: the hex-2 imaging case (a VisMapper over the hex-2
    hera-filt cube: maps, the diagonal and row-sum P, compute_Am and
    compute_Pm), the hex-2 hera-coupling chain at its truth (loss and
    gradients) and the whole hex-2 hera-cal Hessian (133 x 133), each on
    the card in float64 against the port on the CPU in float64 (1e-9),
    and the imaging and coupling in float32 through the kernels against
    the same (TOL)."""
    from bayeslim_tpu_torch.inference import hessian
    from bayeslim_tpu_torch.utils import healpix as hp
    theta, phi = hp.pix2ang(8, np.arange(hp.nside2npix(8)))
    ra, dec = np.rad2deg(phi), 90 - np.rad2deg(theta)
    kw = dict(hexN=2, nside=8, nfreq=16, fmax=200e6, ntime=2, pix_chunk=512)
    _, _, info = build_filt(bt, device="cpu", dtype=torch.float64, **kw)
    vd = info["unfiltered"]

    def run(device, dtype, use_kernel):
        v = vd.copy()
        v.data = vd.data.to(device=device,
                            dtype=torch.complex64 if dtype == torch.float32
                            else torch.complex128)
        b = bt.PixelBeam(np.ones((1, 1, 1, 1, 2)) * 14.0, vd.freqs,
                         R=bt.AiryResponse(), pol="e", powerbeam=True,
                         fov=180.0, parameter=False, device=device,
                         dtype=dtype)
        m = bt.VisMapper(v, ra, dec, beam=b, use_kernel=use_kernel,
                         pix_chunk=64, dtype=dtype)
        m.set_normalization("A2w")
        with torch.no_grad():
            maps, P = m.make_map(contract="diag")
            _, Pr = m.make_map(contract="rowsum")
            Am = m.compute_Am(maps)
            Pm = m.compute_Pm(maps)
        return m._kernel_route(), [x.cpu().numpy() for x in
                                   (maps, P, Pr, Am, Pm)]
    # both cases against the plain version in float64 on the CPU ('A2w';
    # the mapper evaluates its beam in float64 whatever its type)
    ref = run("cpu", torch.float64, False)[1]
    names = ("maps", "P diag", "P rowsum", "compute_Am", "compute_Pm")
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, TOL)):
        rime_cuda.launches = rime_cuda.dtau_launches = 0
        kern, got = run(dev, dtype, "auto")
        errs = {n: relerr(g, r) for n, g, r in zip(names, got, ref)}
        print(f"phase 7 card vs CPU, hex-2 imaging ({dtype}, 'A2w', "
              f"kernel route {kern}, rime_fwd launches "
              f"{rime_cuda.launches}): "
              + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
              + f" (tol {tol:g})", flush=True)
        check(kern == (dtype == torch.float32)
              and (rime_cuda.launches > 0) == kern, "hex-2 imaging route")
        check(all(v <= tol for v in errs.values()), f"hex-2 imaging {dtype}")

    # the coupling chain in float64 at its truth (nonzero coupling terms)
    # and at its start; in float32 at its start (at the truth the residual
    # is the unit noise under visibilities of ~1e2, and float32 rounding
    # of the model moves the gradient by ~5e-4 at hex-2)
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512)
    cpu, truth, _ = build_coupling(bt, device="cpu", dtype=torch.float64,
                                   **kw)
    start = {k: v.detach().numpy().copy()
             for k, v in cpu.collect_main_params().items()}
    for dtype, where, tol in ((torch.float64, "truth", 1e-9),
                              (torch.float64, "start", 1e-9),
                              (torch.float32, "start", TOL)):
        params = truth if where == "truth" else start
        bt.load_numpy_pdict(cpu.model, params)
        vc, gc = cpu.value_and_grad()
        gpu, _, _ = build_coupling(bt, device=dev, dtype=dtype, **kw)
        gpu.target[0].data = cpu.target[0].data.to(gpu.target[0].data.dtype
                                                   ).to(dev)
        bt.load_numpy_pdict(gpu.model, params)
        rime_cuda.launches = 0
        vg, gg = gpu.value_and_grad()
        errs = {"loss": abs(float(vg) - float(vc)) / abs(float(vc))}
        errs.update({k: relerr(gg[k].cpu().numpy(), gc[k].numpy())
                     for k in gc})
        print(f"phase 7 card vs CPU, hex-2 hera-coupling chain at its "
              f"{where} ({dtype}, rime_fwd launches {rime_cuda.launches}): "
              + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
              + f" (tol {tol:g})", flush=True)
        check(all(v <= tol for v in errs.values()),
              f"hex-2 hera-coupling {dtype} at its {where}")

    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512,
              ant_sigma=0.05, gain_sigma=0.1)
    cpu, _ = build_cal(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _ = build_cal(bt, device=dev, dtype=torch.float64, **kw)
    gpu.target[0].data = cpu.target[0].data.to(dev)
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    t0 = time.time()
    Hg, _ = hessian.compute_hessian(gpu)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = (rime_cuda.launches, rime_cuda.dtau_launches)
    Hc, _ = hessian.compute_hessian(cpu)
    err = relerr(Hg.cpu().numpy(), Hc.numpy())
    print(f"phase 7 card vs CPU, the whole hex-2 hera-cal Hessian "
          f"{tuple(Hg.shape)} in float64 ({wall:.1f} s on the card, kernel "
          f"launches {n}): rel {err:.2e} (tol 1e-9)", flush=True)
    check(n == (0, 0) and err <= 1e-9, "hex-2 Hessian card vs CPU")

    # FactoredInvHessian.from_lbfgs after 3 L-BFGS steps of the same
    # chains, each built where it ran: to_dense() and chol() (as
    # tests/test_hessian.py's test_factored_inv_hessian holds them)
    fg, tg = small_fih(bt, torch, gpu)
    fc, tc = small_fih(bt, torch, cpu)
    errs = {"t_hist": relerr(np.asarray(tg), np.asarray(tc)),
            "to_dense": relerr(fg.to_dense().cpu().numpy(),
                               fc.to_dense().numpy()),
            "chol": relerr(fg.chol().cpu().numpy(), fc.chol().numpy())}
    L = fg.chol()
    errs["L L^T - H"] = relerr((L @ L.T).cpu().numpy(),
                               fg.to_dense().cpu().numpy())
    print(f"phase 7 card vs CPU, hex-2 hera-cal FactoredInvHessian."
          f"from_lbfgs in float64 ({len(fg.u)} / {len(fc.u)} factored "
          f"pairs over {fg.N} parameters, t_hist {tg}): "
          + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
          + " (tol 1e-9)", flush=True)
    check(len(fg.u) == len(fc.u) > 0
          and all(v <= 1e-9 for v in errs.values()),
          "hex-2 FactoredInvHessian card vs CPU")


def small_fih(bt, torch, prob, steps=3):
    """FactoredInvHessian.from_lbfgs of prob after `steps` L-BFGS steps
    from its current parameters (phase 20's first-step H0), and the
    steps' t_hist."""
    _, g0 = prob.value_and_grad()
    opt = bt.LBFGS(prob, H0=first_step_H0(bt, torch, g0,
                                          {ANTVECS: 1e-3, GAINS: 1e-3}))
    for _ in range(steps):
        opt.step()
    return bt.FactoredInvHessian.from_lbfgs(opt), list(opt.t_hist)


def phase_small_hmc(bt, torch, rime_cuda, dev, alm=False):
    """Phase 7, end: one HMC trajectory (HMC_STEPS leapfrog steps of
    HMC_EPS, identity mass) of the hera-hmc chain (build_hmc) or, with
    alm, of the hera-hmc-alm chain (build_hmc_alm: the a_lm sky, the Ylm
    beam; nside 8, lmax 23, beam lmax 8) at hex-2, from the same start
    and momenta, card (float32) against CPU (float64): the end position
    and momentum of every leaf and dU. The start is 5 % off the truth in
    the sky (the pixel sky's amplitudes, or every a_lm) and at unit
    gains, so the residual stands well above float32's rounding of the
    visibilities."""
    kw = dict(hexN=2, nside=8, nfreq=8, fmax=120e6, ntime=2, pix_chunk=512)
    if alm:
        kw.update(lmax=23, beam_lmax=8, beam_nside=8)
    build, label = (build_hmc_alm, "hera-hmc-alm chain") if alm \
        else (build_hmc, "hera-hmc chain")
    cpu, _ = build(bt, device="cpu", dtype=torch.float64, **kw)
    gpu, _ = build(bt, device=dev, dtype=torch.float32, **kw)
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(dev)
    start = {k: v.detach().numpy().copy() for k, v in
             cpu.collect_main_params().items()}
    if alm:
        start[SKY] *= 1.05
    else:
        start[SKY][..., 0, :] *= 1.05
    start[GAINS][..., 0], start[GAINS][..., 1] = 1.0, 0.0
    rng = np.random.default_rng(4)
    momenta = {k: rng.standard_normal(v.shape) for k, v in start.items()}
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    card = hmc_trajectory(bt, torch, gpu, start, momenta, HMC_EPS, HMC_STEPS)
    n = (rime_cuda.launches, rime_cuda.dtau_launches)
    ref = hmc_trajectory(bt, torch, cpu, start, momenta, HMC_EPS, HMC_STEPS)
    errs = {f"q {k}": relerr(card[0][k], ref[0][k]) for k in ref[0]}
    errs.update({f"p {k}": relerr(card[1][k], ref[1][k]) for k in ref[1]})
    errs["dU"] = abs(card[2] - ref[2]) / abs(ref[2])
    evals = HMC_STEPS + 2
    print(f"phase 7 card vs CPU, {label}: one HMC trajectory of "
          f"{HMC_STEPS} leapfrog steps of {HMC_EPS:g} (launches rime_fwd "
          f"{n[0]}, expected {evals} evaluations x 2 times x 2 passes = "
          f"{4 * evals}; rime_dtau {n[1]}): dU card {card[2]:.6e}, CPU "
          f"{ref[2]:.6e}; dH card {card[3]:.6e}, CPU {ref[3]:.6e}; "
          + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
          + f" (tol {TOL:g})", flush=True)
    check(n == (4 * evals, 0), f"small {label} launches {n}")
    check(all(v <= TOL for v in errs.values()), f"card vs CPU {label}")


def build_nmp(bt, device, dtype, hexN=3, nside=16, nfreq=64, ntime=2):
    """A small per-antenna-beam posterior through the port's public API:
    a hex array whose first half of antennas carries Gaussian beam model
    0 and the rest model 1 (up to 4 model pairs on its baselines), the
    power-law pixel sky of build_sky_beam, trainable sky, beams and
    antenna positions; target the forward at a truth away from the
    start in every parameter. Returns (prob, number of model pairs)."""
    import torch
    from bayeslim_tpu_torch.utils import AntposDict, healpix as hp, make_hex
    device = bt.resolve_device(device)
    kw = dict(device=device, dtype=dtype)
    rng = np.random.default_rng(3)
    T = bt.TelescopeModel(LOC)
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, 120e6, nfreq)
    arr = bt.ArrayModel(AntposDict(ants, antvecs), freqs=freqs,
                        parameter=True, **kw)
    npix = hp.nside2npix(nside)
    theta, phi = hp.pix2ang(nside, np.arange(npix))
    params = np.zeros((1, 1, 2, npix))
    params[0, 0, 0] = rng.uniform(1, 10, npix)
    params[0, 0, 1] = -2.5
    sky = bt.PixelSky(params, np.stack([phi * 180 / np.pi,
                                        90 - theta * 180 / np.pi]),
                      hp.nside2pixarea(nside), R=bt.PixelSkyResponse(
                          freqs, freq_mode="powerlaw", f0=float(freqs[0]),
                          **kw), **kw)
    bp = np.ones((1, 1, 2, nfreq, 2)) * np.array([0.5, 0.8])[:, None, None]
    ant2beam = {a: int(i >= len(ants) // 2) for i, a in enumerate(ants)}
    beam = bt.PixelBeam(bp, freqs, R=bt.GaussResponse(), pol="e",
                        ant2beam=ant2beam, fov=180.0, **kw)
    bls = arr.get_bls(keep_autos=False)
    times = 2458168.3 + np.arange(ntime) * 5e-4
    rime = bt.RIME(sky, T, beam, arr, bls, times, freqs, pix_chunk=512)
    # the truth: antennas moved by N(0, 5 cm), beams 10 % wider, the sky
    # 5 % brighter
    moved = arr.antvecs.detach().clone()
    moved[:, :2] += torch.as_tensor(0.05 * rng.standard_normal(
        (len(ants), 2)), dtype=dtype, device=device)
    truth = bt.ParamDict({"array.antvecs": moved,
                          "beam.params": beam.params.detach() * 1.1,
                          "sky.params": sky.params.detach() * 1.05})
    with torch.no_grad():
        data = rime.updated(truth)().data
    tgt = bt.VisData()
    tgt.setup_meta(T, arr.to_antpos())
    tgt.setup_data(bls, times, freqs, pol="ee", data=data)
    nmp = len(np.unique(beam.modelpairs(bls)[2]))
    return bt.LogProb(rime, tgt), nmp


def phase_entry_points(bt, torch, rime_cuda, dev, rng, f0, df):
    """Phase 10: the Nmp > 1 grouped dispatch, RimeFused and
    rime_pallas_reduce on the card against the CPU float64 plain path,
    with their launch counts."""
    cpu, nmp = build_nmp(bt, "cpu", torch.float64)
    gpu, _ = build_nmp(bt, dev, torch.float32)
    gpu.target[0].data = cpu.target[0].data.to(torch.complex64).to(dev)
    rime = gpu.model
    nt = len(rime.sim_times)
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    vg, gg = gpu.value_and_grad()
    torch.cuda.synchronize()
    n = (rime_cuda.launches, rime_cuda.dtau_launches)
    vc, gc = cpu.value_and_grad()
    errs = {"loss": abs(float(vg) - float(vc)) / abs(float(vc))}
    errs.update({k: relerr(gg[k].cpu().numpy(), gc[k].numpy()) for k in gc})
    print(f"phase 10 Nmp > 1 grouped dispatch: {len(rime.array.ants)} "
          f"antennas, 2 beam models, {nmp} model pairs over "
          f"{len(rime.sim_bls)} baselines, {nt} times, {rime.Npix_cut} FOV "
          f"pixels; launches rime_fwd {n[0]} (expected {nmp} pairs x {nt} "
          f"times x 2 passes = {2 * nmp * nt}), rime_dtau {n[1]} (expected "
          f"{nmp * nt}); card vs CPU float64: " + ", ".join(
              f"{k} rel {v:.2e}" for k, v in errs.items())
          + f" (tol {TOL:g})", flush=True)
    check(nmp > 1, f"the Nmp > 1 case has {nmp} model pair")
    check(n == (2 * nmp * nt, nmp * nt),
          f"Nmp > 1 launches rime_fwd {n[0]}, rime_dtau {n[1]}")
    check(all(np.isfinite(v) and v <= TOL for v in errs.values()),
          "Nmp > 1 grouped dispatch vs plain")

    nf, npx, nb = 16, 700, 37
    for ps_real in (True, False):
        for conj in (False, True):
            ps, tauT = rand_case(rng, 2 * nf, npx, nb, ps_real)
            d = rng.standard_normal((2 * nf, nb)) * 10
            res, counts = [], []
            for device, rdt in ((dev, torch.float32), ("cpu", torch.float64)):
                cdt = torch.complex64 if rdt == torch.float32 \
                    else torch.complex128
                args = [torch.as_tensor(x, dtype=dt, device=device)
                        .requires_grad_(True) for x, dt in (
                            (ps, rdt if ps_real else cdt), (tauT.T, rdt))]
                rime_cuda.launches = rime_cuda.dtau_launches = 0
                out = rime_cuda.rime_fused(*args, f0, df, nf, conj)
                loss = torch.sum(torch.abs(out - torch.as_tensor(
                    d, dtype=rdt, device=device)) ** 2)
                loss.backward()
                counts.append((rime_cuda.launches, rime_cuda.dtau_launches))
                res.append([out.detach().cpu().numpy()]
                           + [a.grad.cpu().numpy() for a in args])
            card_counts = counts[0]
            errs = [relerr(a, b) for a, b in zip(*res)]
            print(f"phase 10 RimeFused: ps_real={ps_real} conj={conj}: "
                  f"value rel {errs[0]:.2e}, psky grad rel {errs[1]:.2e}, "
                  f"tau grad rel {errs[2]:.2e} (tol {TOL:g}); launches "
                  f"rime_fwd {card_counts[0]}, rime_dtau {card_counts[1]} "
                  f"(expected 2, 1)", flush=True)
            check(all(e <= TOL for e in errs), "RimeFused vs plain")
            check(card_counts == (2, 1), f"RimeFused launches {card_counts}")
    ps, tauT = rand_case(rng, nf, npx, nb, False)
    freqs = f0 + np.arange(nf) * df
    rime_cuda.launches = 0
    a = rime_cuda.rime_pallas_reduce(
        torch.as_tensor(ps, dtype=torch.complex64, device=dev),
        torch.as_tensor(tauT.T, dtype=torch.float32, device=dev), freqs)
    n = rime_cuda.launches
    b = rime_cuda.rime_pallas_reduce(torch.as_tensor(ps),
                                     torch.as_tensor(tauT.T), freqs)
    err = relerr(a.cpu().numpy(), b.numpy())
    print(f"phase 10 rime_pallas_reduce: rel {err:.2e} (tol {TOL:g}), "
          f"{n} launch", flush=True)
    check(a.shape == (nb, nf) and err <= TOL and n == 1,
          f"rime_pallas_reduce vs plain: {err:.2e}, {n} launches")


def phase_hera_prod(bt, torch, rime_cuda, pix_chunks, hera_prod):
    """Phase 11: main path 4 at full width. Returns (launches of
    rime_fwd, launches of rime_dtau)."""
    steps = 3
    res = hera_prod.run(bt, rime_cuda, hera_prod.SIZE, steps=steps)
    prob = res["prob"]
    rime = prob.model.rime
    nsim, ndata = len(rime.sim_bls), len(rime.data_bls)
    ntime, nbatch = len(rime.sim_times), rime.Nbatch
    nparams = sum(p.numel() for p in prob.model.parameters())
    nchunks = len(pix_chunks(nsim, rime.Npix_cut))
    print(f"phase 11 hera-prod build: {len(rime.array.ants)} antennas, "
          f"{nsim} redundant groups simulated, expanded to {ndata} data "
          f"baselines, 4 pols, {rime.Nfreqs} freqs, {nbatch} batches of "
          f"{ntime} times, {rime.Npix_cut} FOV pixels of "
          f"{rime.sky.params.shape[-1]}, a fixed 2x2 Jones PixelResponse "
          f"beam, {nparams} trainable parameters (4 Stokes planes and 4-pol "
          f"complex gains); targets {nbatch} x "
          f"{tuple(prob.target[0].data.shape)} "
          f"{prob.target[0].data.dtype}; {res['build_s']:.1f} s", flush=True)
    expect = steps * nbatch * ntime * 2 * nchunks
    losses, step_s = res["losses"], res["step_s"]
    print(f"phase 11 hera-prod main path: Adam (lr 1e-3) over both batches "
          f"a step: losses {losses}; step wall first {step_s[0] * 1e3:.1f} "
          f"ms, then {', '.join(f'{t * 1e3:.1f}' for t in step_s[1:])} ms; "
          f"rime_fwd launches {res['fwd']} (expected {steps} steps x "
          f"{nbatch} batches x {ntime} times x 2 passes x {nchunks} chunks "
          f"= {expect}), rime_dtau launches {res['dtau']} (expected 0: "
          f"antenna positions are fixed); peak device memory "
          f"{res['peak_gib']:.2f} GiB", flush=True)
    check(all(np.isfinite(losses)), "non-finite hera-prod loss")
    check(losses[-1] < losses[0], "hera-prod loss did not decrease")
    check(res["fwd"] == expect and res["dtau"] == 0,
          f"hera-prod launches rime_fwd {res['fwd']}, rime_dtau "
          f"{res['dtau']} != {expect}, 0")
    profile(torch, res["trainer"].step, "phase 11 profile of one step")
    return res["fwd"], res["dtau"]


def phase_hera_redcal(bt, torch, rime_cuda, pix_chunks, size=HERA,
                      steps=3):
    """Phase 12: main path 5, hera-redcal, at full width unless given
    another size. Returns the launches of rime_fwd."""
    import gc
    from bayeslim_tpu_torch.models.calibration import (chisq,
                                                       compute_redcal_degen)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    prob, truth, rms = build_redcal(bt, device=None, dtype=torch.float32,
                                    **size)
    seq = prob.model
    rime, tgt = seq.rime, prob.target[0]
    torch.cuda.synchronize()
    sizes = {k: v.numel() for k, v in seq.named_parameters()}
    nparams = sum(sizes.values())
    print(f"phase 12 hera-redcal build: {len(rime.array.ants)} antennas, "
          f"{len(rime.sim_bls)} redundant groups simulated, expanded to "
          f"{len(rime.data_bls)} data baselines, {rime.Nfreqs} freqs, "
          f"{len(rime.sim_times)} times, {rime.Npix_cut} FOV pixels; "
          f"trainable {nparams} parameters: RedVisModel "
          f"{tuple(seq.redvis.params.shape)} ({sizes[REDVIS]}), gains "
          f"{tuple(seq.cal.params.shape)} ({sizes[GAINS]}); group rms "
          f"{rms.min():.4g} ... {rms.max():.4g}; target "
          f"{tuple(tgt.data.shape)} {tgt.data.dtype}; "
          f"{time.time() - t0:.1f} s", flush=True)
    nchunks = len(pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    torch.cuda.reset_peak_memory_stats()
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    evals0 = prob.closure_eval
    # starting inverse Hessian from the gradient at the start: the first
    # trial step moves the correction by at most 1 (its truth's scale is
    # 0.05 x a group rms of ~1e2) and the gains by at most 1e-3
    loss0, g0 = prob.value_and_grad()
    first = {REDVIS: 1.0, GAINS: 1e-3}
    opt = bt.LBFGS(prob, H0=first_step_H0(bt, torch, g0, first))
    losses, step_s, evals = [], [], []
    for _ in range(steps):
        t1 = time.time()
        losses.append(float(opt.step()))
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
        evals.append(opt.func_evals)
    # per-leaf probe L-BFGS runs from the solve's running diagonal
    t1 = time.time()
    h0 = {k: v.reshape(-1) for k, v in
          opt._template.unravel(opt._Hdiag).items()}
    cov = bt.lbfgs_approx_cov(prob, Nsteps=2, H0=h0)
    torch.cuda.synchronize()
    cov_s = time.time() - t1
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    nevals = prob.closure_eval - evals0
    expect = len(rime.sim_times) * nchunks * nevals
    peak = torch.cuda.max_memory_allocated() / 2**30
    d = cov.diag
    sig = {}
    off = 0
    for k in sorted(sizes):
        sig[k] = float(torch.sqrt(torch.median(d[off:off + sizes[k]])))
        off += sizes[k]
    with torch.no_grad():
        out = seq().data
        chi2 = float(torch.sum(chisq(tgt.data, out, tgt.icov)
                               .to(torch.float64)))
        g = seq.cal.get_jones()
    nvis = tgt.data.numel()
    dof = nvis - nparams / 2
    aa, ps = compute_redcal_degen(g, seq.cal.ants, seq.cal.R.antpos)
    aa, ps = float(aa.abs().max()), float(ps.abs().max())
    edge = float(np.abs(seq.cal.R.antpos.asnumpy()[:, :2]).max())
    print(f"phase 12 hera-redcal main path: L-BFGS (strong Wolfe, lr 1, "
          f"H0 a DiagMat giving a first trial step of at most "
          f"{first[REDVIS]:g} for the correction and {first[GAINS]:g} for "
          f"gains), loss with both priors: start {float(loss0)}, losses "
          f"{losses}; step walls {step_s} s; function evaluations after "
          f"each step {evals}; lbfgs_approx_cov (2 probe steps a leaf) "
          f"{cov_s:.2f} s; rime_fwd launches {fwd} (expected "
          f"{len(rime.sim_times)} times x {nchunks} chunks x {nevals} "
          f"evaluations = {expect}), rime_dtau launches {dtau} (expected "
          f"0: antenna positions fixed); peak device memory {peak:.2f} GiB",
          flush=True)
    print(f"phase 12 hera-redcal result: chi^2 {chi2:.6e} over {nvis} "
          f"complex visibilities, chi^2/dof {chi2 / dof:.4f} (dof = "
          f"{nvis} - {nparams} / 2 = {dof:.0f}; the target's noise alone "
          f"gives ~1); the solved gains' degeneracies: max |abs amp| "
          f"{aa:.3e}, max |phase slope| {ps:.3e} rad/m ({ps * edge:.3e} rad "
          f"at the array's edge, {edge:.1f} m); DiagMat of "
          f"{d.numel()} entries, median sigma "
          + ", ".join(f"{k} {v:.4e}" for k, v in sig.items()), flush=True)
    check(np.isfinite(float(loss0)) and all(np.isfinite(losses)),
          "non-finite hera-redcal loss")
    check(losses[-1] < float(loss0), "hera-redcal loss did not decrease")
    check(np.isfinite(chi2) and chi2 > 0, "hera-redcal chi^2")
    check(fwd == expect and dtau == 0,
          f"hera-redcal launches rime_fwd {fwd}, rime_dtau {dtau} != "
          f"{expect}, 0")
    check(d.numel() == nparams and bool(torch.all(d > 0))
          and bool(torch.all(torch.isfinite(d))), "hera-redcal DiagMat")
    check(aa <= 1e-5 and ps * edge <= 1e-4,
          f"hera-redcal degeneracies not projected out: {aa}, {ps}")
    profile(torch, prob.value_and_grad,
            "phase 12 profile of one function evaluation")
    return fwd


def phase_hera_hmc(bt, torch, rime_cuda, pix_chunks, size=HERA,
                   f64_chunk=512):
    """Phase 13: main path 6, hera-hmc, config #4's joint posterior over
    sky, beam and gains, sampled at full width unless given another
    size. Returns the launches of rime_fwd on the sampling path."""
    import gc
    import statistics
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    prob, _ = build_hmc(bt, device=None, dtype=torch.float32, **size)
    seq = prob.model
    rime, tgt = seq.rime, prob.target[0]
    torch.cuda.synchronize()
    build_s = time.time() - t0
    sizes = {k: v.numel() for k, v in seq.named_parameters()}
    nparams = sum(sizes.values())
    nt = len(rime.sim_times)
    nchunks = len(pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    print(f"phase 13 hera-hmc build: {len(rime.array.ants)} antennas "
          f"(fixed), {len(rime.sim_bls)} redundant groups simulated, "
          f"expanded to {len(rime.data_bls)} data baselines, {rime.Nfreqs} "
          f"freqs, {nt} times, {rime.Npix_cut} FOV pixels of "
          f"{rime.sky.params.shape[-1]}; trainable {nparams} parameters: "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in
                      seq.named_parameters())
          + f"; target {tuple(tgt.data.shape)} {tgt.data.dtype}; "
          f"{build_s:.1f} s", flush=True)
    U, _ = prob.value_and_grad()
    print(f"phase 13 U at the truth {float(U)!r}: dtype {U.dtype}, shape "
          f"{tuple(U.shape)}", flush=True)
    check(U.dtype == torch.float64 and U.ndim == 0,
          f"hera-hmc U is {U.dtype} of shape {tuple(U.shape)}, not a "
          f"float64 scalar")
    pot = bt.Potential(prob)
    torch.cuda.reset_peak_memory_stats()

    def walls(ts):
        return (f"first {ts[0] * 1e3:.1f} ms, median of the rest "
                f"{statistics.median(ts[1:]) * 1e3:.1f} ms" if len(ts) > 1
                else f"{ts[0] * 1e3:.1f} ms")

    def timed(fn, n):
        out = []
        for _ in range(n):
            t1 = time.time()
            fn()
            torch.cuda.synchronize()
            out.append(time.time() - t1)
        return out

    # 1. the diagonal mass: lbfgs_approx_cov's probe steps (a first
    # trial step of at most HMC_PROBE[k] in leaf k) move the params,
    # which are restored after. Its probe of the gains alone needs no
    # sky cotangent (one rime_fwd pass an evaluation), so the launch
    # count below starts after it.
    t1 = time.time()
    evals0 = prob.closure_eval
    x0 = prob.collect_main_params().detach().clone()
    _, g0 = prob.value_and_grad()
    h0 = {k: torch.full((v.numel(),), HMC_PROBE[k] / float(v.abs().max()),
                        dtype=v.dtype, device=v.device)
          for k, v in g0.items()}
    cov = bt.lbfgs_approx_cov(prob, Nsteps=2, H0=h0)
    prob.send_main_params(x0)
    cov_L = x0.unravel(torch.sqrt(cov.diag))
    torch.cuda.synchronize()
    print(f"phase 13 mass: lbfgs_approx_cov (2 probe steps a leaf) "
          f"{time.time() - t1:.2f} s, {prob.closure_eval - evals0} "
          f"evaluations; cov_L (sqrt of its diagonal) per leaf "
          + ", ".join(f"{k} {float(v.min()):.4e} ... {float(v.max()):.4e}"
                      for k, v in cov_L.items()), flush=True)
    check(all(bool(torch.all(torch.isfinite(v) & (v > 0)))
              for v in cov_L.values()), "hera-hmc mass not finite positive")

    # 2-3. dual averaging, then 10 samples at the averaged step
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    evals0 = prob.closure_eval
    hmc = bt.HMC(pot, x0, eps=1e-3, Nstep=10, seed=0)
    hmc.set_chol(cov_L=cov_L)
    hmc.dual_averaging(Nadapt=20, target=0.8)
    n0 = hmc.fn_evals
    ts = timed(hmc.step, 20)
    eps = float(np.exp(hmc.stepsize.log_eps_bar))
    adapt_dH = list(hmc.dHs)
    print(f"phase 13 dual averaging (20 steps of 10, target 0.8, from eps "
          f"1e-3): adapted eps {eps!r}; acceptance "
          f"{np.mean(hmc._acceptances):.3f}; dH {adapt_dH}; divergences "
          f"{hmc._divergences}; fn_evals {hmc.fn_evals - n0}; step walls "
          f"{walls(ts)}", flush=True)
    hmc.eps, hmc.stepsize = eps, None
    n0, a0, d0 = hmc.fn_evals, len(hmc._acceptances), len(hmc.dHs)
    trajs, ts = [], []
    for i in range(10):
        x_start = hmc.x
        t1 = time.time()
        hmc.step()
        torch.cuda.synchronize()
        ts.append(time.time() - t1)
        if i < 3:
            trajs.append((x_start, hmc.p) + hmc.last_proposal
                         + (hmc.dHs[-1],))
    acc = hmc._acceptances[a0:]
    dHs = hmc.dHs[d0:]
    divs = [d for d in hmc._divergences if d >= a0]
    ch = hmc.get_chain(burn=a0)
    stds = {k: float(np.median(v.std(axis=0))) for k, v in ch.items()}
    # the share of each leaf's elements that the 10 samples moved: a
    # float32 position keeps no leapfrog increment below half its ulp
    moved = {k: float((v != v[:1]).any(axis=0).mean()) for k, v in ch.items()}
    print(f"phase 13 HMC (10 samples, 10 steps of {eps:.4e}): acceptance "
          f"{np.mean(acc):.3f} ({', '.join(f'{a:.3f}' for a in acc)}); "
          f"dH {dHs}; divergences {divs}; fn_evals {hmc.fn_evals - n0}; "
          f"step walls {walls(ts)}; the chain's median per-element std "
          + ", ".join(f"{k} {v:.4e}" for k, v in stds.items())
          + "; share of elements moved "
          + ", ".join(f"{k} {v:.4f}" for k, v in moved.items()), flush=True)
    check(np.mean(acc) >= 0.3, f"hera-hmc acceptance {np.mean(acc):.3f}")
    check(not divs, f"hera-hmc divergences at {divs}")

    # 4. NUTS at the adapted step
    nuts = bt.NUTS(pot, hmc.x, eps=eps, mass=hmc.mass.mass, max_treedepth=5,
                   seed=1)
    ts = timed(nuts.step, 3)
    print(f"phase 13 NUTS (3 steps, max depth 5): tree depths "
          f"{nuts.tree_depths}; acceptance statistics "
          f"{[round(a, 4) for a in nuts._acceptances]}; fn_evals "
          f"{nuts.fn_evals}; step walls {walls(ts)}", flush=True)

    # 5. RecycledHMC
    rec = bt.RecycledHMC(pot, nuts.x, eps=eps, Nstep=10,
                         mass=hmc.mass.mass, seed=2)
    ts = timed(rec.step, 2)
    print(f"phase 13 RecycledHMC (2 steps of 10): {rec.Nsamples} samples, "
          f"acceptance {rec.acceptance_rate:.3f}; dH {rec.dHs}; fn_evals "
          f"{rec.fn_evals}; step walls {walls(ts)}", flush=True)

    # 6. chains one after another
    n0 = hmc.fn_evals
    t1 = time.time()
    out = hmc.sample_chains(Nsample=3, Nchain=2)
    torch.cuda.synchronize()
    print(f"phase 13 HMC.sample_chains (2 chains of 3): acceptance "
          f"{out['acceptance_rate'].tolist()}; divergent "
          f"{out['divergent'].tolist()}; fn_evals {hmc.fn_evals - n0}; "
          f"{time.time() - t1:.2f} s", flush=True)
    finite = all(np.isfinite(v).all() for v in out["chain"].values())

    # 7. the chain through an npz and back
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        f = os.path.join(d, "chain.npz")
        hmc.write_chain(f)
        back = bt.HMC(pot, x0, eps=eps, Nstep=10)
        back.load_chain(f)
    same = back.Nsamples == hmc.Nsamples and all(
        torch.equal(back.x[k], hmc.x[k]) for k in hmc.x.keys())
    print(f"phase 13 write_chain / load_chain: {back.Nsamples} samples, "
          f"position restored {same}, divergences {back._divergences}",
          flush=True)
    check(same and all(type(v) is int for v in back._divergences),
          "hera-hmc chain round trip")
    for s in (hmc, nuts, rec):
        finite = finite and all(np.isfinite(v).all()
                                for v in s.get_chain().values())
    check(finite, "hera-hmc chain has non-finite positions")

    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    nevals = prob.closure_eval - evals0
    expect = 2 * nt * nchunks * nevals
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 13 hera-hmc main path (from dual averaging to the chain's "
          f"round trip): {nevals} evaluations; rime_fwd "
          f"launches {fwd} (expected 2 passes x {nt} times x {nchunks} "
          f"chunks x {nevals} evaluations = {expect}), rime_dtau launches "
          f"{dtau} (expected 0: antenna positions fixed); peak device "
          f"memory {peak:.2f} GiB", flush=True)
    check(fwd == expect and dtau == 0,
          f"hera-hmc launches rime_fwd {fwd}, rime_dtau {dtau} != "
          f"{expect}, 0")
    phase_hera_hmc_dH(bt, torch, prob, hmc, trajs, lambda: build_hmc(
        bt, device=None, dtype=torch.float64,
        **dict(size, pix_chunk=f64_chunk))[0], "phase 13", f64_chunk)
    profile(torch, hmc.step, "phase 13 profile of one HMC step")
    return fwd


def phase_hera_hmc_dH(bt, torch, prob, hmc, trajs, build64, label,
                      f64_chunk):
    """Phases 13 and 16, the dH check: the first three trajectories'
    start and end points evaluated by the same chain in float64 (the
    plain path; build64() builds it), against the sampler's float32 dH;
    beside them what the energy repair removed: the float32 |r|^2 at
    those points summed in float32 and in float64, and the dH each sum
    gives. Returns the worst |dH32 - dH64| and the peak device memory
    [GiB] of the check."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    p64 = build64()
    p64.target[0].data = prob.target[0].data.to(torch.complex128)

    def sums32(q):
        with torch.no_grad():
            _, res, _ = prob.forward_chisq(q)
            terms = (res.conj() * res).real * prob.target[0].icov
            return torch.stack([torch.sum(terms).double(),
                                torch.sum(terms, dtype=torch.float64)]
                               ).tolist()

    def u64(q):
        with torch.no_grad():
            return float(p64.forward_chisq(q.operator(torch.Tensor.double))[0])
    lines, worst = [], 0.0
    for i, (q0, pm0, q1, pm1, U0, U1, dH) in enumerate(trajs):
        dK = hmc.K(pm1) - hmc.K(pm0)
        a32, a64 = sums32(q0)
        b32, b64 = sums32(q1)
        dH64 = u64(q1) - u64(q0) + dK
        worst = max(worst, abs(dH - dH64))
        lines.append(f"trajectory {i}: sampler dH {dH!r} (U {U0!r} -> "
                     f"{U1!r}); float32 |r|^2 summed in float32 gives dH "
                     f"{b32 - a32 + dK!r}, summed in float64 "
                     f"{b64 - a64 + dK!r}"
                     f"; float64 chain dH {dH64!r}; |dH32 - dH64| "
                     f"{abs(dH - dH64):.4e}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} dH check ({time.time() - t1:.1f} s, the float64 chain "
          f"in pixel chunks of {f64_chunk}): " + "; ".join(lines)
          + f"; worst |dH32 - dH64| {worst:.4e}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    check(np.isfinite(worst), f"{label} dH check not finite")
    del p64
    gc.collect()
    torch.cuda.empty_cache()
    return worst, peak


def phase_hera_alm(bt, torch, rime_cuda, pix_chunks, size=ALM, nrow=64,
                   npx=2048, nch=4):
    """Phase 14: main path 7, hera-alm, config #2's a_lm sky, at full
    width unless given another size. Returns the launches of rime_fwd
    and of rime_dtau on its 3 Adam steps, and its sky's (Ylm, alm_mult),
    which phases 15 and 16 take."""
    import gc
    from bayeslim_tpu_torch.ops.sph_harm import (_ylm_mm, _ylm_mm_grad,
                                                 gen_sph2pix)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    prob, truth, info = build_alm(bt, device=None, dtype=torch.float32,
                                  **size)
    rime, tgt, alm = prob.model, prob.target[0], info["alm"]
    torch.cuda.synchronize()
    build_s = time.time() - t0
    Y = alm.Ylm
    ylm_gib = Y.numel() * Y.element_size() / 2**30
    build_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    nparams = sum(p.numel() for p in rime.parameters())
    nt = len(rime.sim_times)
    nchunks = len(pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    print(f"phase 14 hera-alm build: {len(rime.array.ants)} antennas, "
          f"{len(rime.sim_bls)} redundant groups, {rime.Nfreqs} freqs, {nt} "
          f"times, nside {size['nside']} ({Y.shape[1]} pixels, "
          f"{rime.Npix_cut} in the FOV), lmax {size['lmax']} ({alm.Ncoeff} "
          f"modes); Ylm {tuple(Y.shape)} {Y.dtype} ({ylm_gib:.3f} GiB); "
          f"trainable {nparams} parameters: "
          + ", ".join(f"{k} {tuple(v.shape)}" for k, v in
                      rime.named_parameters())
          + f"; build {build_s:.2f} s, of which generate_Ylm "
          f"{info['gen_s']:.3f} s: host Legendre table {info['host_s']:.3f} "
          f"s, device Ylm assembly {info['gen_s'] - info['host_s']:.3f} s; "
          f"peak device memory of the build {build_peak:.3f} GiB above "
          f"the {base / 2**30:.3f} GiB held before", flush=True)
    if size is ALM:
        # phases 2 and 8 hold rime_fwd to its plain version and time it at
        # these shapes
        check(rime.Npix_cut == ALM_SHAPES[0][1] and nchunks == 1
              and len(rime.sim_bls) == ALM_SHAPES[0][2]
              and rime.Nfreqs == ALM["nfreq"],
              f"hera-alm's rime_fwd shapes ({rime.Nfreqs} rows, "
              f"{rime.Npix_cut} pixels in {nchunks} chunks, "
              f"{len(rime.sim_bls)} groups) are not ALM_SHAPES'")
    # finite everywhere, a block of rows at a time (isfinite of the whole
    # complex Ylm would hold a float copy of each part and their masks)
    finite = all(bool(torch.isfinite(Y[i:i + 1024]).all())
                 for i in range(0, Y.shape[0], 1024))
    check(finite, "hera-alm Ylm has non-finite values")

    # the card's Ylm rows against float64 values
    rng = np.random.default_rng(7)
    l, m = alm.l, alm.m
    lmax = size["lmax"]
    must = [int(np.flatnonzero((l == a) & (m == b))[0])
            for a, b in ((lmax, lmax), (lmax, 0), (0, 0))]
    rows = np.unique(np.concatenate([must, rng.choice(
        len(l), nrow - len(must), replace=False)]))
    theta, phi = info["theta"], info["phi"]
    got = Y.index_select(0, torch.as_tensor(rows, device=Y.device)).cpu() \
        .numpy().astype(np.complex128)
    try:
        from scipy.special import sph_harm_y
        ref = np.stack([sph_harm_y(int(l[i]), int(m[i]), theta, phi)
                        for i in rows])
        ref_from = "scipy.special.sph_harm_y"
    except ImportError:
        ref = gen_sph2pix(theta, phi, l[rows], m[rows], high_prec=False,
                          device="cpu", dtype=torch.float64)[0].numpy()
        ref_from = "the port's CPU float64 recurrence"
    row_err = np.abs(got - ref).max(1) / np.abs(ref).max(1)
    print(f"phase 14 Ylm rows: {len(rows)} rows (l = m = {lmax}, ({lmax}, "
          f"0) and (0, 0) among them) against {ref_from} in float64: worst "
          f"error {row_err.max():.3e} of the row maximum (tol 1e-6), at "
          f"(l, m) = ({l[rows][row_err.argmax()]}, "
          f"{m[rows][row_err.argmax()]})", flush=True)
    check(np.isfinite(row_err).all() and row_err.max() <= 1e-6,
          f"hera-alm Ylm rows {row_err.max():.3e}")

    # the card's map of the truth against a CPU float64 evaluation
    px = np.sort(rng.choice(len(theta), npx, replace=False))
    ch = np.sort(rng.choice(rime.Nfreqs, nch, replace=False))
    with torch.no_grad():
        sky_map = rime.sky.R(torch.as_tensor(truth, dtype=torch.float32,
                                             device=Y.device))
    card = sky_map[0, 0][ch][:, px].double().cpu().numpy()
    rms = float(torch.sqrt(torch.mean(sky_map.double() ** 2)))
    Ys, _, am = gen_sph2pix(theta[px], phi[px], l, m, high_prec=False,
                            device="cpu", dtype=torch.float64)
    a = truth[0, 0, ch, :, 0] + 1j * truth[0, 0, ch, :, 1]
    ref = ((torch.as_tensor(a) * am) @ Ys).real.numpy()
    del Ys
    map_err = float(np.abs(card - ref).max()) / rms
    print(f"phase 14 map of the truth: {npx} random pixels x {nch} "
          f"channels against a CPU float64 evaluation (the Ylm of those "
          f"pixels): worst error {map_err:.3e} of the map's rms {rms:.4f} "
          f"(tol 1e-4)", flush=True)
    check(map_err <= 1e-4, f"hera-alm map {map_err:.3e}")

    with torch.no_grad():
        vis = rime.updated(bt.ParamDict({"sky.params": torch.as_tensor(
            truth, dtype=torch.float32, device=Y.device)}))().data
        vrms = float(torch.sqrt(torch.mean(torch.abs(vis.to(
            torch.complex128)) ** 2)))
        nrms = float(torch.sqrt(torch.mean(torch.abs(
            (tgt.data - vis).to(torch.complex128)) ** 2)))
    del vis
    trainer = bt.Trainer(prob, lr=1e-2)
    torch.cuda.synchronize()
    checks_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses, step_s = [], []
    for _ in range(3):
        t1 = time.time()
        losses.append(float(trainer.step()))
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    expect = 3 * 2 * nt * nchunks
    step_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    peak = max(checks_peak, step_peak)
    print(f"phase 14 hera-alm main path: visibility rms at the truth "
          f"{vrms:.4f} against noise rms {nrms:.4f}; Adam (lr 1e-2) losses "
          f"{losses}; step wall first {step_s[0] * 1e3:.1f} ms, median of "
          f"the rest {np.median(step_s[1:]) * 1e3:.1f} ms (steps "
          f"{[round(t * 1e3, 1) for t in step_s]}); rime_fwd launches "
          f"{fwd} (expected 3 steps x 2 passes x {nt} times x {nchunks} "
          f"chunks = {expect}), rime_dtau launches {dtau} (expected 0: "
          f"antenna positions are fixed); peak device memory above what "
          f"was held before: the steps {step_peak:.3f} GiB, the build and "
          f"checks {checks_peak:.3f} GiB (the Ylm {ylm_gib:.3f} GiB; limit "
          f"the Ylm + 2 GiB)", flush=True)
    check(all(np.isfinite(losses)), "non-finite hera-alm loss")
    check(losses[2] < losses[1] < losses[0], "hera-alm loss did not fall")
    check(fwd == expect and dtau == 0,
          f"hera-alm launches rime_fwd {fwd}, rime_dtau {dtau} != "
          f"{expect}, 0")
    check(peak < ylm_gib + 2, f"hera-alm peak {peak:.3f} GiB: a copy of "
          f"the Ylm ({ylm_gib:.3f} GiB)?")
    # the two Ylm products of a step by CUDA events, against two bounds:
    # the complex GEMM as run (8 M K N operations each), and the work the
    # function needs with real_output (the map Re(a Y) and the a_lm
    # gradient of a real g: 4 M K N each)
    a = torch.ones((rime.Nfreqs, alm.Ncoeff), dtype=Y.dtype, device=Y.device)
    g = torch.ones((rime.Nfreqs, Y.shape[1]), dtype=Y.dtype, device=Y.device)
    fwd_ms = cuda_ms(torch, lambda: _ylm_mm(a, Y), 5)
    bwd_ms = cuda_ms(torch, lambda: _ylm_mm_grad(g, Y), 5)
    flop = 8.0 * a.shape[0] * Y.shape[0] * Y.shape[1]
    bound = rime_cuda.roofline_ms(flop, 8.0 * (a.numel() + Y.numel()
                                               + g.numel()))
    # the map is real (4 bytes a value); Y is read whole
    need = rime_cuda.roofline_ms(flop / 2, 8.0 * (a.numel() + Y.numel())
                                 + 4.0 * g.numel())
    print(f"phase 14 the Ylm products by CUDA events: a_lm -> map "
          f"{fwd_ms:.3f} ms, the a_lm gradient {bwd_ms:.3f} ms, "
          f"{flop:.3e} FP32 operations each as complex GEMMs "
          f"({flop / fwd_ms / 1e9:.1f} / {flop / bwd_ms / 1e9:.1f} TFLOP/s); "
          f"bound of the complex GEMM {bound[0]:.3f} ms ({bound[1]}; the "
          f"products at {bound[0] / fwd_ms:.1%} / {bound[0] / bwd_ms:.1%} "
          f"of it); bound of the work real_output needs ({flop / 2:.3e} "
          f"operations each) {need[0]:.3f} ms ({need[1]}; the products at "
          f"{need[0] / fwd_ms:.1%} / {need[0] / bwd_ms:.1%} of it)",
          flush=True)
    del a, g
    busy, gemm = profile(torch, trainer.step, "phase 14 profile of one step",
                         match="gemm")
    prods = fwd_ms + bwd_ms
    seen = "the profiler saw no device time" if busy is None else (
        f"the profiler saw {gemm:.2f} ms of cuBLAS GEMM kernels in "
        f"{busy:.2f} ms of device time" + (
            f" ({gemm / busy:.1%})" if gemm >= 0.9 * prods else
            ": it missed kernels (less GEMM than the CUDA events time)"))
    print(f"phase 14 the Ylm products: {prods:.2f} ms a step by CUDA "
          f"events, {prods / np.median(step_s[1:]) / 1e3:.1%} of the "
          f"median step wall; {seen}", flush=True)
    ylm = (Y, alm.alm_mult)
    del prob, rime, alm, Y
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, dtau, ylm


def sfb_bound_ms(rime_cuda, nf, nn, nc, nk_cols, nk_l):
    """Least times of the SFB transform's forward and of its gradient
    (complex64 t_lmn and a_lm, float32 g): each (f, n, column) of a
    column's first Nk(l) rows is a real-by-complex multiply-add, 4
    operations (nk_cols = sum over columns of Nk); bytes: the forward
    reads those rows of the t_lmn and every g_ln once and writes the
    a_lm; the gradient reads the a_lm's cotangent and the g_ln and writes
    the whole t_lmn gradient (nn rows). Returns ((ms, by), (ms, by))."""
    flop = 4.0 * nf * nk_cols
    g = 4.0 * nf * nk_l
    return (rime_cuda.roofline_ms(flop, 8.0 * nk_cols + g + 8.0 * nf * nc),
            rime_cuda.roofline_ms(flop, 8.0 * nf * nc + g + 8.0 * nn * nc))


def phase_hera_sfb(bt, torch, rime_cuda, pix_chunks, sky_ylm, size=SFB,
                   npx=2048, nch=4):
    """Phase 15: main path 8, hera-sfb, config #2's widths with the SFB
    radial basis and a Ylm beam, at full width unless given another
    size; the sky's Ylm is phase 14's (sky_ylm = (Ylm, alm_mult)).
    Returns the launches of rime_fwd and of rime_dtau on its 3 Adam
    steps, and its beam's response (phase 16 takes it)."""
    import gc
    from bayeslim_tpu_torch.ops.sph_harm import SFBModel, gen_sph2pix
    from bayeslim_tpu_torch.utils import healpix as hp
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prob, truth, info = build_sfb(bt, device=None, dtype=torch.float32,
                                  sky_ylm=sky_ylm, **size)
    rime, tgt, alm = prob.model, prob.target[0], info["alm"]
    beam_R, sfb = rime.beam.R, rime.sky.R.sfb
    Y, Yb = alm.Ylm, beam_R.alm.Ylm
    check(Y is sky_ylm[0], "hera-sfb built a second sky Ylm")
    sky_gib = Y.numel() * Y.element_size() / 2**30
    beam_gib = Yb.numel() * Yb.element_size() / 2**30
    nt = len(rime.sim_times)
    nchunks = len(pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    nk = info["nk"]
    nk_cols = int(sum(nk.get(float(ll), 0) for ll in alm.l))
    nk_l = int(sum(nk.values()))
    nparams = sum(p.numel() for p in rime.parameters())
    print(f"phase 15 hera-sfb build: {len(rime.array.ants)} antennas, "
          f"{len(rime.sim_bls)} redundant groups, {rime.Nfreqs} freqs, {nt} "
          f"times, nside {size['nside']} ({Y.shape[1]} pixels, "
          f"{rime.Npix_cut} in the FOV), lmax {size['lmax']} ({alm.Ncoeff} "
          f"modes, {len(nk)} distinct l); kmax {float(info['kmax'])!r} "
          f"1/Mpc: Nk {nk[0.0]} at l = 0, {max(nk.values())} at most (l = "
          f"{max(nk, key=nk.get):g}), {nk[max(nk)]} at l = {max(nk):g}, "
          f"{nk_l} over the l, {nk_cols} over the columns; the sky's Ylm "
          f"{tuple(Y.shape)} {Y.dtype} ({sky_gib:.3f} GiB) phase 14's "
          f"through setup_Ylm; the beam's lmax {size['beam_lmax']} "
          f"({beam_R.alm.Ncoeff} modes) on nside {size['beam_nside']}, Ylm "
          f"{tuple(Yb.shape)} ({beam_gib:.3f} GiB); trainable {nparams} "
          f"parameters: " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in
                                      rime.named_parameters())
          + f"; build {info['total_s']:.2f} s: host gen_bessel2freq "
          f"{info['bessel_s']:.3f} s (with sfb_kmax), the beam's Ylm "
          f"{info['beam_s']:.3f} s, the rest "
          f"{info['total_s'] - info['bessel_s'] - info['beam_s']:.3f} s",
          flush=True)
    if size is SFB:
        check(rime.Npix_cut == ALM_SHAPES[0][1] and nchunks == 1
              and len(rime.sim_bls) == ALM_SHAPES[0][2]
              and rime.Nfreqs == ALM["nfreq"],
              f"hera-sfb's rime_fwd shapes ({rime.Nfreqs} rows, "
              f"{rime.Npix_cut} pixels in {nchunks} chunks, "
              f"{len(rime.sim_bls)} groups) are not ALM_SHAPES'")

    # the sky map at the truth and the beam map, card against a CPU
    # float64 evaluation (SFBModel of the host float64 g_ln, the Ylm of
    # the sampled pixels)
    rng = np.random.default_rng(8)
    ch = np.sort(rng.choice(rime.Nfreqs, nch, replace=False))
    errs = {}
    with torch.no_grad():
        sky_map = rime.sky.R(torch.as_tensor(truth["sky"],
                                             dtype=torch.float32,
                                             device=Y.device))[0, 0]
        beam_map = beam_R.grid_beam(torch.as_tensor(
            truth["beam"], dtype=torch.float32, device=Y.device))[0, 0, 0]
    t = torch.as_tensor(truth["sky"])
    a_sky = SFBModel(alm.l, alm.m, info["gln"], info["kbins"])(
        torch.complex(t[..., 0], t[..., 1]))[0, 0]
    bt_ = torch.as_tensor(truth["beam"])[0, 0, 0]
    a_beam = torch.complex(bt_[..., 0], bt_[..., 1])
    nb = size["beam_nside"]
    for name, card_map, a, model, (theta, phi) in (
            ("sky", sky_map, a_sky, alm, (info["theta"], info["phi"])),
            ("beam", beam_map, a_beam, beam_R.alm,
             hp.pix2ang(nb, np.arange(hp.nside2npix(nb))))):
        px = np.sort(rng.choice(len(theta), npx, replace=False))
        got = card_map[ch][:, px].double().cpu().numpy()
        rms = float(torch.sqrt(torch.mean(card_map.double() ** 2)))
        Ys, _, am = gen_sph2pix(theta[px], phi[px], model.l, model.m,
                                high_prec=False, device="cpu",
                                dtype=torch.float64)
        ref = ((a[ch] * am) @ Ys).real.numpy()
        errs[name] = (float(np.abs(got - ref).max()) / rms, rms)
        del Ys
    print(f"phase 15 maps at the truth, {npx} random pixels x {nch} "
          f"channels against a CPU float64 evaluation: " + "; ".join(
              f"{k} worst error {e:.3e} of the map's rms {r:.4e}"
              for k, (e, r) in errs.items()) + " (tol 1e-4)", flush=True)
    check(all(e <= 1e-4 for e, _ in errs.values()),
          f"hera-sfb maps {errs}")
    del sky_map, beam_map

    # 3 Adam steps: the t_lmn's learning rate is hera-alm's (1e-2) over
    # the median rms_f |g_l(f, :)| (the t_lmn of an a_lm of 1 are ~1 /
    # that), the beam a_lm's 1e-3 (they are ~1e-2-1e-1)
    gscale = float(np.median([1.0 / np.sqrt(np.mean(np.sum(
        g.numpy() ** 2, axis=1))) for g in info["gln"].values()]))
    lrs = {"sky.params": 1e-2 * gscale, "beam.params": 1e-3}
    trainer = bt.Trainer(prob)
    keys = list(trainer.pdict.keys())
    trainer.set_opt(lambda ps: torch.optim.Adam(
        [{"params": [p], "lr": lrs[k]} for k, p in zip(keys, ps)]))
    torch.cuda.synchronize()
    checks_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses, step_s = [], []
    for _ in range(3):
        t1 = time.time()
        losses.append(float(trainer.step()))
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    expect = 3 * 2 * nt * nchunks
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    peak = max(checks_peak, step_peak)
    limit = sky_gib + beam_gib + 2
    print(f"phase 15 hera-sfb main path: Adam (lr {lrs['sky.params']:.4g} "
          f"on the t_lmn, {lrs['beam.params']:g} on the beam a_lm) losses "
          f"{losses}; step wall first {step_s[0] * 1e3:.1f} ms, median of "
          f"the rest {np.median(step_s[1:]) * 1e3:.1f} ms (steps "
          f"{[round(x * 1e3, 1) for x in step_s]}); rime_fwd launches "
          f"{fwd} (expected 3 steps x 2 passes x {nt} times x {nchunks} "
          f"chunks = {expect}), rime_dtau launches {dtau} (expected 0: "
          f"antenna positions are fixed); peak device memory: the steps "
          f"{step_peak:.3f} GiB, the build and checks {checks_peak:.3f} GiB "
          f"({base / 2**30:.3f} GiB held before, the sky's Ylm among it; "
          f"limit the sky Ylm + the beam Ylm + 2 GiB = {limit:.3f} GiB)",
          flush=True)
    check(all(np.isfinite(losses)), "non-finite hera-sfb loss")
    check(losses[2] < losses[1] < losses[0], "hera-sfb loss did not fall")
    check(fwd == expect and dtau == 0,
          f"hera-sfb launches rime_fwd {fwd}, rime_dtau {dtau} != "
          f"{expect}, 0")
    check(peak < limit, f"hera-sfb peak {peak:.3f} GiB above {limit:.3f}")

    # the SFB transform by CUDA events: the batched product and its
    # gradient beside their bounds and the per-l plain loop's
    nn, nc = size["nn"], alm.Ncoeff
    gen = torch.Generator(device=Y.device).manual_seed(9)
    p = torch.randn((1, 1, nn, nc), generator=gen, dtype=torch.complex64,
                    device=Y.device).requires_grad_(True)
    out = sfb(p)
    outp = sfb.forward_plain(p)
    g = torch.randn(out.shape, generator=gen, dtype=out.dtype,
                    device=Y.device)
    err = relerr(out.detach().cpu().numpy(), outp.detach().cpu().numpy())
    times = dict(
        fwd=cuda_ms(torch, lambda: sfb(p.detach()), 20),
        bwd=cuda_ms(torch, lambda: torch.autograd.grad(
            out, p, g, retain_graph=True), 20),
        plain_fwd=cuda_ms(torch, lambda: sfb.forward_plain(p.detach()), 3),
        plain_bwd=cuda_ms(torch, lambda: torch.autograd.grad(
            outp, p, g, retain_graph=True), 3))
    (bf, byf), (bb, byb) = sfb_bound_ms(rime_cuda, rime.Nfreqs, nn, nc,
                                        nk_cols, nk_l)
    print(f"phase 15 the SFB transform by CUDA events (t_lmn (1, 1, {nn}, "
          f"{nc}) complex64; batched against the plain loop rel "
          f"{err:.2e}): forward {times['fwd']:.4f} ms (bound {bf:.4f} ms, "
          f"{byf}: {bf / times['fwd']:.1%}; the per-l loop "
          f"{times['plain_fwd']:.3f} ms), gradient {times['bwd']:.4f} ms "
          f"(bound {bb:.4f} ms, {byb}: {bb / times['bwd']:.1%}; the per-l "
          f"loop's {times['plain_bwd']:.3f} ms)", flush=True)
    check(err <= 1e-5, f"hera-sfb batched SFB against its loop {err:.2e}")
    del p, out, outp, g
    busy = profile(torch, trainer.step, "phase 15 profile of one step")
    if busy is not None:
        print(f"phase 15 device busy {busy:.2f} ms of the median step wall "
              f"{np.median(step_s[1:]) * 1e3:.1f} ms", flush=True)
    del prob, rime, trainer, sfb
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, dtau, beam_R


def phase_hera_hmc_alm(bt, torch, rime_cuda, pix_chunks, sky_ylm, beam_R,
                       size=HMC_ALM, f64_chunk=2048, nadapt=10):
    """Phase 16: main path 9, hera-hmc-alm, BASELINE.json config #4 as
    written: hera-hmc's chain over hera-alm's a_lm sky (phase 14's Ylm)
    and phase 15's Ylm beam (beam_R), 128 channels, sampled at full width
    unless given another size. Returns the launches of rime_fwd and of
    rime_dtau on the sampling path."""
    import gc
    import statistics
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.time()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    prob, truth = build_hmc_alm(bt, device=None, dtype=torch.float32,
                                sky_ylm=sky_ylm, beam_R=beam_R, **size)
    seq = prob.model
    rime, tgt = seq.rime, prob.target[0]
    torch.cuda.synchronize()
    build_s = time.time() - t0
    sizes = {k: v.numel() for k, v in seq.named_parameters()}
    nparams = sum(sizes.values())
    nt = len(rime.sim_times)
    nchunks = len(pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    nf, nc = rime.Nfreqs, rime.sky.R.spat_LM.Ncoeff
    expect_n = 2 * nf * (nc + beam_R.alm.Ncoeff + len(rime.array.ants))
    print(f"phase 16 hera-hmc-alm build: {len(rime.array.ants)} antennas "
          f"(fixed), {len(rime.sim_bls)} redundant groups simulated, "
          f"expanded to {len(rime.data_bls)} data baselines, {nf} freqs, "
          f"{nt} times, {rime.Npix_cut} FOV pixels; the sky's Ylm phase "
          f"14's, the beam's response phase 15's; trainable {nparams} "
          f"parameters (expected 2 x {nf} x ({nc} sky modes + "
          f"{beam_R.alm.Ncoeff} beam modes + {len(rime.array.ants)} gains) "
          f"= {expect_n}): " + ", ".join(
              f"{k} {tuple(v.shape)}" for k, v in seq.named_parameters())
          + f"; target {tuple(tgt.data.shape)} {tgt.data.dtype}; "
          f"{build_s:.1f} s", flush=True)
    check(nparams == expect_n, f"hera-hmc-alm has {nparams} parameters")
    check(rime.sky.R.spat_LM.Ylm is sky_ylm[0] and rime.beam.R is beam_R,
          "hera-hmc-alm built a second sky Ylm or beam response")
    if size is HMC_ALM:
        check(rime.Npix_cut == ALM_SHAPES[0][1] and nchunks == 1
              and len(rime.sim_bls) == ALM_SHAPES[0][2]
              and nf == ALM["nfreq"],
              "hera-hmc-alm's rime_fwd shapes are not ALM_SHAPES'")
    U, _ = prob.value_and_grad()
    check(U.dtype == torch.float64 and U.ndim == 0,
          f"hera-hmc-alm U is {U.dtype} of shape {tuple(U.shape)}")
    pot = bt.Potential(prob)

    def walls(ts):
        return (f"first {ts[0] * 1e3:.1f} ms, median of the rest "
                f"{statistics.median(ts[1:]) * 1e3:.1f} ms" if len(ts) > 1
                else f"{ts[0] * 1e3:.1f} ms")

    # 1. the diagonal mass from lbfgs_approx_cov's probe (restored after)
    t1 = time.time()
    evals0 = prob.closure_eval
    x0 = prob.collect_main_params().detach().clone()
    _, g0 = prob.value_and_grad()
    h0 = {k: torch.full((v.numel(),), HMC_PROBE[k] / float(v.abs().max()),
                        dtype=v.dtype, device=v.device)
          for k, v in g0.items()}
    cov = bt.lbfgs_approx_cov(prob, Nsteps=2, H0=h0)
    prob.send_main_params(x0)
    cov_L = x0.unravel(torch.sqrt(cov.diag))
    torch.cuda.synchronize()
    print(f"phase 16 U at the truth {float(U)!r}; mass: lbfgs_approx_cov "
          f"(2 probe steps a leaf) {time.time() - t1:.2f} s, "
          f"{prob.closure_eval - evals0} evaluations; cov_L per leaf "
          + ", ".join(f"{k} {float(v.min()):.4e} ... {float(v.max()):.4e}"
                      for k, v in cov_L.items()), flush=True)
    check(all(bool(torch.all(torch.isfinite(v) & (v > 0)))
              for v in cov_L.values()), "hera-hmc-alm mass not finite")

    # 2-3. dual averaging, then 10 samples at the averaged step
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    evals0 = prob.closure_eval
    t1 = time.time()
    hmc = bt.HMC(pot, x0, eps=1e-3, Nstep=10, seed=0)
    hmc.set_chol(cov_L=cov_L)
    hmc.dual_averaging(Nadapt=nadapt, target=0.8)
    n0 = hmc.fn_evals
    ts = []
    for _ in range(nadapt):
        t2 = time.time()
        hmc.step()
        torch.cuda.synchronize()
        ts.append(time.time() - t2)
    eps = float(np.exp(hmc.stepsize.log_eps_bar))
    print(f"phase 16 dual averaging ({nadapt} steps of 10, target 0.8, "
          f"from eps 1e-3): adapted eps {eps!r}; acceptance "
          f"{np.mean(hmc._acceptances):.3f}; dH {list(hmc.dHs)}; "
          f"divergences {hmc._divergences}; fn_evals {hmc.fn_evals - n0}; "
          f"step walls {walls(ts)}", flush=True)
    hmc.eps, hmc.stepsize = eps, None
    n0, a0, d0 = hmc.fn_evals, len(hmc._acceptances), len(hmc.dHs)
    trajs, ts = [], []
    for i in range(10):
        x_start = hmc.x
        t2 = time.time()
        hmc.step()
        torch.cuda.synchronize()
        ts.append(time.time() - t2)
        if i < 3:
            trajs.append((x_start, hmc.p) + hmc.last_proposal
                         + (hmc.dHs[-1],))
    acc = hmc._acceptances[a0:]
    divs = [d for d in hmc._divergences if d >= a0]
    ch = hmc.get_chain(burn=a0)
    moved = {k: float((v != v[:1]).any(axis=0).mean()) for k, v in ch.items()}
    print(f"phase 16 HMC (10 samples, 10 steps of {eps:.4e}): acceptance "
          f"{np.mean(acc):.3f} ({', '.join(f'{a:.3f}' for a in acc)}); "
          f"dH {hmc.dHs[d0:]}; divergences {divs}; fn_evals "
          f"{hmc.fn_evals - n0}; step walls {walls(ts)}; share of elements "
          f"moved " + ", ".join(f"{k} {v:.4f}" for k, v in moved.items()),
          flush=True)
    check(all(np.isfinite(hmc.dHs[d0:])), "hera-hmc-alm dH not finite")
    check(not divs, f"hera-hmc-alm divergences at {divs}")

    # 4. NUTS at the adapted step
    nuts = bt.NUTS(pot, hmc.x, eps=eps, mass=hmc.mass.mass, max_treedepth=5,
                   seed=1)
    ts = []
    for _ in range(3):
        t2 = time.time()
        nuts.step()
        torch.cuda.synchronize()
        ts.append(time.time() - t2)
    print(f"phase 16 NUTS (3 steps, max depth 5): tree depths "
          f"{nuts.tree_depths}; acceptance statistics "
          f"{[round(a, 4) for a in nuts._acceptances]}; fn_evals "
          f"{nuts.fn_evals}; step walls {walls(ts)}", flush=True)
    check(all(np.isfinite(v).all() for s in (hmc, nuts)
              for v in s.get_chain().values()),
          "hera-hmc-alm chain has non-finite positions")
    sample_s = time.time() - t1
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    nevals = prob.closure_eval - evals0
    expect = 2 * nt * nchunks * nevals
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 16 hera-hmc-alm main path (dual averaging, HMC, NUTS: "
          f"{sample_s:.1f} s): {nevals} evaluations, "
          f"{sample_s / nevals * 1e3:.1f} ms each; rime_fwd launches {fwd} "
          f"(expected 2 passes x {nt} times x {nchunks} chunks x {nevals} "
          f"evaluations = {expect}), rime_dtau launches {dtau} (expected 0: "
          f"antenna positions fixed); peak device memory {peak:.2f} GiB",
          flush=True)
    check(fwd == expect and dtau == 0,
          f"hera-hmc-alm launches rime_fwd {fwd}, rime_dtau {dtau} != "
          f"{expect}, 0")
    phase_hera_hmc_dH(bt, torch, prob, hmc, trajs, lambda: build_hmc_alm(
        bt, device=None, dtype=torch.float64,
        **dict(size, pix_chunk=f64_chunk))[0], "phase 16", f64_chunk)
    profile(torch, prob.value_and_grad,
            "phase 16 profile of one evaluation")
    print(f"phase 16 wall {time.time() - t_phase:.1f} s", flush=True)
    del prob, seq, rime, hmc, nuts
    gc.collect()
    torch.cuda.empty_cache()
    return fwd, dtau


def kernel_instances(src, names):
    """{kernel: instances the CUDA source makes}: its distinct template
    arguments (`name<16>`, `name<4>`), or 1 for a kernel that is no
    template."""
    import re
    return {n: len(set(re.findall(rf"\b{n}<(\d+)>", src))) or 1
            for n in names}


def phase_spike(torch, spike, dev, built):
    """Phase 9: the mosaic_spike kernels. Returns their entries of the
    JSON line of kernels."""
    path, _, report = built["mosaic_spike.cu"]
    redesigned = tuple(BEFORE_MS)
    for name, line in ptxas_by_function(report).items():
        if any(k in name for k in redesigned):
            print(f"phase 9 mosaic_spike.cu ptxas: {name}: {line}", flush=True)
    fp64 = fp64_by_function(path)
    if fp64 is None:
        print("phase 9 mosaic_spike.cu SASS: no cuobjdump, FP64 not counted",
              flush=True)
    else:
        with open(os.path.join(ROOT, "bayeslim_tpu_torch", "csrc",
                               "mosaic_spike.cu")) as f:
            want = kernel_instances(f.read(), redesigned)
        got = {n: sum(n in k for k in fp64) for n in redesigned}
        print(f"phase 9 mosaic_spike.cu SASS: FP64 instructions by kernel "
              f"{fp64}; instances of the redesigned kernels {got} (the "
              f"source makes {want})", flush=True)
        check(got == want and not any(fp64.values()),
              f"the spikes run FP64 instructions: {fp64}")
    # the script's sizes (TC = TB, so k_nn's and k_nt's M, N, K agree)
    dims = (spike.NF, spike.TC, spike.TB)
    plans = {name: (spike.sgemm_plan(nt, *dims),
                    spike.card_sgemm_plan(nt, *dims, (0, 0)))
             for name, nt in (("k_nn", False), ("k_nt", True))}
    plans["k_vt"] = (spike.vt_plan(*dims), spike.card_vt_plan(*dims,
                                                              (0, 0, 0)))
    plans["k_lr"] = (spike.lr_plan(*dims), spike.card_lr_plan(*dims,
                                                              (0, 0)))
    plans["k_bd"] = (spike.bd_plan(*dims), spike.card_bd_plan(*dims, (0, 0)))
    for label, fdims in (("", dims), (" (hera-stat's forward shape)",
                                      (1024, 6144, 630))):
        plans["k_fwd" + label] = (spike.fwd_plan(*fdims),
                                  spike.card_fwd_plan(*fdims))
    for name, (plan, card) in plans.items():
        print(f"phase 9 {name} launch at the script's sizes: {plan}; the "
              f"C launcher's: {card}", flush=True)
        check(all(plan[k] == v for k, v in card.items()),
              f"{name}'s plan differs from its launcher's: {plan} {card}")

    worst = dict.fromkeys(spike.RUN, 0.0)
    sizes = (("script", (spike.NF, spike.TC, spike.TB, spike.G)),
             ("odd", (96, 200, 100, 8)))
    cases = [(label, name, size) for label, size in sizes
             for name, _ in spike.SPIKES]
    # k_fwd against the plain version's every chain count G: the others
    # at the odd size
    cases += [("odd", "k_fwd", (96, 200, 100, g)) for g in spike.FWD_G
              if g != spike.G]
    # the redesigned kernels' 4-byte loads: rows of a length that is no
    # multiple of 4, rows and columns off the tile (k_bd and k_fwd take
    # NF % G == 0)
    cases += [("ragged", name, (97, 203, 101, 8))
              for name in redesigned if name not in ("k_bd", "k_fwd")]
    cases += [("ragged", name, size) for name in ("k_bd", "k_fwd")
              for size in ((104, 203, 101, 8), (97, 203, 101, 1))]
    for label, name, size in cases:
        rel, err, n = spike.compare(name, *size, device=dev)
        torch.cuda.synchronize()
        same = ""
        if name in redesigned:
            # (k_rot on unit_m's inputs: mk's overflow to NaN at 1024)
            args = spike.make_args(name, *size, device=dev, distinct=True,
                                   unit_rot=True)
            one, two = spike.RUN[name](*args), spike.RUN[name](*args)
            eq = all(torch.equal(a, b) for a, b in zip(
                one if isinstance(one, tuple) else (one,),
                two if isinstance(two, tuple) else (two,)))
            same = f"; a second launch {'bit-equal' if eq else 'DIFFERS'}"
            check(eq, f"{name} at {size}: two launches differ")
        print(f"phase 9 {name} vs plain (float64), {label} NF, TC, TB, "
              f"G = {size}: rel {rel:.2e} (tol {TOL:g}) abs {err:.2e}, "
              f"{n} launch{same}", flush=True)
        check(n == 1 and np.isfinite(rel) and rel <= TOL,
              f"{name} vs plain at {size}: rel {rel:.2e}, {n} launches")
        worst[name] = max(worst[name], err)
    # k_rot's float-float power across NF (the first design's float32
    # loop: 4.82e-5 relative at 1024, 2.2e-4 at 4096)
    for tc, tb in ((spike.TC, spike.TB), (200, 100), (203, 101)):
        for nf in ROT_NF:
            rel, err, n = spike.compare("k_rot", nf, tc, tb, 1, device=dev)
            torch.cuda.synchronize()
            print(f"phase 9 k_rot vs plain (float64), unit_m's inputs at "
                  f"NF = {nf}, TC, TB = {tc}, {tb}: rel {rel:.2e} (tol "
                  f"{TOL:g}; the design's bar 1e-6 "
                  f"{'held' if rel <= 1e-6 else 'MISSED'}), {n} launch",
                  flush=True)
            check(n == 1 and np.isfinite(rel) and rel <= TOL,
                  f"k_rot vs plain at NF = {nf}, {tc} x {tb}: rel {rel:.2e}")

    # the spike's own entry point, its counts set to 0 just before: one
    # warm-up launch and nrep captured in the timing graph per kernel
    nrep = 400
    for name in spike.launches:
        spike.launches[name] = 0
    times = spike.main(device=dev, n=nrep)
    torch.cuda.synchronize()
    counts = dict(spike.launches)
    print(f"phase 9 mosaic-spike main path: launches {counts} (expected "
          f"{1 + nrep} each)", flush=True)
    check(all(n == 1 + nrep for n in counts.values()),
          f"spike launches by main() are not {1 + nrep} each: {counts}")

    entries = []
    for name, _ in spike.SPIKES:
        args = spike.make_args(name, device=dev)
        pms = cuda_ms(torch, lambda: spike.PLAIN[name](*args), 3)
        t = times[name]
        lib = (f"library {t['library_ms']:.4f} ms" if t["library_ms"]
               is not None else "no single PyTorch call computes it, so no "
               "library time")
        if name in BEFORE_MS and t["library_ms"] is not None:
            lib += (f" (kernel {t['ms'] / t['library_ms']:.2f}x the library "
                    f"call)")
        if name == "k_bd":
            mm = spike.timeit(torch.matmul, *args[:2], n=nrep)
            lib += (f", torch.matmul(ps, m) alone {mm:.4f} ms (kernel "
                    f"{t['ms'] / mm:.2f}x it)")
        if name in BEFORE_MS:
            lib += (f"; the previous design ran {BEFORE_MS[name]} "
                    f"ms on an NVIDIA H100 80GB HBM3 at 700 W, "
                    f"{BEFORE_MS[name] / t['ms']:.2f}x this time")
        print(f"phase 9 times: {name} at NF, TC, TB = {spike.NF}, "
              f"{spike.TC}, {spike.TB}: kernel {t['ms']:.4f} ms, plain "
              f"{pms:.3f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}), kernel at {t['bound_ms'] / t['ms']:.1%} "
              f"of bound; the TPU body's loop covered at "
              f"{t['loop_tflops']:.2f} TFLOP/s; {lib}",
              flush=True)
        entries.append({
            "name": name, "route": "cuda",
            "source": "bayeslim_tpu_torch/csrc/mosaic_spike.cu",
            "replaces": f"scripts/mosaic_spike.py:{SPIKE_LINES[name]}",
            "launches": counts[name],
            "launches_by_path": {"mosaic-spike": counts[name]},
            "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": pms,
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    return entries


def phase_fwd_beside_spikes(torch, spike, dev, fwd_shape, timing):
    """Phase 8, end: the spike's forward loop (k_fwd) at hera-stat's
    forward shape fwd_shape = (R, K, N), beside rime_fwd's times at both
    shapes (timing, phase 8), and k_rot at the same shape (NF = R, TC x
    TB = K x N) on mk's and unit_m's inputs, L2 warm and emptied before
    each launch, each beside its previous design's time."""
    R, K, N = fwd_shape

    def line(name, ms, how=""):
        bms, by = spike.bound_ms(name, R, K, N)
        tflops = spike.loop_flops(name, R, K, N) / ms / 1e9
        old = SPIKE_BEFORE_MS[name]
        print(f"phase 8 times at hera-stat's forward shape NF={R} TC={K} "
              f"TB={N} G=8: {name}{how} {ms:.5f} ms, bound {bms:.5f} ms "
              f"({by}), kernel at {bms / ms:.1%} of bound; the TPU body's "
              f"loop covered at {tflops:.2f} TFLOP/s; the previous design "
              f"ran {old} ms on an NVIDIA H100 80GB HBM3 at 700 W, "
              f"{old / ms:.2f}x this time", flush=True)

    args = spike.make_args("k_fwd", NF=R, TC=K, TB=N, G=8, device=dev)
    kf = spike.timeit(spike.run_fwd, *args, n=20)
    line("k_fwd", kf)
    rot = {}
    for label, unit in (("mk's", False), ("unit_m's", True)):
        m, _ = spike.make_args("k_rot", NF=R, TC=K, TB=N, device=dev,
                               unit_rot=unit)
        for how, timer, n in (("L2 warm", spike.timeit, 100),
                              ("L2 emptied", spike.timeit_flushed, 20)):
            rot[label, how] = timer(spike.run_rot, m, R, n=n)
            line("k_rot", rot[label, how], f" on {label} inputs, {how},")
    for how in ("L2 warm", "L2 emptied"):
        a, b = rot["mk's", how], rot["unit_m's", how]
        print(f"phase 8 k_rot {how}: mk's inputs / unit_m's {a / b:.3f}",
              flush=True)
    print(f"phase 8 rime_fwd beside the spikes: forward shape "
          f"{timing[0][0]:.4f} ms = {timing[0][0] / kf:.1%} of k_fwd's "
          f"{kf:.4f} ms at that shape, backward shape {timing[1][0]:.4f} ms "
          f"= {timing[1][0] / kf:.1%} of it", flush=True)


def filt_band_power(torch, ft, x, bins, rows):
    """Power of x's delay spectrum (ft: a float64 FFT over the channels
    with a window) inside each length bin's filtered band, |delay| <=
    the bin's tau, summed over the bin's baselines and the times."""
    delays = torch.as_tensor(ft.freqs, device=x.device)
    out = []
    for b, tau in enumerate(bins["tau"]):
        idx = torch.as_tensor(rows[b], device=x.device)
        spec = ft(x.index_select(2, idx).to(torch.complex128))
        out.append(float(torch.sum(torch.abs(spec[..., delays.abs() <= tau])
                                   ** 2)))
    return np.asarray(out)


def phase_hera_filt(bt, torch, rime_cuda, pix_chunks, size=HERA, steps=3):
    """Phase 17: main path 10, hera-filt, config #5's delay filter over
    hera-cal's chain with smooth polynomial gains, at full width unless
    given another size. Returns (launches of rime_fwd, of rime_dtau)."""
    import gc
    from bayeslim_tpu_torch.ops import linalg
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    prob, truth, info = build_filt(bt, device=None, dtype=torch.float32,
                                   **size)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    seq, tgt = prob.model, prob.target[0]
    rime, wedge, bins = seq.rime, info["wedge"], info["bins"]
    vd = info["unfiltered"]
    nsim, ndata = len(rime.sim_bls), len(rime.data_bls)
    sizes = {k: v.numel() for k, v in seq.named_parameters()}
    nparams = sum(sizes.values())
    nf, nt = rime.Nfreqs, len(rime.sim_times)
    print(f"phase 17 hera-filt build: {len(rime.array.ants)} antennas, "
          f"{nsim} redundant groups simulated, expanded to {ndata} data "
          f"baselines, {nf} freqs, {nt} times, {rime.Npix_cut} FOV pixels; "
          f"trainable {nparams} parameters: antenna positions "
          f"({sizes[ANTVECS]}), gains as {seq.cal.params.shape[4]} "
          f"Legendre coefficients {tuple(seq.cal.params.shape)} "
          f"({sizes[GAINS]}); WedgeFilter of {len(wedge.filters)} "
          f"GPFilter(residual=True) over {len(bins['tau'])} length bins of "
          f"{bins['edges'][1]:.2f} m, baselines a bin {bins['counts']}, "
          f"tau [ns] {np.round(bins['tau'] * 1e9, 1).tolist()}, Cn 1e-9 I; "
          f"target {tuple(tgt.data.shape)} {tgt.data.dtype}; build "
          f"{build_s:.1f} s, of them the {len(wedge.filters)} host float64 "
          f"inversions {info['inv_s']:.2f} s", flush=True)
    nchunks = len(pix_chunks(nsim, rime.Npix_cut))
    loss0, g0 = prob.value_and_grad()
    # a second evaluation at the same parameters: the backward's
    # index_add adds with atomics in no fixed order, and what the filter
    # leaves of the float32 gradient is near its rounding noise
    g1 = prob.value_and_grad()[1]
    rep = {k: relerr(g1[k].cpu().numpy(), g0[k].cpu().numpy()) for k in g0}
    print(f"phase 17 hera-filt: two evaluations at the start with "
          f"PyTorch's default algorithms, their gradients differ by "
          + ", ".join(f"{k} {v:.2e}" for k, v in rep.items())
          + " of each leaf's max (reported, not gated)", flush=True)
    del g1
    first = {ANTVECS: 1e-3, GAINS: 1e-3}
    opt = bt.LBFGS(prob, H0=first_step_H0(bt, torch, g0, first))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses, step_s, evals = [], [], []
    for _ in range(steps):
        t1 = time.time()
        losses.append(float(opt.step()))
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
        evals.append(opt.func_evals)
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    expect = nt * nchunks * opt.func_evals
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        chi2 = float(torch.sum(torch.abs(seq().data - tgt.data)
                               .to(torch.float64) ** 2))
        # the filtered noise's expected chi^2: sum over the bins of
        # baselines x times x |I - G|_F^2
        eye = torch.eye(nf, device=tgt.data.device)
        noise_chi2 = sum(n * nt * float(torch.sum((eye - f.G) ** 2))
                         for n, f in zip(bins["counts"], wedge.filters))
    dof = noise_chi2 - nparams / 2
    print(f"phase 17 hera-filt main path: L-BFGS (strong Wolfe, lr 1, H0 a "
          f"DiagMat giving a first trial step of at most "
          f"{first[ANTVECS] * 1e3:g} mm for antennas and {first[GAINS]:g} "
          f"for gain coefficients): start loss {float(loss0)}, losses "
          f"{losses}; step walls {step_s} s; function evaluations after "
          f"each step {evals}; rime_fwd launches {fwd}, rime_dtau launches "
          f"{dtau} (each expected {nt} times x {nchunks} chunks x "
          f"{opt.func_evals} evaluations = {expect}); peak device memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"phase 17 hera-filt result: chi^2 {chi2:.6e} over "
          f"{tgt.data.numel()} filtered visibilities; the filtered noise "
          f"alone gives {noise_chi2:.6e} (the bins' baselines x times x "
          f"|I - G|_F^2); chi^2/dof {chi2 / dof:.4f} (dof = that - "
          f"{nparams} / 2 = {dof:.0f}; reported, not gated)", flush=True)
    check(np.isfinite(float(loss0)) and all(np.isfinite(losses))
          and np.isfinite(chi2), "non-finite hera-filt loss")
    check(losses[-1] < float(loss0), "hera-filt loss did not decrease")
    check(fwd == expect and dtau == expect,
          f"hera-filt launches rime_fwd {fwd}, rime_dtau {dtau} != {expect}")
    check(peak < 20, f"hera-filt took {peak:.2f} GiB of device memory")

    # the filtered cube of float32 data (the chain's filter: products in
    # float64, output float32) against the same filter on float64 data,
    # from the same input (the unfiltered target); beside it the same
    # filters with G and the products in float32
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    freqs = np.asarray(rime.freqs)
    wedge32 = bt.WedgeFilter(
        [bt.MatFilter(G=f.G, residual=True, device=f.G.device,
                      dtype=torch.float32) for f in wedge.filters],
        wedge.filt2bls)
    with torch.no_grad():
        y32 = wedge(vd).data
        y32g = wedge32(vd).data
        vd64 = vd.copy()
        vd64.data = vd.data.to(torch.complex128)
        y64 = wedge(vd64).data
        rms_in = float(torch.sqrt(torch.mean(torch.abs(vd64.data) ** 2)))
        rms_out = float(torch.sqrt(torch.mean(torch.abs(y64) ** 2)))
        peak_in = float(torch.max(torch.abs(vd64.data)))
        err = float(torch.max(torch.abs(y32.to(torch.complex128) - y64)))
        errg = float(torch.max(torch.abs(y32g.to(torch.complex128) - y64)))
        del vd64, y64, y32g
        # the suppression of the foregrounds themselves: the chain at its
        # truth without the noise, filtered
        unf = bt.Sequential({"rime": seq.rime, "cal": seq.cal})
        clean = unf.updated(bt.ParamDict({
            k: torch.as_tensor(v, dtype=torch.float32, device=vd.data.device)
            for k, v in truth.items()}))()
        ft = bt.FFT(dim=4, N=nf, dx=freqs[1] - freqs[0], ndim=5,
                    window="bh", device=vd.data.device, dtype=torch.float64)
        rows = [np.where(bins["bin_of"] == b)[0]
                for b in np.unique(bins["bin_of"])]
        p_in = filt_band_power(torch, ft, clean.data, bins, rows)
        clean64 = clean.copy()
        clean64.data = clean.data.to(torch.complex128)
        sup = {k: filt_band_power(torch, ft, w(c).data, bins, rows) / p_in
               for k, w, c in (("float32 data", wedge, clean),
                               ("float32 G", wedge32, clean),
                               ("float64", wedge, clean64))}
        del clean, clean64
        pd = bt.PeakDelay(dim=4, N=nf, dx=freqs[1] - freqs[0], ndim=5,
                          window="bh", device=vd.data.device,
                          dtype=torch.float32)
        before = pd(vd.data)[0, 0].abs().cpu().numpy()
        after = pd(y32)[0, 0].abs().cpu().numpy()
    med = [(float(np.median(before[r])) * 1e9,
            float(np.median(after[r])) * 1e9) for r in rows]
    print(f"phase 17 hera-filt filter on float32 data (products in float64, "
          f"output float32) vs float64 data, on the card: max |y32 - y64| "
          f"{err:.3e} = {err / rms_in:.3e} of the input's rms {rms_in:.4e} "
          f"(tol 1e-5; its peak {peak_in:.4e}) and {err / rms_out:.3e} of "
          f"the filtered cube's rms {rms_out:.4e}; with G and the products "
          f"in float32: {errg:.3e} = {errg / rms_in:.3e} of the input's rms"
          f", {errg / peak_in:.3e} of its peak, {errg / rms_out:.3e} of the "
          f"filtered cube's rms", flush=True)
    print(f"phase 17 hera-filt suppression of the foregrounds (the chain at "
          f"its truth, no noise): power within each bin's band (|delay| <= "
          f"tau; blackman-harris window, float64 FFT), filtered / "
          f"unfiltered: " + "; ".join(
              f"{k} {[float(f'{v:.3e}') for v in x]}"
              for k, x in sup.items()), flush=True)
    print(f"phase 17 hera-filt PeakDelay (blackman-harris): median |peak "
          f"delay| of each bin [ns], unfiltered -> filtered: "
          + ", ".join(f"bin {b} (tau {tau * 1e9:.1f}) {m[0]:.1f} -> "
                      f"{m[1]:.1f}" for b, (tau, m) in
                      enumerate(zip(bins["tau"], med))), flush=True)
    check(err <= 1e-5 * rms_in,
          f"hera-filt float32 filter vs float64: {err / rms_in:.3e}")

    # the filter's time against its bound: M spectra through a real G,
    # one real product over the two planes (4 M nf^2 FLOPs), the cube
    # read once and written once
    x = vd.data
    M = x.numel() // nf
    flops = 4.0 * M * nf * nf
    nbytes = 2.0 * x.numel() * x.element_size()
    bound, by = rime_cuda.roofline_ms(flops, nbytes)
    G = wedge.filters[-1].G
    G32 = G.float()
    Gc = G32.to(torch.complex64)
    gy = torch.randn_like(x)
    with torch.no_grad():
        t = {"planes float64": cuda_ms(
                torch, lambda: linalg.apply_along(G, x, 4), 10),
             "planes float32": cuda_ms(
                torch, lambda: linalg.apply_along(G32, x, 4), 10),
             "complex64": cuda_ms(
                torch, lambda: linalg.apply_along(Gc, x, 4), 10),
             "WedgeFilter forward": cuda_ms(torch, lambda: wedge(vd), 10),
             "WedgeFilter forward, float32 G": cuda_ms(
                torch, lambda: wedge32(vd), 10)}

    def fwd_bwd(w):
        xg = x.detach().requires_grad_(True)
        v = vd.copy()
        v.data = xg
        torch.autograd.grad(w(v).data, xg, gy)
    t["WedgeFilter forward and backward"] = cuda_ms(
        torch, lambda: fwd_bwd(wedge), 5)
    t["WedgeFilter forward and backward, float32 G"] = cuda_ms(
        torch, lambda: fwd_bwd(wedge32), 5)
    print(f"phase 17 hera-filt filter times (CUDA events; {M} spectra of "
          f"{nf} channels, {flops:.4e} FLOPs, {nbytes:.4e} bytes; bound "
          f"{bound:.3f} ms ({by}) a pass): one G over the whole cube: "
          + ", ".join(f"{k} {v:.3f} ms "
                      f"({bound * (1 + ('backward' in k)) / v:.1%} of bound)"
                      for k, v in t.items()), flush=True)
    del x, gy, y32
    res = profile(torch, prob.value_and_grad,
                  "phase 17 profile of one function evaluation",
                  match=("gemm", "rime"))
    if res[0] is not None:
        busy, (gemm, rk) = res
        print(f"phase 17 device time of one function evaluation {busy:.2f} "
              f"ms: GEMM kernels {gemm:.2f} ms (the filter's, and the "
              f"RIME's small delay product), rime_fwd and rime_dtau "
              f"{rk:.2f} ms, the rest {busy - gemm - rk:.2f} ms", flush=True)
    return fwd, dtau


def img_bound_ms(rime_cuda, nf, nbl, npix, swapped):
    """The bound of one hera-img rime_fwd call over npix pixels: the
    role-swapped launch (baselines as K, complex ps, the real plane out,
    2 FMAs a triple), or the forward one (pixels as K, real ps, complex
    out, 2 FMAs a triple)."""
    if swapped:
        return kernel_bound_ms(rime_cuda, nf, nbl, npix, False, False)
    return kernel_bound_ms(rime_cuda, nf, npix, nbl, True, True)


def phase_img_kernels(torch, rime_cuda, mapper, rng, ncol=64):
    """Phase 18: rime_fwd at hera-img's two shapes (the first pixel
    chunk of time 0 and all 54,615 baselines, the delays split into
    float32 and its residual as the mapper passes them): the kernel
    against its plain version in float64 on ncol columns of its output
    (columns are independent), the launch timed beside its bound and
    its plain version. Returns {label: timing and error}."""
    sl = mapper._chunks(True)[0]
    f0, df = mapper._grid()
    nf, nbl = mapper.Nfreqs, mapper.Nbls
    out = {}
    for label, swapped in (("hera-img fwd", False), ("hera-img bwd", True)):
        tauT, lo = mapper._delays(0, sl, swapped)
        if swapped:
            ps = torch.as_tensor(
                rng.standard_normal((nf, nbl))
                + 1j * rng.standard_normal((nf, nbl)),
                dtype=torch.complex64, device=tauT.device)
        else:
            ps = torch.as_tensor(rng.standard_normal(
                (nf, tauT.shape[0])), dtype=torch.float32,
                device=tauT.device)
        K, N = tauT.shape
        cols = np.sort(rng.choice(N, ncol, replace=False))
        ct = torch.as_tensor(cols, device=tauT.device)
        kw = dict(conj=swapped, out_imag=not swapped, tauT_lo=lo)
        a = rime_cuda.rime_fwd(ps, tauT, f0, df, nf, **kw)
        b = rime_cuda.rime_fwd(ps, tauT, f0, df, nf, **kw)
        p64 = ps.to(torch.complex128 if swapped else torch.float64)
        ref = rime_cuda.rime_fwd_plain(p64, tauT[:, ct].double()
                                       + lo[:, ct].double(), f0, df, nf,
                                       conj=swapped, out_imag=not swapped)
        err = relerr(a[:, ct].cpu().numpy(), ref.cpu().numpy())
        ms = cuda_ms(torch, lambda: rime_cuda.rime_fwd(ps, tauT, f0, df, nf,
                                                       **kw), 5)
        kwc = dict(kw, tauT_lo=lo[:, ct])
        pms = cuda_ms(torch, lambda: rime_cuda.rime_fwd_plain(
            ps, tauT[:, ct], f0, df, nf, **kwc), 1) * N / ncol
        bms, by = (kernel_bound_ms(rime_cuda, nf, K, N, not swapped,
                                   not swapped))
        out[label] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                          max_abs_err=err)
        print(f"phase 18 rime_fwd {label} R={nf} K={K} N={N} ps_real="
              f"{not swapped} conj={swapped} out_imag={not swapped}: vs "
              f"float64 plain on {ncol} columns rel {err:.2e} (tol {TOL:g}); "
              f"two launches bit-equal {bool(torch.equal(a, b))}; kernel "
              f"{ms:.4f} ms, plain {pms:.1f} ms (float32, its {ncol}-column "
              f"time scaled to N), bound {bms:.4f} ms ({by}), kernel at "
              f"{bms / ms:.1%} of bound; no single PyTorch call computes "
              f"this fused function, so no library time", flush=True)
        check(err <= TOL, f"rime_fwd at {label} vs float64 plain: {err:.2e}")
        check(bool(torch.equal(a, b)), f"rime_fwd at {label}: launches "
              f"not bit-equal")
    return out


def phase_hera_img(bt, torch, rime_cuda, pix_chunks, size=HERA, npx=2048,
                   chans=(0, 341, 682, 1023)):
    """Phase 18: main path 11, hera-img, config #5's imaging at full
    width: hera-filt's chain (build_filt) at its truth plus noise, the
    cube before and after its WedgeFilter, imaged by one VisMapper onto
    the nside-32 HEALPix grid (unit weights, 'A2w', the chain's Airy
    power beam) through rime_fwd. Returns (rime_fwd launches, rime_dtau
    launches, the kernel checks at hera-img's shapes)."""
    from bayeslim_tpu_torch.utils import healpix as hp
    t0 = time.time()
    prob, _, info = build_filt(bt, device=None, dtype=torch.float32, **size)
    rime = prob.model.rime
    unf, filt = info["unfiltered"], prob.target[0]
    nside = size["nside"]
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    ra, dec = np.rad2deg(phi), 90 - np.rad2deg(theta)
    torch.cuda.synchronize()
    t1 = time.time()
    mapper = bt.VisMapper(unf, ra, dec, beam=rime.beam)
    torch.cuda.synchronize()
    chunks = mapper._chunks(True)
    ntime = len(mapper.times)
    print(f"phase 18 hera-img build: cubes {tuple(unf.data.shape)} "
          f"{unf.data.dtype} before and after the WedgeFilter (chain "
          f"{t1 - t0:.1f} s); VisMapper onto {len(ra)} nside-{nside} "
          f"pixels, {mapper.Npad} FOV pixels a time (padded), "
          f"{mapper.Nbls} baselines, {mapper.Nfreqs} channels, {ntime} "
          f"times, {len(chunks)} pixel chunks ({[c.stop - c.start if c.stop else mapper.Npad for c in chunks]}), "
          f"kernel route {mapper._kernel_route()}; mapper "
          f"{time.time() - t1:.1f} s", flush=True)
    check(mapper._kernel_route(), "hera-img mapper not on the kernel route")
    nb, nf, npad = mapper.Nbls, mapper.Nfreqs, mapper.Npad
    a_tb = nb * nf * npad * 8 / 1e12
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    calls = (("make_map unfiltered", lambda: mapper.make_map(
                 return_P=True, contract="diag"), 1),
             ("make_map filtered", lambda: mapper.make_map(
                 vd=filt, return_P=True, contract="diag"), 1))
    res, total = {}, 0
    with torch.no_grad():
        for label, fn, per in calls:
            rime_cuda.launches = rime_cuda.dtau_launches = 0
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res[label] = fn()
            b.record()
            b.synchronize()
            n = rime_cuda.launches
            expect = per * ntime * len(chunks)
            total += n
            print(f"phase 18 hera-img {label}: {a.elapsed_time(b):.1f} ms "
                  f"(CUDA events), rime_fwd launches {n} (expected {ntime} "
                  f"times x {len(chunks)} chunks = {expect}), rime_dtau "
                  f"{rime_cuda.dtau_launches}", flush=True)
            check(n == expect and rime_cuda.dtau_launches == 0,
                  f"hera-img {label}: launches {n} / "
                  f"{rime_cuda.dtau_launches}, expected {expect} / 0")
        maps, P = res["make_map unfiltered"]
        fmaps, _ = res["make_map filtered"]
        for label, fn, per in (
                ("compute_Am", lambda: mapper.compute_Am(maps), 1),
                ("compute_Pm", lambda: mapper.compute_Pm(maps), 2)):
            rime_cuda.launches = rime_cuda.dtau_launches = 0
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            n = rime_cuda.launches
            expect = per * ntime * len(chunks)
            total += n
            print(f"phase 18 hera-img {label} of the unfiltered map: "
                  f"{a.elapsed_time(b):.1f} ms (CUDA events), out "
                  f"{tuple(out.shape)}, finite "
                  f"{bool(torch.isfinite(out).all())}, rime_fwd launches "
                  f"{n} (expected {per} x {ntime} times x {len(chunks)} "
                  f"chunks = {expect}), rime_dtau {rime_cuda.dtau_launches}",
                  flush=True)
            check(n == expect and rime_cuda.dtau_launches == 0,
                  f"hera-img {label}: launches {n}, expected {expect}")
            check(bool(torch.isfinite(out).all()), f"hera-img {label} "
                  f"not finite")
            del out
    peak = torch.cuda.max_memory_allocated() / 2**30
    s_unf, s_filt = float(maps.abs().sum()), float(fmaps.abs().sum())
    print(f"phase 18 hera-img: peak device memory {peak:.2f} GiB ({base:.2f} "
          f"GiB held before the calls: the chain and both cubes); one time "
          f"of A (Nbls x Nfreqs x Npad complex64) would be {a_tb:.2f} TB; "
          f"maps {tuple(maps.shape)}, P {tuple(P.shape)} finite "
          f"{bool(torch.isfinite(maps).all() and torch.isfinite(P).all())}; "
          f"sum |m| unfiltered {s_unf:.6e}, filtered {s_filt:.6e} (ratio "
          f"{s_filt / s_unf:.3e}, must be < 0.5)", flush=True)
    check(bool(torch.isfinite(maps).all() and torch.isfinite(fmaps).all()
               and torch.isfinite(P).all()), "hera-img maps not finite")
    check(s_filt < 0.5 * s_unf, "hera-img: filtered map not suppressed")
    check(peak < 24, f"hera-img peak {peak:.1f} GiB")

    # the maps and the diagonal P at npx pixels and 4 channels against
    # the plain version in float64 (A built per time in pixel chunks) on
    # the same cubes and geometry (the antenna positions the cubes were
    # made at), with the chain's Airy beam built anew in float64
    rng = np.random.default_rng(0)
    fov = mapper._cut[0][mapper._mask[0]]
    sel = np.sort(rng.choice(fov, npx, replace=False))
    chans = list(chans)
    t2 = time.time()
    errs = []
    with torch.no_grad():
        vd64 = unf.select(freq_inds=chans, inplace=False)
        vd64.data = vd64.data.to(torch.complex128)
        beam64 = bt.PixelBeam(rime.beam.params.detach().double().cpu()
                              .numpy(), rime.freqs, R=bt.AiryResponse(),
                              pol="e", powerbeam=True, fov=180.0,
                              parameter=False, dtype=torch.float64)
        m64 = bt.VisMapper(vd64, ra[sel], dec[sel], beam=beam64,
                           use_kernel=False, dtype=torch.float64)
        for label, vd, m32, P32 in (("unfiltered", unf, maps, P),
                                    ("filtered", filt, fmaps, None)):
            v = vd64.copy()
            v.data = vd.data[..., chans].to(torch.complex128)
            ref, Pref = m64.make_map(vd=v, return_P=True, contract="diag")
            pairs = [("map", m32, ref)]
            if P32 is not None:
                pairs.append(("diagonal P", P32, Pref))
            for what, got, want in pairs:
                got = got[chans][:, sel].double()
                rms = float(torch.sqrt(torch.mean(want ** 2)))
                err = float((got - want).abs().max()) / rms
                errs.append(err)
                print(f"phase 18 hera-img {label} {what} vs the float64 "
                      f"plain version (beam in float64) at {npx} FOV "
                      f"pixels and channels {chans}: max |diff| / rms "
                      f"{err:.2e} (tol {TOL:g}), rms {rms:.4e}", flush=True)
    print(f"phase 18 hera-img float64 check {time.time() - t2:.1f} s",
          flush=True)
    check(max(errs) <= TOL, f"hera-img maps and P vs float64: "
          f"{max(errs):.2e}")
    for label, swapped in (("role-swapped (make_map, baselines as K)", True),
                           ("forward (compute_Am, pixels as K)", False)):
        bms = sum(img_bound_ms(rime_cuda, nf, nb, c.stop - c.start
                               if c.stop else npad, swapped)[0]
                  for c in chunks)
        print(f"phase 18 hera-img {label} launches: bound {bms:.3f} ms a "
              f"time (FP32 FMAs at 67 TFLOP/s over all {npad} pixels; "
              f"{2 * nf * nb * npad:.3e} FMAs)", flush=True)
    shapes = phase_img_kernels(torch, rime_cuda, mapper, rng)
    del mapper, unf, filt, maps, fmaps, P, prob
    torch.cuda.empty_cache()
    return total, 0, shapes


def phase_hera_coupling(bt, torch, rime_cuda, pix_chunks, size=HERA,
                        steps=3):
    """Phase 19: main path 12, hera-coupling at full width
    (build_coupling): the 630 groups simulated, inflated onto all 54,615
    cross baselines and coupled, then 1-pol gains; coupling terms and
    gains trainable; 3 Adam steps. Returns the rime_fwd launches."""
    t0 = time.time()
    prob, truth, terms = build_coupling(bt, device=None,
                                        dtype=torch.float32, **size)
    seq = prob.model
    rime, coupling = seq.rime, seq.coupling
    nant = len(rime.array.ants)
    nparams = {k: v.numel() for k, v in seq.named_parameters()}
    torch.cuda.synchronize()
    print(f"phase 19 hera-coupling build: {nant} antennas, "
          f"{len(rime.sim_bls)} groups simulated, inflated onto "
          f"{len(coupling.full_bls)} baselines and coupled, "
          f"{len(coupling.out_bls)} out; {len(terms)} coupling terms "
          f"(gen_coupling_terms, max_len {COUPLING_MAX_LEN} m, compressed "
          f"to redundant separations; one complex amplitude each, constant "
          f"in time and channel); trainable {nparams}; "
          f"{time.time() - t0:.1f} s", flush=True)
    trainer = bt.Trainer(prob, lr=1e-3)
    nchunks = len(pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    expect = steps * len(rime.sim_times) * nchunks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses, step_s = [], []
    for _ in range(steps):
        t1 = time.time()
        losses.append(float(trainer.step()))
        torch.cuda.synchronize()
        step_s.append(time.time() - t1)
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    ntf = len(rime.sim_times) * rime.Nfreqs
    flop = 4 * 8.0 * nant ** 3 * ntf
    bms = rime_cuda.roofline_ms(flop, 0)[0]
    print(f"phase 19 hera-coupling main path: Adam lr 1e-3, losses "
          f"{losses}; step walls {[round(s * 1e3, 1) for s in step_s]} ms; "
          f"rime_fwd launches {fwd} (expected {steps} steps x "
          f"{len(rime.sim_times)} times x {nchunks} chunks = {expect}; the "
          f"sky, beam and array are fixed, so no backward launch), "
          f"rime_dtau {dtau}; peak device memory {peak:.2f} GiB; the four "
          f"products of a forward {flop:.3e} FLOP, bound {bms:.2f} ms",
          flush=True)
    check(all(np.isfinite(losses)), "non-finite hera-coupling loss")
    check(losses[-1] < losses[0], "hera-coupling loss did not fall")
    check(fwd == expect and dtau == 0,
          f"hera-coupling launches {fwd} / {dtau}, expected {expect} / 0")
    # the coupling's forward alone, and one step under the profiler
    with torch.no_grad():
        vd = rime()
        ms = cuda_ms(torch, lambda: coupling(vd), 3)
    print(f"phase 19 hera-coupling RedVisCoupling forward {ms:.1f} ms "
          f"(CUDA events), {bms / ms:.1%} of the four products' bound",
          flush=True)
    del vd
    busy, gemm = profile(torch, trainer.step,
                         "phase 19 profile of one step", match="gemm")
    if busy is not None:
        print(f"phase 19 hera-coupling step: device {busy:.1f} ms, of it "
              f"GEMM kernels {gemm:.1f} ms ({gemm / busy:.1%}); the rest "
              f"{busy - gemm:.1f} ms", flush=True)
    del prob, trainer
    torch.cuda.empty_cache()
    return fwd


def avg_identity(torch, fit, bl2red, vd, avg, const):
    """The sufficient-statistics identity at the fit's current sky and
    beam: the full per-baseline chi^2 of the group model inflated onto
    vd's baselines (bl2red: baseline -> the fit's group row) against
    chi^2 of the model against the statistics avg plus const, over the
    fit's time batches, each model output cast to avg's dtype. Returns
    (full, stats + const, their sky / beam gradients as lists of numpy
    arrays, empty under torch.no_grad)."""
    from bayeslim_tpu_torch.inference.prob import _sum_chisq
    params = [p for p in fit.parameters() if p.requires_grad] \
        if torch.is_grad_enabled() else []
    gf = gs = [torch.zeros_like(p) for p in params]
    full = stats = 0.0
    for i in range(fit.Nbatch):
        fit.batch_idx = i
        out = fit()
        out.data = out.data.to(avg.data.dtype)
        sel = dict(time_inds=[i], inplace=False)
        a, d = avg.select(**sel), vd.select(**sel)
        infl = out.inflate_by_redundancy(bls=d.bls, bl2red=bl2red)
        cf = _sum_chisq(torch.abs(infl.data - d.data) ** 2 * d.icov)
        cs = _sum_chisq(torch.abs(out.data - a.data) ** 2 * a.icov)
        if params:
            gf = [x + y for x, y in zip(gf, torch.autograd.grad(
                cf, params, retain_graph=True))]
            gs = [x + y for x, y in zip(gs, torch.autograd.grad(cs, params))]
        full, stats = full + float(cf.detach()), stats + float(cs.detach())
        del out, infl, cf, cs
    fit.batch_idx = 0
    return full, stats + const, [g.cpu().numpy() for g in gf], \
        [g.cpu().numpy() for g in gs]


def phase_small_avg(bt, torch, rime_cuda, dev):
    """Phase 7, end: the hex-2 hera-avg cases on the card in float32
    (kernels, at TOL) and in float64 (plain path, at 1e-9) against the
    CPU in float64: the chain Sequential(RIME -> RedVisInflate ->
    JonesModel -> RedVisAvg) (loss and gradients through the segment
    sums), Difference of two time selections, and apply_cal(undo=True)
    of a 4-pol CalData from inflate_to_4pol."""
    from bayeslim_tpu_torch.data.containers import CalData, Difference
    cpu = build_avg_chain(bt, torch, "cpu", torch.float64)
    start = {k: v.detach().numpy() for k, v in
             cpu.collect_main_params().items()}
    vc, gc = cpu.value_and_grad()
    rng = np.random.default_rng(7)
    ants = cpu.model.cal.ants
    shp = (2, 2, len(cpu.target[0].bls), 4, 8)
    x = rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
    g = 1 + 0.1 * (rng.standard_normal((1, 1, len(ants), 4, 8))
                   + 1j * rng.standard_normal((1, 1, len(ants), 4, 8)))

    def data_ops(device, cdt):
        vd = bt.VisData()
        vd.setup_meta(cpu.target[0].telescope, cpu.target[0].antpos)
        vd.setup_data(cpu.target[0].bls, 2458168.3 + np.arange(4) * 5e-4,
                      np.linspace(100e6, 120e6, 8),
                      data=torch.as_tensor(x, dtype=cdt, device=device))
        diff = Difference(dict(time_inds=[0, 1]),
                          dict(time_inds=[2, 3]))(vd).data
        cd = CalData()
        cd.setup_data(ants, vd.times, vd.freqs, pol="ee",
                      data=torch.as_tensor(g, dtype=cdt, device=device))
        return diff, vd.apply_cal(cd.inflate_to_4pol(), undo=True).data

    want = data_ops("cpu", torch.complex128)
    for dtype, cdt, tol in ((torch.float32, torch.complex64, TOL),
                            (torch.float64, torch.complex128, 1e-9)):
        card = build_avg_chain(bt, torch, dev, dtype)
        card.target[0].data = cpu.target[0].data.to(cdt).to(dev)
        card.target[0].icov = cpu.target[0].icov.to(dtype).to(dev)
        bt.load_numpy_pdict(card.model, start)
        rime_cuda.launches = rime_cuda.dtau_launches = 0
        vg, gg = card.value_and_grad()
        n = (rime_cuda.launches, rime_cuda.dtau_launches)
        errs = {"loss": abs(float(vg) - float(vc)) / abs(float(vc))}
        errs.update({k: relerr(gg[k].cpu().numpy(), gc[k].numpy())
                     for k in gc})
        got = data_ops(dev, cdt)
        errs.update({"Difference": relerr(got[0].cpu().numpy(),
                                          want[0].numpy()),
                     "apply_cal 4-pol undo": relerr(got[1].cpu().numpy(),
                                                    want[1].numpy())})
        print(f"phase 7 card ({dtype}) vs CPU, hex-2 hera-avg chain "
              f"RIME -> RedVisInflate -> JonesModel -> RedVisAvg (launches "
              f"rime_fwd {n[0]}, rime_dtau {n[1]}), Difference of two time "
              f"selections, apply_cal(undo=True) of an inflate_to_4pol "
              f"CalData: " + ", ".join(f"{k} rel {v:.2e}"
                                       for k, v in errs.items())
              + f" (tol {tol:g})", flush=True)
        check(all(v <= tol for v in errs.values()),
              f"card vs CPU hera-avg ({dtype})")
        check((n[0] > 0) == (dtype == torch.float32) and n[1] == 0,
              f"hex-2 hera-avg launches {n}")


def phase_hera_avg(bt, torch, rime_cuda, pix_chunks, size=AVG, steps=3):
    """Phase 21: main path 14, hera-avg, HERA's reduction before a sky
    fit at full width: build_avg's chain simulated at 4 times with unit
    noise; the gains exported (JonesModel.to_CalData) and divided out
    (VisData.apply_cal(undo=True)); the time bins AVG_BINS averaged with
    LST rephasing; reduce_by_redundancy onto the 630 groups; a Dataset
    of the two averaged times fitted by Adam (sky and beam, over both
    batches); the fitted model inflated back (RedVisInflate) and its
    chi^2 against the averaged per-baseline cube. Gates: the noise-free
    calibrated cube against the inflated group output; bl_average and
    time_average on the card against the CPU in float64; the float64
    sufficient-statistics identity (value and gradients, 1e-9) and the
    float32 route's (value at its bar, gradients at AVG_G32_TOL); the
    losses fall; the launch counts; the fitted chi^2 below the start's
    by at least the losses' fall and equal to the statistics' plus
    const. Returns rime_fwd's launches on the path."""
    from bayeslim_tpu_torch.data.containers import RedVisInflate
    from bayeslim_tpu_torch.data.dataset import Dataset
    from bayeslim_tpu_torch.models.telescope import build_reds
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    seq, info = build_avg(bt, device=None, dtype=torch.float32, **size)
    rime, reds = seq.rime, info["reds"]
    nchunks = len(pix_chunks(len(reds), rime.Npix_cut))
    ntime = len(info["times"])
    torch.cuda.synchronize()
    build_s = time.time() - t0
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    t1 = time.time()
    groups, clean, vd = simulate_avg(bt, torch, seq, info)
    torch.cuda.synchronize()
    sim = (rime_cuda.launches, rime_cuda.dtau_launches)
    sim_s = time.time() - t1
    nbl, nf = vd.Nbls, vd.Nfreqs
    print(f"phase 21 hera-avg build: {len(info['arr'].ants)} antennas, "
          f"{len(reds)} redundant groups simulated at {ntime} times, "
          f"inflated to {nbl} baselines, {nf} freqs, {rime.Npix_cut} FOV "
          f"pixels; cube {tuple(vd.data.shape)} {vd.data.dtype}; build "
          f"{build_s:.1f} s, simulation {sim_s:.2f} s; rime_fwd / rime_dtau "
          f"launches {sim} (expected {ntime} times x {nchunks} chunks = "
          f"{ntime * nchunks}, 0)", flush=True)
    check(sim == (ntime * nchunks, 0), f"hera-avg simulation launches {sim}")

    # 2. the gains out and divided out
    cd = seq.cal.to_CalData(info["freqs"], info["times"], pol="ee",
                            telescope=info["T"], antpos=info["antpos"])
    check(cd.data.device == vd.data.device and not cd.data.requires_grad,
          "to_CalData: gains not detached on the card")
    cal = vd.apply_cal(cd, undo=True)
    ccl = vd.copy()
    ccl.data = clean
    ccl = ccl.apply_cal(cd, undo=True)
    infl = groups.inflate_by_redundancy(bls=info["data_bls"], bl2red={
        b: i for i, r in enumerate(reds) for b in r})
    rms = float(torch.sqrt(torch.mean(torch.abs(infl.data) ** 2)))
    cal_err = float(torch.abs(ccl.data - infl.data).max()) / rms
    del ccl, clean, infl
    print(f"phase 21 hera-avg calibration: to_CalData {tuple(cd.data.shape)} "
          f"on {cd.data.device}; the noise-free calibrated cube against the "
          f"RIME's group output inflated onto {nbl} baselines: max abs "
          f"{cal_err:.2e} of its rms {rms:.4e} (tol {TOL:g})", flush=True)
    check(cal_err <= TOL, f"hera-avg calibrated cube {cal_err:.2e}")

    # 3-4. time average with rephasing, then the redundant reduction
    tav = cal.time_average(time_inds=AVG_BINS, rephase=True)
    avg, const = tav.reduce_by_redundancy()
    # the groups it built (from antpos at its redtol), in its rows' order
    avg_reds = build_reds(info["antpos"], bls=tav.bls)[0]
    bl2row = {b: i for i, r in enumerate(avg_reds) for b in r}
    counts = np.asarray([len(r) for r in avg_reds], dtype=np.float32)
    icov_ok = bool(torch.equal(avg.icov[0, 0].cpu(), torch.as_tensor(
        2 * counts)[:, None, None].expand(-1, len(AVG_BINS), nf)))
    same = sorted(map(sorted, avg_reds)) == sorted(map(sorted, reds))
    print(f"phase 21 hera-avg reduction: time_average({AVG_BINS}, "
          f"rephase=True) -> {tuple(tav.data.shape)}; reduce_by_redundancy "
          f"-> {avg.Nbls} groups {tuple(avg.data.shape)} (the array's "
          f"groups: {same}), icov = 2 x member counts {icov_ok}, const "
          f"{const!r}", flush=True)
    check(same and icov_ok, "hera-avg reduce_by_redundancy groups / icov")

    # bl_average and time_average on a subset, card vs CPU float64
    sub_bls = np.sort(np.random.default_rng(3).choice(
        nbl, AVG_SUB_BLS, replace=False))
    sub = cal.select(bl_inds=sub_bls, freq_inds=list(AVG_SUB_FREQS),
                     inplace=False)
    s64 = sub.copy()
    s64.data = sub.data.cpu().to(torch.complex128)
    s64.icov = sub.icov.cpu().double()
    sub_err = {}
    for name, fn in (("bl_average", lambda v: v.bl_average()),
                     ("time_average(rephase=True)", lambda v: v.time_average(
                         time_inds=AVG_BINS, rephase=True))):
        a, b = fn(sub), fn(s64)
        sub_err[name] = relerr(a.data.cpu().numpy(), b.data.numpy())
        check(np.array_equal(a.blnums, b.blnums), f"{name} groups differ")
    print(f"phase 21 hera-avg on {AVG_SUB_BLS} baselines x "
          f"{len(AVG_SUB_FREQS)} channels, card (float32) vs CPU (float64): "
          + ", ".join(f"{k} rel {v:.2e}" for k, v in sub_err.items())
          + f" (tol {TOL:g})", flush=True)
    check(all(v <= TOL for v in sub_err.values()), "hera-avg ops vs CPU")

    # 5. the fit: a Dataset of the two averaged times
    fit = bt.RIME(rime.sky, info["T"], rime.beam, info["arr"], avg.bls,
                  [avg.times[:1], avg.times[1:]], info["freqs"],
                  pix_chunk=rime.pix_chunk)
    with torch.no_grad():
        rime.sky.params[0, 0, 0] *= 0.9
    ds = Dataset([avg.select(time_inds=[i], inplace=False)
                  for i in range(len(AVG_BINS))])
    prob = bt.LogProb(fit, ds)
    # the sufficient-statistics identity: the cube cast to float64 and
    # a float64 copy of the fit's model (the chunked plain path: a
    # float32 model would round the two routes' cotangents apart)
    tav64 = tav.copy()
    tav64.data = tav.data.to(torch.complex128)
    tav64.icov = tav.icov.double()
    avg64, const64 = tav64.reduce_by_redundancy()
    T, arr64, sky64, beam64, _ = build_sky_beam(
        bt, size["hexN"], size["nside"], size["nfreq"], size["fmax"], 0.5,
        False, None, torch.float64, np.random.default_rng(0), amp=1e4)
    with torch.no_grad():
        sky64.params.copy_(rime.sky.params)
        beam64.params.copy_(rime.beam.params)
    fit64 = bt.RIME(sky64, T, beam64, arr64, avg.bls,
                    [avg.times[:1], avg.times[1:]], info["freqs"],
                    pix_chunk=AVG_F64_CHUNK)
    t3 = time.time()
    f64, s64v, gf, gs = avg_identity(torch, fit64, bl2row, tav64, avg64,
                                     const64)
    id_s = time.time() - t3
    id_err = abs(s64v - f64) / abs(f64)
    g_err = max(relerr(b, a) for a, b in zip(gf, gs))
    del tav64, avg64, fit64, sky64, beam64
    # the route the fit runs: float32 through rime_fwd
    f32, s32v, gf32, gs32 = avg_identity(torch, fit, bl2row, tav, avg, const)
    id32 = abs(s32v - f32) / abs(f32)
    g32 = max(relerr(b, a) for a, b in zip(gf32, gs32))
    del gf32, gs32
    dbar = float(torch.abs(avg.data).max())
    bar = 4 * EPS32 * dbar ** 2 * float(torch.sum(avg.icov.double())) / f32
    print(f"phase 21 hera-avg sufficient statistics (model at the fit's "
          f"start; {id_s:.1f} s in float64, pixel chunks of "
          f"{AVG_F64_CHUNK}): float64: full chi^2 {f64!r}, statistics + const "
          f"{s64v!r}, rel {id_err:.2e} (tol 1e-9); sky / beam gradients rel "
          f"{g_err:.2e} of their largest (tol 1e-9); float32 route: full "
          f"{f32!r}, statistics + const {s32v!r}, rel {id32:.2e} against the "
          f"bar 4 eps32 max|dbar|^2 sum(W) / chi^2 = {bar:.2e} (max |dbar| "
          f"{dbar:.4e}); its gradients rel {g32:.2e} (tol {AVG_G32_TOL:g})",
          flush=True)
    check(id_err <= 1e-9 and g_err <= 1e-9,
          f"hera-avg identity {id_err:.2e}, gradients {g_err:.2e}")
    check(id32 <= bar and g32 <= AVG_G32_TOL,
          f"hera-avg float32 identity {id32:.2e}, gradients {g32:.2e}")

    trainer = bt.Trainer(prob, lr=1e-3)
    n0 = rime_cuda.launches, rime_cuda.dtau_launches
    torch.cuda.synchronize()
    losses, step_s = [], []
    for _ in range(steps):
        t2 = time.time()
        losses.append(float(trainer.step()))
        torch.cuda.synchronize()
        step_s.append(time.time() - t2)
    fit_n = (rime_cuda.launches - n0[0], rime_cuda.dtau_launches - n0[1])
    expect = steps * 2 * len(AVG_BINS) * nchunks
    prob.update(trainer.pdict)
    print(f"phase 21 hera-avg fit: Adam (lr 1e-3) on sky and beam from "
          f"0.9 x the truth's amplitudes over a Dataset of {len(ds)} "
          f"one-time targets, losses {losses}; step walls {step_s} s; "
          f"rime_fwd / rime_dtau launches {fit_n} (expected {steps} steps x "
          f"2 x {len(AVG_BINS)} times x {nchunks} chunks = {expect}, 0)",
          flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and all(b < a for a, b in zip(losses, losses[1:])),
          "hera-avg losses did not fall")
    check(fit_n == (expect, 0), f"hera-avg fit launches {fit_n}")

    # 6. the fitted model inflated back, chi^2 against the averaged cube
    with torch.no_grad():
        model = bt.concat_VisData(fit.run_batches(concat=False), "time")
    back = RedVisInflate(tav.bls, bl2red=bl2row)(model)
    chi2 = float(torch.sum(tav.chisq(back).double()))
    fit_s = float(torch.sum(avg.chisq(model).double())) + const
    fit_id = abs(fit_s - chi2) / abs(chi2)
    dof = tav.data.numel()
    path = rime_cuda.launches
    print(f"phase 21 hera-avg fitted model inflated onto {back.Nbls} "
          f"baselines: chi^2 {chi2!r} over {dof} visibilities "
          f"(chi^2/dof {chi2 / dof:.4f}), at the start {f32!r} (fell by "
          f"{f32 - chi2!r}); statistics + const at the fit {fit_s!r}, rel "
          f"{fit_id:.2e} (bar {bar:.2e}); rime_fwd launches on the path "
          f"{path}", flush=True)
    # the loss is chi^2 / 2 plus a constant, and the fitted parameters
    # are a step past the last loss: the full chi^2 falls by more than
    # twice the losses' fall (held at once, for room over rounding)
    check(np.isfinite(chi2) and f32 - chi2 >= losses[0] - losses[-1],
          f"hera-avg fitted chi^2 {chi2!r} fell by {f32 - chi2!r} from the "
          f"start's, less than the losses' {losses[0] - losses[-1]!r}")
    check(fit_id <= bar, f"hera-avg identity at the fit {fit_id:.2e}")

    # each operation by CUDA events beside its bytes bound
    N4, N2, NG = vd.data.numel(), tav.data.numel(), avg.data.numel()
    ops = (("apply_cal(undo=True)", lambda: vd.apply_cal(cd, undo=True),
            16 * N4 + 8 * cd.data.numel()),
           ("time_average(rephase=True)", lambda: cal.time_average(
               time_inds=AVG_BINS, rephase=True), 12 * N4 + 12 * N2),
           ("bl_average", lambda: tav.bl_average(reds=avg_reds),
            12 * N2 + 12 * NG),
           ("reduce_by_redundancy", lambda: tav.reduce_by_redundancy(
               reds=avg_reds), 12 * N2 + 12 * NG),
           ("inflate_by_redundancy", lambda: model.inflate_by_redundancy(
               bls=tav.bls, bl2red=bl2row), 8 * NG + 8 * N2))
    times = {}
    with torch.no_grad():
        for name, fn, nbytes in ops:
            ms = cuda_ms(torch, fn, 3)
            bms = rime_cuda.roofline_ms(0.0, nbytes)[0]
            times[name] = ms
            print(f"phase 21 hera-avg time: {name} {ms:.3f} ms, bytes bound "
                  f"{bms:.3f} ms ({nbytes / 1e9:.3f} GB at "
                  f"{rime_cuda.PEAK_BYTES / 1e12:.2f} TB/s), at "
                  f"{bms / ms:.1%} of bound", flush=True)
    print(f"phase 21 hera-avg peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del seq, vd, cal, tav, avg, prob, trainer, fit, model, back, groups
    torch.cuda.empty_cache()
    return path


def hess_fd_rows(torch, prob, key, rows, h):
    """Central differences of the float64 gradient of key along its
    first raveled coordinates rows: (len(rows), n) numpy."""
    pd = prob.collect_main_params()
    x0 = pd[key].detach().clone()
    out = []
    for i in rows:
        gs = []
        for sgn in (1.0, -1.0):
            x = x0.clone().reshape(-1)
            x[i] += sgn * h
            pd2 = pd.copy()
            pd2[key] = x.reshape(x0.shape)
            gs.append(prob.value_and_grad(pd2)[1][key].reshape(-1))
        out.append(((gs[0] - gs[1]) / (2 * h)).cpu().numpy())
    return np.stack(out)


def phase_hera_hess(bt, torch, rime_cuda, pix_chunks, size=HERA, nrows=6,
                    hess_chunk=256, h=1e-4):
    """Phase 20: main path 13, hera-hess: hera-cal's chain through 3
    L-BFGS steps, FactoredInvHessian.from_lbfgs over its 678,881
    parameters (probe vectors only), compute_hessian's first nrows rows
    over the antenna positions in float64 on the card inside
    force_chunked (no launch), held against central differences of the
    float64 gradient and the float32 chain's rows; a double backward
    outside the context raises its named error. Returns the solve's
    (rime_fwd, rime_dtau) launches."""
    from bayeslim_tpu_torch.inference import hessian
    t0 = time.time()
    prob, _ = build_cal(bt, device=None, dtype=torch.float32, **size)
    seq = prob.model
    loss0, g0 = prob.value_and_grad()
    opt = bt.LBFGS(prob, H0=first_step_H0(bt, torch, g0,
                                          {ANTVECS: 1e-3, GAINS: 1e-3}))
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    losses = [float(opt.step()) for _ in range(3)]
    torch.cuda.synchronize()
    solve = (rime_cuda.launches, rime_cuda.dtau_launches)
    n = opt.x.numel()
    print(f"phase 20 hera-hess solve: hera-cal's chain, {n} parameters, "
          f"3 L-BFGS steps, losses {float(loss0)} -> {losses}, "
          f"{len(opt.s_hist)} pairs kept, line-search steps t_hist "
          f"{opt.t_hist}, {opt.func_evals} evaluations, rime_fwd / "
          f"rime_dtau launches {solve}; {time.time() - t0:.1f} s",
          flush=True)
    t1 = time.time()
    fih = bt.FactoredInvHessian.from_lbfgs(opt)
    gen = torch.Generator(device=opt.x.device).manual_seed(3)
    v, w = (torch.randn(n, generator=gen, device=opt.x.device,
                        dtype=opt.x.dtype) for _ in range(2))
    hv, hw, lv = fih.hvp(v), fih.hvp(w), fih.lvp(v)
    torch.cuda.synchronize()
    a, b = float(w.double() @ hv.double()), float(v.double() @ hw.double())
    vhv = float(v.double() @ hv.double())
    sym = abs(a - b) / max(abs(a), abs(b))
    print(f"phase 20 hera-hess FactoredInvHessian.from_lbfgs on the card: "
          f"{len(fih.u)} factored pairs over {fih.N} parameters, nothing "
          f"dense; <w, Hv> {a:.6e}, <v, Hw> {b:.6e} (rel {sym:.2e}), "
          f"<v, Hv> {vhv:.6e}, lvp finite "
          f"{bool(torch.isfinite(lv).all())}; {time.time() - t1:.2f} s",
          flush=True)
    check(len(fih.u) > 0 and sym <= TOL and vhv > 0
          and bool(torch.isfinite(lv).all()), "hera-hess factored inverse")

    # outside force_chunked: a double backward through the fused kernels
    x = seq.rime.array.antvecs.detach().clone().requires_grad_(True)
    rime_cuda.launches = 0
    g, = torch.autograd.grad(prob(bt.ParamDict({ANTVECS: x})), x,
                             create_graph=True)
    named = False
    try:
        torch.autograd.grad(g.sum(), x)
    except RuntimeError as e:
        named = "force_chunked" in str(e)
        print(f"phase 20 hera-hess double backward outside force_chunked "
              f"(rime_fwd launches {rime_cuda.launches}): {e}", flush=True)
    check(named and rime_cuda.launches > 0, "hera-hess: a double backward "
          "through the fused kernels did not raise the named error")
    del g, x

    # the row block in float64 on the card at the solved parameters
    solved = {k: v.detach().cpu().double().numpy()
              for k, v in seq.named_parameters()}
    sz = dict(size, pix_chunk=hess_chunk)
    seq.rime.pix_chunk = hess_chunk
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    t2 = time.time()
    rows32, _ = hessian.compute_hessian(prob, keys=[ANTVECS], Nstart=0,
                                        Nrows=nrows)
    torch.cuda.synchronize()
    s32 = time.time() - t2
    del prob, opt, fih, seq
    torch.cuda.empty_cache()
    p64, _ = build_cal(bt, device=None, dtype=torch.float64, **sz)
    bt.load_numpy_pdict(p64.model, solved)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t3 = time.time()
    H, idx = hessian.compute_hessian(p64, keys=[ANTVECS], Nstart=0,
                                     Nrows=nrows)
    torch.cuda.synchronize()
    wall = time.time() - t3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = (rime_cuda.launches, rime_cuda.dtau_launches)
    Hn = H.cpu().numpy()
    sub = Hn[:, :nrows]
    asym = float(np.abs(sub - sub.T).max() / np.abs(sub).max())
    t4 = time.time()
    fd = hess_fd_rows(torch, p64, ANTVECS, range(nrows), h)
    fd_err = relerr(Hn, fd)
    e32 = relerr(rows32.double().cpu().numpy(), Hn)
    print(f"phase 20 hera-hess compute_hessian(keys=[antenna positions], "
          f"Nstart=0, Nrows={nrows}) in float64 on the card: H "
          f"{tuple(H.shape)} over {idx[ANTVECS].stop} positions, "
          f"{wall:.1f} s ({wall / nrows:.2f} s a row, forward-over-reverse "
          f"through the chunked RIME path, pixel chunks of {hess_chunk}), "
          f"peak device memory {peak:.2f} GiB; kernel launches inside "
          f"force_chunked: rime_fwd {launches[0]}, rime_dtau {launches[1]}; "
          f"{nrows}x{nrows} block asymmetry {asym:.2e}; against central "
          f"differences of the float64 gradient (h {h:g} m, "
          f"{time.time() - t4:.1f} s) rel {fd_err:.2e}; the float32 "
          f"chain's rows ({s32:.1f} s) against these rel {e32:.2e}",
          flush=True)
    check(launches == (0, 0), f"hera-hess launched kernels {launches}")
    check(np.isfinite(Hn).all() and asym <= 1e-8,
          f"hera-hess block not symmetric: {asym:.2e}")
    check(fd_err <= 1e-6, f"hera-hess rows vs finite differences {fd_err:.2e}")
    del p64, H
    torch.cuda.empty_cache()
    return solve


def io_seq_dict(sky_pkl, hexN, nfreq, fmax, ntime, pix_chunk):
    """hera-cal's chain (build_cal) as build_prob's seq_dict: the sky a
    pickle path; the Airy beam (fixed), the telescope, the array (redtol
    0.5, antenna positions trainable), the RIME (the redundant groups'
    first baselines simulated, expanded to every cross baseline) and
    the JonesModel (1-pol unit gains as real pairs, refant the first
    antenna) as kwargs dicts."""
    from bayeslim_tpu_torch.utils import make_hex
    ants, antvecs = make_hex(hexN, D=15.0)
    freqs = np.linspace(100e6, fmax, nfreq)
    gains = np.zeros((1, 1, len(ants), 1, nfreq, 2))
    gains[..., 0] = 1.0
    rime = dict(
        sky=sky_pkl, telescope=dict(location=LOC),
        beam=dict(kind="airy", params=np.ones((1, 1, 1, 1, 2)) * 14.0,
                  freqs=freqs, pol="e", powerbeam=True, fov=180.0,
                  parameter=False),
        array=dict(ants=ants, antvecs=antvecs, freqs=freqs, redtol=0.5,
                   parameter=True),
        sim_bls=dict(uniq_bls=True, keep_autos=False),
        data_bls=dict(keep_autos=False),
        times=2458168.3 + np.arange(ntime) * 5e-4, freqs=freqs,
        pix_chunk=pix_chunk)
    cal = dict(kind="jones", params=gains, ants=ants, refant=ants[0])
    return dict(order=["rime", "cal"], kind=["rime", "calibration"],
                mdict=dict(rime=rime, cal=cal))


def io_target(bt, torch, io, seq_dict, device, dtype, seed=0):
    """hera-io's target: the chain (built from seq_dict) at cal_truth
    plus complex noise of unit variance (a seeded torch.Generator), icov
    ones, as a VisData."""
    sim = io.build_sequential(**seq_dict, device=device, dtype=dtype)
    rime = sim.rime
    truth = cal_truth(rime.array.ants, rime.array.to_antpos().asnumpy(),
                      rime.Nfreqs, 0.01, 0.05)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with torch.no_grad():
        data = sim.updated(bt.ParamDict({
            k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in truth.items()}))().data
        for part in (data.real, data.imag):
            part += np.sqrt(0.5) * torch.randn(
                data.shape, generator=gen, dtype=dtype, device=device)
    tgt = bt.VisData()
    tgt.setup_meta(rime.telescope, rime.array.to_antpos())
    tgt.setup_data(rime.data_bls, rime.all_sim_times, rime.freqs, pol="ee",
                   data=data, icov=torch.ones(data.shape, dtype=dtype,
                                              device=device))
    return tgt


def _yaml_plain(x):
    """x with numpy arrays and scalars as lists and Python numbers, for
    yaml.safe_dump (floats keep every bit through YAML)."""
    if isinstance(x, dict):
        return {k: _yaml_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_yaml_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x.item() if isinstance(x, np.generic) else x


def io_yaml_chains(io, seq_dict, target, work, device, dtype):
    """The path a user takes from a YAML config: seq_dict with its sky
    the bundled demo_powerlaw_cat.yaml (build_sky(catfile=), a PointSky)
    and its JonesModel a write_pkl pickle (build_calibration(modfile=)),
    the rest as in seq_dict, dumped to a YAML file; load_yaml then
    build_prob(**config), beside build_prob(seq_dict=...) of the same
    chain from the kwargs dicts. Returns (the YAML build, the kwargs
    build, the YAML file's path); needs yaml."""
    import copy

    import yaml

    from bayeslim_tpu_torch.data import CONFIG_PATH
    kw = copy.deepcopy(seq_dict)
    rime = kw["mdict"]["rime"]
    rime["sky"] = dict(catfile=os.path.join(CONFIG_PATH,
                                            "demo_powerlaw_cat.yaml"),
                       freqs=rime["freqs"])
    cal_pkl = os.path.join(work, "cal.pkl")
    io.write_pkl(cal_pkl, io.build_calibration(
        **kw["mdict"]["cal"], device=device, dtype=dtype), overwrite=True)
    cfg = copy.deepcopy(kw)
    cfg["mdict"]["cal"] = dict(modfile=cal_pkl)
    cfg_path = os.path.join(work, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(dict(seq_dict=_yaml_plain(cfg)), f)
    from_yaml = io.build_prob(**io.load_yaml(cfg_path), data=target,
                              device=device, dtype=dtype)
    from_kwargs = io.build_prob(seq_dict=kw, data=target, device=device,
                                dtype=dtype)
    return from_yaml, from_kwargs, cfg_path


def _event_ms(torch, fn):
    """fn's result and its time in ms by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def phase_hera_io(bt, torch, rime_cuda, pix_chunks, size=HERA, device=None):
    """Phase 22: main path 15, hera-io, the file layer at full width
    (see the module docstring). Returns rime_fwd's and rime_dtau's
    launches on the path."""
    import importlib.util
    import shutil

    from bayeslim_tpu_torch.data import DATA_PATH, io
    from bayeslim_tpu_torch.data import uvdata_interface as uv
    from bayeslim_tpu_torch.utils import checkpoint as ck
    from bayeslim_tpu_torch.utils import logging as blog
    dev = bt.resolve_device(device)
    work = os.path.join(ROOT, "build", "hera_io")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.reset_peak_memory_stats()
    dt = torch.float32
    size = dict(size)
    nside = size.pop("nside")
    t0 = time.time()
    _, _, sky, _, _ = build_sky_beam(
        bt, size["hexN"], nside, size["nfreq"], size["fmax"], 0.5, True, dev,
        dt, np.random.default_rng(0), amp=1e4)
    sky_pkl = os.path.join(work, "sky.pkl")
    io.write_pkl(sky_pkl, sky)
    del sky
    sd = io_seq_dict(sky_pkl, **size)
    tgt = io_target(bt, torch, io, sd, dev, dt)

    def build():
        return io.build_prob(seq_dict=sd, data=tgt, device=dev, dtype=dt)
    prob = build()
    torch.cuda.synchronize()
    build_s = time.time() - t0
    rime = prob.model.rime
    nsim = len(rime.sim_bls)
    ntime = len(rime.all_sim_times)
    per_eval = ntime * len(pix_chunks(nsim, rime.Npix_cut))
    nparams = sum(p.numel() for p in prob.model.parameters())
    print(f"phase 22 hera-io build: sky pickle {os.path.getsize(sky_pkl)} "
          f"bytes, chain by build_prob(seq_dict=...) from it and kwargs "
          f"dicts: {len(rime.array.ants)} antennas, {nsim} groups "
          f"simulated, {len(rime.data_bls)} data baselines, {rime.Nfreqs} "
          f"freqs, {ntime} times, {rime.Npix_cut} FOV pixels, {nparams} "
          f"trainable parameters; target {tuple(tgt.data.shape)} "
          f"{tgt.data.dtype} as a VisData; {build_s:.1f} s", flush=True)

    # 2. one evaluation's launches, as phase 6's; the same bits twice?
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    l1, g1 = prob.value_and_grad()
    one = (rime_cuda.launches, rime_cuda.dtau_launches)
    check(one == (per_eval, per_eval),
          f"hera-io evaluation launches {one} != phase 6's "
          f"({per_eval}, {per_eval})")
    (l2, g2), eval_ms = _event_ms(torch, prob.value_and_grad)
    same = float(l1) == float(l2) and all(torch.equal(g1[k], g2[k])
                                          for k in g1.keys())
    print(f"phase 22 hera-io evaluation: loss {float(l1)}; rime_fwd / "
          f"rime_dtau launches {one} (phase 6: {per_eval} each an "
          f"evaluation); a second evaluation {eval_ms:.3f} ms (CUDA "
          f"events), bit-equal to the first with PyTorch's default "
          f"algorithms: {same}", flush=True)
    del g1, g2
    evals = 2

    def adam(params):
        return torch.optim.Adam(params, lr=IO_LR)
    log_path = os.path.join(work, "train.jsonl")
    logger = blog.get_logger("hera_io", jsonl_path=log_path)
    metrics = blog.Metrics()

    def fit(trainer, steps, mgr, walls, saves):
        for _ in range(steps):
            _, ms = _event_ms(torch, lambda: trainer.train(1))
            walls.append(ms)
            step = len(trainer.loss_history) - 1
            t = time.perf_counter()
            mgr.maybe_save(step, trainer.pdict, trainer.opt, every=1,
                           extra={"losses": list(trainer.loss_history)})
            saves.append(time.perf_counter() - t)

    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    # 3. the uninterrupted fit
    mgr_a = ck.CheckpointManager(os.path.join(work, "run_a"), max_to_keep=2)
    ta = bt.Trainer(prob, optimizer=adam, Nreport=1, metrics=metrics,
                    logger=logger, verbose=False)
    walls, saves = [], []
    fit(ta, IO_STEPS, mgr_a, walls, saves)
    evals += IO_STEPS
    kept = mgr_a.all_steps()
    ck_bytes = os.path.getsize(os.path.join(mgr_a.directory,
                                            f"{kept[-1]}.pt"))
    ref_losses = list(ta.loss_history)
    ref_params = {k: v.detach().clone() for k, v in ta.pdict.items()}
    # 4. interrupted after IO_SPLIT steps, rebuilt, restored, resumed
    mgr_b = ck.CheckpointManager(os.path.join(work, "run_b"), max_to_keep=2)
    tb = bt.Trainer(build(), optimizer=adam, verbose=False)
    walls_b, saves_b = [], []
    fit(tb, IO_SPLIT, mgr_b, walls_b, saves_b)
    del tb
    tc = bt.Trainer(build(), optimizer=adam, verbose=False)
    t = time.perf_counter()
    st = mgr_b.restore_latest(like={"params": tc.pdict, "opt_state": tc.opt})
    restore_s = time.perf_counter() - t
    tc.loss_history = list(st["extra"]["losses"])
    walls_c, saves_c = [], []
    fit(tc, IO_STEPS - IO_SPLIT, mgr_b, walls_c, saves_c)
    evals += IO_STEPS
    torch.use_deterministic_algorithms(det)
    resumed = tc.loss_history == ref_losses and all(
        torch.equal(tc.pdict[k], ref_params[k]) for k in ref_params)
    for h in list(logger.handlers):
        h.flush()
    events = [json.loads(ln) for ln in open(log_path)]
    print(f"phase 22 hera-io fit: Adam (lr {IO_LR}) under "
          f"torch.use_deterministic_algorithms, losses {ref_losses}; step "
          f"walls {walls} ms (CUDA events); Metrics {metrics.summary()}; "
          f"{len(events)} JSON-lines events; checkpoints kept "
          f"{kept} (max_to_keep 2), {ck_bytes} bytes each, written in "
          f"{[round(x * 1e3, 3) for x in saves]} ms (atomic: a temporary "
          f"file, fsync, os.replace)", flush=True)
    print(f"phase 22 hera-io resume: {IO_SPLIT} steps (walls {walls_b} ms), "
          f"a fresh build restored from step {st['step']}'s "
          f"checkpoint in {restore_s * 1e3:.3f} ms, {IO_STEPS - IO_SPLIT} "
          f"more (walls {walls_c} ms): losses {tc.loss_history}; losses and "
          f"final parameters bit-equal to the uninterrupted run's: "
          f"{resumed}", flush=True)
    check(all(np.isfinite(ref_losses)) and ref_losses[-1] < ref_losses[0],
          f"hera-io losses do not fall: {ref_losses}")
    check(kept == list(range(IO_STEPS - 2, IO_STEPS)),
          f"hera-io checkpoints kept {kept}")
    check(len(events) == IO_STEPS and metrics.summary()["loss"]["n"]
          == IO_STEPS, "hera-io logger / metrics records")
    check(resumed, "hera-io resumed fit differs from the uninterrupted one")
    del tc, st

    # 5. the fitted chain through a pickle
    model_pkl = os.path.join(work, "chain.pkl")
    t = time.perf_counter()
    io.write_pkl(model_pkl, prob.model)
    w_s = time.perf_counter() - t
    t = time.perf_counter()
    chain = io.read_pkl(model_pkl, device=dev)
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t
    with torch.no_grad():
        la = float(prob())
        lb = float(bt.LogProb(chain, prob.target)())
    evals += 2
    print(f"phase 22 hera-io pickle: the fitted chain {os.path.getsize(model_pkl)} "
          f"bytes, write_pkl {w_s * 1e3:.1f} ms, read_pkl(device='cuda') "
          f"{r_s * 1e3:.1f} ms; loss {la} against {lb}, bit-equal "
          f"{la == lb}", flush=True)
    check(la == lb, "hera-io pickled chain's loss differs")

    # 6. the fitted gains through calfits, on the card; the bundled file
    arr = chain.rime.array
    cd = chain.cal.to_CalData(rime.freqs, rime.all_sim_times, pol="ee",
                              telescope=rime.telescope,
                              antpos=arr.to_antpos())
    cd.data = cd.data.to(torch.complex128).expand(
        -1, -1, -1, ntime, -1).contiguous()
    cd.flags = np.zeros(tuple(cd.data.shape), bool)
    cal_path = os.path.join(work, "gains.calfits")
    t = time.perf_counter()
    uv.write_calfits(cd, cal_path)
    cw_s = time.perf_counter() - t
    t = time.perf_counter()
    back = uv.read_calfits(cal_path, device=dev)
    torch.cuda.synchronize()
    cr_s = time.perf_counter() - t
    exact = (back.data.device == cd.data.device
             and torch.equal(back.data, cd.data)
             and np.array_equal(back.flags, cd.flags)
             and back.ants == cd.ants
             and np.allclose(back.times, cd.times, rtol=0, atol=1e-9)
             and np.allclose(back.freqs, cd.freqs, rtol=1e-12))
    bundled = os.path.join(DATA_PATH, "demo_hex7_gains.calfits")
    bc, bh = (uv.read_calfits(bundled, device=d) for d in (dev, "cpu"))
    same_b = bc.data.device == cd.data.device and torch.equal(
        bc.data.cpu(), bh.data)
    print(f"phase 22 hera-io calfits: gains {tuple(cd.data.shape[2:])} "
          f"{cd.data.dtype}, {os.path.getsize(cal_path)} bytes, "
          f"write_calfits {cw_s * 1e3:.1f} ms, read_calfits onto the card "
          f"{cr_s * 1e3:.1f} ms, exact {exact}; the bundled "
          f"demo_hex7_gains.calfits {tuple(bc.data.shape)} on the card "
          f"equal to the CPU read: {same_b}", flush=True)
    check(exact, "hera-io calfits round trip not exact")
    check(same_b, "hera-io bundled calfits: card read != CPU read")

    # 7. a YAML config with a bundled catalogue sky, where yaml is present
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("h5py", "yaml", "pyuvdata")}
    yaml_fwd = 0
    if have["yaml"]:
        f0 = rime_cuda.launches
        t = time.time()
        py, pk, cfg_path = io_yaml_chains(io, sd, tgt, work, dev, dt)
        torch.cuda.synchronize()
        yb_s = time.time() - t
        with torch.no_grad():
            ly, lk = float(py()), float(pk())
        prt = py.model.rime
        yaml_fwd = 2 * ntime * len(pix_chunks(nsim, prt.Npix_cut))
        got = rime_cuda.launches - f0
        print(f"phase 22 hera-io YAML: load_yaml + build_prob of a "
              f"{os.path.getsize(cfg_path)}-byte config (the sky "
              f"demo_powerlaw_cat.yaml, {prt.Npix_cut} sources in the FOV; "
              f"the gains a pickle), beside the kwargs build, both on the "
              f"card: {yb_s:.1f} s; loss {ly} against {lk}, bit-equal "
              f"{ly == lk}; rime_fwd launches {got} (expected {yaml_fwd})",
              flush=True)
        check(np.isfinite(ly) and ly == lk,
              f"hera-io YAML build's loss {ly} != kwargs build's {lk}")
        check(prt.Npix_cut > 0 and got == yaml_fwd,
              f"hera-io YAML builds' launches {got} != {yaml_fwd}")
        del py, pk
    else:
        print("phase 22 hera-io YAML: yaml absent, the config path not run",
              flush=True)

    # 8. HDF5 where h5py is absent
    h5_path = os.path.join(work, "target.h5")
    if have["h5py"]:
        small = tgt.select(bl_inds=[0, 1], inplace=False)
        small.write_hdf5(h5_path)
        note = "h5py present: a 2-baseline VisData written to HDF5"
    else:
        try:
            tgt.write_hdf5(h5_path)
        except ImportError as e:
            check("h5py" in str(e), f"ImportError not naming h5py: {e}")
            note = f"VisData.write_hdf5 raised ImportError: {e}"
        else:
            check(False, "write_hdf5 ran without h5py")
    fwd, dtau = rime_cuda.launches, rime_cuda.dtau_launches
    expect = (per_eval * evals + yaml_fwd, per_eval * (evals - 2))
    print(f"phase 22 hera-io packages present {have}; {note}; rime_fwd / "
          f"rime_dtau launches on the path {(fwd, dtau)} (expected "
          f"{expect}: {evals} evaluations of the pixel-sky chain, the "
          f"last 2 forward only, and {yaml_fwd} of the YAML step); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; {smi()}", flush=True)
    check((fwd, dtau) == expect, f"hera-io launches {(fwd, dtau)} != {expect}")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    shutil.rmtree(work, ignore_errors=True)
    return fwd, dtau


def shard_rank(rank, world, stage, workdir, backend):
    """One rank of phase 23 (a spawned process): on card rank % count,
    joins the stage's process group through a file:// store in workdir
    with a timeout on every collective, runs SHARD_STAGES[stage] and
    pickles its report (peak memory added). A failure writes the
    traceback and exits non-zero; the parent then kills the other
    ranks."""
    import pickle
    import traceback
    try:
        import torch
        sys.path.insert(0, ROOT)
        import bayeslim_tpu_torch as bt
        from bayeslim_tpu_torch.parallel import multihost
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        multihost.initialize(
            init_method="file://" + os.path.join(workdir, "store"),
            world_size=world, rank=rank, backend=backend,
            timeout=SHARD_COLL_S, device=dev)
        rep = SHARD_STAGES[stage](bt, torch, rank, world)
        rep["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        rep["card"] = str(dev)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(rep, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def run_shard_stage(stage, world, backend="gloo"):
    """Spawn the stage's ranks, join them within SHARD_STAGE_S, kill any
    still running; fail with the ranks' tracebacks. Returns (the ranks'
    reports, seconds)."""
    import multiprocessing as mp
    import pickle
    import shutil
    workdir = os.path.join(ROOT, "build", "shard", f"{stage}-{backend}")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ctx = mp.get_context("spawn")
    t0 = time.time()
    procs = [ctx.Process(target=shard_rank,
                         args=(r, world, stage, workdir, backend))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(t0 + SHARD_STAGE_S - time.time(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = [open(os.path.join(workdir, f"err{r}.txt")).read()
            for r in range(world)
            if os.path.exists(os.path.join(workdir, f"err{r}.txt"))]
    codes = [p.exitcode for p in procs]
    check(not hung and not errs and all(c == 0 for c in codes),
          f"phase 23 stage {stage} ({backend}): ranks still running after "
          f"{SHARD_STAGE_S} s {hung} (killed), exit codes {codes}\n"
          + "\n".join(errs))
    reps = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            reps.append(pickle.load(f))
    return reps, time.time() - t0


def _shard_evals(torch, rime_cuda, C, sprob, n):
    """n timed evaluations of a sharded posterior: (loss, gradients,
    walls [s], (rime_fwd, rime_dtau) launches, collective stats)."""
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    C.reset_stats()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t1 = time.time()
        v, g = sprob.value_and_grad()
        torch.cuda.synchronize()
        walls.append(time.time() - t1)
    return (v, g, walls, (rime_cuda.launches, rime_cuda.dtau_launches),
            dict(C.STATS))


def _shard_errs(v, g, ref):
    """(loss rel. error, {leaf: max |dg| / max |g_ref|}) against the
    single-process (loss, gradients)."""
    return (abs(float(v) - ref[0]) / abs(ref[0]),
            {k: relerr(g[k].cpu().numpy(), ref[1][k].cpu().numpy())
             for k in ref[1]})


def shard_stage_a(bt, torch, rank, world):
    """Stage A (rank side): hera-filt's chain (build_filt, its filter at
    SHARD_FILT_NOISE, a suppression of 100: this checks the sharding,
    not config #5's own 1e9 filter, whose float32 gradient is rounding
    noise, ROADMAP C10) at 4 times, built whole on every rank, its times
    over {'data': world}, under torch.use_deterministic_algorithms (the
    backward's index_add then adds in a fixed order). Rank 0 evaluates
    the whole chain twice (the same bits), the single-process reference.
    Then SHARD_EVALS timed sharded evaluations and SHARD_STEPS L-BFGS
    steps (a digest of the parameters after each), then the filtered
    target imaged with the channels split over the ranks, against rank
    0's whole map."""
    import gc
    import hashlib
    import torch.distributed as dist
    from bayeslim_tpu_torch.ops import rime_cuda
    from bayeslim_tpu_torch.ops.rime_cuda import _pix_chunks
    from bayeslim_tpu_torch.parallel import ShardedLogProb, make_mesh
    from bayeslim_tpu_torch.parallel import collectives as C
    from bayeslim_tpu_torch.parallel.multihost import local_block
    from bayeslim_tpu_torch.utils import healpix as hp
    t0 = time.time()
    prob, _, info = build_filt(bt, device=None, dtype=torch.float32,
                               noise=SHARD_FILT_NOISE, **SHARD)
    torch.cuda.synchronize()
    rep = dict(build_s=time.time() - t0)
    filt = prob.target[0]
    del info
    mesh = make_mesh({"data": world})
    ref = None
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    if rank == 0:
        (v, g), (v2, g2) = prob.value_and_grad(), prob.value_and_grad()
        rep["deterministic_repeat"] = float(v) == float(v2) and all(
            torch.equal(g[k], g2[k]) for k in g)
        ref = (float(v), g)
        del g2
    sprob = ShardedLogProb(prob, mesh)
    del prob
    rime = sprob.model.rime
    nt = len(rime.sim_times)
    nchunks = len(_pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    rep.update(mesh=dict(mesh.axis_sizes), times=nt, chunks=nchunks,
               data_shape=tuple(sprob.prob.target[0].data.shape))
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    v, g, walls, launches, coll = _shard_evals(torch, rime_cuda, C, sprob,
                                               SHARD_EVALS)
    rep.update(loss=float(v), eval_walls_s=walls, eval_launches=launches,
               eval_expect=nt * nchunks * SHARD_EVALS, eval_coll=coll)
    if ref is not None:
        rep["errs"] = _shard_errs(v, g, ref)
        del ref
    first = {ANTVECS: 1e-3, GAINS: 1e-3}
    opt = bt.LBFGS(sprob, H0=first_step_H0(bt, torch, g, first))
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    C.reset_stats()
    losses, walls, digests = [], [], []
    for _ in range(SHARD_STEPS):
        torch.cuda.synchronize()
        t1 = time.time()
        losses.append(float(opt.step()))
        torch.cuda.synchronize()
        walls.append(time.time() - t1)
        digests.append(hashlib.sha256(b"".join(
            p.detach().cpu().numpy().tobytes()
            for p in opt.pdict.values())).hexdigest())
    rep.update(start_loss=float(v), lbfgs_losses=losses,
               lbfgs_walls_s=walls, digests=digests, evals=opt.func_evals,
               lbfgs_launches=(rime_cuda.launches, rime_cuda.dtau_launches),
               lbfgs_expect=nt * nchunks * opt.func_evals,
               lbfgs_coll=dict(C.STATS))
    beam = rime.beam
    del opt, sprob, rime, g
    gc.collect()
    torch.cuda.empty_cache()
    theta, phi = hp.pix2ang(SHARD["nside"],
                            np.arange(hp.nside2npix(SHARD["nside"])))
    mapper = bt.VisMapper(filt, np.rad2deg(phi), 90 - np.rad2deg(theta),
                          beam=beam)
    lo, hi = local_block(mapper.Nfreqs, world, rank)
    mapper.set_freq_inds(np.arange(lo, hi))
    rime_cuda.launches = 0
    C.reset_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.time()
        maps, _ = mapper.make_map(return_P=True, contract="diag")
        torch.cuda.synchronize()
        rep.update(img_s=time.time() - t1, img_launches=rime_cuda.launches,
                   img_expect=len(mapper.times) * len(mapper._chunks(True)),
                   img_chans=(lo, hi))
        allmaps = torch.cat(C.all_gather(maps, mesh.group("data")), dim=-2)
        rep["img_coll"] = dict(C.STATS)
        if rank == 0:
            mapper.set_freq_inds(None)
            full, _ = mapper.make_map(return_P=True, contract="diag")
            d = torch.abs(allmaps.double() - full.double())
            at = np.unravel_index(int(torch.argmax(d)), tuple(d.shape))
            rep.update(
                img_err=float(d.max()) / float(full.abs().max()),
                img_err_rms=float(d.max()) / float(
                    torch.sqrt(torch.mean(full.double() ** 2))),
                img_worst=(tuple(int(i) for i in at), float(full[at])),
                img_shape=tuple(full.shape))
    torch.use_deterministic_algorithms(det)
    return rep


def shard_stage_b(bt, torch, rank, world):
    """Stage B (rank side): hera-cal's chain (build_cal) at full width,
    its 630 simulated groups and 54,615 data baselines over {'model':
    world}: each rank simulates its groups, gathers the simulated cube
    and expands onto its data baselines; the Jones block auto-pinned and
    cut. Rank 0 also evaluates the whole chain. SHARD_EVALS timed
    evaluations."""
    import gc
    import torch.distributed as dist
    from bayeslim_tpu_torch.ops import rime_cuda
    from bayeslim_tpu_torch.ops.rime_cuda import _pix_chunks
    from bayeslim_tpu_torch.parallel import ShardedLogProb, make_mesh
    from bayeslim_tpu_torch.parallel import collectives as C
    t0 = time.time()
    prob, _ = build_cal(bt, device=None, dtype=torch.float32, **HERA)
    torch.cuda.synchronize()
    rep = dict(build_s=time.time() - t0)
    mesh = make_mesh({"model": world})
    ref = None
    if rank == 0:
        v, g = prob.value_and_grad()
        ref = (float(v), g)
    sprob = ShardedLogProb(prob, mesh, time_axis=None, bl_axis="model")
    del prob
    seq = sprob.model
    rime = seq.rime
    nt = len(rime.sim_times)
    nchunks = len(_pix_chunks(len(rime.sim_bls), rime.Npix_cut))
    rep.update(mesh=dict(mesh.axis_sizes), times=nt, chunks=nchunks,
               sim=len(rime.sim_bls), data=len(rime.data_bls),
               gain_idx=len(seq.cal._g1_idx),
               data_shape=tuple(sprob.prob.target[0].data.shape))
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    v, g, walls, launches, coll = _shard_evals(torch, rime_cuda, C, sprob,
                                               SHARD_EVALS)
    rep.update(loss=float(v), eval_walls_s=walls, eval_launches=launches,
               eval_expect=nt * nchunks * SHARD_EVALS, eval_coll=coll)
    if ref is not None:
        rep["errs"] = _shard_errs(v, g, ref)
    return rep


def shard_stage_c(bt, torch, rank, world):
    """Stage C (rank side), build_nmp's hex-3 posterior (2 Gaussian beam
    models, Nmp > 1; sky, beams and antennas trainable) on {'model':
    world}: baseline-sharded (each rank regroups its baselines by
    model pair on the host), then with the device baseline -> pair map
    pinned (the dispatch's device branch: every pair over all local
    baselines, mask-selected) against the host grouping, then
    shard_pixels over 'model' (the kernel on the local pixels). Rank 0
    evaluates the whole posterior for the reference."""
    from bayeslim_tpu_torch.ops import rime_cuda
    from bayeslim_tpu_torch.ops.rime_cuda import _pix_chunks
    from bayeslim_tpu_torch.parallel import (ShardedLogProb, make_mesh,
                                             shard_pixels)
    from bayeslim_tpu_torch.parallel import collectives as C
    prob, nmp = build_nmp(bt, None, torch.float32)
    mesh = make_mesh({"model": world})
    ref = None
    if rank == 0:
        v, g = prob.value_and_grad()
        ref = (float(v), g)

    def expect(rime, mp_idx, passes, npairs=None):
        """Launches of one evaluation of the grouped dispatch: one a
        pair (every pair with a device map), time and pixel chunk,
        times passes."""
        K = rime.Npix_cut
        mp = np.asarray(mp_idx)
        pairs = range(npairs) if npairs else np.unique(mp)
        nb = [len(mp) if npairs else int((mp == m).sum()) for m in pairs]
        return passes * len(rime.sim_times) * sum(
            len(_pix_chunks(n, K)) for n in nb)

    rep = dict(mesh=dict(mesh.axis_sizes), nmp=nmp)
    sprob = ShardedLogProb(prob, mesh, time_axis=None, bl_axis="model")
    rime = sprob.model
    mp_loc = rime._mp_groups[0][2]
    torch.distributed.barrier()
    v, g, walls, launches, coll = _shard_evals(torch, rime_cuda, C, sprob, 1)
    rep.update(
        host=dict(loss=float(v), launches=launches, walls_s=walls,
                  coll=coll, times=len(rime.sim_times),
                  bls=len(rime.sim_bls), pairs=len(np.unique(mp_loc)),
                  expect=(expect(rime, mp_loc, 2), expect(rime, mp_loc, 1))))
    if ref is not None:
        rep["host"]["errs"] = _shard_errs(v, g, ref)
    host = (float(v), g)
    npairs = int(rime._mp_groups[0][0].shape[0])
    rime._mp_idx_dev = {0: torch.as_tensor(
        mp_loc, device=prob.target[0].data.device)}
    v2, g2, walls, launches, coll = _shard_evals(torch, rime_cuda, C, sprob,
                                                 1)
    rep["devmap"] = dict(
        launches=launches, walls_s=walls, coll=coll,
        errs=_shard_errs(v2, g2, host),
        expect=(expect(rime, mp_loc, 2, npairs),
                expect(rime, mp_loc, 1, npairs)))
    del rime._mp_idx_dev
    rime_px = shard_pixels(prob.model, mesh, pix_axis="model")
    ppx = bt.LogProb(rime_px, prob.target)
    mp_all = rime_px._mp_groups[0][2]
    rime_cuda.launches = rime_cuda.dtau_launches = 0
    C.reset_stats()
    torch.cuda.synchronize()
    t1 = time.time()
    v3, g3 = ppx.value_and_grad()
    torch.cuda.synchronize()
    rep["pixels"] = dict(
        loss=float(v3), walls_s=[time.time() - t1],
        launches=(rime_cuda.launches, rime_cuda.dtau_launches),
        coll=dict(C.STATS), K=(prob.model.Npix_cut, rime_px.Npix_cut),
        expect=(expect(rime_px, mp_all, 2), expect(rime_px, mp_all, 1)))
    if ref is not None:
        rep["pixels"]["errs"] = _shard_errs(v3, g3, ref)
    return rep


def shard_stage_bc(bt, torch, rank, world):
    """Stages B and C in one spawn of ranks (one start-up)."""
    return {"b": shard_stage_b(bt, torch, rank, world),
            "c": shard_stage_c(bt, torch, rank, world)}


SHARD_STAGES = {"a": shard_stage_a, "bc": shard_stage_bc}


def _shard_rank_line(label, r, rep, part):
    """One rank's report line of a stage part."""
    c = part.get("coll", {})
    return (f"phase 23 hera-shard {label} rank {r} ({rep['card']}): "
            f"walls {[round(w * 1e3, 2) for w in part['walls_s']]} ms, "
            f"launches rime_fwd {part['launches'][0]}, rime_dtau "
            f"{part['launches'][1]} (expected {part['expect']}), "
            f"collectives {c.get('calls', 0)} calls {c.get('ms', 0.0):.2f} "
            f"ms {c.get('bytes', 0)} B (host wall, waits for the peers "
            f"included), peak {rep['peak_gib']:.2f} GiB")


def _shard_check_errs(label, errs, against="single-process (rank 0)"):
    loss, grads = errs
    print(f"phase 23 hera-shard {label} vs {against}: loss "
          f"rel {loss:.2e} (bar {SHARD_LOSS_TOL:g}), gradients " + ", ".join(
              f"{k} {v:.2e}" for k, v in grads.items())
          + f" of each leaf's max (bar {TOL:g})", flush=True)
    check(loss <= SHARD_LOSS_TOL and all(v <= TOL for v in grads.values()),
          f"hera-shard {label} sharded vs single-process: {errs}")


def phase_hera_shard(bt, torch, rime_cuda):
    """Phase 23: main path 16, hera-shard, config #5 run whole over
    ranks (parallel/ on torch.distributed): stage A on 2 ranks, stages B
    and C on 3 (the SHARD_STAGES functions), ranks that share the card
    over gloo, then stage A over NCCL with one rank a card where two or
    more cards are visible. Returns (rime_fwd, rime_dtau) launches of
    the ranks' sharded paths, summed."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    ndev = torch.cuda.device_count()
    print(f"phase 23 hera-shard: backend gloo, the ranks of each stage "
          f"sharing cuda:0 ({smi()}); {ndev} card(s) visible; the "
          f"collectives all-gathers of the card's tensors "
          f"(parallel/collectives.py)", flush=True)
    fwd = dtau = 0

    def stage_a(backend, world):
        nonlocal fwd, dtau
        reps, secs = run_shard_stage("a", world, backend)
        label = f"A ({backend}, {world} ranks, mesh {reps[0]['mesh']})"
        print(f"phase 23 hera-shard {label}: hera-filt's chain at "
              f"{SHARD['ntime']} times, {reps[0]['times']} a rank, local "
              f"target {reps[0]['data_shape']}, {reps[0]['chunks']} pixel "
              f"chunk(s); builds {[round(r['build_s'], 1) for r in reps]} s; "
              f"stage {secs:.1f} s", flush=True)
        for r, rep in enumerate(reps):
            ev = dict(walls_s=rep["eval_walls_s"],
                      launches=rep["eval_launches"],
                      expect=rep["eval_expect"], coll=rep["eval_coll"])
            print(_shard_rank_line(label + " evaluations", r, rep, ev),
                  flush=True)
            lb = dict(walls_s=rep["lbfgs_walls_s"],
                      launches=rep["lbfgs_launches"],
                      expect=rep["lbfgs_expect"], coll=rep["lbfgs_coll"])
            print(_shard_rank_line(label + " L-BFGS", r, rep, lb)
                  + f"; losses {rep['lbfgs_losses']} from "
                  f"{rep['start_loss']}, {rep['evals']} evaluations",
                  flush=True)
            for part in (ev, lb):
                check(part["launches"] == (part["expect"],) * 2,
                      f"hera-shard {label} rank {r} launches "
                      f"{part['launches']} != {part['expect']}")
            fwd += rep["eval_launches"][0] + rep["lbfgs_launches"][0] \
                + rep["img_launches"]
            dtau += rep["eval_launches"][1] + rep["lbfgs_launches"][1]
            print(f"phase 23 hera-shard {label} imaging rank {r}: channels "
                  f"{rep['img_chans']} in {rep['img_s'] * 1e3:.1f} ms, "
                  f"rime_fwd launches {rep['img_launches']} (expected "
                  f"{rep['img_expect']}: times x pixel chunks), the maps "
                  f"gathered in {rep['img_coll']['ms']:.2f} ms", flush=True)
            check(rep["img_launches"] == rep["img_expect"],
                  f"hera-shard {label} imaging rank {r} launches "
                  f"{rep['img_launches']} != {rep['img_expect']}")
        print(f"phase 23 hera-shard {label}: the filter's noise "
              f"{SHARD_FILT_NOISE:g} I; under "
              f"torch.use_deterministic_algorithms two single-process "
              f"evaluations the same bits: "
              f"{reps[0]['deterministic_repeat']}", flush=True)
        check(reps[0]["deterministic_repeat"],
              f"hera-shard {label}: deterministic evaluations differ")
        _shard_check_errs(label, reps[0]["errs"])
        same = all(r["digests"] == reps[0]["digests"]
                   and r["lbfgs_losses"] == reps[0]["lbfgs_losses"]
                   and r["loss"] == reps[0]["loss"] for r in reps)
        print(f"phase 23 hera-shard {label}: losses and parameters after "
              f"each L-BFGS step the same bits on every rank: {same}; the "
              f"channel-split maps {reps[0]['img_shape']} against the "
              f"single-process make_map: {reps[0]['img_err']:.2e} of its "
              f"max |m| (bar {TOL:g}), {reps[0]['img_err_rms']:.2e} of its "
              f"rms, the largest difference at (channel, pixel) "
              f"{reps[0]['img_worst'][0]} where the map is "
              f"{reps[0]['img_worst'][1]:.4g}", flush=True)
        check(same, f"hera-shard {label}: ranks differ")
        check(reps[0]["lbfgs_losses"][-1] < reps[0]["start_loss"],
              f"hera-shard {label}: L-BFGS loss did not fall")
        check(reps[0]["img_err"] <= TOL,
              f"hera-shard {label} maps: {reps[0]['img_err']}")

    stage_a("gloo", 2)
    reps, secs = run_shard_stage("bc", 3)
    print(f"phase 23 hera-shard B and C (gloo, 3 ranks): one spawn, "
          f"{secs:.1f} s", flush=True)
    reps_b = [r["b"] for r in reps]
    label = f"B (gloo, 3 ranks, mesh {reps_b[0]['mesh']})"
    print(f"phase 23 hera-shard {label}: hera-cal's chain, "
          f"{reps_b[0]['sim']} simulated groups and {reps_b[0]['data']} data "
          f"baselines a rank (Jones indices pinned and cut: "
          f"{reps_b[0]['gain_idx']}), local target {reps_b[0]['data_shape']}; "
          f"builds {[round(r['build_s'], 1) for r in reps_b]} s", flush=True)
    for r, rep in enumerate(reps_b):
        rep["card"], rep["peak_gib"] = reps[r]["card"], reps[r]["peak_gib"]
        ev = dict(walls_s=rep["eval_walls_s"], launches=rep["eval_launches"],
                  expect=rep["eval_expect"], coll=rep["eval_coll"])
        print(_shard_rank_line(label, r, rep, ev), flush=True)
        check(ev["launches"] == (ev["expect"],) * 2,
              f"hera-shard {label} rank {r} launches {ev['launches']}")
        check(rep["loss"] == reps_b[0]["loss"], f"hera-shard {label}: rank "
              f"{r}'s loss differs")
        fwd += ev["launches"][0]
        dtau += ev["launches"][1]
    _shard_check_errs(label, reps_b[0]["errs"])
    reps_c = [r["c"] for r in reps]
    label = f"C (gloo, 3 ranks, mesh {reps_c[0]['mesh']})"
    print(f"phase 23 hera-shard {label}: build_nmp's hex-3 posterior, "
          f"{reps_c[0]['nmp']} model pairs, {reps_c[0]['host']['bls']} "
          f"baselines and {reps_c[0]['host']['times']} time(s) a rank",
          flush=True)
    for r, rep in enumerate(reps_c):
        rep["card"], rep["peak_gib"] = reps[r]["card"], reps[r]["peak_gib"]
        for part in ("host", "devmap", "pixels"):
            p = rep[part]
            print(_shard_rank_line(f"{label} {part}", r, rep, p), flush=True)
            check(p["launches"] == p["expect"], f"hera-shard {label} "
                  f"{part} rank {r} launches {p['launches']} != "
                  f"{p['expect']}")
            fwd += p["launches"][0]
            dtau += p["launches"][1]
    _shard_check_errs(f"{label} Nmp > 1 baseline-sharded",
                      reps_c[0]["host"]["errs"])
    for r, rep in enumerate(reps_c):
        _shard_check_errs(f"{label} rank {r} device mp_idx", rep["devmap"]
                          ["errs"], "the host grouping")
    print(f"phase 23 hera-shard {label} shard_pixels: padded FOV cut "
          f"{reps_c[0]['pixels']['K'][0]} pixels, "
          f"{reps_c[0]['pixels']['K'][1]} a rank", flush=True)
    _shard_check_errs(f"{label} shard_pixels", reps_c[0]["pixels"]["errs"])
    if ndev >= 2:
        stage_a("nccl", 2)
    else:
        print("phase 23 hera-shard NCCL: not run (one card visible; NCCL "
              "takes one rank a card)", flush=True)
    print(f"phase 23 hera-shard: {time.time() - t0:.1f} s; launches on "
          f"the sharded paths, summed over the ranks: rime_fwd {fwd}, "
          f"rime_dtau {dtau}", flush=True)
    return fwd, dtau


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "bayeslim_tpu_torch")):
        print("chip_smoke: bayeslim_tpu_torch/ not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import bayeslim_tpu_torch as bt
    from bayeslim_tpu_torch.ops import rime_cuda
    from bayeslim_tpu_torch.ops.rime_cuda import _pix_chunks
    from bayeslim_tpu_torch.scripts import hera_prod
    from bayeslim_tpu_torch.scripts import mosaic_spike as spike

    dev = torch.device("cuda")
    card = smi()
    print(card, flush=True)
    print(f"phase 1 setup: torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    t0 = time.time()
    built = rime_cuda.build()
    for src, (path, secs, report) in built.items():
        regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
        print(f"phase 1 build: {src} -> {os.path.relpath(path, ROOT)} "
              f"nvcc {secs:.1f} s; {' | '.join(regs)}", flush=True)
    print(f"phase 1 build total {time.time() - t0:.1f} s", flush=True)
    phase_build(torch, rime_cuda, dev, built)

    f0, df = 100e6, 100e6 / 1023
    rng = np.random.default_rng(0)
    worst_fwd = phase_fwd_vs_plain(torch, rime_cuda, dev, rng, f0, df)
    worst_dtau = phase_dtau_vs_plain(torch, rime_cuda, dev, rng, f0, df)
    phase_function(torch, rime_cuda, dev, rng, f0, df)
    rime, sim_bls, stat_launches = phase_hera_stat(bt, torch, rime_cuda,
                                                   _pix_chunks)
    cal_fwd, cal_dtau = phase_hera_cal(bt, torch, rime_cuda, _pix_chunks)
    phase_small(bt, torch, rime_cuda, dev, hera_prod)

    # ---- 8. times at the main paths' shapes and the kernels' bounds
    R, K, N = rime.Nfreqs, rime.Npix_cut, len(sim_bls)
    timing = []
    for label, (Rr, Kk, Nn), ps_real, conj, out_imag in (
            ("forward", (R, K, N), True, False, True),
            ("backward", (R, N, K), False, True, False)):
        ps, tauT = rand_case(rng, Rr, Kk, Nn, ps_real)
        ps32 = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                               else torch.complex64, device=dev)
        tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
        ms = cuda_ms(torch, lambda: rime_cuda.rime_fwd(
            ps32, tau32, f0, df, R, conj, out_imag), 20)
        pms = cuda_ms(torch, lambda: rime_cuda.rime_fwd_plain(
            ps32, tau32, f0, df, R, conj, out_imag), 3)
        bms, by = kernel_bound_ms(rime_cuda, Rr, Kk, Nn, ps_real, out_imag)
        timing.append((ms, pms, bms, by))
        print(f"phase 8 times: rime_fwd {label} R={Rr} K={Kk} N={Nn} "
              f"ps_real={ps_real} out_imag={out_imag}: kernel {ms:.4f} ms, "
              f"plain {pms:.3f} ms, bound {bms:.4f} ms ({by}), kernel at "
              f"{bms / ms:.1%} of bound; no single PyTorch call computes "
              f"this fused function, so no library time", flush=True)
        # the K split against one slice (a launch, not counted)
        _, _, per_sm, sms = rime_cuda.fwd_info(dev, ps_real, out_imag)
        S, _ = rime_cuda.fwd_plan(Rr, Kk, Nn, R, sms, per_sm)
        nms = cuda_ms(torch, lambda: rime_cuda._launch_fwd(
            ps32, tau32, f0, df, R, conj, out_imag, 1, Kk), 20)
        print(f"phase 8 K split: rime_fwd {label}: {S} slices (used) "
              f"{ms:.4f} ms, one slice {nms:.4f} ms", flush=True)
    # hera-prod: 4 stacked rows a channel, complex ps, complex output
    prod_t = {}
    for label, Kk, Nn, conj in PROD_SHAPES:
        Rr = 4 * R
        ps, tauT = rand_case(rng, Rr, Kk, Nn, False)
        ps32 = torch.as_tensor(ps, dtype=torch.complex64, device=dev)
        tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
        ms = cuda_ms(torch, lambda: rime_cuda.rime_fwd(
            ps32, tau32, f0, df, R, conj, True), 20)
        pms = cuda_ms(torch, lambda: rime_cuda.rime_fwd_plain(
            ps32, tau32, f0, df, R, conj, True), 3)
        bms, by = kernel_bound_ms(rime_cuda, Rr, Kk, Nn, False, True)
        _, _, per_sm, sms = rime_cuda.fwd_info(dev, False, True)
        S, _ = rime_cuda.fwd_plan(Rr, Kk, Nn, R, sms, per_sm)
        prod_t[label] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
        print(f"phase 8 times: rime_fwd {label} R={Rr} K={Kk} N={Nn} "
              f"ps_real=False conj={conj} out_imag=True: kernel {ms:.4f} ms, "
              f"plain {pms:.3f} ms, bound {bms:.4f} ms ({by}), kernel at "
              f"{bms / ms:.1%} of bound; {S} K slices; no single PyTorch "
              f"call computes this fused function, so no library time",
              flush=True)
    # hera-alm: one row a channel, 128 channels over 100-200 MHz, the
    # whole FOV in one launch
    alm_t = {}
    nfa = ALM["nfreq"]
    dfa = (ALM["fmax"] - f0) / (nfa - 1)
    for label, Kk, Nn, ps_real, conj, out_imag in ALM_SHAPES:
        ps, tauT = rand_case(rng, nfa, Kk, Nn, ps_real)
        ps32 = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                               else torch.complex64, device=dev)
        tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
        ms = cuda_ms(torch, lambda: rime_cuda.rime_fwd(
            ps32, tau32, f0, dfa, nfa, conj, out_imag), 20)
        pms = cuda_ms(torch, lambda: rime_cuda.rime_fwd_plain(
            ps32, tau32, f0, dfa, nfa, conj, out_imag), 3)
        bms, by = kernel_bound_ms(rime_cuda, nfa, Kk, Nn, ps_real, out_imag)
        _, _, per_sm, sms = rime_cuda.fwd_info(dev, ps_real, out_imag)
        S, _ = rime_cuda.fwd_plan(nfa, Kk, Nn, nfa, sms, per_sm)
        alm_t[label] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
        print(f"phase 8 times: rime_fwd {label} R={nfa} K={Kk} N={Nn} "
              f"ps_real={ps_real} conj={conj} out_imag={out_imag}: kernel "
              f"{ms:.4f} ms, plain {pms:.3f} ms, bound {bms:.4f} ms ({by}), "
              f"kernel at {bms / ms:.1%} of bound; {S} K slices; no single "
              f"PyTorch call computes this fused function, so no library "
              f"time", flush=True)
    # hera-cal: real ps (a power beam on a Stokes-I sky), conj False; the
    # complex-ps variant at the same shape beside it
    dtau_t = {}
    for ps_real in (True, False):
        ps, tauT = rand_case(rng, R, K, N, ps_real)
        ct = rng.standard_normal((R, N)) + 1j * rng.standard_normal((R, N))
        ps32 = torch.as_tensor(ps, dtype=torch.float32 if ps_real
                               else torch.complex64, device=dev)
        tau32 = torch.as_tensor(tauT, dtype=torch.float32, device=dev)
        ct32 = torch.as_tensor(ct, dtype=torch.complex64, device=dev)
        dms = cuda_ms(torch, lambda: rime_cuda.rime_dtau(
            ct32, ps32, tau32, f0, df, R), 20)
        dpms = cuda_ms(torch, lambda: rime_cuda.rime_dtau_plain(
            ct32, ps32, tau32, f0, df, R), 3)
        dbms, dby = dtau_bound_ms(rime_cuda, R, K, N, ps_real)
        dtau_t[ps_real] = (dms, dpms, dbms, dby)
        old = (f"; the previous design (one output a thread, double "
               f"seeds) ran {DTAU_BEFORE_MS} ms here on an NVIDIA H100 80GB "
               f"HBM3 at 700 W, {DTAU_BEFORE_MS / dms:.2f}x this time"
               if ps_real else "")
        print(f"phase 8 times: rime_dtau hera-cal R={R} K={K} N={N} "
              f"ps_real={ps_real}: kernel {dms:.4f} ms, plain {dpms:.3f} ms, "
              f"bound {dbms:.4f} ms ({dby}), kernel at {dbms / dms:.1%} of "
              f"bound{old}; no single PyTorch call computes this fused "
              f"function, so no library time", flush=True)
    dms, dpms, dbms, dby = dtau_t[True]

    phase_fwd_beside_spikes(torch, spike, dev, (R, K, N), timing)
    spikes = phase_spike(torch, spike, dev, built)
    phase_entry_points(bt, torch, rime_cuda, dev, rng, f0, df)
    prod_fwd, prod_dtau = phase_hera_prod(bt, torch, rime_cuda, _pix_chunks,
                                          hera_prod)
    redcal_fwd = phase_hera_redcal(bt, torch, rime_cuda, _pix_chunks)
    hmc_fwd = phase_hera_hmc(bt, torch, rime_cuda, _pix_chunks)
    alm_fwd, alm_dtau, sky_ylm = phase_hera_alm(bt, torch, rime_cuda,
                                                _pix_chunks)
    sfb_fwd, sfb_dtau, beam_R = phase_hera_sfb(bt, torch, rime_cuda,
                                               _pix_chunks, sky_ylm)
    hmca_fwd, hmca_dtau = phase_hera_hmc_alm(bt, torch, rime_cuda,
                                             _pix_chunks, sky_ylm, beam_R)
    del sky_ylm, beam_R
    filt_fwd, filt_dtau = phase_hera_filt(bt, torch, rime_cuda, _pix_chunks)
    img_fwd, img_dtau, img_t = phase_hera_img(bt, torch, rime_cuda,
                                              _pix_chunks)
    coup_fwd = phase_hera_coupling(bt, torch, rime_cuda, _pix_chunks)
    hess_fwd, hess_dtau = phase_hera_hess(bt, torch, rime_cuda, _pix_chunks)
    avg_fwd = phase_hera_avg(bt, torch, rime_cuda, _pix_chunks)
    io_fwd, io_dtau = phase_hera_io(bt, torch, rime_cuda, _pix_chunks)
    shard_fwd, shard_dtau = phase_hera_shard(bt, torch, rime_cuda)

    # rime_fwd: the two shapes are launched equally often on hera-stat:
    # report the mean per launch (hera-prod's and hera-alm's shapes beside
    # them)
    mean = [float(np.mean([t[i] for t in timing])) for i in range(3)]
    kernels = [{
        "name": "rime_fwd", "route": "cuda",
        "source": "bayeslim_tpu_torch/csrc/rime_fwd.cu",
        "replaces": "bayeslim_tpu/ops/rime_pallas.py:298",
        "launches": stat_launches + cal_fwd + prod_fwd + redcal_fwd
        + hmc_fwd + alm_fwd + sfb_fwd + hmca_fwd + filt_fwd + img_fwd
        + coup_fwd + hess_fwd + avg_fwd + io_fwd + shard_fwd,
        "launches_by_path": {"hera-stat": stat_launches, "hera-cal": cal_fwd,
                             "hera-prod": prod_fwd,
                             "hera-redcal": redcal_fwd,
                             "hera-hmc": hmc_fwd, "hera-alm": alm_fwd,
                             "hera-sfb": sfb_fwd,
                             "hera-hmc-alm": hmca_fwd,
                             "hera-filt": filt_fwd, "hera-img": img_fwd,
                             "hera-coupling": coup_fwd,
                             "hera-hess": hess_fwd, "hera-avg": avg_fwd,
                             "hera-io": io_fwd, "hera-shard": shard_fwd},
        "max_abs_err": max(worst_fwd["hera-fwd"], worst_fwd["hera-bwd"]),
        "ms": mean[0], "plain_ms": mean[1], "bound_ms": mean[2],
        "bound_by": timing[0][3] if timing[0][3] == timing[1][3]
        else "operations", "library_ms": None,
        "hera_prod_shapes": {
            label: dict(prod_t[label], max_abs_err=worst_fwd[label])
            for label, *_ in PROD_SHAPES},
        "hera_alm_shapes": {
            label: dict(alm_t[label], max_abs_err=worst_fwd[label])
            for label, *_ in ALM_SHAPES},
        "hera_img_shapes": img_t}, {
        "name": "rime_dtau", "route": "cuda",
        "source": "bayeslim_tpu_torch/csrc/rime_dtau.cu",
        "replaces": "bayeslim_tpu/ops/rime_pallas.py:693",
        "launches": cal_dtau + prod_dtau + alm_dtau + sfb_dtau + hmca_dtau
        + filt_dtau + img_dtau + hess_dtau + io_dtau + shard_dtau,
        "launches_by_path": {"hera-stat": 0, "hera-cal": cal_dtau,
                             "hera-prod": prod_dtau, "hera-redcal": 0,
                             "hera-hmc": 0, "hera-alm": alm_dtau,
                             "hera-sfb": sfb_dtau,
                             "hera-hmc-alm": hmca_dtau,
                             "hera-filt": filt_dtau, "hera-img": img_dtau,
                             "hera-coupling": 0, "hera-hess": hess_dtau,
                             "hera-avg": 0, "hera-io": io_dtau,
                             "hera-shard": shard_dtau},
        "max_abs_err": worst_dtau, "ms": dms, "plain_ms": dpms,
        "bound_ms": dbms, "bound_by": dby, "library_ms": None}]
    kernels += spikes
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
