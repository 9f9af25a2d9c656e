"""Posterior, optimizer loop, quasi-Newton optimizers, structured
operators and the MCMC samplers."""
from . import bfgs, hmat, prob, sampler, trainer
from .bfgs import BFGS, LBFGS, lbfgs_approx_cov, strong_wolfe
from .hmat import (BaseMat, DenseMat, DiagMat, HadamardMat, HierMat,
                   MatColumn, MatDict, MatRow, MatSum, OneMat,
                   PartitionedMat, SolveHierMat, SolveMat, SparseMat,
                   TransposedMat, TriangMat, ZeroMat, make_hodlr)
from .prob import (BaseLogPrior, LogGaussPrior, LogLaplacePrior, LogProb,
                   LogTaperedUniformPrior, LogUniformPrior, MainParams,
                   apply_icov)
from .sampler import (HMC, NUTS, DynamicStepSize, Potential, RecycledHMC,
                      RelativeStepSize, SamplerBase, StepSize, leapfrog,
                      multiply_eps)
from .trainer import Trainer
