"""Posterior, optimizer loop, quasi-Newton optimizers, Hessians,
structured operators and the MCMC samplers."""
from . import bfgs, hessian, hmat, prob, sampler, trainer
from .bfgs import BFGS, LBFGS, lbfgs_approx_cov, strong_wolfe
from .hessian import (FactoredInvHessian, compute_hessian, compute_icov,
                      factor_pairs, factored_hvp, factored_lvp,
                      implicit_to_dense, invert_hessian, main_params_index,
                      main_params_kron_inv_hess, mask_hessian,
                      unmask_hessian)
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
