"""Posterior, optimizer loop and quasi-Newton optimizers."""
from . import bfgs, hmat, prob, trainer
from .bfgs import BFGS, LBFGS, lbfgs_approx_cov, strong_wolfe
from .hmat import DiagMat
from .prob import (BaseLogPrior, LogGaussPrior, LogLaplacePrior, LogProb,
                   LogTaperedUniformPrior, LogUniformPrior, MainParams,
                   apply_icov)
from .trainer import Trainer
