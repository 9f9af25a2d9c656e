"""Posterior, optimizer loop and quasi-Newton optimizers."""
from . import bfgs, hmat, prob, trainer
from .bfgs import BFGS, LBFGS, strong_wolfe
from .hmat import DiagMat
from .prob import LogProb, apply_icov
from .trainer import Trainer
