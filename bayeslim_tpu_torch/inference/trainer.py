"""
Training loop over a LogProb with torch.optim: epochs, loss and time
history, chain tracking and rollback.

Counterpart of bayeslim_tpu/inference/trainer.py (Trainer :22, set_opt
:68, init_chain :77, get_chain :86, train :97, revert_chain :133), with
its reporting: every Nreport epochs a structured event to logger
(utils.logging.log_event) or, without one, a printed line when verbose;
each epoch's loss and time into metrics (utils.logging.Metrics); a
torch.profiler trace of train into profile_dir (utils.logging.trace_profile:
its Chrome trace holds the program's bl.* spans, one bl.opt a step). The
JAX Trainer keeps a ParamDict and an optax state; here the ParamDict's
tensors are the leaves that a torch.optim optimizer steps in place. The
optimizer is a factory params -> torch.optim.Optimizer (the default:
torch.optim.Adam at lr, the update optax.adam computes).
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..utils.logging import span

__all__ = ["Trainer"]


class Trainer:
    """Epoch loop: step the optimizer against prob.value_and_grad.

    track keeps each epoch's parameters (track_norm: their norms) in
    ``chain``; revert_chain rolls back to an earlier epoch. Nreport,
    verbose, metrics, logger and profile_dir: the reporting (module
    docstring).
    """

    def __init__(self, prob, optimizer=None, track=False, track_norm=False,
                 Nreport=None, verbose=True, metrics=None, logger=None,
                 profile_dir=None, lr=1e-2):
        self.prob = prob
        self.Nreport = Nreport
        self.verbose = verbose
        self.metrics = metrics
        self.logger = logger
        self.profile_dir = profile_dir
        self.pdict = prob.collect_main_params().operator(
            lambda v: v.detach().clone().requires_grad_(True))
        if optimizer is None:
            optimizer = functools.partial(torch.optim.Adam, lr=lr)
        self.opt = optimizer(self.pdict.values())
        self.loss_history = []
        self.time_history = []
        self.track = track
        self.track_norm = track_norm
        self.chain = {k: [] for k in self.pdict} if track else None

    @property
    def loss(self):
        """Per-epoch losses as an array."""
        return np.asarray(self.loss_history)

    @property
    def times(self):
        """Per-epoch wall times since the start of train [s]."""
        return np.asarray(self.time_history)

    def set_opt(self, optimizer, reset_state=True):
        """Swap the optimizer (a factory, as in the constructor); with
        reset_state=False the old optimizer's per-parameter state (e.g.
        Adam's moments) carries over."""
        old = self.opt
        self.opt = optimizer(self.pdict.values())
        if not reset_state:
            for p in self.pdict.values():
                if p in old.state:
                    self.opt.state[p] = old.state[p]

    def init_chain(self, track_params=None):
        """Start chain tracking afresh, of every main-param key or of
        track_params only."""
        self.track = True
        keys = list(self.pdict) if track_params is None \
            else list(track_params)
        self.chain = {k: [] for k in keys}

    def get_chain(self, name=None, idx=None):
        """Tracked history: one key's by name, or all as a dict; idx
        picks one epoch."""
        if not self.track:
            raise ValueError("chain tracking is off")
        if name is not None:
            c = self.chain[name]
            return np.stack(c) if idx is None else c[idx]
        if idx is None:
            return {k: np.stack(c) for k, c in self.chain.items()}
        return {k: c[idx] for k, c in self.chain.items()}

    @span("bl.opt")
    def step(self):
        """One optimizer step; returns the loss (a 0-d tensor)."""
        loss, grads = self.prob.value_and_grad(self.pdict)
        for p, g in zip(self.pdict.values(), grads.values()):
            p.grad = g
        self.opt.step()
        return loss

    def train(self, Nepochs=1, Nreport=None):
        """Run Nepochs steps, recording losses, times, metrics and (if
        tracking) the chain and reporting every Nreport epochs (default:
        the constructor's), then write the parameters into the model."""
        from ..utils.logging import log_event, trace_profile
        if Nreport is None:
            Nreport = self.Nreport
        start = time.time()
        with trace_profile(self.profile_dir,
                           enabled=self.profile_dir is not None):
            for epoch in range(Nepochs):
                loss = float(self.step())
                self.loss_history.append(loss)
                self.time_history.append(time.time() - start)
                if self.metrics is not None:
                    self.metrics.log("loss", loss, step=epoch)
                    self.metrics.log("epoch_time", self.time_history[-1],
                                     step=epoch)
                if self.track:
                    for k in self.chain:
                        v = self.pdict[k].detach().cpu().numpy()
                        self.chain[k].append(np.linalg.norm(v)
                                             if self.track_norm else v.copy())
                if Nreport and epoch % Nreport == 0:
                    if self.logger is not None:
                        log_event("train_epoch", logger=self.logger,
                                  epoch=epoch, loss=loss,
                                  elapsed=self.time_history[-1])
                    elif self.verbose:
                        print(f"epoch {epoch:5d} | loss {loss:.6e} | "
                              f"{self.time_history[-1]:.1f}s")
        self.prob.update(self.pdict)
        return self.loss_history

    def revert_chain(self, Nepochs):
        """Roll the parameters back Nepochs epochs along the tracked
        chain (the optimizer's state is kept) and write them into the
        model."""
        if not self.track or self.track_norm:
            raise ValueError("revert_chain needs full chain tracking")
        if Nepochs < 1:
            raise ValueError("Nepochs must be >= 1")
        idx = -Nepochs
        with torch.no_grad():
            for k in self.chain:
                self.pdict[k].copy_(torch.as_tensor(self.chain[k][idx]))
                self.chain[k] = self.chain[k][:idx]
        self.loss_history = self.loss_history[:idx]
        self.time_history = self.time_history[:idx]
        self.prob.update(self.pdict)
