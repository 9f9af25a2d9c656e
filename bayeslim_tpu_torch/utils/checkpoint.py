"""
Training-state checkpoints: parameters, optimizer state, step and extra.

Counterpart of bayeslim_tpu/utils/checkpoint.py (save_train_state :27,
restore_train_state :43, CheckpointManager :63). The JAX package writes
through orbax; here a state is one file written by torch.save, and every
write is atomic: a temporary file in the same directory, flushed to
disk, then os.replace onto the name, and the directory flushed so that
the rename survives a crash. A CheckpointManager keeps the files of the
last max_to_keep steps, as orbax's manager does, and removes the
temporary files that an interrupted save left behind.

Resuming a fit (a torch.optim optimizer over the tensors of a ParamDict,
as the port's Trainer holds them)::

    mgr = CheckpointManager(directory, max_to_keep=2)
    for step in range(N):
        trainer.train(1)
        mgr.maybe_save(step, trainer.pdict, trainer.opt, every=1)
    ...
    trainer = Trainer(build_prob(...))          # a fresh build
    mgr.restore_latest(like={"params": trainer.pdict,
                             "opt_state": trainer.opt})

restore with like copies the saved values into like's tensors in place
(the ones the optimizer steps) and loads the optimizer's state_dict, so
the resumed run continues bit for bit. The state is loaded onto the CPU
first: torch.optim.Optimizer.load_state_dict then casts each moment to
its parameter's device and dtype, and keeps Adam's step counts on the
CPU, where a fresh Adam keeps them.
"""
from __future__ import annotations

import os
import re

import torch

from .dtypes import resolve_device

__all__ = ["save_train_state", "restore_train_state", "CheckpointManager"]


def _state(pdict, opt_state, step, extra):
    if hasattr(opt_state, "state_dict"):
        opt_state = opt_state.state_dict()
    state = {"params": {k: v.detach() for k, v in pdict.items()},
             "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if extra is not None:
        state["extra"] = extra
    return state


def _atomic_save(obj, path):
    path = os.path.abspath(str(path))
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(os.path.dirname(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return path


def save_train_state(path, pdict, opt_state=None, step=0, extra=None):
    """Atomically save {params, opt_state, step, extra} to the file path:
    pdict a ParamDict (or dict) of tensors, opt_state a torch.optim
    optimizer or its state_dict. Returns the absolute path."""
    return _atomic_save(_state(pdict, opt_state, step, extra), path)


def restore_train_state(path, like=None, device=None):
    """A state saved by save_train_state, as a dict.

    like: {"params": a ParamDict (or dict) of tensors, "opt_state": an
    optimizer}: the saved values are copied into those tensors in place
    and the optimizer loads its state; the returned params are like's.
    Without like the params are put on device (None: CUDA) and the
    optimizer state is returned as a state_dict on the CPU.
    """
    state = torch.load(os.path.abspath(str(path)), map_location="cpu",
                       weights_only=False)
    if like is None:
        dev = resolve_device(device)
        state["params"] = {k: v.to(dev) for k, v in state["params"].items()}
        return state
    params = like.get("params")
    if params is not None:
        with torch.no_grad():
            for k, v in state["params"].items():
                params[k].copy_(v)
        state["params"] = params
    opt = like.get("opt_state")
    if hasattr(opt, "load_state_dict") and "opt_state" in state:
        opt.load_state_dict(state["opt_state"])
    return state


class CheckpointManager:
    """Periodic checkpoints with retention: the files <step>.pt of a
    directory, of which the last max_to_keep steps are kept. Steps
    already in the directory count, so a new process resumes from
    them."""

    def __init__(self, directory, max_to_keep=3):
        self.directory = os.path.abspath(str(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, f"{int(step)}.pt")

    def all_steps(self):
        """The saved steps, ascending."""
        steps = [int(m.group(1)) for m in
                 (re.fullmatch(r"(\d+)\.pt", f)
                  for f in os.listdir(self.directory)) if m]
        return sorted(steps)

    def maybe_save(self, step, pdict, opt_state=None, every=1, extra=None):
        """Save at steps that are multiples of every; then drop all but
        the last max_to_keep steps, and the temporary files of saves
        that never finished. Returns whether it saved."""
        if step % max(int(every), 1):
            return False
        _atomic_save(_state(pdict, opt_state, step, extra), self._path(step))
        for f in os.listdir(self.directory):
            if re.fullmatch(r"\d+\.pt\.tmp-\d+", f):
                os.remove(os.path.join(self.directory, f))
        if self.max_to_keep is not None:
            for s in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(s))
        return True

    def restore_latest(self, like=None, device=None):
        """The latest step's state (restore_train_state), or None."""
        step = self.latest_step
        if step is None:
            return None
        return restore_train_state(self._path(step), like=like,
                                   device=device)

    @property
    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing to finish: every save is complete when it returns."""
