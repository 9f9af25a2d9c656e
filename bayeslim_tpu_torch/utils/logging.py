"""
Structured logging and profiling hooks.

Counterpart of bayeslim_tpu/utils/logging.py (get_logger :21, log_event
:49, Metrics :66, trace_profile :98, device_memory_stats :119, log
:136): a logger whose events also go, one JSON record a line, to a
file; a metrics store; a torch.profiler trace of a block; the CUDA
caching allocator's memory statistics. Unlike the JAX trace_profile,
an error of the profiler is raised, not swallowed.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

__all__ = ["log", "get_logger", "log_event", "Metrics", "trace_profile",
           "device_memory_stats"]

_LOGGER = None


def get_logger(name="bayeslim_tpu_torch", level=logging.INFO,
               jsonl_path=None):
    """The package's logger; with jsonl_path, its JSON events are also
    appended to that file, one record a line."""
    global _LOGGER
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
    if jsonl_path is not None:
        path = os.path.abspath(str(jsonl_path))
        have = any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == path
                   for h in logger.handlers)
        if not have:
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter("%(message)s"))
            fh.addFilter(lambda rec: rec.getMessage().startswith("{"))
            logger.addHandler(fh)
    _LOGGER = logger
    return logger


def log_event(event, logger=None, **fields):
    """Log one structured record {"event", "t", **fields} as JSON and
    return it; numpy scalars and 0-d tensors become Python numbers."""
    logger = logger or _LOGGER or get_logger()
    rec = {"event": event, "t": time.time()}
    for k, v in fields.items():
        if isinstance(v, np.generic):
            v = v.item()
        elif hasattr(v, "item") and getattr(v, "ndim", None) == 0:
            v = float(v)
        rec[k] = v
    logger.info(json.dumps(rec, default=str))
    return rec


class Metrics:
    """Scalar series by name, with summaries and JSON-lines export."""

    def __init__(self):
        self.series = {}

    def log(self, name, value, step=None):
        s = self.series.setdefault(name, {"steps": [], "values": []})
        s["steps"].append(len(s["values"]) if step is None else step)
        s["values"].append(float(value))

    def __getitem__(self, name):
        return np.asarray(self.series[name]["values"])

    def summary(self):
        return {k: dict(n=len(v["values"]),
                        last=v["values"][-1] if v["values"] else None,
                        min=float(np.min(v["values"])) if v["values"]
                        else None,
                        mean=float(np.mean(v["values"])) if v["values"]
                        else None)
                for k, v in self.series.items()}

    def to_jsonl(self, path):
        with open(path, "w") as f:
            for k, s in self.series.items():
                for st, v in zip(s["steps"], s["values"]):
                    f.write(json.dumps({"name": k, "step": st, "value": v})
                            + "\n")


@contextlib.contextmanager
def trace_profile(logdir=None, enabled=True):
    """torch.profiler trace of the block (CPU, and CUDA when a card is
    present), written as a Chrome trace to logdir/trace.json; nothing
    when disabled or without logdir."""
    if not enabled or logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


def device_memory_stats():
    """{device name: {bytes_in_use, peak_bytes_in_use, bytes_limit}} of
    each CUDA device (the caching allocator's allocated bytes and the
    card's total memory); {} without one."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out


def log(message, verbose=False, style=1):
    """Print message when verbose: style 1 plain, 2 underlined, 3
    boxed."""
    if not verbose:
        return
    if style == 2:
        print(f"{message}\n{'-' * 30}")
    elif style == 3:
        print(f"\n{'-' * 30}\n{message}\n{'-' * 30}")
    else:
        print(f"{message}")
