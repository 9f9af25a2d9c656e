"""
Structured logging and profiling hooks.

Counterpart of bayeslim_tpu/utils/logging.py (get_logger :21, log_event
:49, Metrics :66, trace_profile :98, device_memory_stats :119, log
:136): a logger whose events also go, one JSON record a line, to a
file; a metrics store; a torch.profiler trace of a block; the CUDA
caching allocator's memory statistics. Unlike the JAX trace_profile,
an error of the profiler is raised, not swallowed.

The port's own addition: ``span``, a named range of the program's
layers in a profiler's trace, recorded only while a profiler runs.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time

import numpy as np
import torch

__all__ = ["log", "get_logger", "log_event", "Metrics", "trace_profile",
           "device_memory_stats", "span"]

_LOGGER = None

# torch.cuda._sleep kernels launched at the start of a CUDA trace: past a
# process's first seconds the profiler drops the first kernels it is
# started on (up to 63 seen), so these are dropped in their place
PROFILE_MARKS = 1024


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


class _Span:
    """What span(name) returns. Recording, it enters a RecordFunction of
    function scope, an operation's kind of range (record_function's user
    scope would also make the profiler put a copy of the range, as long
    as its kernels, among the device's events, where it reads as a
    kernel); else it does nothing. As a decorator, each call of the
    function opens span(name) anew, so whether it records follows the
    profiler at the call, not at the decoration."""
    __slots__ = ("name", "_record", "_range")

    def __init__(self, name, record):
        self.name, self._record, self._range = name, record, None

    def __enter__(self):
        if self._record:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()

    def __exit__(self, *exc):
        if self._record:
            self._range.__exit__(*exc)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


_NULL_SPANS = {}


def span(name):
    """A named range of the program, as a context manager or a
    decorator (``with span("bl.psky"):``, ``@span("bl.eval")``).

    While a torch profiler runs (torch.autograd._profiler_enabled():
    trace_profile, a Trainer's profile_dir, any torch.profiler),
    it records a CPU range on the trace's clock, nested as the calls
    are: the kernels its operations launch follow it by correlation id,
    and the backward nodes of those operations by sequence number.
    Otherwise it is one null context shared by every use of the name:
    nothing is allocated or recorded, and no autograd node is added."""
    if torch.autograd._profiler_enabled():
        return _Span(name, True)
    null = _NULL_SPANS.get(name)
    if null is None:
        null = _NULL_SPANS.setdefault(name, _Span(name, False))
    return null


@contextlib.contextmanager
def trace_profile(logdir=None, enabled=True):
    """torch.profiler trace of the block (CPU, and CUDA when a card is
    present), written as a Chrome trace to logdir/trace.json; nothing
    when disabled or without logdir. The trace holds the program's
    ``bl.*`` spans (``span``) beside the operations and kernels. On a
    card, PROFILE_MARKS spin kernels are launched before the block, so
    that the kernels the profiler drops at its start are those and not
    the block's first."""
    if not enabled or logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=acts) as prof:
        if cuda:
            for _ in range(PROFILE_MARKS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
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
