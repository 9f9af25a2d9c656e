"""
Antenna/baseline bookkeeping and small host-side index utilities.

Counterpart of bayeslim_tpu/utils/indexing.py (AntposDict :36,
ants2blnum :115, blnum2ants :137, make_hex :158, flatten :208,
gauss_taper :248, inflate_bls :317). Everything here but gauss_taper is
host numpy.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["AntposDict", "blnum2ants", "ants2blnum", "make_hex",
           "flatten", "gauss_taper", "inflate_bls"]


class AntposDict:
    """Dict-like antenna-position store: ``ants`` is a list of ints,
    ``antvecs`` an (Nants, 3) array of ENU positions [m]: float64 numpy,
    or a tensor (trainable antenna positions), kept as given."""

    def __init__(self, ants, antvecs):
        self.ants = [int(a) for a in ants]
        self._ant_idx = {a: i for i, a in enumerate(self.ants)}
        if not isinstance(antvecs, torch.Tensor):
            antvecs = np.asarray(antvecs, dtype=np.float64)
        self.antvecs = antvecs

    def asnumpy(self):
        """Host float64 numpy copy of antvecs."""
        if isinstance(self.antvecs, torch.Tensor):
            return self.antvecs.detach().cpu().numpy().astype(np.float64)
        return self.antvecs

    def keys(self):
        return iter(self.ants)

    def values(self):
        return iter(self.antvecs)

    def items(self):
        return zip(self.ants, self.antvecs)

    def __getitem__(self, key):
        if isinstance(key, (int, np.integer)):
            return self.antvecs[self._ant_idx[int(key)]]
        return self.antvecs[[self._ant_idx[int(k)] for k in key]]

    def __len__(self):
        return len(self.ants)

    def __contains__(self, key):
        return int(key) in self._ant_idx

    def __iter__(self):
        return self.keys()

    def __repr__(self):
        return f"Antpos{{{self.ants}}}"

    def index(self, ants):
        """Integer indices into antvecs for a list of antenna numbers."""
        return np.asarray([self._ant_idx[int(a)] for a in ants])


def ants2blnum(antnums, separate=False):
    """Antenna-pair tuple(s) -> baseline integer(s): (1, 2) -> 101102."""
    if isinstance(antnums, tuple):
        a1, a2 = antnums[0] + 100, antnums[1] + 100
        return (a1, a2) if separate else int(a1 * 1000 + a2)
    if isinstance(antnums, list) and len(antnums) \
            and isinstance(antnums[0], tuple):
        bl = np.asarray(antnums) + 100
        if separate:
            return bl[:, 0] * 1000, bl[:, 1]
        return bl[:, 0] * 1000 + bl[:, 1]
    return np.asarray(antnums)  # already blnums


def blnum2ants(blnum, separate=False):
    """Baseline integer(s) -> antenna-pair tuple(s): 102103 -> (2, 3)."""
    if isinstance(blnum, tuple):
        return blnum
    if isinstance(blnum, list) and len(blnum) \
            and isinstance(blnum[0], tuple):
        return list(zip(*blnum)) if separate else blnum
    if isinstance(blnum, (int, np.integer)):
        a1 = int(blnum // 1000)
        a2 = int(blnum - a1 * 1000)
        return (a1 - 100, a2 - 100)
    arr = np.asarray(blnum)
    a1 = (arr // 1000).astype(np.int64) - 100
    a2 = (arr % 1000).astype(np.int64) - 100
    if separate:
        return a1.tolist(), a2.tolist()
    return list(zip(a1.tolist(), a2.tolist()))


def make_hex(N, D=15.0):
    """Hexagonal array with N antennas per side and spacing D [m].

    Returns ants (list of int) and antvecs (Nants, 3) numpy."""
    x, y, ants = [], [], []
    ant, k, start = 0, 0, 0.0
    for i in range(2 * N - 1):
        for j in range(N + k):
            x.append(j + start)
            y.append(i * np.sin(np.pi / 3))
            ants.append(ant)
            ant += 1
        if i < N - 1:
            k += 1
            start -= 0.5
        else:
            k -= 1
            start += 0.5
    x = np.asarray(x) - np.mean(x)
    y = np.asarray(y) - np.mean(y)
    antvecs = np.vstack([x, y, np.zeros_like(x)]).T * D
    return ants, antvecs


def flatten(nested, Nelem=None):
    """Flatten a nested sequence one level; Nelem keeps the first Nelem
    elements of each sub-sequence. Non-sequence items pass through."""
    s = slice(None) if Nelem is None else slice(0, Nelem)
    out = []
    for x in nested:
        if isinstance(x, (list, tuple, np.ndarray)) or hasattr(x, "__next__"):
            out.extend(list(x)[s] if hasattr(x, "__next__") else x[s])
        else:
            out.append(x)
    return out


def gauss_taper(x, scale):
    """Gaussian edge taper exp(-0.5 (x/scale)^2)."""
    return torch.exp(-0.5 * (torch.as_tensor(x) / scale) ** 2)


def inflate_bls(red_bls, bl2red, all_bls=None):
    """The baselines of all_bls (default: every key of bl2red) whose
    redundant group holds one of red_bls, and each one's group index:
    (new_bls, red_inds)."""
    if all_bls is None:
        all_bls = list(bl2red.keys())
    red_indices = set(bl2red.get(bl, None) for bl in red_bls)
    new_bls, red_inds = [], []
    for bl in all_bls:
        ridx = bl2red.get(bl, -1)
        if ridx in red_indices:
            new_bls.append(bl)
            red_inds.append(ridx)
    return new_bls, red_inds
