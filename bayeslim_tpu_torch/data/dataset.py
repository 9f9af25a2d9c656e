"""
Dataset: a minibatch-indexable collection of data containers.

Counterpart of bayeslim_tpu/data/dataset.py (Dataset :16). LogProb
takes one as its target (batch i uses entry i); an entry that is a
string is read by read_fn on access. Reading files (load_data) is the
file layer, which is not ported: an entry that is a path needs a
read_fn.
"""
from __future__ import annotations

from .containers import CalData, MapData, TensorData, VisData

__all__ = ["Dataset"]


class Dataset:
    """Indexable list of data containers, or of paths read by read_fn
    when indexed."""

    def __init__(self, data, read_fn=None):
        if isinstance(data, (VisData, MapData, CalData, TensorData)):
            data = [data]
        self.data = list(data)
        self.read_fn = read_fn

    def __len__(self):
        return len(self.data)

    @property
    def Nbatch(self):
        return len(self.data)

    def __getitem__(self, idx):
        d = self.data[idx]
        if isinstance(d, str):
            if self.read_fn is None:
                raise NotImplementedError(
                    "reading a data file (load_data) is the file layer "
                    "(ROADMAP queue A9b), which is not ported yet: give "
                    "the Dataset a read_fn")
            d = self.read_fn(d)
        return d

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
