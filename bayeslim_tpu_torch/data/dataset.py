"""
Dataset: a minibatch-indexable collection of data containers.

Counterpart of bayeslim_tpu/data/dataset.py (Dataset :16). LogProb
takes one as its target (batch i uses entry i); an entry that is a
string is read when indexed, by read_fn or else by load_data (an HDF5
file, its tensors on device).
"""
from __future__ import annotations

from .containers import CalData, MapData, TensorData, VisData, load_data

__all__ = ["Dataset"]


class Dataset:
    """Indexable list of data containers, or of paths read when
    indexed: by read_fn if given, else by load_data onto device (None:
    CUDA)."""

    def __init__(self, data, read_fn=None, device=None):
        if isinstance(data, (VisData, MapData, CalData, TensorData)):
            data = [data]
        self.data = list(data)
        self.read_fn = read_fn
        self.device = device

    def __len__(self):
        return len(self.data)

    @property
    def Nbatch(self):
        return len(self.data)

    def __getitem__(self, idx):
        d = self.data[idx]
        if isinstance(d, str):
            d = self.read_fn(d) if self.read_fn is not None \
                else load_data(d, device=self.device)
        return d

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
