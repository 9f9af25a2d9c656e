"""Data containers, the in-memory data layer, Dataset and the file
layer (HDF5 and UVH5 I/O, calfits, the builders and pickles).

DATA_PATH / CONFIG_PATH name the bundled demo files (a UVH5 file, a
calfits file and YAML catalogues), read in place from the JAX package's
bundle beside this package (nothing of it is imported).
"""
import os as _os

DATA_PATH = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), "bayeslim_tpu", "data", "bundled")
CONFIG_PATH = _os.path.join(DATA_PATH, "configs")

from . import containers, dataset, io, uvdata_interface
from .containers import (TensorData, VisData, MapData, CalData,
                         concat_VisData, concat_MapData, concat_CalData,
                         load_data)
from .dataset import Dataset
