"""Data containers, the in-memory data layer and Dataset."""
from . import containers, dataset
from .containers import (TensorData, VisData, MapData, CalData,
                         concat_VisData, concat_MapData, concat_CalData)
from .dataset import Dataset
