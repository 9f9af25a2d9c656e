"""Data containers."""
from . import containers
from .containers import TensorData, VisData, MapData, concat_VisData
