"""repro_torch.core — the paper's spline unit: fixed-point format and
datapaths, CR tables and interpolation, the approximant registry, the
activation engine, error analysis and the area model (counterpart of
``repro/core/__init__.py``, exporting every name of its ``__all__``)."""

from .fixed_point import Q2_13, QFormat, dequantize, quantize, representable_grid
from .catmull_rom import (
    BASIS,
    FixedTable,
    SplineTable,
    basis_weights,
    build_fixed_table,
    build_table,
    interpolate,
    interpolate_fixed,
    interpolate_pwl,
)
from .approximant import ApproxSpec
from .activations import ActivationConfig, ActivationEngine, get_engine, tanh_table
from .error_analysis import PAPER_TABLE_1_2, ErrorStats, table_1_2, tanh_error
from . import approximant

__all__ = [
    "Q2_13", "QFormat", "quantize", "dequantize", "representable_grid",
    "BASIS", "SplineTable", "FixedTable", "basis_weights", "build_table",
    "build_fixed_table", "interpolate", "interpolate_fixed", "interpolate_pwl",
    "ApproxSpec", "approximant",
    "ActivationConfig", "ActivationEngine", "get_engine", "tanh_table",
    "PAPER_TABLE_1_2", "ErrorStats", "table_1_2", "tanh_error",
]
