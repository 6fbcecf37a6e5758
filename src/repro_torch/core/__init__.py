"""repro_torch.core — the paper's spline unit: fixed-point format, CR
tables and interpolation, the approximant registry and the activation
engine (counterpart of ``repro/core/__init__.py``).

Exports every name of the reference's ``__all__`` that is ported. The
fixed-point datapaths and the error analysis (``representable_grid``,
``FixedTable``, ``build_fixed_table``, ``interpolate_fixed``,
``PAPER_TABLE_1_2``, ``ErrorStats``, ``table_1_2``, ``tanh_error``) wait
for ROADMAP.md, Queue A item 2.
"""

from .fixed_point import Q2_13, QFormat, dequantize, quantize
from .catmull_rom import (
    BASIS,
    SplineTable,
    basis_weights,
    build_table,
    interpolate,
    interpolate_pwl,
)
from .approximant import ApproxSpec
from .activations import ActivationConfig, ActivationEngine, get_engine, tanh_table
from . import approximant

__all__ = [
    "Q2_13", "QFormat", "quantize", "dequantize",
    "BASIS", "SplineTable", "basis_weights", "build_table",
    "interpolate", "interpolate_pwl",
    "ApproxSpec", "approximant",
    "ActivationConfig", "ActivationEngine", "get_engine", "tanh_table",
]
