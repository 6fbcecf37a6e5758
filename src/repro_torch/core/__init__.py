"""The paper's spline unit: fixed-point format, CR tables and
interpolation, the approximant registry and the activation engine."""
