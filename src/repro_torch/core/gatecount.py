"""Analytic NAND2-equivalent gate-count model (stands in for RTL synthesis).

Counterpart of ``repro/core/gatecount.py``, plain Python arithmetic.

We cannot run Synopsys/Cadence in this environment; the paper's Table III
compares synthesized gate counts. This model counts datapath structures at
textbook NAND2-equivalent costs and is applied uniformly to every variant
we build, so *relative* area comparisons are meaningful. Published numbers
for external works ([5],[6],[10]) are quoted verbatim, as the paper itself
does for [10].

Cost basis (NAND2-equivalents, standard-cell folklore):
  full adder            6   (2xXOR=8 is pessimistic; mirror FA ~ 6)
  half adder            3
  2:1 mux (per bit)     3
  register (per bit)    8   (scan DFF)
  AND/OR/XOR            1 / 1 / 3
Array multiplier n x m: n*m AND + (n-1) m-bit adder rows -> ~ n*m + 6*(n-1)*m,
with a 0.75 optimization factor for Booth/Wallace synthesis results.
Constant-LUT-as-logic (k entries x n bits): synthesis collapses a constant
table to roughly 0.75 gates per stored bit after Boolean minimization.
"""
from __future__ import annotations

import dataclasses

FA = 6.0
MUX_BIT = 3.0
LUT_BIT = 0.75
MULT_OPT = 0.75


def adder(bits: int) -> float:
    return FA * bits


def multiplier(n: int, m: int) -> float:
    return MULT_OPT * (n * m + FA * (n - 1) * m) if min(n, m) > 0 else 0.0


def mux(bits: int, ways: int = 2) -> float:
    return MUX_BIT * bits * (ways - 1)


def const_lut(entries: int, bits: int) -> float:
    return LUT_BIT * entries * bits


@dataclasses.dataclass
class AreaReport:
    name: str
    gates: float
    memory_kbits: float
    breakdown: dict

    def row(self):
        return (self.name, round(self.gates), self.memory_kbits)


TRUNC_MULT = 0.55   # truncated multiplier keeping only needed top columns


def cr_spline_datapath(frac_bits: int = 13, depth: int = 32,
                       t_in_lut: bool = False, x_int_bits: int = 2) -> AreaReport:
    """The paper's Fig. 2/3 datapath, at the EXACT widths the bit-accurate
    emulation (core/catmull_rom.py interpolate_fixed) carries:

    - |x| / sign fixup: one n-bit negate-mux pair;
    - control-point LUT: depth x frac_bits as random logic (+1 window
      neighbor wiring, free);
    - t-vector: t has t_bits significant lsbs, so t^2 (t_bits x t_bits)
      and t^3 (2t_bits x t_bits) multipliers are EXACT and small; the four
      basis polynomials are integer-coefficient shift-adds at 3t_bits+2
      width (7 adders; x3 and x5 factors counted as their adds). The
      t_in_lut=True variant stores the 4 basis values in a second LUT of
      2^t_bits x 4 x frac_bits instead (the paper's faster/bigger option);
    - 4-tap MAC: 4 truncated multipliers (full product width never stored:
      only the top columns that survive the single final shift-round are
      formed, standard truncated-multiplier design) + 3-adder tree;
    - saturation compare + mux.
    """
    n = frac_bits
    in_bits = 1 + x_int_bits + frac_bits
    # t_bits: lsbs of the magnitude below the LUT index (depth segments
    # over [0, x_max = 2^x_int_bits))
    import math
    t_bits = x_int_bits + frac_bits - int(math.log2(depth))
    b: dict[str, float] = {}
    b["abs+sign"] = adder(in_bits) + mux(in_bits)
    b["lut_control_points"] = const_lut(depth, n)
    if t_in_lut:
        b["t_vector_lut"] = const_lut(2 ** t_bits, 4 * n)
        wide = n + 2
    else:
        b["t_sq_mult"] = multiplier(t_bits, t_bits)
        b["t_cube_mult"] = multiplier(2 * t_bits, t_bits)
        b["basis_combine_adds"] = 7 * adder(3 * t_bits + 2)
        wide = 3 * t_bits + 2
    b["mac_mults"] = 4 * TRUNC_MULT * multiplier(n + 1, wide)
    b["mac_adder_tree"] = 3 * adder(n + 3)
    b["saturation"] = adder(n) + mux(n)
    total = sum(b.values())
    return AreaReport(
        name=f"CR spline (depth={depth}, {n}b{', t-LUT' if t_in_lut else ''})",
        gates=total, memory_kbits=0.0, breakdown=b)


def pwl_datapath(frac_bits: int = 13, depth: int = 32,
                 x_int_bits: int = 2) -> AreaReport:
    """PWL interpolator matching the registered ``pwl`` approximant's
    FIXED datapath (core/approximant.py::PWL.fixed_block): a [depth, 2]
    value+delta LUT (both columns counted — the delta column is what
    spares a runtime subtractor), one truncated slope multiplier of the
    exact widths the integer MAC carries (delta x t-residue), one adder.
    All widths grow with the Q format."""
    import math
    n = frac_bits
    in_bits = 1 + x_int_bits + frac_bits
    t_bits = max(x_int_bits + frac_bits - int(math.log2(depth)), 1)
    b = {
        "abs+sign": adder(in_bits) + mux(in_bits),
        "lut_value_delta": const_lut(depth, 2 * n),
        "slope_mult": TRUNC_MULT * multiplier(t_bits + 1, t_bits),
        "add": adder(n),
        "saturation": adder(n) + mux(n),
    }
    return AreaReport(name=f"PWL (depth={depth}, {n}b)", gates=sum(b.values()),
                      memory_kbits=0.0, breakdown=b)


def poly_datapath(frac_bits: int = 13, depth: int = 8,
                  degree: int = 3, x_int_bits: int = 2) -> AreaReport:
    """Piecewise-polynomial (DCTIF-style) unit matching the ``poly``
    fixed datapath: a [depth, degree+1] coefficient LUT feeding
    ``degree`` truncating Horner stages. Each stage is one truncated
    (coeff x t_bits) multiplier plus a guard-width adder; the
    coefficient ROM carries GUARD_BITS guard bits below the datapath
    LSB (matching the error-analysis model and the integer circuit),
    which is what synthesis sees; one rounding shift drops the guard
    bits at the output."""
    import math

    from .fixed_point import GUARD_BITS
    n = frac_bits
    in_bits = 1 + x_int_bits + frac_bits
    coeff_bits = n + GUARD_BITS
    t_bits = max(x_int_bits + frac_bits - int(math.log2(depth)), 1)
    b = {
        "abs+sign": adder(in_bits) + mux(in_bits),
        "lut_coeffs": const_lut(depth, (degree + 1) * coeff_bits),
        "horner_mults": degree * TRUNC_MULT * multiplier(coeff_bits, t_bits),
        "horner_adds": degree * adder(coeff_bits),
        "round_shift": adder(n),
        "saturation": adder(n) + mux(n),
    }
    return AreaReport(
        name=f"poly (depth={depth}, deg={degree}, {n}b)",
        gates=sum(b.values()), memory_kbits=0.0, breakdown=b)


def rational_datapath(frac_bits: int = 13, degree: int = 5,
                      newton_iters: int | None = None,
                      x_int_bits: int = 2) -> AreaReport:
    """Padé + Newton-reciprocal unit (no divider, no LUT beyond the
    wired coefficient constants) at the widths the fixed datapath
    carries: u = x^2 lands straight in the guard format, two Horner
    chains in u for num/den run at internal width ``g`` = frac +
    GUARD_BITS (+ the integer bits covering den(x_max^2)), one
    linear-seed MAC, then ``newton_iters`` iterations of r <- r(2 - d r)
    at two multipliers + one subtractor each, and the final num * r
    multiplier dropping back to the output lattice. Coefficients are
    wired constants (synthesis folds them into the multipliers; counted
    as full multipliers here, i.e. conservatively). ``newton_iters``
    defaults to the iteration count the emulated datapath actually runs
    (approximant.NEWTON_ITERS), so area and benchmark stay in lockstep."""
    from .approximant import NEWTON_ITERS, PadeRational
    from .fixed_point import GUARD_BITS
    if newton_iters is None:
        newton_iters = NEWTON_ITERS
    order = PadeRational._order(degree)   # same rounding as the datapath
    n = frac_bits
    in_bits = 1 + x_int_bits + frac_bits
    g = n + GUARD_BITS        # internal fraction width (guard format)
    k = order // 2            # Horner stages per chain in u
    b = {
        "abs+sign": adder(in_bits) + mux(in_bits),
        "u_square": TRUNC_MULT * multiplier(in_bits - 1, in_bits - 1),
        "horner_num": k * (TRUNC_MULT * multiplier(g, g)
                           + adder(g)),
        "horner_den": k * (TRUNC_MULT * multiplier(g, g)
                           + adder(g)),
        "newton_seed": TRUNC_MULT * multiplier(g, g) + adder(g),
        "newton_iters": newton_iters * (2 * TRUNC_MULT * multiplier(g, g)
                                        + adder(g)),
        "final_mult": TRUNC_MULT * multiplier(g, in_bits - 1),
        "saturation": adder(n) + mux(n),
    }
    return AreaReport(
        name=f"rational (order={order}, {n}b, {newton_iters} Newton)",
        gates=sum(b.values()), memory_kbits=0.0, breakdown=b)


def approximant_datapath(spec) -> AreaReport:
    """Area model for any registered approximant spec (the DSE hook):
    dispatches on ``spec.scheme`` with the spec's own geometry and
    fixed-point format."""
    if spec.scheme == "cr_spline":
        return cr_spline_datapath(spec.frac_bits, spec.depth,
                                  x_int_bits=spec.int_bits)
    if spec.scheme == "pwl":
        return pwl_datapath(spec.frac_bits, spec.depth,
                            x_int_bits=spec.int_bits)
    if spec.scheme == "poly":
        return poly_datapath(spec.frac_bits, spec.depth, spec.degree,
                             x_int_bits=spec.int_bits)
    if spec.scheme == "rational":
        return rational_datapath(spec.frac_bits, spec.degree,
                                 x_int_bits=spec.int_bits)
    raise ValueError(f"no gate-count model for scheme {spec.scheme!r}; "
                     "add one to core/gatecount.py::approximant_datapath")


# Published Table III rows, quoted verbatim (we did not synthesize these).
PUBLISHED = [
    dict(work="[5] RALUT", precision=10, gates=515, memory_kbits=0.0, max_err=0.0189),
    dict(work="[6] region", precision=6, gates=129, memory_kbits=0.0, max_err=0.0196),
    dict(work="[10] DCTIF", precision=11, gates=230, memory_kbits=22.17, max_err=0.00050),
    dict(work="[10] DCTIF", precision=16, gates=800, memory_kbits=1250.5, max_err=0.00010),
    dict(work="paper CR (published)", precision=13, gates=5840, memory_kbits=0.0, max_err=0.000152),
]
