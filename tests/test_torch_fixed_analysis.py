"""Port vs reference: the error analysis of the paper's Tables I/II
(``core/error_analysis.py``) and the gate-count model
(``core/gatecount.py``).

The reference picks its float grid's precision from jax's global 64-bit
flag; the port takes it as ``dtype``. Each mode is held against the
reference run in the same mode. The statistics are equal as floats: the
fixed datapath is integer, and the float paths are the same f32 (or f64)
operations on the same lattice (measured: every statistic equal).
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import error_analysis as jea  # noqa: E402
from repro.core import gatecount as jgc  # noqa: E402
from repro.core.activations import ActivationConfig as JCfg  # noqa: E402
from repro.core.activations import ActivationEngine as JEng  # noqa: E402
from repro.core.approximant import spec_for as j_spec_for  # noqa: E402
from repro.core.fixed_point import QFormat as JQ  # noqa: E402
from repro_torch.core import error_analysis as tea  # noqa: E402
from repro_torch.core import gatecount as tgc  # noqa: E402
from repro_torch.core.activations import ActivationConfig as TCfg  # noqa: E402
from repro_torch.core.activations import ActivationEngine as TEng  # noqa: E402
from repro_torch.core.approximant import spec_for as t_spec_for  # noqa: E402
from repro_torch.core.fixed_point import QFormat as TQ  # noqa: E402

LSB = 2.0 ** -13
CPU = "cpu"
# (method, depth, degree) of each scheme's deployed geometry
METHODS = [("cr", 32, 3), ("pwl", 32, 3), ("poly", 8, 3),
           ("rational", 32, 5)]


def same(a, b):
    assert dataclasses.astuple(a) == dataclasses.astuple(b), (a, b)


@pytest.mark.parametrize("method,depth,degree", METHODS)
@pytest.mark.parametrize("datapath", ["float", "qlut", "qout", "fixed"])
def test_tanh_error_matches_reference(method, depth, degree, datapath):
    same(tea.tanh_error(method, depth, datapath=datapath, degree=degree,
                        device=CPU),
         jea.tanh_error(method, depth, datapath=datapath, degree=degree))


@pytest.mark.parametrize("frac_bits", [10, 16])
@pytest.mark.parametrize("method,depth,degree", METHODS)
def test_tanh_error_fixed_at_swept_qformats(method, depth, degree,
                                            frac_bits):
    same(tea.tanh_error(method, depth, datapath="fixed", degree=degree,
                        fmt=TQ(2, frac_bits), device=CPU),
         jea.tanh_error(method, depth, datapath="fixed", degree=degree,
                        fmt=JQ(2, frac_bits)))


def test_cr_depth64_fixed_is_one_lsb_and_table_1_2_matches():
    st = tea.tanh_error("cr", 64, datapath="fixed", device=CPU)
    assert abs(st.max - LSB) <= 0.05 * LSB
    same(st, tea.tanh_error("cr_spline", 64, datapath="fixed", device=CPU))
    assert tea.PAPER_TABLE_1_2 == jea.PAPER_TABLE_1_2
    for dp in ("qout", "fixed"):
        rows = tea.table_1_2(dp, device=CPU) if dp != "fixed" else [
            tea.tanh_error("cr", d, datapath=dp, device=CPU)
            for d in (8, 16, 32, 64)]
        ref = jea.table_1_2(dp) if dp != "fixed" else [
            jea.tanh_error("cr", d, datapath=dp) for d in (8, 16, 32, 64)]
        if dp == "fixed":
            for a, b in zip(rows, ref, strict=True):
                same(a, b)
        else:
            assert rows == ref
    with pytest.raises(ValueError, match="registered"):
        tea.tanh_error("cordic", 32, datapath="fixed", device=CPU)
    with pytest.raises(ValueError, match="unknown datapath"):
        tea.tanh_error("cr", 32, datapath="bogus", device=CPU)


@pytest.mark.x64
class TestFloat64Mode:
    """The reference's 64-bit mode against ``dtype=torch.float64``."""

    @pytest.fixture(autouse=True)
    def _x64(self):
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        yield
        jax.config.update("jax_enable_x64", old)

    @pytest.mark.parametrize("datapath", ["float", "qlut", "qout", "fixed"])
    def test_tanh_error_in_float64(self, datapath):
        for method, depth, degree in METHODS:
            same(tea.tanh_error(method, depth, datapath=datapath,
                                degree=degree, dtype=torch.float64,
                                device=CPU),
                 jea.tanh_error(method, depth, datapath=datapath,
                                degree=degree))

    def test_table_1_2_in_float64(self):
        assert tea.table_1_2("qout", dtype=torch.float64, device=CPU) == \
            jea.table_1_2("qout")


def test_generic_error_of_a_fixed_engine_matches_reference():
    te = TEng(TCfg(impl="cr_fixed"))
    je = JEng(JCfg(impl="cr_fixed"))
    sig = lambda g: 1.0 / (1.0 + np.exp(-g))
    same(tea.generic_error(te.sigmoid, sig, -8, 8, n=20001, device=CPU),
         jea.generic_error(je.sigmoid, sig, -8, 8, n=20001))


@pytest.mark.parametrize("scheme,depth,degree", [
    ("cr_spline", 32, 3), ("cr_spline", 64, 3), ("pwl", 16, 3),
    ("poly", 8, 3), ("poly", 16, 5), ("rational", 32, 5),
    ("rational", 32, 7)])
@pytest.mark.parametrize("frac_bits", [10, 13, 16])
def test_gatecount_matches_reference(scheme, depth, degree, frac_bits):
    kw = dict(depth=depth, degree=degree, int_bits=2, frac_bits=frac_bits)
    a = tgc.approximant_datapath(t_spec_for(scheme, "tanh", **kw))
    b = jgc.approximant_datapath(j_spec_for(scheme, "tanh", **kw))
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_gatecount_datapaths_and_published_rows_match_reference():
    assert tgc.PUBLISHED == jgc.PUBLISHED
    for t_in_lut in (False, True):
        assert dataclasses.astuple(tgc.cr_spline_datapath(
            13, 32, t_in_lut=t_in_lut)) == dataclasses.astuple(
            jgc.cr_spline_datapath(13, 32, t_in_lut=t_in_lut))
    assert tgc.rational_datapath(13, 5, newton_iters=3).gates == \
        jgc.rational_datapath(13, 5, newton_iters=3).gates
    assert tgc.AreaReport("x", 1.0, 0.0, {}).row() == ("x", 1, 0.0)

    class Bogus:
        scheme = "cordic"
    with pytest.raises(ValueError, match="no gate-count model"):
        tgc.approximant_datapath(Bogus())
