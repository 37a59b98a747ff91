"""The window's arithmetic: whole solves over their own span, phase and
counter means, and the trace-derived shares, from fixed records."""
import pytest

from edbench.core import trace, yardstick
from edbench.run import Context


def _solves():
    # three solves; the gaps between them (answers read back) count
    return [dict(t0=10.0, t1=14.0, timings=dict(diagonalization=2.0,
                                                greens_functions=1.0),
                 matvecs=100),
            dict(t0=14.5, t1=17.0, timings=dict(diagonalization=1.0,
                                                greens_functions=0.5),
                 matvecs=80),
            dict(t0=17.0, t1=22.0, timings=dict(diagonalization=3.0),
                 matvecs=90)]


def test_seconds_per_solve_is_span_over_count():
    ctx = Context({}, 5.0, _solves(), None)
    assert ctx.seconds_per_solve() == pytest.approx((22.0 - 10.0) / 3)
    assert ctx.phase_mean("diagonalization") == pytest.approx(2.0)
    assert ctx.phase_mean("greens_functions") == pytest.approx(0.75)
    assert ctx.matvecs_mean() == pytest.approx(90.0)
    assert Context({}, 1.0, [], None).seconds_per_solve() is None


def test_trace_shares():
    params = dict(norb=2, nbath=2, jx=0.15, jp=0.15)
    t = dict(n_solves=2, groups={"cuBLAS gemm/gemv": 3.0}, busy_s=4.0,
             window_s=10.0, b1_device_s=0.5, launches={(2, 4): 1000})
    ctx = Context(params, 1.0, _solves(), t)
    assert ctx.device_group_per_solve("cuBLAS gemm/gemv") == 1.5
    assert ctx.device_group_per_solve("gathers and scatters") is None
    assert ctx.idle_pct() == pytest.approx(60.0)
    least = 1000 * yardstick.bound(*yardstick.normal_sector_work(
        2, 2, 2, 4, True, True))
    assert ctx.b1_roofline_pct() == pytest.approx(100 * least / 0.5)
    t["launches"] = {}
    assert ctx.b1_roofline_pct() is None


def test_yardstick_counts_the_model():
    # (1,1) of one orbital, one bath level: 2x2 states; the hop has one
    # nonzero each way a spin; H has n + 2*2 + 2*2 nonzeros
    flops, nbytes = yardstick.normal_sector_work(1, 1, 1, 1, False, False)
    assert flops == 2 * (4 + 2 * 2 + 2 * 2)
    assert nbytes == 2 * 8 * 4 + 12 * (2 + 2)


def test_reduce_busy_gaps_and_groups():
    ev = [dict(ph="X", cat="user_annotation", name=trace.SOLVE_SPAN, ts=0,
               dur=100),
          dict(ph="X", cat="user_annotation", name="sector build", ts=0,
               dur=40),
          dict(ph="X", cat="kernel", name="row_gather_kernel<double, 4>",
               ts=40, dur=10),
          dict(ph="X", cat="kernel", name="ampere_dgemm_64x64", ts=45,
               dur=20),
          dict(ph="X", cat="kernel", name="ampere_dgemm_64x64", ts=90,
               dur=5)]
    r = trace.reduce(ev)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["groups"]["fused matvec B1 (f64)"] == pytest.approx(10e-6)
    assert r["groups"]["cuBLAS gemm/gemv"] == pytest.approx(25e-6)
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0] == ["sector build", pytest.approx(40e-6)]
    assert [g[1] for g in gaps] == pytest.approx([40e-6, 25e-6, 5e-6])


def test_traced_run_fails_when_a_wrapped_name_is_gone(monkeypatch):
    from edipack_tpu_torch.solver import core
    monkeypatch.delattr(core, "build_fused_normal")
    with pytest.raises(RuntimeError, match="build_fused_normal"):
        with trace.instrumented():
            pass
