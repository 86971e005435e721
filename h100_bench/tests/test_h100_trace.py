"""The reduction of a profiler trace, on a hand-made trace: union of device
activity, the calls' spans as the window, family times from the kernel
table, the labelled idle gaps, and the failures on an unnamed kernel."""

import os
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from h100_bench import manifest
from h100_bench.trace import Trace, covered, load_kernel_table, union_runs

TABLE = load_kernel_table(os.path.join(manifest.ROOT, "h100_bench", "kernels"))
K1 = "void sesa::gemm_ws_kernel<3, true>(CUtensorMap_st, CUtensorMap_st, sesa::WsArgs)"
K2 = "void sesa::gemm_ws_kernel<0, true>(CUtensorMap_st, CUtensorMap_st, sesa::WsArgs)"
NORM = "sesa::rms_norm_rows_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, int, int)"


def ev(name, start, end, device=True, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           thread=thread)


def _events(extra=()):
    return [
        ev("bench::song#0", 0, 100, device=False), ev("bench::song#0", 1, 99),
        ev("bench::song#1", 150, 250, device=False),
        ev("aten::copy_", 10, 40, device=False), ev("cudaLaunchKernel", 41, 42, device=False),
        ev(K1, 5, 30), ev(K2, 20, 50), ev(NORM, 60, 70), ev("Memcpy DtoH (Device -> Pageable)",
                                                            80, 90),
        ev("void at::native::elementwise_kernel<4>", 160, 200), ev(K1, 210, 240),
        ev("aten::add", 120, 140, device=False),  # between calls: not the program's
        *extra]


def test_union_and_cover():
    runs = union_runs([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert runs == [(0, 20), (30, 45)]
    assert covered(runs, 10, 35) == 15
    assert covered(runs, 100, 200) == 0


def test_window_busy_families_and_gaps():
    t = Trace(_events(), TABLE, {"K1": 2, "K2": 1})
    assert t.window_us() == 200
    # song 0: 5-50, 60-70, 80-90 busy = 65; song 1: 160-200, 210-240 = 70
    assert t.busy_us() == 135
    assert t.families["K1"] == 55 and t.families["K2"] == 40
    assert t.kind_us("memcpy", ("Memcpy HtoD", "Memcpy DtoH")) == 10
    assert t.kernel_count() == 5 and t.sesa_kernel_us() == 95
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == K1 and bd["device_ops"][0][1] == pytest.approx(55e-6)
    # the gaps inside the calls: 0-5, 50-60, 70-80, 90-100 and 150-160, 200-210, 240-250
    gaps = bd["idle_gaps"]
    assert len(gaps) == 7 and sum(g[1] for g in gaps) == pytest.approx(65e-6)
    assert gaps[0][1] == pytest.approx(10e-6) and gaps[-1] == ["bench::song#0 / python",
                                                               pytest.approx(5e-6)]
    assert all(g[0].startswith("bench::") for g in gaps)


def test_a_shared_name_goes_to_the_family_that_launched():
    t = Trace(_events(), TABLE, {"K1": 2, "K2": 1})
    assert t.families["K2"] == 40  # the norm kernel: K2's pattern only


def test_an_unnamed_program_kernel_fails_the_run():
    with pytest.raises(RuntimeError, match="no family"):
        Trace(_events([ev("void sesa::renamed_kernel<1>()", 30, 31)]), TABLE, {"K1": 1})


def test_a_trace_without_spans_or_kernels_fails():
    with pytest.raises(RuntimeError, match="spans"):
        Trace([ev(K1, 0, 1)], TABLE, {})
    with pytest.raises(RuntimeError, match="no device kernel"):
        Trace([ev("bench::song#0", 0, 10, device=False)], TABLE, {})
