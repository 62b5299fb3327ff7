"""The traced run's reduction on a hand-made trace: the window, the busy
and idle time, the breakdown, and each per-layer metric's reader."""

import pytest

from cardbench.harness import roofline, spec, trace

B2Call = spec.metric_module("b2_roofline_pct").B2Call

TRACE = {"traceEvents": [
    {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW, "ts": 0,
     "dur": 1000},
    {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 300,
     "dur": 200},
    {"ph": "X", "cat": "kernel", "ts": 0, "dur": 100,
     "name": "void regular_fft<2500u>(kernel_arguments_t)"},
    {"ph": "X", "cat": "kernel", "ts": 100, "dur": 200,
     "name": "void (anonymous namespace)::subminor_loop_kernel<true>(float*)"},
    {"ph": "X", "cat": "gpu_memcpy", "ts": 250, "dur": 50,
     "name": "Memcpy HtoD"},
    {"ph": "X", "cat": "kernel", "ts": 500, "dur": 300,
     "name": "void hogbom_select_step_kernel<1>(float*)"},
    {"ph": "X", "cat": "kernel", "ts": 950, "dur": 100,
     "name": "void vector_fft<1250u>(kernel_arguments_t)"},
    {"ph": "i", "cat": "kernel", "ts": 5, "name": "instant"},
]}


def context(**kwargs):
    device, host, window = trace.parse(TRACE)
    config = spec.resolve("multiscale_wideband_2k.diffuse").config
    base = dict(config=config, device_name="NVIDIA H100 80GB HBM3", runs=2,
                iterations=[600, 600], window=window, device=device,
                host=host)
    base.update(kwargs)
    return trace.TraceContext(**base)


def test_window_busy_and_idle():
    ctx = context()
    assert ctx.window == (0.0, 1000.0) and ctx.window_s == pytest.approx(1e-3)
    # Busy: [0, 300] and [500, 800] and [950, 1000] inside the window.
    assert ctx.busy_s() == pytest.approx(650e-6)
    idle = spec.metric_reader("device_idle_pct")(ctx)
    assert idle == pytest.approx(35.0)
    gaps = trace.idle_gaps(ctx)
    assert gaps[0] == ["aten::nonzero", pytest.approx(200e-6)]
    assert gaps[1] == ["host (no op)", pytest.approx(150e-6)]
    ops = dict(trace.top_device_ops(ctx))
    assert ops[TRACE["traceEvents"][5]["name"]] == pytest.approx(300e-6)


def test_fft_and_sync_readers():
    ctx = context(syncs=[120, 126])
    assert spec.metric_reader("fft_ms_per_run")(ctx) == pytest.approx(
        (100 + 100) * 1e-3 / 2)
    assert spec.metric_reader("host_syncs_per_run")(ctx) == 123.0
    assert spec.metric_reader("host_syncs_per_run")(context()) is None


def test_roofline_readers():
    ctx = context(probes={"b2_roofline_pct": [B2Call(0, 4, 1000, 0, 80, 10)]})
    b, f = roofline.b2_work(4, 1000, 10, 80)
    # Every iteration gathers its K * N four-byte PSF values.
    assert b == 3 * 4 * 1000 * 4 + 2 * 1000 * 4 + 80 + 10 * 4 * 1000 * 4
    want = 100 * roofline.bound_s(b, f, ctx.device_name)[0] / 200e-6
    assert spec.metric_reader("b2_roofline_pct")(ctx) == pytest.approx(want)
    b, f = roofline.b1_linear_work(8, 2048, 2048, 1200)
    want = 100 * roofline.bound_s(b, f, ctx.device_name)[0] / 300e-6
    assert spec.metric_reader("b1_roofline_pct")(ctx) == pytest.approx(want)
    # Nothing to read: no metric, never a 0.
    empty = context(device=[])
    assert spec.metric_reader("b2_roofline_pct")(empty) is None
    assert spec.metric_reader("b1_roofline_pct")(empty) is None
    assert spec.metric_reader("fft_ms_per_run")(empty) is None
