"""The metrics that read the program's spans and counters: each reader on
hand-made traces with nested spans, idle gaps inside and outside them, and
none; the B1 no-op probe's deltas; and, on the card, the spans on the
device's clock."""

import copy

import pytest
import torch

from cardbench.harness import fields, program, spans, spec, trace

B1Counts = spec.metric_module("b1_noop_launch_pct").B1Counts


def event(name, start, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": start,
            "dur": end - start}


# Two runs in a window of [0, 1000] us.  Device busy: [0, 30], [120, 180],
# [300, 340], [400, 560], [620, 700], [850, 870], [950, 1000]; idle: [30,
# 120], [180, 300], [340, 400], [560, 620], [700, 850], [870, 950].
SPANS = [
    event(trace.WINDOW, 0, 1000),
    event("radler.init", 0, 50),
    event("radler.perform", 50, 900),
    event("radler.perform.load", 60, 100),
    event("radler.perform.noise", 100, 200),
    event("radler.algorithm", 250, 800),
    event("clark.select", 260, 360),
    event("aten::nonzero", 300, 350, cat="cpu_op"),
    event("clark.b2", 360, 600),
    event("multiscale.loop", 600, 790),
    event("multiscale.pass", 610, 780),
    event("radler.perform.store", 820, 880),
    event("radler.perform", 910, 990),
    event("clark.select", 915, 935),
]
DEVICE = [
    event("void regular_fft<2500u>(kernel_arguments_t)", 0, 30, "kernel"),
    event("void median_kernel(float*)", 120, 180, "kernel"),
    event("void select_kernel(float*)", 300, 340, "kernel"),
    event("void subminor_loop_kernel<true>(float*)", 400, 560, "kernel"),
    event("void hogbom_select_step_kernel<1>(float*)", 620, 700, "kernel"),
    event("Memcpy DtoH", 850, 870, "gpu_memcpy"),
    event("void vector_fft<1250u>(kernel_arguments_t)", 950, 1000, "kernel"),
    # A range the profiler projects onto the device's timeline: not work.
    event("radler.perform", 40, 990, "gpu_user_annotation"),
]


def context(events=SPANS, runs=2, probes=None):
    device, host, window = trace.parse({"traceEvents": events + DEVICE})
    return trace.TraceContext(
        config={}, device_name="NVIDIA H100 80GB HBM3", runs=runs,
        iterations=[600] * runs, window=window, device=device, host=host,
        probes=probes or {})


def test_intersect_and_idle_inside_spans():
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25)]) == [
        (5, 10), (20, 25)]
    assert spans.intersect([(0, 10)], []) == []
    ctx = context()
    assert spans.intervals(ctx, "radler.perform") == [(50, 900), (910, 990)]
    # Idle inside multiscale.pass: [610, 620] and [700, 780].
    assert spans.idle_s(ctx, spans.intervals(ctx, "multiscale.pass")
                        ) == pytest.approx(90e-6)


def test_entry_idle_leaves_the_algorithm_out():
    """Idle inside radler.perform and outside radler.algorithm: [50, 120],
    [180, 250], [800, 850], [870, 900] and [910, 950]; the gap before the
    perform ([30, 50], in radler.init) counts nowhere."""
    read = spec.metric_reader("entry_idle_ms_per_run")
    assert read(context()) == pytest.approx((70 + 70 + 50 + 30 + 40) * 1e-3
                                            / 2)
    assert read(context(runs=4)) == pytest.approx(260e-3 / 4)


def test_select_sums_its_spans():
    read = spec.metric_reader("select_ms_per_run")
    assert read(context()) == pytest.approx((100 + 20) * 1e-3 / 2)


def test_fused_loop_idle():
    """Idle inside multiscale.loop: [600, 620] and [700, 790]."""
    read = spec.metric_reader("fused_loop_idle_ms_per_run")
    assert read(context()) == pytest.approx((20 + 90) * 1e-3 / 2)


@pytest.mark.parametrize("name", ["entry_idle_ms_per_run",
                                  "select_ms_per_run",
                                  "fused_loop_idle_ms_per_run"])
def test_span_readers_give_nothing_without_their_spans(name):
    """A program without spans (the parent of the spans) gives no value,
    never a 0; so does a stretch of no runs."""
    read = spec.metric_reader(name)
    assert read(context(events=SPANS[:1])) is None
    assert read(context(runs=0)) is None


def test_b1_noop_share():
    read = spec.metric_reader("b1_noop_launch_pct")
    ctx = context(probes={"b1_noop_launch_pct": [B1Counts(1096, 496)]})
    assert read(ctx) == pytest.approx(100 * 496 / 1096)
    assert read(context()) is None
    assert read(context(probes={"b1_noop_launch_pct": [B1Counts(0, 0)]})
                ) is None


def test_b1_probe_reads_the_counters_deltas(monkeypatch):
    """The probe records the counters' change over the stretch it is
    installed for, and nothing where the program has no counters."""
    from radler_tpu_torch.kernels import hogbom_step

    loop = hogbom_step.run_chunks
    monkeypatch.setattr(loop, "enqueued", 1000, raising=False)
    monkeypatch.setattr(loop, "noops", 300, raising=False)
    module = spec.metric_module("b1_noop_launch_pct")
    p = module.probe()
    with p.installed():
        p.run = 1
        loop.enqueued += 128
        loop.noops += 64
    assert [(c.enqueued, c.noops) for c in p.settle({0: 600, 1: 600})
            ] == [(128, 64)]
    monkeypatch.delattr(loop, "enqueued")
    p = module.probe()
    with p.installed():
        pass
    assert p.settle({}) == []


@pytest.mark.gpu
def test_b2_runs_inside_its_span_on_the_card(card):
    """In a traced Clark run on the card, every ``subminor_loop_kernel``
    starts after its ``clark.b2`` span starts and ends before it ends (the
    span ends at ``read_result``, which waits for the kernel): the spans
    and the device's events share one clock."""
    cell = spec.resolve("clark_wideband_8k.dense_field")
    config = copy.deepcopy(cell.config)
    traffic = copy.deepcopy(cell.traffic)
    config["image_size"] = 2048
    config["settings"]["minor_iteration_count"] = 1000
    # At 2048^2 only the polynomial fit runs B2 (the others take B1 up to
    # 4096^2, generic_clean.py's rule).
    config["settings"]["spectral_fitting.mode"] = "POLYNOMIAL"
    traffic["fields"] = 1
    pool = fields.make_fields(config, traffic, 2**31 + 5, card)

    def run():
        program.deconvolve(config, pool.psfs, pool.pool[0],
                           pool.frequencies, pool.weights)
        torch.cuda.synchronize(card)

    run()  # the library's build and cuFFT's plans
    device, host, window = trace.profile(run)
    kernels = [e for e in device if "subminor_loop_kernel" in e.name]
    b2 = [e for e in host if e.name == "clark.b2"]
    assert kernels and b2
    for k in kernels:
        assert any(s.start <= k.start and k.end <= s.end for s in b2), k
