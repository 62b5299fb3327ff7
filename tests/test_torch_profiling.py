"""``radler_tpu_torch.utils.profiling`` and the spans the port opens with
it: ``trace``, ``annotate`` with and without a profiler recording, the
span tree of a Clark and of a fused multiscale ``Radler.perform`` on the
CPU, results unchanged under the profiler, the Högbom loop's counters of
enqueued and no-op iterations, the Clark selection's counters, and the
module's imports."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import radler_tpu_torch as rd
from radler_tpu_torch.kernels import hogbom_step as hs
from radler_tpu_torch.models import subminor as sm
from radler_tpu_torch.utils import profiling

# Several test processes share the machine's cores; one intra-op thread
# each keeps the small CPU tensor ops from contending for them.
torch.set_num_threads(1)

SIZE = 128
PREFIXES = ("radler.", "generic.", "clark.", "multiscale.")


def test_trace_writes_a_chrome_trace_with_nested_annotations(tmp_path):
    """On the CPU ``trace`` writes ``trace.json``, and an ``annotate``
    range inside another shows up inside it in the trace."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    path = tmp_path / "trace" / "trace.json"
    assert path.exists()
    events = {e["name"]: e for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("ph") == "X"}
    outer, inner = events["outer"], events["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner"} <= names


def test_annotate_without_a_profiler_is_the_shared_no_op(monkeypatch):
    """With no profiler recording, ``annotate`` never reaches
    ``record_function`` and hands out one shared no-op."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.annotate("a"), profiling.annotate("b")
    assert first is second is profiling._NO_SPAN
    with first:
        with second:
            pass


def test_annotate_follows_the_profilers_flag(monkeypatch):
    """``annotate`` opens a ``record_function`` range exactly when
    ``torch._C._autograd._profiler_enabled()`` says a profiler records."""
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or name)
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled",
                        lambda: True)
    assert profiling.annotate("span") == "span"
    monkeypatch.setattr(torch._C._autograd, "_profiler_enabled",
                        lambda: False)
    assert profiling.annotate("other") is profiling._NO_SPAN
    assert opened == ["span"]


# ---------------------------------------------------------------------------
# The program's spans on the CPU
# ---------------------------------------------------------------------------


def problem(n_chan=2, seed=3):
    """Point sources and Gaussian blobs under a ringed Gaussian PSF whose
    width grows with the channel; returns (psfs, residual, frequencies)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    r2 = (yy - SIZE // 2) ** 2 + (xx - SIZE // 2) ** 2
    sky = np.zeros((SIZE, SIZE), np.float32)
    for _ in range(12):
        cy, cx = rng.integers(SIZE // 8, 7 * SIZE // 8, 2)
        s = rng.uniform(0.5, 8.0)
        sky += rng.uniform(0.2, 1.0) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    psfs, residual = [], []
    for c in range(n_chan):
        w = 2.5 * (1.0 + 0.04 * c)
        p = np.exp(-r2 / (2 * w * w)) + 0.06 * np.exp(
            -((np.sqrt(r2) - 14.0) ** 2) / 6)
        psfs.append(p.astype(np.float32))
        fp = np.fft.rfft2(np.fft.ifftshift(psfs[-1]))
        residual.append(np.fft.irfft2(np.fft.rfft2(sky * (1 + 0.1 * c)) * fp,
                                      s=(SIZE, SIZE)))
    freqs = np.array([[1.0e8 + c * 1e7, 1.1e8 + c * 1e7]
                      for c in range(n_chan)])
    return (np.stack(psfs), np.stack(residual).astype(np.float32), freqs)


def settings(route):
    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = SIZE
    s.minor_loop_gain = 0.1
    s.spectral_fitting.mode = rd.SpectralFittingMode.POLYNOMIAL
    s.spectral_fitting.terms = 2
    if route == "clark":
        s.minor_iteration_count = 100
        s.absolute_threshold = 0.02
    else:
        s.algorithm_type = rd.AlgorithmType.MULTISCALE
        s.minor_iteration_count = 60
        s.major_loop_gain = 0.85
    return s


def perform(route):
    """One ``Radler.perform`` on the CPU; returns (residual, model,
    iterations)."""
    psfs, residual, freqs = problem()
    model = np.zeros_like(residual)
    r = rd.Radler(settings(route), psfs, residual, model, 0.0,
                  frequencies=freqs, device="cpu")
    r.perform(0)
    return residual, model, r.iteration_number


def traced(fn, tmp_path):
    """``fn()`` under :func:`profiling.trace` on the CPU; returns its result
    and the program's spans as (name, start, end) from the Chrome trace, by
    start."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIXES)]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def children(spans, parent):
    """The spans directly inside ``parent``, in time order."""
    inside = [s for s in spans if s is not parent
              and parent[1] <= s[1] and s[2] <= parent[2]]
    return [s for s in inside
            if not any(o is not s and o[1] <= s[1] and s[2] <= o[2]
                       for o in inside)]


def only(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_clark_perform_spans(tmp_path):
    """A Clark perform (128^2, 2 channels): ``radler.perform`` holds the
    loads, the noise, ``radler.algorithm`` and the store; the algorithm
    holds the peak, the selection, B2 and the correction, in that order."""
    _, spans = traced(lambda: perform("clark"), tmp_path)
    outer = [s[0] for s in spans if not any(
        o is not s and o[1] <= s[1] and s[2] <= o[2] for o in spans)]
    assert outer == ["radler.init", "radler.perform"]
    top = only(spans, "radler.perform")
    assert [s[0] for s in children(spans, top)] == [
        "radler.perform.load", "radler.perform.noise", "radler.perform.load",
        "radler.algorithm", "radler.perform.store"]
    algorithm = only(spans, "radler.algorithm")
    assert [s[0] for s in children(spans, algorithm)] == [
        "generic.peak", "clark.select", "clark.b2", "clark.correct"]


def test_clark_perform_selection_counters():
    """A Clark perform without a mask selects its candidates once, and that
    selection copies no host mask: the window is the borders' slice of the
    card's value plane."""
    calls, host_masks = (sm.select_candidates.calls,
                         sm.select_candidates.host_masks)
    _, _, iterations = perform("clark")
    assert iterations > 0
    assert sm.select_candidates.calls - calls == 1
    assert sm.select_candidates.host_masks - host_masks == 0


def test_fused_multiscale_perform_spans_and_counters(tmp_path):
    """A fused multiscale perform: the banks, then ``multiscale.loop``
    holding the first maxima and one ``multiscale.pass`` a pass, each
    holding one dense loop, one correction and one maxima refresh; the
    Högbom loop's counters account for every iteration it ran."""
    enqueued, noops = hs.run_chunks.enqueued, hs.run_chunks.noops
    (_, _, iterations), spans = traced(lambda: perform("multiscale"),
                                       tmp_path)
    assert iterations > 0
    ran = (hs.run_chunks.enqueued - enqueued) - (hs.run_chunks.noops - noops)
    assert ran == iterations
    algorithm = only(spans, "radler.algorithm")
    assert [s[0] for s in children(spans, algorithm)] == [
        "multiscale.banks", "multiscale.loop"]
    loop = children(spans, only(spans, "multiscale.loop"))
    names = [s[0] for s in loop]
    assert names[0] == "multiscale.maxima" and len(names) > 1
    assert set(names[1:]) == {"multiscale.pass"}
    for one_pass in loop[1:]:
        assert [s[0] for s in children(spans, one_pass)] == [
            "multiscale.dense", "multiscale.correct", "multiscale.maxima"]


@pytest.mark.parametrize("route", ["clark", "multiscale"])
def test_results_equal_with_and_without_a_profiler(route, tmp_path):
    """The spans change nothing the perform computes: residual, model and
    iteration count are bit-equal with a profiler recording and without."""
    plain = perform(route)
    under, spans = traced(lambda: perform(route), tmp_path)
    assert spans
    assert under[2] == plain[2] > 0
    np.testing.assert_array_equal(under[0], plain[0])
    np.testing.assert_array_equal(under[1], plain[1])


@pytest.mark.parametrize("stop,limit,want_noops", [
    (30, 1000, 34),  # stops mid-chunk: the chunk's other 34 do nothing
    (128, 1000, 0),  # stops on a chunk boundary
    (100, 100, 0),  # the iteration limit trims the last chunk
])
def test_run_chunks_counts_enqueued_and_noop_iterations(stop, limit,
                                                        want_noops):
    """``run_chunks.enqueued - run_chunks.noops`` is the iterations the
    loop ran on the device, read from the state's host reads."""
    state = torch.zeros(hs.STATE_SIZE, dtype=torch.int32)
    state[hs.ACTIVE] = 1
    buffers = hs.LoopBuffers(state, torch.zeros(1), torch.zeros(1),
                             torch.zeros(1))

    def iterate():  # the kernel's contract: a no-op once inactive
        if state[hs.ACTIVE]:
            state[hs.ITERATION] += 1
            state[hs.ACTIVE] = int(state[hs.ITERATION] < stop)

    params = hs.LoopParams.make(0.1, 0.0, 1.0, 0.0, limit, False)
    enqueued, noops = hs.run_chunks.enqueued, hs.run_chunks.noops
    out = hs.run_chunks(iterate, buffers, params, 0, True)
    assert out.iteration == min(stop, limit)
    assert hs.run_chunks.noops - noops == want_noops
    assert (hs.run_chunks.enqueued - enqueued) - want_noops == out.iteration


def test_importing_the_module_loads_no_jax():
    code = ("import sys, radler_tpu_torch.utils.profiling; "
            "print(any(m == 'jax' or m.startswith('jax.') "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"
