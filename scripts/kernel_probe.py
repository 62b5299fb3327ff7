#!/usr/bin/env python3
"""A debug subset of ``chip_smoke.py``: build the kernels, print what
``-Xptxas -v`` says of each, and run the phases of the kernels named on the
command line, on one NVIDIA GPU.  Run from the root of a checkout:

    python3 scripts/kernel_probe.py b2        # the subminor kernel
    python3 scripts/kernel_probe.py b3        # the à-trous kernel
    python3 scripts/kernel_probe.py ms        # multiscale: B1 linear, config 3
                                              # on its 3 routes, the mesh
    python3 scripts/kernel_probe.py dense     # the dense subminor loop's forms
    python3 scripts/kernel_probe.py facets    # B1's facet mode, config 5 on
                                              # its 5 routes, card vs CPU
    python3 scripts/kernel_probe.py asp       # ASP, component optimization
    python3 scripts/kernel_probe.py mesh      # the mesh's Clark loop (B2's
                                              # tile axis), MORE_SANE, PYTHON
    python3 scripts/kernel_probe.py b2 b3 check   # against plain only
    python3 scripts/kernel_probe.py registers PARENT_ROOT .
                        # registers of B1's step instantiations in each
                        # checkout, and whether the single-cube step's SASS
                        # is the first checkout's

``check`` leaves out the timing phases.  It imports nothing of JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def dense_loop_forms(iterations=640, rounds=3):
    """Multiscale's dense subminor loop at config 3's shape ([8, 2048,
    2048], B1 in linear mode with a weight plane) in its three forms: no
    fit, the host path's fit between launches (``fitter``) and the fused
    loop's fit in coefficient space (``coefficients``); ``iterations``
    iterations from the brightest pixel with no threshold, in turns over
    ``rounds`` rounds; prints the milliseconds per iteration
    (synchronized host clock)."""
    import time

    import numpy as np

    from radler_tpu_torch.image_set import CubeMeta
    from radler_tpu_torch.models.multiscale_fused import (
        _coefficient_basis,
        dense_subminor_loop,
    )
    from radler_tpu_torch.ops.spectral_fitting import SpectralFitter
    from radler_tpu_torch.settings import SpectralFittingMode

    C, size = cs.MS_CHANNELS, cs.MS_SIZE
    inputs = cs._case_inputs("linear", C, 1, False, size, size, seed=C)
    meta = CubeMeta(C, 1, (1.0,) * C, (True,), 1.0, False,
                    tuple(1e8 + 1e7 * c for c in range(C)))
    fitter = SpectralFitter(SpectralFittingMode.POLYNOMIAL, 2,
                            meta.frequencies, meta.weights)
    dev = inputs["res"].device
    pair = (torch.as_tensor(fitter._fit_matrix, dtype=torch.float32,
                            device=dev),
            torch.as_tensor(_coefficient_basis(fitter, meta), device=dev))
    flat = int(torch.argmax(inputs["res"][0].abs()))
    y, x = divmod(flat, size)
    forms = {"no fit": {}, "fit between launches (host path)":
             {"fitter": fitter}, "coefficient space (fused loop)":
             {"coefficients": pair}}
    times = {name: [] for name in forms}
    for _ in range(rounds):
        for name, kw in forms.items():
            res = inputs["res"].clone()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = dense_subminor_loop(
                res, inputs["psfs"], inputs["weight"], None, 1e-9, 0.1, 0,
                iterations, 0.0, (float(res[0, y, x]), x, y, True),
                meta=meta, allow_negative=True, stop_on_negative=False, **kw)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - start) * 1e3
                               / out[2])
    for name, t in times.items():
        cs.say(f"  {name}: {', '.join(f'{v:.4f}' for v in t)} ms an "
               f"iteration ({iterations} iterations)")


def _step_kernels(root):
    """The kernel library of the checkout at ``root``, built there (or
    reused) by its own ``_build``: {(kind, template arguments): (registers,
    SASS instructions)} for each instantiation of B1's single-cube step
    (mode, row shard) and facet step, from ``cuobjdump``, which reads a
    reused library as well as a fresh one."""
    import re
    import shutil
    import subprocess

    code = ("import sys; sys.path.insert(0, '.'); "
            "from radler_tpu_torch.kernels import _build; _build.library(); "
            "print(_build.BuildInfo.path)")
    path = subprocess.run([sys.executable, "-c", code], cwd=root, text=True,
                          capture_output=True, check=True).stdout.split()[-1]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def dump(*flags):
        return subprocess.run([cuobjdump, *flags, path], text=True,
                              capture_output=True, check=True).stdout

    def key(mangled):
        entry = re.search(r"(hogbom_(?:facet_)?step_kernel)I((?:L[ib]\d+E)+)E",
                          mangled)
        if not entry:
            return None
        args = tuple(int(a) for a in re.findall(r"L[ib](\d+)E", entry[2]))
        return entry[1], args

    kernels = {}
    for mangled, regs in re.findall(r"Function (\S+):\s*REG:(\d+)",
                                    dump("--dump-resource-usage")):
        k = key(mangled)
        if k:
            kernels[k] = [int(regs), None]
    for mangled, body in re.findall(
            r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)",
            dump("-sass"), flags=re.S):
        k = key(mangled)
        if k in kernels:
            kernels[k][1] = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*;)", body)
    return path, kernels


def step_registers(roots=(".",)):
    """ptxas's registers for each instantiation of B1's single-cube step
    (mode, row shard) and its facet step, for each checkout in ``roots``;
    with two or more roots, whether each single-cube instantiation's SASS is
    the same as in the first (the instructions, without their addresses)."""
    modes = ("signed", "linear", "normal", "squared")
    first = None
    for root in roots:
        path, kernels = _step_kernels(root)
        cs.say(f"  {Path(root).resolve()}: {path}")
        for (kind, args), (regs, sass) in sorted(kernels.items()):
            names = [modes[args[0]], *map(str, args[1:])]
            label = f"{kind}<{', '.join(names)}>"
            same = ""
            # The single-cube step: (mode, row shard) and, in checkouts
            # before the facet step had its own kernel, a facet flag of 0.
            single = kind == "hogbom_step_kernel" and not any(args[2:])
            if single and first is not None:
                theirs = first.get(args[:2])
                same = (f", SASS the same as the first root's "
                        f"({len(sass)} instructions): {sass == theirs}")
            cs.say(f"    {label}: {regs} registers{same}")
        if first is None:
            first = {args[:2]: sass for (kind, args), (_, sass)
                     in kernels.items()
                     if kind == "hogbom_step_kernel" and not any(args[2:])}


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    cs.say("== the card ==")
    cs.phase_card()
    timed = "check" not in argv
    if "registers" in argv:
        cs.say("== B1's step instantiations: registers (cuobjdump) ==")
        step_registers([a for a in argv if Path(a).is_dir()] or ["."])
    if "b2" in argv:
        cs.say("== the subminor kernel against its plain version ==")
        cs.phase_subminor_vs_plain()
        cs.say("== the subminor kernel at config 2's shapes ==")
        psf2, residual2 = cs.make_problem(cs.CLARK_SIZE, cs.N_SOURCES)
        if timed:
            cs.phase_subminor_times(psf2, residual2)
        cs.say("== config 2 (Clark) through Radler.perform ==")
        cs.phase_config2(psf2, residual2)
        cs.say("== point-source contract, Clark ==")
        cs.phase_contract(clark=True)
    if "b3" in argv:
        cs.say("== the à-trous kernel (B3) against its plain version ==")
        cs.phase_atrous_vs_plain()
        if timed:
            cs.say("== B3 times at 4096^2 ==")
            cs.phase_atrous_times()
        cs.say("== config 4 (IUWT 4096^2) through Radler.perform ==")
        iuwt = cs.phase_config4()
        cs.say("== B3 against its plain version at config 4's shapes ==")
        cs.phase_atrous_main_shapes(iuwt[2])
        cs.say("== the IUWT diffuse-source contract ==")
        cs.phase_iuwt_contract()
    if "dense" in argv:
        cs.say("== multiscale's dense subminor loop in its three forms ==")
        dense_loop_forms()
    if "ms" in argv:
        cs.say("== B1 in linear mode at config 3's shape against its plain "
               "version ==")
        cs.phase_linear_b1()
        cs.say("== config 3 (multiscale 2048^2 x 8 channels) through "
               "Radler.perform: the fused, dense and Clark routes ==")
        cs.phase_config3()
        for route in ("fused", "dense"):
            cs.say(f"== point-source contract, multiscale, {route} route ==")
            cs.phase_ms_contract(route)
            cs.say(f"== multiscale on the card against the CPU, {route} "
                   "route ==")
            cs.phase_ms_card_vs_cpu(route)
        cs.say("== multiscale on a chan 4 x tile 2 mesh ==")
        cs.phase_ms_mesh()
        if timed:
            cs.say("== B4 in linear mode at the multiscale mesh's shard ==")
            cs.phase_b4_times(cs.B4_LINEAR_CASE)
    if "facets" in argv:
        cs.say("== B1's step instantiations: registers (cuobjdump) ==")
        step_registers()
        cs.say("== B1's facet mode against its plain version ==")
        cs.phase_facet_b1_vs_plain()
        cs.say("== config 5 through Radler.perform ==")
        runs = cs.phase_config5()
        boxes = runs["generic, batched"]["boxes"]
        if timed:
            cs.say("== B1's facet mode at config 5's shape and true boxes ==")
            cs.phase_facet_b1_times([(b[3], b[2]) for b in boxes])
            cs.say("== the same in linear mode with a PSF stack a facet ==")
            cs.phase_facet_b1_times([(b[3], b[2]) for b in boxes], "linear",
                                    shared=False)
        cs.say("== faceted performs on the card against the CPU ==")
        cs.phase_facets_card_vs_cpu()
    if "asp" in argv:
        cs.say("== point-source contract, ASP ==")
        cs.phase_asp_contract()
        if timed:
            cs.say("== ASP through Radler.perform ==")
            cs.phase_asp_perform()
        cs.say("== ASP on the card against the CPU ==")
        cs.phase_asp_card_vs_cpu()
        cs.say("== component optimization on the card against the CPU ==")
        cs.phase_component_optimization_card_vs_cpu()
    if "mesh" in argv:
        psf, residual = cs.make_problem(cs.SIZE, cs.N_SOURCES)
        psfs, res, kwargs = cs._joined_inputs(psf, residual)
        del psf, residual
        cs.say("== the joined-channel cube, Clark, chan 4 x tile 2 ==")
        cs.phase_mesh_clark("joined channels", psfs, res, kwargs, cs.SIZE,
                            cs.MESH_ITERATIONS)
        del psfs, res
        psf2, residual2 = cs.make_problem(cs.CLARK_SIZE, cs.N_SOURCES)
        cs.say("== config 2, Clark, chan 1 x tile 8 ==")
        cs.phase_mesh_clark(
            "config 2", torch.as_tensor(psf2, device=cs.DEVICE),
            torch.as_tensor(residual2, device=cs.DEVICE), {}, cs.CLARK_SIZE,
            cs.ITERATIONS, tile_times=timed)
        cs.say("== MORE_SANE and PYTHON at config 2's field ==")
        cs.phase_host_plugins(psf2, residual2)
    cs.say("probe done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
