#!/usr/bin/env python
"""How far the JAX package's IUWT perform differs from itself.

Runs the problem of ``tests/test_algorithms.py::test_iuwt_diffuse_source``
(128^2 diffuse source, seed 0) through ``radler_tpu.Radler.perform`` in
several fresh CPU processes, each pinned to a different number of cores,
at each iteration count given, and prints every run's final residual rms
and model flux and, per count, the largest difference between two runs'
residuals.  Then it runs the port, ``radler_tpu_torch``, on the same inputs
on the CPU with one torch thread, as its tests do, and prints how far it
lies from each JAX run.  ``tests/test_torch_iuwt.py`` holds the port to
this spread.

    python scripts/iuwt_jax_spread.py [--repeats N] [iterations ...]
                                                    # default: 2, 40 50
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

RUN = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import radler_tpu as rd
from radler_tpu.ops.convolution import padded_convolve

size, iterations = 128, int(sys.argv[1])
yy, xx = np.mgrid[0:size, 0:size]
r2 = (yy - size // 2) ** 2 + (xx - size // 2) ** 2
psf = np.exp(-r2 / (2 * 2.0**2)).astype(np.float32)
sky = np.exp(-((yy - 60.0) ** 2 + (xx - 70.0) ** 2) / (2 * 4.0**2))
residual = np.asarray(padded_convolve(jnp.asarray(sky.astype(np.float32)),
                                      jnp.asarray(psf))).astype(np.float32)
residual += np.random.default_rng(0).normal(
    scale=1e-3, size=residual.shape).astype(np.float32)
model = np.zeros_like(residual)
if sys.argv[3] == "port":
    import torch
    import radler_tpu_torch as rd
    torch.set_num_threads(1)
s = rd.Settings()
s.algorithm_type = rd.AlgorithmType.IUWT
s.trimmed_image_width = s.trimmed_image_height = size
s.pixel_scale.x = s.pixel_scale.y = np.pi / (180.0 * 60.0)
s.minor_iteration_count = iterations
kwargs = {"device": "cpu"} if sys.argv[3] == "port" else {}
r = rd.Radler(s, psf, residual, model, 0.0, **kwargs)
r.perform(0)
np.save(sys.argv[2], np.stack([residual, model]))
"""


def main() -> int:
    args = sys.argv[1:]
    repeats = 2
    if args[:1] == ["--repeats"]:
        repeats, args = int(args[1]), args[2:]
    counts = [int(a) for a in args] or [40, 50]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    n_cores = os.cpu_count() or 1
    core_sets = sorted({"0", f"0-{min(1, n_cores - 1)}",
                        f"0-{min(3, n_cores - 1)}", f"0-{n_cores - 1}"})
    with tempfile.TemporaryDirectory() as tmp:
        for iterations in counts:
            finals = []
            for repeat in range(repeats):
                for cores in core_sets:
                    out = os.path.join(tmp, f"{iterations}-{cores}-{repeat}.npy")
                    subprocess.run(
                        ["taskset", "-c", cores, sys.executable, "-c", RUN,
                         str(iterations), out, "jax"],
                        env=env, check=True, capture_output=True,
                    )
                    res, model = np.load(out)
                    finals.append(res)
                    print(f"{iterations} iterations, cores {cores}, run "
                          f"{repeat}: residual rms "
                          f"{np.sqrt((res.astype(np.float64) ** 2).mean())!r}, "
                          f"model flux {float(model.sum())!r}", flush=True)
            spread = max(float(np.abs(a - b).max())
                         for a in finals for b in finals)
            print(f"{iterations} iterations: max |residual difference| "
                  f"between two runs {spread!r}")
            out = os.path.join(tmp, f"{iterations}-port.npy")
            subprocess.run([sys.executable, "-c", RUN, str(iterations), out,
                            "port"], env=env, check=True, capture_output=True)
            port, _ = np.load(out)
            port_rms = np.sqrt((port.astype(np.float64) ** 2).mean())
            for res in finals:
                res_rms = np.sqrt((res.astype(np.float64) ** 2).mean())
                print(f"{iterations} iterations, the port: residual rms "
                      f"{port_rms!r}; against a JAX run: max |residual "
                      f"difference| {float(np.abs(port - res).max())!r}, "
                      f"rms relative {abs(port_rms - res_rms) / res_rms!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
