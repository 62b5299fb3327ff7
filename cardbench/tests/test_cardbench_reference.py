"""The plain references against the port on the CPU, at sizes a test run
holds: a sound run reads 0 on every number, and the control (the reference
in bfloat16 in the program's place) fails the configuration's limits."""

import copy

import pytest
import torch

from cardbench.harness import check, fields, program, spec

# (cell, size, minor iterations): small enough for the CPU.
CASES = [("clark_wideband_8k.dense_field", 512, 300),
         ("multiscale_wideband_2k.diffuse", 256, 60)]


def small(cell_name, size, iterations):
    cell = spec.resolve(cell_name)
    config = copy.deepcopy(cell.config)
    traffic = copy.deepcopy(cell.traffic)
    config["image_size"] = size
    config["settings"]["minor_iteration_count"] = iterations
    traffic["fields"] = 2
    return config, traffic


@pytest.mark.parametrize("cell,size,iterations", CASES)
def test_port_equals_reference(cell, size, iterations):
    config, traffic = small(cell, size, iterations)
    pool = fields.make_fields(config, traffic, 2**31 + 99, "cpu")
    for f in range(2):
        args = (pool.psfs, pool.pool[f], pool.frequencies, pool.weights)
        out = program.deconvolve(config, *args)
        res, mod = out.cubes()
        ref = check.run_reference(config, *args)
        numbers = check.compare(pool.pool[f], (res, mod, out.iterations), ref)
        assert numbers == {"iterations": 0.0, "residual": 0.0, "model": 0.0}
        assert out.iterations > 0 and float(mod.abs().max()) > 0.0
        assert check.judge(numbers, config["limits"])


@pytest.mark.parametrize("cell,size,iterations", CASES)
def test_control_fails(cell, size, iterations):
    config, traffic = small(cell, size, iterations)
    pool = fields.make_fields(config, traffic, 2**31 + 99, "cpu")
    args = (pool.psfs, pool.pool[0], pool.frequencies, pool.weights)
    control = check.run_reference(config, *args, dtype=torch.bfloat16)
    ref = check.run_reference(config, *args)
    numbers = check.compare(pool.pool[0], control, ref)
    assert not check.judge(numbers, config["limits"])
    limits = config["limits"]
    assert max(numbers["residual"] / limits["residual"],
               numbers["model"] / limits["model"]) > 100
