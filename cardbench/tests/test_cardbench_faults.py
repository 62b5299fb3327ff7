"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have, and true for the sound path."""

import copy
import time

import pytest
import torch

from cardbench.harness import cell_run, program, spec

CASES = [("clark_wideband_8k.dense_field", 512, 300),
         ("multiscale_wideband_2k.diffuse", 256, 40)]


def small_cell(name, size, iterations):
    cell = spec.resolve(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["image_size"] = size
    cell.config["settings"]["minor_iteration_count"] = iterations
    cell.config["checked_runs"] = 1
    cell.traffic["fields"] = 2
    return cell


def unchanged(config, psfs, field, frequencies, weights):
    """The run hands back its state as it came, the count as if it ran."""
    out = program.deconvolve(config, psfs, field, frequencies, weights)
    return program.RunOutput(out.iterations, out.performs,
                             [p.clone() for p in field],
                             [torch.zeros_like(p) for p in field])


def half_the_channels(config, psfs, field, frequencies, weights):
    """Half the channels deconvolved; the others get their mean."""
    h = field.shape[0] // 2
    out = program.deconvolve(config, psfs[:h], field[:h], frequencies[:h],
                             weights[:h])
    mean_r = torch.stack(out.residual).mean(0)
    mean_m = torch.stack(out.model).mean(0)
    rest = field.shape[0] - h
    return program.RunOutput(out.iterations, out.performs,
                             list(out.residual) + [mean_r] * rest,
                             list(out.model) + [mean_m] * rest)


def altered(config, psfs, field, frequencies, weights):
    """One component's value altered by 1% where it is written back."""
    out = program.deconvolve(config, psfs, field, frequencies, weights)
    model = [m.clone() for m in out.model]
    flat = model[0].view(-1)
    i = int(flat.abs().argmax())
    flat[i] = flat[i] * 1.01
    return program.RunOutput(out.iterations, out.performs, out.residual,
                             model)


@pytest.mark.parametrize("cell,size,iterations", CASES)
@pytest.mark.parametrize("fault", [None, unchanged, half_the_channels,
                                   altered])
def test_fault_turns_correct_false(cell, size, iterations, fault):
    c = small_cell(cell, size, iterations)
    kwargs = {} if fault is None else {"deconvolve": fault}
    result = cell_run.run_cell(c, 2**31 + 5, 0.0, False, "cpu",
                               time.perf_counter(), **kwargs)
    assert result.attempted >= 1 and result.failed == 0
    assert result.correct is (fault is None), result.checks
