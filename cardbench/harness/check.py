"""Whether a run's written-back cubes are correct: the cell's plain
reference recomputes the run from the same field, and each number compared
must stay within the configuration's limit.

* ``iterations``: the minor iterations' difference (exact, limit 0);
* ``residual``: the largest difference of any channel's residual pixel,
  over the largest magnitude of the field handed in;
* ``model``: the largest difference of any channel's model pixel, over the
  reference model's largest magnitude.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

NUMBERS = ("iterations", "residual", "model")


def reference(config: dict):
    name = config["reference"]
    return importlib.import_module(f"cardbench.reference.{name}")


def compare(field: torch.Tensor, program: Tuple[torch.Tensor, torch.Tensor,
                                                int],
            ref: Tuple[torch.Tensor, torch.Tensor, int]) -> Dict[str, float]:
    """The numbers compared between the program's (residual, model,
    iterations) and the reference's."""
    res, mod, it = program
    r_res, r_mod, r_it = ref
    scale_res = float(field.abs().max())
    scale_mod = max(float(r_mod.abs().max()), 1e-30)
    return {
        "iterations": float(abs(it - r_it)),
        "residual": float((res.float() - r_res).abs().max()) / scale_res,
        "model": float((mod.float() - r_mod).abs().max()) / scale_mod,
    }


def run_reference(config: dict, psfs, field, frequencies, weights,
                  dtype=torch.float32):
    return reference(config).run(config, psfs, field, frequencies, weights,
                                 dtype=dtype)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or below its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
