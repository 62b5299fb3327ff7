"""One request to the system under test: a whole deconvolution run.

The caller copies a field into fresh residual tensors and makes zeroed
model tensors (WSClean's hand-off), builds a new ``radler_tpu_torch.Radler``
on them through the public work-table surface, and calls ``perform(0)``,
``perform(1)``, ... while ``perform`` asks for another major iteration
(``Radler.perform`` itself stops at ``major_iteration_count`` and at the
minor-iteration limit).  The residual that a perform writes back is what
the next one reads, as an ideal predict and invert would hand it on.  The
run ends at a ``torch.cuda.synchronize()`` on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np
import torch


def make_settings(config: dict):
    """``radler_tpu_torch.Settings`` from ``config["settings"]``: dotted
    attribute paths to values, an enum by its member's name."""
    import radler_tpu_torch as rd

    s = rd.Settings()
    s.trimmed_image_width = s.trimmed_image_height = int(config["image_size"])
    for key, value in config["settings"].items():
        owner = s
        *path, last = key.split(".")
        for part in path:
            owner = getattr(owner, part)
        current = getattr(owner, last)
        if isinstance(current, enum.Enum):
            value = type(current)[value]
        setattr(owner, last, value)
    return s


@dataclasses.dataclass
class RunOutput:
    iterations: int
    performs: int
    residual: List  # the accessors' planes after the last perform
    model: List

    def cubes(self):
        """The written-back residual and model as ``[C, H, W]`` tensors."""
        return torch.stack(list(self.residual)), torch.stack(list(self.model))


def deconvolve(config: dict, psfs: torch.Tensor, field: torch.Tensor,
               frequencies: np.ndarray, weights: np.ndarray) -> RunOutput:
    """One deconvolution run of ``field`` ([C * P, H, W], channel-major
    over the configuration's ``polarizations``) with one PSF a channel
    (``psfs`` [C, H, W], on the channel's first entry, as Radler's work
    table takes it); returns before the device has finished (the caller
    synchronizes)."""
    import radler_tpu_torch as rd

    pols = [rd.Polarization[p] for p in config["polarizations"]]
    C = psfs.shape[0]
    residual = field.clone()
    model = torch.zeros_like(field)
    table = rd.WorkTable([], C, 0)
    res_acc, mod_acc = [], []
    for i in range(field.shape[0]):
        c, p = divmod(i, len(pols))
        e = rd.WorkTableEntry()
        e.polarization = pols[p]
        e.original_channel_index = c
        e.image_weight = float(weights[c])
        e.band_start_frequency = float(frequencies[c][0])
        e.band_end_frequency = float(frequencies[c][1])
        e.psf_accessors = [rd.TensorImageAccessor(psfs[c])] if p == 0 else []
        e.residual_accessor = rd.TensorImageAccessor(residual[i])
        e.model_accessor = rd.TensorImageAccessor(model[i])
        res_acc.append(e.residual_accessor)
        mod_acc.append(e.model_accessor)
        table.add_entry(e)
    r = rd.Radler(make_settings(config), table)
    major = 0
    while r.perform(major):
        major += 1
    return RunOutput(iterations=r.iteration_number, performs=major + 1,
                     residual=[a.array for a in res_acc],
                     model=[a.array for a in mod_acc])
