"""Checkpoint and resume of the major-loop state.

Port of ``radler_tpu.checkpoint``, in the same format, so that a checkpoint
written by either package loads into the other.  The reference keeps the
state in memory (iteration number, auto-mask phase, per-scale masks); this
makes it an explicit structure so that a major loop can resume after
preemption.

Format: one ``np.savez_compressed`` file holding the host arrays (bool
masks) and a JSON header as a ``uint8`` array under ``__header__``; no
tensor is pickled.  The caller still owns the residual and model images,
which round-trip through the accessors each major iteration.
"""

from __future__ import annotations

import json

import numpy as np

from .models.multiscale import MultiScaleAlgorithm, ScaleInfo

_FORMAT_VERSION = 1
# The ScaleInfo fields a checkpoint carries; the rest are per-run peaks.
_SCALE_FIELDS = ("scale", "kernel_peak", "psf_peak", "bias_factor", "gain",
                 "is_active", "n_components_cleaned", "total_flux_cleaned")


def save_state(radler, path: str) -> None:
    """Serialize the cross-major-iteration state of a :class:`Radler`."""
    arrays = {}
    header = {
        "version": _FORMAT_VERSION,
        "auto_mask_is_finished": radler._auto_mask_is_finished,
        "auto_mask_finishing_iteration": radler._auto_mask_finishing_iteration,
        "algorithms": [],
    }
    if radler._auto_mask is not None:
        arrays["auto_mask"] = radler._auto_mask
    for i, alg in enumerate(radler._parallel.algorithms):
        alg_state = {"iteration_number": alg.iteration_number}
        if isinstance(alg, MultiScaleAlgorithm):
            alg_state["scales"] = [
                {name: getattr(s, name) for name in _SCALE_FIELDS}
                for s in alg.scale_infos
            ]
            for j, mask in enumerate(alg.scale_masks):
                if mask is not None:
                    arrays[f"alg{i}_scale_mask{j}"] = mask
            alg_state["n_scale_masks"] = len(alg.scale_masks)
        header["algorithms"].append(alg_state)
    for j, mask in enumerate(radler._parallel._scale_masks):
        arrays[f"facet_scale_mask{j}"] = mask
    header["n_facet_scale_masks"] = len(radler._parallel._scale_masks)

    arrays["__header__"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_state(radler, path: str) -> None:
    """Restore state saved with :func:`save_state` (by either package) into
    a freshly constructed :class:`Radler` with the same settings and work
    table."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"].tobytes()).decode())
        if header["version"] != _FORMAT_VERSION:
            raise RuntimeError(
                f"Unsupported checkpoint version {header['version']}"
            )
        radler._auto_mask_is_finished = header["auto_mask_is_finished"]
        radler._auto_mask_finishing_iteration = header[
            "auto_mask_finishing_iteration"
        ]
        radler._auto_mask = data["auto_mask"] if "auto_mask" in data else None
        algorithms = radler._parallel.algorithms
        if len(algorithms) != len(header["algorithms"]):
            raise RuntimeError(
                "Checkpoint algorithm count does not match the current "
                "configuration"
            )
        for i, (alg, alg_state) in enumerate(
            zip(algorithms, header["algorithms"])
        ):
            alg.iteration_number = alg_state["iteration_number"]
            if isinstance(alg, MultiScaleAlgorithm) and "scales" in alg_state:
                alg.scale_infos = [ScaleInfo(**s) for s in alg_state["scales"]]
                alg.scale_masks = []
                for j in range(alg_state.get("n_scale_masks", 0)):
                    key = f"alg{i}_scale_mask{j}"
                    alg.scale_masks.append(data[key] if key in data else None)
        radler._parallel._scale_masks = [
            data[f"facet_scale_mask{j}"]
            for j in range(header.get("n_facet_scale_masks", 0))
        ]
