"""The dense subminor loop of multiscale CLEAN.

Port of ``dense_subminor_loop`` of ``radler_tpu.models.multiscale_fused``:
the Clark subminor loop at a fixed scale run as a *dense masked clean* over
the scale-convolved residual cube (the candidate-set restriction is an
optimization, not a semantic requirement: both subtract the twice-convolved
PSF and stop at the same threshold, ``subminor_loop.h:17-50``).  Each
iteration is the Högbom kernel pair of
:mod:`radler_tpu_torch.kernels.hogbom_step` in its *linear* integration mode
(``SubMinorModel::GetMaxComponent``, ``subminor_loop.cc:13-36``) with the
search weight plane, through :func:`~radler_tpu_torch.kernels.hogbom_step.
hogbom_loop`: the host reads the loop state once per ``CHUNK`` iterations.

The rest of the JAX module (the single-program multiscale loop with its
spectral-domain residual, and the mesh form of this loop) is not ported
yet (ROADMAP queue A, items 2 and 8.3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..image_set import CubeMeta, linear_integration_coefficients
from ..kernels.hogbom_step import LoopParams, hogbom_loop


def dense_subminor_loop(
    conv_res: torch.Tensor,  # [N, H, W] scale-convolved residual, in place
    psfs: torch.Tensor,  # [C, H, W] twice-convolved PSFs at image size
    weight: torch.Tensor,  # [H, W] window x mask x rms weight
    rms_factor: Optional[torch.Tensor],  # [H, W] rms factor, or None
    threshold: float,
    gain: float,
    start_iteration: int,
    max_iterations: int,
    divergence_limit: float,
    peak0: Tuple[float, int, int, bool],  # (value, x, y, found)
    *,
    meta: CubeMeta,
    allow_negative: bool,
    stop_on_negative: bool,
    fitter=None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, int, float, bool, bool]:
    """One dense Clark subminor pass at a fixed scale.

    Each iteration fits the peak values (``fitter.fit_and_evaluate``),
    multiplies them by ``gain`` and adds them into the component cube; the
    step subtracts the shifted PSFs and finds the next peak of the linear
    integration times ``weight``, whose signed value (times the rms factor
    when one is given) is tested against ``threshold`` and against
    ``|value0| * divergence_limit``.  The loop stops at the threshold, at
    ``max_iterations`` or, with ``stop_on_negative``, at a negative peak.
    Returns ``(conv_res, comp, iteration, value, found, diverging)``.

    CUDA tensors run the kernels (``plain`` runs their plain versions
    instead, for comparison); CPU tensors run the plain versions.
    """
    comp = torch.zeros_like(conv_res)
    params = LoopParams.make(gain, threshold, abs(peak0[0]), divergence_limit,
                             max_iterations, stop_on_negative)
    out = hogbom_loop(
        conv_res, comp, psfs.contiguous(), weight.contiguous(),
        rms_factor.contiguous() if rms_factor is not None else None,
        peak0, params, start_iteration, meta=meta,
        allow_negative=allow_negative, fitter=fitter, plain=plain,
        integration=("linear", linear_integration_coefficients(meta)),
    )
    return conv_res, comp, out.iteration, out.value, out.found, out.diverging
