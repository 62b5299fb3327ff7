"""Component-amplitude optimization (after auto-masking).

Port of ``radler_tpu.ops.component_optimization``
(``cpp/math/component_optimization.{h,cc}``) on ``torch.fft``, through
:func:`~radler_tpu_torch.ops.convolution.padded_convolve`:

* :func:`linear_component_solve`: the least-squares solve of the component
  amplitudes at the model's non-zero positions, so that the residual is
  zero there (``component_optimization.cc:181-263``); the ``K x K`` system
  is one PSF gather, solved in float64;
* :func:`gradient_descent` and :func:`gradient_descent_with_variable_psf`:
  line-search gradient descent with FFT convolutions
  (``component_optimization.cc:265-400``); the JAX package's ``fori_loop``
  is a host loop that only enqueues work and reads nothing back;
* :func:`lm_nonlinear_fit`: the regularized Levenberg-Marquardt amplitude
  fit of ``LsDeconvolution::nonLinearFit`` (``ls_deconvolution.cc:243-316``)
  in K-space; the JAX package's ``while_loop`` reads its stop condition
  once an iteration.

None of them has a kernel of its own: the work is FFTs, gathers and small
dense solves, as in the JAX package, which runs them outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..settings import OptimizationAlgorithm
from .convolution import padded_convolve


def linear_system(model: torch.Tensor, residual: torch.Tensor,
                  psf: torch.Tensor):
    """The system of :func:`linear_component_solve`: the model's non-zero
    positions ``(ys, xs)``, the ``K x K`` PSF gather ``a`` between them
    (wrap-around indexing, the reference's ``(x + width + psf_x - x_i) %
    width``) and the dirty image, residual plus the model convolved with
    the PSF, whose values at the positions are the right-hand side.
    Returns None when the model is empty."""
    h, w = model.shape
    ys, xs = (torch.as_tensor(v, device=model.device)
              for v in np.nonzero(model.cpu().numpy()))
    if ys.numel() == 0:
        return None
    dyy = (ys[:, None] - ys[None, :] + h + h // 2) % h
    dxx = (xs[:, None] - xs[None, :] + w + w // 2) % w
    return ys, xs, psf[dyy, dxx], residual + padded_convolve(model, psf)


def solve_amplitudes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The least-squares amplitudes of ``a x = b``, in float64: with the
    components of a CLEAN the system's condition number reaches thousands,
    and a float32 solve (the JAX package's) then differs from call to call
    on the CPU, and between the CPU and the card, by its condition number
    times float32's epsilon.  Returns float64."""
    return torch.linalg.lstsq(a.double(), b.double()[:, None]).solution[:, 0]


def linear_component_solve(
    model: torch.Tensor, residual: torch.Tensor, psf: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the amplitudes at the model's non-zero positions exactly
    (``LinearComponentSolve``): the dirty image must equal the new model
    convolved with the PSF there (:func:`linear_system`,
    :func:`solve_amplitudes`).  Returns ``(model, residual)``, the residual
    zeroed at the positions."""
    system = linear_system(model, residual, psf)
    if system is None:
        return model, residual
    ys, xs, a, dirty = system
    amplitudes = solve_amplitudes(a, dirty[ys, xs]).to(model.dtype)
    new_model = torch.zeros_like(model)
    new_model[ys, xs] = amplitudes
    new_residual = dirty - padded_convolve(new_model, psf)
    new_residual[ys, xs] = 0.0
    return new_model, new_residual


def gradient_descent(
    model: torch.Tensor,
    residual: torch.Tensor,
    psf: torch.Tensor,
    n_iterations: int = 4,
    support_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Line-search gradient descent over the component amplitudes
    (``component_optimization.cc:265-321``): only the support's pixels
    change (by default the model's non-zero pixels).  Returns ``(model,
    residual)``."""
    h, w = model.shape
    if support_mask is None:
        mask = (model != 0.0).to(model.dtype)
    else:
        mask = support_mask.to(model.dtype)
    dirty = residual + padded_convolve(model, psf)
    padded = (2 * h, 2 * w)

    def conv(x):
        return padded_convolve(x, psf, padded_shape=padded)

    for _ in range(n_iterations):
        res = dirty - conv(model)
        gradient = conv(res) * mask
        conv_grad = conv(gradient)
        denom = torch.sum(conv_grad * conv_grad)
        step = torch.where(denom > 0.0, torch.sum(res * conv_grad) / denom,
                           0.0)
        model = model + step * gradient
    return model, dirty - conv(model)


def gradient_descent_with_variable_psf(
    supports: Sequence[torch.Tensor],
    image: torch.Tensor,
    psfs: Sequence[torch.Tensor],
    n_iterations: int = 10,
    padded_shape: Optional[Tuple[int, int]] = None,
) -> List[torch.Tensor]:
    """Joint line-search gradient descent over groups of components, each
    with its own PSF (``GradientDescentWithVariablePsf``,
    ``component_optimization.cc:323-400``): multiscale refines every
    scale's components at once, each convolved with its scale-convolved
    PSF.  ``supports[g]`` is a 0/1 image of group ``g``'s positions;
    returns one delta image a group."""
    h, w = image.shape
    if padded_shape is None:
        padded_shape = (2 * h, 2 * w)

    def conv(x, psf):
        return padded_convolve(x, psf, padded_shape=padded_shape)

    models = [torch.zeros((h, w), dtype=torch.float32, device=image.device)
              for _ in psfs]
    for _ in range(n_iterations):
        residual = image
        for model, psf in zip(models, psfs):
            residual = residual - conv(model, psf)
        gradients = [conv(residual, psf) * support
                     for psf, support in zip(psfs, supports)]
        direction = torch.zeros_like(image)
        for gradient, psf in zip(gradients, psfs):
            direction = direction + conv(gradient, psf)
        denom = torch.sum(direction * direction)
        step = torch.where(denom > 0.0,
                           torch.sum(residual * direction) / denom, 0.0)
        models = [model + step * gradient
                  for model, gradient in zip(models, gradients)]
    return models


def lm_iterations(gram: torch.Tensor, b: torch.Tensor, dirty_sq: torch.Tensor,
                  mu: float, max_iterations: int) -> torch.Tensor:
    """The Levenberg-Marquardt loop over the amplitudes ``x`` (``_lm_
    iterations`` of the JAX package): minimize ``||dirty - A x||^2 + (mu *
    sum|x|)^2``, whose data term is ``||dirty||^2 - 2 x.b + x.G.x`` in
    K-space.  The penalty's Jacobian row is ``mu * |x_p|``, the reference's
    inexact derivative (``ls_deconvolution.cc:107-125``); the stop test is
    ``gsl_multifit_test_delta(dx, x, 1e-4, 1e-4)``, read once an
    iteration."""
    k = b.shape[0]
    dev, dt = b.device, gram.dtype
    eye = torch.eye(k, dtype=dt, device=dev)
    mu = torch.tensor(mu, dtype=dt, device=dev)

    def cost_of(x):
        data = dirty_sq - 2.0 * torch.dot(x, b) + torch.dot(x, gram @ x)
        pen = mu * torch.sum(torch.abs(x))
        return data + pen * pen

    x = torch.zeros_like(b)
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    cost = cost_of(x)
    for _ in range(max_iterations):
        ax = torch.abs(x)
        pen_sum = mu * torch.sum(ax)
        g = -(b - gram @ x) + (mu * ax) * pen_sum
        hess = gram + (mu * mu) * torch.outer(ax, ax)
        damped = hess + lam * (torch.diag(torch.diag(hess)) + 1e-12 * eye)
        delta = torch.linalg.solve(damped, -g)
        new_x = x + delta
        new_cost = cost_of(new_x)
        accept = new_cost < cost
        x = torch.where(accept, new_x, x)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.1, lam * 10.0)
        converged = accept & torch.all(torch.abs(delta)
                                       < 1e-4 + 1e-4 * torch.abs(x))
        if bool(converged | (lam > 1e12)):
            break
    return x


def lm_nonlinear_fit(
    mask: np.ndarray,  # [H, W] bool component support
    residual: torch.Tensor,
    psf: torch.Tensor,
    regularization: float = 0.1,
    max_iterations: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The regularized amplitude fit over ``mask``'s positions
    (``LsDeconvolution::nonLinearFit``, ``ls_deconvolution.cc:243-316``).
    The model is linear in the amplitudes, so ``A^T A`` is the PSF's
    circular autocorrelation at the pairwise offsets, and the whole fit
    runs in K-space (:func:`lm_iterations`) after two FFT correlations.
    Returns ``(model, residual)``: the amplitudes at their positions, and
    ``dirty - model ⊛ psf`` everywhere (not zeroed at the positions)."""
    h, w = residual.shape
    ys, xs = np.nonzero(np.asarray(mask))
    if len(xs) == 0:
        return torch.zeros_like(residual), residual
    dev = residual.device
    ys_t, xs_t = torch.as_tensor(ys, device=dev), torch.as_tensor(xs,
                                                                  device=dev)
    psf_f = torch.fft.rfft2(torch.fft.ifftshift(psf))
    autocorr = torch.fft.irfft2(psf_f * torch.conj(psf_f), s=(h, w))
    gram = autocorr[(ys_t[:, None] - ys_t[None, :]) % h,
                    (xs_t[:, None] - xs_t[None, :]) % w]
    corr = torch.fft.irfft2(torch.fft.rfft2(residual) * torch.conj(psf_f),
                            s=(h, w))
    b = corr[ys_t, xs_t]
    dirty_sq = torch.sum(residual * residual)
    amplitudes = lm_iterations(gram.to(torch.float32), b.to(torch.float32),
                               dirty_sq, regularization, max_iterations)
    model = torch.zeros_like(residual)
    model[ys_t, xs_t] = amplitudes
    fitted = torch.fft.irfft2(torch.fft.rfft2(model) * psf_f, s=(h, w))
    return model, residual - fitted


def run_component_optimization(dirty_set, model_set, psfs: torch.Tensor,
                               algorithm: OptimizationAlgorithm) -> None:
    """One optimization a plane (``generic_clean.cc:26-49``).  Only the
    model changes: the reference's solvers take the residual as const and
    leave the stored residual images as they are."""
    meta = dirty_set.meta
    new_model = []
    for i in range(dirty_set.n_images):
        res, mod = dirty_set.data[i], model_set.data[i]
        psf = psfs[meta.psf_index(i)]
        if algorithm == OptimizationAlgorithm.LINEAR_EQUATION_SOLVER:
            mod, _ = linear_component_solve(mod, res, psf)
        elif algorithm == OptimizationAlgorithm.GRADIENT_DESCENT:
            mod, _ = gradient_descent(mod, res, psf)
        else:
            raise RuntimeError(
                f"Unsupported optimization algorithm {algorithm} for generic "
                "clean")
        new_model.append(mod)
    model_set.data = torch.stack(new_model)
