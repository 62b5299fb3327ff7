"""Generic (Högbom/Clark) CLEAN with joined channels & polarizations.

Port of ``radler_tpu.models.generic_clean``
(``cpp/algorithms/generic_clean.{h,cc}``): the initial peak search on the
linear integration, the major-loop threshold, then either the Clark subminor
loop of :class:`radler_tpu_torch.models.subminor.SubMinorLoop` followed by
one FFT residual correction, or the Högbom minor loop of
:func:`radler_tpu_torch.kernels.hogbom_step.hogbom_loop`, or, with a device
mesh, by the JAX package's rule: the mesh's Clark subminor loop
(:func:`radler_tpu_torch.parallel.mesh.mesh_subminor_clean`, each tile its
own loop) or the partitioned Högbom loop
(:func:`radler_tpu_torch.parallel.mesh.mesh_hogbom_loop`), and the
single-device Högbom loop for a cube that divides over neither; for a facet
grid, every facet's Högbom loop in lockstep
(:meth:`GenericClean.execute_batched_facets`); after auto-masking, with
component optimization set, the amplitudes' optimization
(:mod:`radler_tpu_torch.ops.component_optimization`) instead.  All run
their CUDA kernels on CUDA tensors and the kernels' plain PyTorch versions
on CPU tensors.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..image_set import CubeMeta, get_linear_integrated, get_square_integrated
from ..kernels.hogbom_step import (
    FacetLoopParams,
    LoopParams,
    facet_hogbom_loop,
    facet_hogbom_steps,
    hogbom_loop,
)
from ..kernels.subminor_loop import SubminorParams
from ..ops.component_optimization import run_component_optimization
from ..ops.convolution import untrim
from ..ops.peak_finder import border_from_ratio, find_peak, window_mask
from ..parallel.mesh import (
    CardCopies,
    facet_runs,
    mesh_hogbom_loop,
    mesh_pallas_eligible,
    mesh_subminor_clean,
    run_together,
)
from ..settings import OptimizationAlgorithm, SpectralFittingMode
from ..utils.profiling import annotate
from .base import DeconvolutionAlgorithm, DeconvolutionResult
from .subminor import (
    SubMinorLoop,
    choose_padded_size,
    correct_residual,
)

# The batched facet route's budget for its stacks' estimate, in bytes: the
# JAX package's (generic_clean.py:614-618) on every device, so that the
# port takes the JAX package's route whatever memory the device has.
BATCHED_FACETS_BUDGET = 4e9


# The largest image (pixels) whose Clark run takes the Högbom kernel on the
# card when the spectral fit is not a constant projection, as the JAX
# package routes it on a TPU (generic_clean.py:410-424).
_HOGBOM_FALLBACK_PIXELS = 4096 * 4096


class GenericClean(DeconvolutionAlgorithm):
    """``cpp/algorithms/generic_clean.{h,cc}``."""

    def __init__(self, use_sub_minor_optimization: bool = True):
        super().__init__()
        self.convolution_padding = 1.1
        self.use_sub_minor_optimization = use_sub_minor_optimization
        # The batched facets' shared PSFs on the mesh's other cards.
        self._card_copies = CardCopies()

    # ------------------------------------------------------------------
    def _find_peak(self, integrated: torch.Tensor):
        """``GenericClean::FindPeak`` (``generic_clean.cc:255-277``)."""
        img = integrated
        if self.rms_factor_image is not None:
            img = integrated * self.rms_factor_image
        h, w = img.shape
        hb, vb = border_from_ratio(w, h, self.clean_border_ratio)
        return find_peak(
            img, self.allow_negative_components, hb, vb, self.clean_mask
        )

    def _peak_search_weight(self, height: int, width: int, device):
        """The kernel's peak-search weight, mask x border x rms, or None
        when none of them is set (then the kernel reads no weight plane)."""
        hb, vb = border_from_ratio(width, height, self.clean_border_ratio)
        if (
            hb == 0
            and vb == 0
            and self.clean_mask is None
            and self.rms_factor_image is None
        ):
            return None
        host = window_mask(height, width, hb, vb).astype(np.float32)
        if self.clean_mask is not None:
            host = host * np.asarray(self.clean_mask, np.float32)
        weight = torch.as_tensor(host, device=device)
        if self.rms_factor_image is not None:
            weight = weight * self.rms_factor_image
        return weight.contiguous()

    # ------------------------------------------------------------------
    def execute_major_iteration(
        self, dirty_set, model_set, psfs: torch.Tensor
    ) -> DeconvolutionResult:
        meta: CubeMeta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        mesh = self.device_mesh
        if mesh is not None and mesh.size == 1:
            mesh = None
        iteration_counter_at_start = self.iteration_number
        if self.stop_on_negative_components:
            self.allow_negative_components = True

        with annotate("generic.peak"):
            integrated = get_linear_integrated(dirty_set.data, meta)
            pk = self._find_peak(integrated)
            # One host read for the initial peak.
            pk_value, pk_found, pk_x, pk_y = torch.stack(
                [pk.value, pk.found.float(), pk.x.float(), pk.y.float()]
            ).tolist()
        found = bool(pk_found)
        result = DeconvolutionResult()
        result.starting_peak_value = pk_value if found else None
        result.final_peak_value = pk_value if found else 0.0
        if not found:
            return result
        if self.iteration_number >= self.max_iterations:
            # Enables the facet layer's peak-only phase-1 pass
            # (generic_clean.cc:83-88).
            return result

        if self.component_optimization_algorithm != OptimizationAlgorithm.CLEAN:
            run_component_optimization(dirty_set, model_set, psfs,
                                       self.component_optimization_algorithm)
            self._fit_model_spectra(model_set)
            return result

        initial_max_value = abs(pk_value)
        first_threshold = self.threshold
        major_iter_threshold = max(
            self.major_iteration_threshold,
            initial_max_value * (1.0 - self.major_loop_gain),
        )
        if major_iter_threshold > first_threshold:
            first_threshold = major_iter_threshold

        if psfs.shape[-2:] != (height, width):
            psfs = untrim(psfs, height, width)
        fit = (
            self.spectral_fitter
            if self.spectral_fitter is not None and self.spectral_fitter.is_active
            else None
        )
        if mesh is not None:
            if self.use_sub_minor_optimization and (
                self._mesh_subminor_eligible(meta, height)
            ):
                return self._run_mesh_subminor(
                    dirty_set,
                    model_set,
                    psfs,
                    first_threshold,
                    iteration_counter_at_start,
                    major_iter_threshold,
                    result,
                )
            if not mesh_pallas_eligible(mesh, meta, height):
                # The JAX package lets XLA partition its single-device
                # Högbom loop here (generic_clean.py:457-509), which keeps
                # that loop's semantics; the loop runs unpartitioned on the
                # mesh's lead, where the cube lies.
                mesh = None
        elif self.use_sub_minor_optimization and (
            self._clark_runs(dirty_set.data.device, fit, height, width)
        ):
            return self._run_clark(
                dirty_set,
                model_set,
                psfs,
                first_threshold,
                iteration_counter_at_start,
                major_iter_threshold,
                result,
            )
        rms = self.rms_factor_image
        args = (
            dirty_set.data,
            model_set.data,
            psfs.contiguous(),
            self._peak_search_weight(height, width, dirty_set.data.device),
            rms.contiguous() if rms is not None else None,
            (pk_value, int(pk_x), int(pk_y), found),
            LoopParams.make(
                self.minor_loop_gain,
                first_threshold,
                initial_max_value,
                self.divergence_limit,
                self.max_iterations,
                self.stop_on_negative_components,
            ),
            self.iteration_number,
        )
        kwargs = dict(meta=meta, allow_negative=self.allow_negative_components,
                      fitter=fit)
        if mesh is not None:
            out = mesh_hogbom_loop(mesh, *args, **kwargs)
        else:
            out = hogbom_loop(*args, **kwargs)
        self.iteration_number = out.iteration
        return self._finish_result(
            result,
            out.diverging,
            out.value if out.found else None,
            iteration_counter_at_start,
            major_iter_threshold,
        )

    def _mesh_subminor_eligible(self, meta: CubeMeta, height: int) -> bool:
        """Whether the mesh's Clark subminor loop runs (``generic_clean.py:
        779-797`` of the JAX package): the cube divides over the mesh as
        the Högbom mesh loop needs (:func:`mesh_pallas_eligible`; the JAX
        package's Högbom rule adds TPU tile gates, its Clark rule does
        not).  ``RADLER_TPU_NO_MESH_SUBMINOR`` sends the run to the mesh's
        Högbom loop, as in the JAX package; the parity tests set it on both
        packages' side."""
        if os.environ.get("RADLER_TPU_NO_MESH_SUBMINOR"):
            return False
        return mesh_pallas_eligible(self.device_mesh, meta, height)

    def _run_mesh_subminor(
        self,
        dirty_set,
        model_set,
        psfs: torch.Tensor,
        first_threshold: float,
        iteration_counter_at_start: int,
        major_iter_threshold: float,
        result: DeconvolutionResult,
    ) -> DeconvolutionResult:
        """The mesh's Clark subminor (``_run_mesh_subminor``,
        ``generic_clean.py:799-927`` of the JAX package): every tile's
        candidates at 0.99 of the threshold cleaned on their own to it,
        then one FFT correction of the whole residual
        (``subminor_loop.cc:195-218``) and the model update."""
        meta = dirty_set.meta
        width, height = dirty_set.width, dirty_set.height
        out = mesh_subminor_clean(
            self.device_mesh,
            dirty_set.data,
            psfs.contiguous(),
            self.rms_factor_image,
            self.clean_mask,
            first_threshold * 0.99,
            SubminorParams.make(
                first_threshold,
                self.minor_loop_gain,
                self.iteration_number,
                self.max_iterations,
                self.divergence_limit,
                self.allow_negative_components,
                self.stop_on_negative_components,
            ),
            meta=meta,
            fitter=self.spectral_fitter,
            borders=border_from_ratio(width, height, self.clean_border_ratio),
        )
        self.iteration_number = out.iteration
        if out.any_selected:
            padded_h, padded_w = choose_padded_size(
                width, height, self.convolution_padding)
            dirty_set.data = correct_residual(
                dirty_set.data, out.delta, psfs, padded_h, padded_w,
                meta.n_channels)
            model_set.data = model_set.data + out.delta
        return self._finish_result(
            result,
            out.diverging,
            out.value if out.any_selected else None,
            iteration_counter_at_start,
            major_iter_threshold,
        )

    @staticmethod
    def _clark_runs(device, fit, height: int, width: int) -> bool:
        """Whether the Clark subminor loop runs, or the Högbom loop instead.

        CPU tensors always run it (its plain version, as the JAX package
        does off the TPU).  On the card the JAX package's TPU rule holds
        (generic_clean.py:410-424): no fit or the polynomial projection
        runs the Clark loop; another fit runs the Högbom kernel on an image
        up to 4096^2 and the Clark loop (B2 with the fit in its body)
        above."""
        if device.type == "cpu" or fit is None:
            return True
        if fit.mode == SpectralFittingMode.POLYNOMIAL:
            return True
        return height * width > _HOGBOM_FALLBACK_PIXELS

    def _run_clark(
        self,
        dirty_set,
        model_set,
        psfs: torch.Tensor,
        first_threshold: float,
        iteration_counter_at_start: int,
        major_iter_threshold: float,
        result: DeconvolutionResult,
    ) -> DeconvolutionResult:
        """The sub-minor ("Clark") optimization (``generic_clean.cc:115-162``):
        the subminor loop over the candidate set, then one FFT correction of
        the full residual and the model update."""
        width, height = dirty_set.width, dirty_set.height
        padded_h, padded_w = choose_padded_size(
            width, height, self.convolution_padding
        )
        sub = SubMinorLoop(width, height, padded_w, padded_h)
        sub.set_iteration_info(self.iteration_number, self.max_iterations)
        sub.set_threshold(first_threshold, first_threshold * 0.99)
        sub.set_gain(self.minor_loop_gain)
        sub.allow_negative_components = self.allow_negative_components
        sub.stop_on_negative_component = self.stop_on_negative_components
        sub.divergence_limit = self.divergence_limit
        sub.rms_factor_image = self.rms_factor_image
        sub.mask = self.clean_mask
        sub.set_clean_borders(
            *border_from_ratio(width, height, self.clean_border_ratio)
        )
        diverging, max_value = sub.run(
            dirty_set.data, dirty_set.meta, psfs, self.spectral_fitter
        )
        self.iteration_number = sub.current_iteration
        if max_value is not None:
            with annotate("clark.correct"):
                new_residual, full_model = sub.correct_residual_dirty(
                    dirty_set.data, psfs
                )
                dirty_set.data = new_residual
                model_set.data = model_set.data + full_model
        # When the subminor loop selected no pixels, the reference's fallback
        # FindPeak runs over a zeroed scratch buffer and finds nothing
        # (generic_clean.cc:156-162): max_value stays unset.
        return self._finish_result(
            result,
            diverging,
            max_value,
            iteration_counter_at_start,
            major_iter_threshold,
        )

    # -- batched facet execution ----------------------------------------
    def batched_facets_eligible(
        self,
        meta: CubeMeta,
        box_w: int,
        box_h: int,
        n_facets: int,
        n_unique_psfs: int = 1,
    ) -> bool:
        """Whether all facets run as one lockstep Högbom loop
        (``generic_clean.py:587-619`` of the JAX package): the dense loop
        has the Clark loop's semantics, so either setting batches, unless
        component optimization is set, ``RADLER_TPU_NO_BATCHED_FACETS`` is
        (the parity tests' switch to the serial route), or the JAX
        package's estimate of the stacks passes
        :data:`BATCHED_FACETS_BUDGET`."""
        if os.environ.get("RADLER_TPU_NO_BATCHED_FACETS"):
            return False
        if self.component_optimization_algorithm != OptimizationAlgorithm.CLEAN:
            return False
        N, C = meta.n_images, meta.n_channels
        est = n_facets * (6 * N + C * max(n_unique_psfs, 1)) * (
            box_h * box_w * 4
        )
        return est < BATCHED_FACETS_BUDGET

    def execute_batched_facets(
        self,
        facet_residual: torch.Tensor,  # [F, N, Hb, Wb], updated in place
        facet_model: torch.Tensor,  # [F, N, Hb, Wb], updated in place
        psfs: torch.Tensor,  # [C, Hb, Wb] shared, or [F, C, Hb, Wb]
        facet_boxes,  # (width, height) of each facet, placed top left
        facet_masks: np.ndarray,  # [F, Hb, Wb] bool search masks
        facet_rms: Optional[torch.Tensor],  # [F, Hb, Wb] or None
        major_iteration_threshold: float,
        start_iterations,  # per facet
        find_peak_only: bool,
        meta: CubeMeta,
        facet_forced_terms: Optional[torch.Tensor] = None,  # [F, T-1, Hb, Wb]
    ):
        """All facets' Högbom minor loops as one lockstep loop, the port of
        ``execute_batched_facets`` (``generic_clean.py:620-760``) and its
        per-facet program ``_facet_hogbom_program`` (``:154``): each facet's
        initial peak on the squared integration times the RMS within its
        valid window (the border of its true box and its mask; the padding
        is never searched), its major-iteration threshold, then the loop
        (:func:`facet_hogbom_loop`) over the true boxes: the padding is
        neither read nor written.  On a mesh of several groups the facets'
        loops spread over the groups' cards (:meth:`_spread_facet_loops`).
        Returns ``(results, iterations, lockstep)``: a
        :class:`DeconvolutionResult` and the iteration count of each facet,
        and the loop's lockstep iterations (the most of a card's)."""
        n_facets, _, box_h, box_w = facet_residual.shape
        dev = facet_residual.device
        valid = np.zeros((n_facets, box_h, box_w), dtype=bool)
        for f, (sw, sh) in enumerate(facet_boxes):
            hb, vb = border_from_ratio(sw, sh, self.clean_border_ratio)
            valid[f, :sh, :sw] = window_mask(sh, sw, hb, vb)
            valid[f] &= facet_masks[f]
        peaks = []
        for f in range(n_facets):
            integrated = get_square_integrated(facet_residual[f], meta)
            if facet_rms is not None:
                integrated = integrated * facet_rms[f]
            pk = find_peak(integrated, self.allow_negative_components, 0, 0,
                           valid[f])
            peaks.append(torch.stack(
                [pk.value, pk.found.float(), pk.x.float(), pk.y.float()]))
        # One host read for every facet's initial peak.
        host_peaks = torch.stack(peaks).tolist()

        # The program's float32 thresholds (generic_clean.py:181-186).
        f32 = np.float32
        keep = f32(1.0) - f32(self.major_loop_gain)
        m_thr, first = [], []
        for value, _, _, _ in host_peaks:
            m = max(f32(major_iteration_threshold), f32(abs(value)) * keep)
            m_thr.append(float(m))
            first.append(float(max(f32(self.threshold), m)))

        iterations = [int(s) for s in start_iterations]
        lockstep = 0
        outs = None
        if not find_peak_only and any(p[1] for p in host_peaks):
            weight = torch.as_tensor(valid.astype(np.float32), device=dev)
            if facet_rms is not None:
                weight = weight * facet_rms
            peaks0 = [(v, int(x), int(y), bool(found))
                      for v, found, x, y in host_peaks]
            boxes = torch.tensor([(sh, sw) for sw, sh in facet_boxes],
                                 dtype=torch.int32)
            fit = (
                self.spectral_fitter
                if self.spectral_fitter is not None
                and self.spectral_fitter.is_active
                else None
            )

            def loop_args(f0, f1, card):
                """The lockstep loop of facets ``[f0, f1)`` on ``card``:
                views of the stacks on their own device, copies
                elsewhere."""
                def part(t):
                    return None if t is None else t[f0:f1].to(card)

                shared = psfs.dim() == 3
                return dict(
                    residual=part(facet_residual), model=part(facet_model),
                    psfs=(self._card_copies.on("psfs", psfs, card)
                          if shared else part(psfs)),
                    weight=part(weight), rms=part(facet_rms),
                    peaks0=peaks0[f0:f1],
                    params=FacetLoopParams.make(
                        self.minor_loop_gain, first[f0:f1],
                        [abs(p[0]) for p in host_peaks[f0:f1]],
                        self.divergence_limit,
                        [self.max_iterations] * (f1 - f0),
                        self.stop_on_negative_components, card),
                    start_iterations=iterations[f0:f1], meta=meta,
                    allow_negative=self.allow_negative_components,
                    fitter=fit, forced_terms=part(facet_forced_terms),
                    boxes=boxes[f0:f1])

            psfs = psfs.contiguous()
            weight = weight.contiguous()
            facet_rms = (facet_rms.contiguous() if facet_rms is not None
                         else None)
            runs = facet_runs(self.device_mesh, n_facets)
            if len(runs) == 1:
                loop = facet_hogbom_loop(**loop_args(0, n_facets, dev))
                outs, lockstep = loop.results, loop.lockstep
            else:
                outs, lockstep = self._spread_facet_loops(
                    runs, loop_args, facet_residual, facet_model)
        results = []
        for f, (value, found, _, _) in enumerate(host_peaks):
            result = DeconvolutionResult()
            if not found:
                results.append(result)
                continue
            result.starting_peak_value = value
            result.final_peak_value = value
            if outs is None:
                results.append(result)
                continue
            out = outs[f]
            iterations[f] = out.iteration
            saved = self.iteration_number
            self.iteration_number = out.iteration
            results.append(self._finish_result(
                result, out.diverging, out.value if out.found else None,
                int(start_iterations[f]), m_thr[f]))
            self.iteration_number = saved
        return results, iterations, lockstep

    def _spread_facet_loops(self, runs, loop_args, facet_residual,
                            facet_model):
        """The lockstep loops of ``runs`` (``(group, facets)``, each a
        contiguous run) on their groups' devices at once
        (:func:`~radler_tpu_torch.parallel.mesh.run_together`), each card
        stopping when its own facets stop; the stacks come back to the
        lead.  Returns every facet's :class:`LoopResult` in facet order and
        the most lockstep iterations of a card."""
        mesh = self.device_mesh
        parts = []
        for group, facets in runs:
            f0, f1 = facets[0], facets[-1] + 1
            parts.append((f0, f1, loop_args(f0, f1, mesh.card(group))))
        done = run_together(facet_hogbom_steps(**args)
                            for _, _, args in parts)
        outs = []
        for (f0, f1, args), loop in zip(parts, done):
            for stack, name in ((facet_residual, "residual"),
                                (facet_model, "model")):
                if args[name].data_ptr() != stack[f0:f1].data_ptr():
                    stack[f0:f1].copy_(args[name])
            outs += loop.results
        return outs, max(loop.lockstep for loop in done)

    def _fit_model_spectra(self, model_set) -> None:
        """``GenericClean::FitSpectra`` (``generic_clean.cc:278-297``): every
        model pixel's spectrum fitted, batched over the image."""
        if self.spectral_fitter is None or not self.spectral_fitter.is_active:
            return
        meta = model_set.meta
        C, P = meta.n_channels, meta.n_polarizations
        H, W = model_set.height, model_set.width
        fitted = self.spectral_fitter.fit_and_evaluate(
            model_set.data.reshape(C, P * H * W))
        model_set.data = fitted.reshape(C * P, H, W)

    def _finish_result(
        self,
        result: DeconvolutionResult,
        diverging: bool,
        max_value,
        iteration_counter_at_start: int,
        major_iter_threshold: float,
    ) -> DeconvolutionResult:
        """Stop-reason reporting (generic_clean.cc:208-251)."""
        if diverging:
            if max_value is not None:
                result.final_peak_value = max_value
            result.another_iteration_required = False
            result.is_diverging = True
        elif max_value is not None:
            final_threshold_reached = (
                abs(max_value) <= self.threshold or max_value == 0.0
            )
            negative_reached = (
                max_value < 0.0 and self.stop_on_negative_components
            )
            mgain_reached = abs(max_value) <= major_iter_threshold
            did_work = (
                self.iteration_number - iteration_counter_at_start
            ) != 0
            result.another_iteration_required = (
                mgain_reached
                and did_work
                and not negative_reached
                and not final_threshold_reached
            )
            result.final_peak_value = max_value
        else:
            result.another_iteration_required = False
        return result
