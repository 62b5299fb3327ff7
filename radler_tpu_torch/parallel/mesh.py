"""The ("chan", "tile") mesh, the mesh-partitioned Högbom minor loop and the
mesh's Clark subminor loop.

Port of ``radler_tpu.parallel.mesh`` (``make_mesh``, ``mesh_pallas_eligible``,
``mesh_hogbom_loop`` and ``mesh_subminor_clean``).  The ``[N, H, W]`` cube is laid out over
``chan x tile`` shards: the planes over ``"chan"``, the image rows over
``"tile"``.  Each minor iteration runs one kernel launch per shard, and the
reference's thread-pool exchanges (``parallel_deconvolution.cc:592-617``)
become the collectives below:

* with a channel split (``chan > 1``) every shard runs kernel B4
  (:mod:`radler_tpu_torch.kernels.subtract_integrate`), and the joined
  integration is the sum of the shards' parts over ``"chan"``, followed by
  the weighted argmax of each tile's rows;
* without one, every shard holds all planes of its rows and runs kernel B1
  (:mod:`radler_tpu_torch.kernels.hogbom_step`) with its row offset, which
  integrates and reduces the shard itself;
* the global peak is a max pair over the shards (:func:`argmax_over_shards`),
  and its ``[N]`` values a masked read, a sum over ``"tile"`` and a gather
  over ``"chan"`` (:func:`read_pixel`).

In this version every shard lives on the one device the mesh names: the
shards are the blocks of a ``[chan, tile, N_loc, H_loc, W]`` tensor, and
each collective is a tensor op over the shard axes, the counterpart of the
JAX package's virtual CPU mesh.  Spreading the shards over several cards
replaces only :func:`place`, :func:`unplace` and the collectives.

The Clark subminor loop on the mesh (:func:`mesh_subminor_clean`) is each
tile cleaning its own candidates to the shared threshold; the tiles share
nothing else, so it runs as T independent loops in one launch of kernel B2
with a tile axis (:func:`radler_tpu_torch.kernels.subminor_loop.subminor_loop_tiles`),
and the ``"chan"`` split, which only shares out a tile's planes, is no
part of it.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.hogbom_step import (
    CoefficientFit,
    INDEX,
    LoopParams,
    LoopResult,
    advance_state,
    fitted_values,
    hogbom_step,
    hogbom_step_reference,
    integrate_values,
    integration_coefficients,
    kernel_coefficients,
    run_chunks,
    start_loop,
)
from ..kernels.subminor_loop import (
    SubminorParams,
    read_tile_results,
    subminor_loop_tiles,
)
from ..kernels.subtract_integrate import (
    plane_coefficients,
    subtract_integrate,
    subtract_integrate_reference,
)
from ..image_set import linear_integration_coefficients
from ..models.subminor import fit_arguments, select_candidates
from ..ops.peak_finder import FLT_MIN
from ..utils.device_consts import device_const


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``chan x tile`` mesh of shards, all held by ``device``."""

    chan: int
    tile: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.chan * self.tile


def make_mesh(n_devices: int, n_channels: Optional[int] = None,
              device="cuda") -> Mesh:
    """A ``("chan", "tile")`` mesh of ``n_devices`` shards on ``device``.

    Channel-major, as in the JAX package (``mesh.py:25-61``): ``"chan"``
    takes the largest factor of ``n_devices`` that divides the channel
    count, so that channels, not rows, are split first; with the count
    unknown, 4 or 2 when that leaves more than one tile.  ``"tile"`` takes
    the rest.
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"make_mesh: n_devices must be at least 1, got {n}")
    chan = 1
    if n_channels is not None:
        chan = max(d for d in range(1, n + 1)
                   if n % d == 0 and n_channels % d == 0)
    else:
        for candidate in (4, 2):
            if n % candidate == 0 and n // candidate > 1:
                chan = candidate
                break
    return Mesh(chan, n // chan, torch.device(device))


def mesh_pallas_eligible(mesh: Mesh, meta, height: int) -> bool:
    """Whether :func:`mesh_hogbom_loop` can run this cube: the planes divide
    over ``"chan"`` without splitting a polarization group, and the rows
    divide over ``"tile"``.  (The JAX package's 8-row and 128-lane gates
    are TPU tiling constraints that the card does not have.)"""
    n = meta.n_images
    if n % mesh.chan != 0 or (n // mesh.chan) % meta.n_polarizations != 0:
        return False
    return height % mesh.tile == 0


# ---------------------------------------------------------------------------
# Placement and collectives: what a multi-card mesh replaces
# ---------------------------------------------------------------------------


def _shard_view(cube: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n, height, width = cube.shape
    return cube.view(mesh.chan, n // mesh.chan, mesh.tile,
                     height // mesh.tile, width).transpose(1, 2)


def place(cube: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ``[N, H, W]`` cube as ``[chan, tile, N_loc, H_loc, W]`` shards,
    each one contiguous block (a view of ``cube`` where its layout already
    is that: one plane per shard, or one tile)."""
    return _shard_view(cube, mesh).contiguous()


def unplace(shards: torch.Tensor, cube: torch.Tensor, mesh: Mesh) -> None:
    """Write the shards back into the ``[N, H, W]`` cube they came from."""
    if shards.data_ptr() != cube.data_ptr():
        _shard_view(cube, mesh).copy_(shards)


def shard_multiscale_inputs(mesh: Mesh,
                            *tensors: Optional[torch.Tensor]) -> None:
    """Check that the fused multiscale loop's state (the residual, the
    model, the banks, the search windows and the rms factor; None is
    skipped) lies where ``mesh``'s shards live (``mesh.py:781`` of the JAX
    package lays it out over the mesh's devices).  Every shard of this mesh
    lives on its one device, so nothing moves and no bank is copied: the
    cube's planes and rows are split per subminor pass by :func:`place`.
    A mesh over several cards replaces this function (ROADMAP A8.4)."""
    device = _index_device(mesh.device)
    for t in tensors:
        if t is not None and _index_device(t.device) != device:
            raise ValueError(f"a fused multiscale input lies on {t.device}, "
                             f"the mesh on {device}")


def psum_chan(parts: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The sum over ``"chan"`` of the shards' ``[chan, tile, H_loc, W]``
    integration parts, into ``out`` ``[tile, H_loc, W]``: a left fold in
    shard order, ``((p0 + p1) + p2) + ...``, so that one plane per shard
    adds in B1's own order."""
    torch.add(parts[0], parts[1], out=out)
    for c in range(2, parts.shape[0]):
        out.add_(parts[c])
    return out


def argmax_over_shards(lmax: torch.Tensor,
                       gidx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``pmax`` pair of ``mesh.py:334-336`` over the shards' local
    maxima and their global flat indices: the global maximum and, among the
    shards that attain it, the LARGEST index (each shard's own argmax took
    its smallest).  Returns 0-d tensors."""
    gmax = lmax.max()
    return gmax, torch.where(lmax >= gmax, gidx, -1).max()


def read_pixel(shards: torch.Tensor, base: torch.Tensor, y: torch.Tensor,
               x: torch.Tensor, row_starts: torch.Tensor) -> torch.Tensor:
    """The values at image pixel (y, x) of row-sharded ``shards``
    ``[..., tile, K, H_loc, W]``: each shard reads its rows' value (0 where
    it does not hold row y), and the reads are summed over ``"tile"``
    (``values_at`` and ``image_at``, ``mesh.py:235-250``).  Returns
    ``[..., K]``, whose flattening is the gather over ``"chan"``.  ``base``
    is :func:`pixel_base` of ``shards``."""
    height_local, width = shards.shape[-2:]
    local_y = y - row_starts
    own = (local_y >= 0) & (local_y < height_local)
    at = local_y.clamp(0, height_local - 1) * width + x
    vals = torch.take(shards, base + at[:, None])
    return torch.where(own[:, None], vals, 0.0).sum(-2)


def pixel_base(shards: torch.Tensor) -> torch.Tensor:
    """The flat offset of every ``[H_loc, W]`` plane of ``shards``
    ``[..., tile, K, H_loc, W]``, shaped ``[..., tile, K]``, on its device."""
    plane = shards.shape[-2] * shards.shape[-1]
    count = shards.numel() // plane
    return (torch.arange(count, device=shards.device) * plane).view(
        shards.shape[:-2])


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def _index_device(device: torch.device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def mesh_hogbom_loop(
    mesh: Mesh,
    residual: torch.Tensor,  # [N, H, W], updated in place
    model: torch.Tensor,  # [N, H, W], updated in place
    psfs: torch.Tensor,  # [C, H, W] centered PSFs at image size
    weight: Optional[torch.Tensor],  # [H, W] mask x border x rms, or None
    rms: Optional[torch.Tensor],  # [H, W] rms factor, or None
    peak0: Tuple[float, int, int, bool],  # (value, x, y, found)
    params: LoopParams,
    start_iteration: int,
    *,
    meta,
    allow_negative: bool,
    fitter=None,
    plain: bool = False,
    integration: Optional[Tuple[str, np.ndarray]] = None,
    coefficients: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> LoopResult:
    """The Högbom minor loop partitioned over ``mesh``, with the contract
    of the JAX package's ``mesh_hogbom_loop`` and the arguments of
    :func:`radler_tpu_torch.kernels.hogbom_step.hogbom_loop`.

    With ``integration`` (linear, as multiscale's dense subminor loop runs
    it) and ``coefficients`` it is also the mesh form of that loop, the
    JAX package's ``_make_mesh_dense_subminor``
    (``multiscale_fused.py:260-454``): the shards with a channel split
    subtract every plane's own PSF, so the planes need only divide over
    ``"chan"``.

    On CUDA tensors the shards run the kernels (``plain`` runs their plain
    versions, for comparison); on CPU tensors the plain versions.  The loop
    state stays on the device, read once per ``CHUNK`` iterations.  Its
    semantics are the JAX mesh loop's, which may differ from the
    single-device loop's: among tiles with equal maxima the largest flat
    index wins; with a channel split and squared joins the comparison image
    is the summed part times weight^2 (no sqrt, no abs) and a peak is found
    when it exceeds 0; the peak's value is the joined integration of its
    gathered ``[N]`` values times the rms factor there.
    """
    n, height, width = residual.shape
    per_plane = integration is not None and meta.n_polarizations > 1
    divides = (
        n % mesh.chan == 0 and height % mesh.tile == 0
        if per_plane else mesh_pallas_eligible(mesh, meta, height)
    )
    if not divides:
        raise ValueError(
            f"mesh_hogbom_loop: {n} planes of {meta.n_polarizations} "
            f"polarizations and {height} rows do not divide over a "
            f"{mesh.chan} x {mesh.tile} mesh")
    if residual.device != _index_device(mesh.device):
        raise ValueError(f"mesh_hogbom_loop: the cube is on "
                         f"{residual.device}, the mesh on {mesh.device}")
    chan, tile = mesh.chan, mesh.tile
    n_loc, h_loc = n // chan, height // tile
    P = meta.n_polarizations
    dev = residual.device
    if integration is None:
        mode, chan_np, pol_np = integration_coefficients(meta)
    else:
        (mode, chan_np), pol_np = integration, np.ones(1, np.float32)
    complete = chan == 1  # each shard holds every plane of its rows
    # B4's PSFs: one per plane where a linear integration lets a shard
    # hold part of a polarization group.
    shard_psfs, shard_P = psfs, P
    if per_plane and not complete:
        shard_psfs = psfs.index_select(
            0, torch.arange(n, device=dev) // P).contiguous()
        shard_P = 1
    c_loc = n_loc // shard_P

    res_sh = place(residual, mesh)
    # With coefficients, the kernels' own model update goes to a scratch
    # cube and ``model`` (the [T*P, H, W] coefficient cube) gains its
    # values here, at the peak.
    mod_sh = (place(model, mesh) if coefficients is None
              else torch.empty_like(res_sh))
    def rows(img):
        return None if img is None else img.view(tile, h_loc, width)

    weight_sh = rows(weight)
    if weight_sh is not None and mode == "squared" and not complete:
        # argmax of sqrt(s)·w is argmax of s·w² (w >= 0): no sqrt pass.
        weight_sh = weight_sh * weight_sh
    rms_sh = rows(rms)
    row_starts = torch.arange(tile, device=dev) * h_loc
    first_index = row_starts * width
    res_base = pixel_base(res_sh)
    rms_base = None if rms is None else pixel_base(rms_sh[:, None])
    chan_coefs = device_const(chan_np, dev)
    pol_coefs = device_const(pol_np, dev)
    if complete:
        step = hogbom_step_reference if plain else hogbom_step
        coefs = device_const(kernel_coefficients(mode, chan_np, pol_np), dev)
    else:
        step = subtract_integrate_reference if plain else subtract_integrate
        coefs = device_const(plane_coefficients(mode, chan_np, shard_P),
                             dev).view(chan, n_loc)
        parts = torch.zeros((chan, tile, h_loc, width), device=dev)
        integ = torch.empty((tile, h_loc, width), device=dev)
    buffers, active0 = start_loop(residual, peak0, params, start_iteration,
                                  meta=meta, fitter=fitter)
    state = buffers.state
    coef_fit = None
    if coefficients is not None:
        coef_fit = CoefficientFit(*coefficients, buffers, model, params.gain,
                                  meta.n_channels, P)

    def shard_maxima():
        """Each tile's local maximum and its global flat index."""
        if complete:
            partials = [
                step(res_sh[0, t], mod_sh[0, t], psfs, buffers.values, state,
                     coefs, None if weight_sh is None else weight_sh[t],
                     mode=mode, n_polarizations=P,
                     allow_negative=allow_negative, row_offset=t * h_loc)
                for t in range(tile)
            ]
            # Blocks hold ascending pixel ranges: the first block with the
            # maximum holds the tile's smallest index among equal maxima.
            lmax, best = torch.stack([p[0] for p in partials]).max(dim=1)
            lidx = torch.stack([p[1] for p in partials]).gather(
                1, best[:, None])[:, 0]
            return lmax, lidx.long() + first_index, FLT_MIN
        for c in range(chan):
            for t in range(tile):
                step(res_sh[c, t], mod_sh[c, t],
                     shard_psfs[c * c_loc:(c + 1) * c_loc],
                     buffers.values[c * n_loc:(c + 1) * n_loc], state,
                     coefs[c], pol_coefs, parts[c, t], mode=mode,
                     n_polarizations=shard_P, row_offset=t * h_loc)
        psum_chan(parts, integ)
        cmp = integ if weight_sh is None else integ * weight_sh
        floor = 0.0
        if mode != "squared":
            cmp = cmp.abs() if allow_negative else cmp
            floor = FLT_MIN
        lmax, lidx = cmp.view(tile, -1).max(dim=1)  # first of equal maxima
        return lmax, lidx + first_index, floor

    def iterate():
        if coef_fit is not None:
            coef_fit.add()
        lmax, gidx, floor = shard_maxima()
        gmax, gsel = argmax_over_shards(lmax, gidx)
        y, x = gsel // width, gsel % width
        raw = read_pixel(res_sh, res_base, y, x, row_starts).reshape(-1)
        value = integrate_values(raw, mode, chan_coefs, pol_coefs, P)
        if rms_sh is not None:
            value = value * read_pixel(rms_sh[:, None], rms_base, y, x,
                                       row_starts)[0]
        advance_state(buffers, params, (gmax > floor).view(1), value.view(1),
                      gsel.view(1), width, raw)
        if coef_fit is not None:
            coef_fit.refit()
        elif fitter is not None:
            buffers.values.copy_(fitted_values(
                fitter, buffers.peak, state[INDEX:INDEX + 1], params.gain,
                meta.n_channels, P))

    result = run_chunks(iterate, buffers, params, start_iteration, active0)
    unplace(res_sh, residual, mesh)
    if coefficients is None:
        unplace(mod_sh, model, mesh)
    return result


# ---------------------------------------------------------------------------
# The Clark subminor loop on the mesh
# ---------------------------------------------------------------------------


class TileCandidates(NamedTuple):
    """Every tile's candidate set, concatenated tile by tile, each tile's in
    raster order: the state that :func:`subminor_loop_tiles` runs on."""

    flat: torch.Tensor        # [K] int64 flat pixel of each candidate
    xs: torch.Tensor          # [K] int32 column
    ys: torch.Tensor          # [K] int32 row, global (the PSF offsets)
    residual_k: torch.Tensor  # [N, K] the residual at the candidates
    rms_k: Optional[torch.Tensor]  # [K] the rms factor there, or None
    offsets: torch.Tensor     # [T + 1] int32 segment bounds, on the device
    counts: List[int]         # [T] candidates of each tile, on the host


def select_tile_candidates(
    mesh: Mesh,
    residual: torch.Tensor,  # [N, H, W]
    rms_factor: Optional[torch.Tensor],  # [H, W] or None
    window: torch.Tensor,  # [H, W] bool: border window AND mask
    considered_threshold: float,
    *,
    meta,
    allow_negative: bool,
) -> TileCandidates:
    """Each tile's candidates (``mesh.py:521-541`` of the JAX package,
    ``subminor_loop.cc:143-184`` run per row band), selected over the whole
    image at once (:func:`radler_tpu_torch.models.subminor.select_candidates`):
    raster order keeps each tile's candidates together, a tile being ``y //
    H_loc``; the per-tile counts are one ``bincount`` and one host read.  K is the exact count: the
    JAX package's per-tile capacity clamp (2^20, brightest first) has no
    counterpart."""
    n, height, width = residual.shape
    dev = residual.device
    flat = select_candidates(residual, meta, rms_factor, window,
                             considered_threshold, allow_negative)
    ys = flat // width
    per_tile = torch.bincount(ys // (height // mesh.tile),
                              minlength=mesh.tile)
    offsets = torch.zeros(mesh.tile + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(per_tile, 0)
    counts = per_tile.tolist()
    rms_k = None
    if rms_factor is not None:
        rms_k = rms_factor.reshape(-1)[flat].contiguous()
    return TileCandidates(
        flat, (flat % width).to(torch.int32), ys.to(torch.int32),
        residual.reshape(n, -1)[:, flat].contiguous(), rms_k, offsets,
        counts)


class MeshSubminorResult(NamedTuple):
    """What :func:`mesh_subminor_clean` returns."""

    delta: Optional[torch.Tensor]  # [N, H, W] model delta; None: no pixel
    iteration: int        # start + the iterations of every tile
    value: float          # the signed value of the largest |final value|
    diverging: bool       # any tile diverged
    any_selected: bool    # any tile had a candidate


def reduce_tile_results(results, start_iteration: int
                        ) -> Tuple[int, float, bool]:
    """The reduction over tiles of ``mesh.py:650-664`` of the JAX package:
    the iterations of every tile added to the shared start, the signed
    value of the largest magnitude (+v over -v on a tie), and whether any
    tile diverged."""
    iteration = start_iteration + sum(it - start_iteration
                                      for it, _, _ in results)
    top = max(abs(value) for _, value, _ in results)
    value = max(v for _, v, _ in results if abs(v) >= top)
    return iteration, value, any(d for _, _, d in results)


def mesh_subminor_clean(
    mesh: Mesh,
    residual: torch.Tensor,  # [N, H, W]
    psfs: torch.Tensor,  # [C, H, W] PSFs at image size
    rms_factor: Optional[torch.Tensor],  # [H, W] or None
    window: torch.Tensor,  # [H, W] bool: border window AND mask
    considered_threshold: float,
    params: SubminorParams,
    *,
    meta,
    fitter=None,
) -> MeshSubminorResult:
    """The Clark subminor loop on ``mesh`` (``mesh_subminor_clean`` and its
    program, ``mesh.py:488-752`` of the JAX package): every tile selects
    its candidates (:func:`select_tile_candidates`) and cleans them on its
    own to ``params.threshold``, from ``params.start_iteration`` up to
    ``params.max_iterations`` each (so the total may pass it, as the
    reference's per-sub-image counts do), in one launch of B2 with a tile
    axis; the results are reduced as :func:`reduce_tile_results` does, and
    the candidates' model values scattered into a model delta.  The
    caller subtracts ``delta ⊛ psf`` from the residual once
    (:func:`radler_tpu_torch.models.subminor.correct_residual`) and adds
    ``delta`` to the model.  ``fitter``'s spectral fit runs in every
    tile's loop (:func:`radler_tpu_torch.models.subminor.fit_arguments`,
    the forced terms gathered at the candidates in the state's tile order,
    so they follow the segments).  The port multiplies by the gain before
    the fit, as the single-device loop does; the JAX mesh fits first
    (``mesh.py:598-601``), which for the log-polynomial and forced fits
    differs by rounding alone."""
    n, height, width = residual.shape
    if height % mesh.tile != 0:
        raise ValueError(f"mesh_subminor_clean: {height} rows do not divide "
                         f"over {mesh.tile} tiles")
    if residual.device != _index_device(mesh.device):
        raise ValueError(f"mesh_subminor_clean: the cube is on "
                         f"{residual.device}, the mesh on {mesh.device}")
    cand = select_tile_candidates(
        mesh, residual, rms_factor, window, considered_threshold, meta=meta,
        allow_negative=params.allow_negative)
    if sum(cand.counts) == 0:
        # The reference's fallback FindPeak scans a zeroed scratch and finds
        # nothing (generic_clean.cc:156-162).
        return MeshSubminorResult(None, params.start_iteration, 0.0, False,
                                  False)
    dev = residual.device
    model_k = torch.zeros_like(cand.residual_k)
    out = subminor_loop_tiles(
        cand.residual_k, model_k, cand.rms_k, cand.xs, cand.ys,
        psfs.contiguous(),
        torch.as_tensor(linear_integration_coefficients(meta), device=dev),
        fit_arguments(fitter, dev, cand.xs, cand.ys), params, cand.offsets,
        cand.counts, n_polarizations=meta.n_polarizations)
    iteration, value, diverging = reduce_tile_results(
        read_tile_results(out), params.start_iteration)
    delta = torch.zeros((n, height * width), dtype=torch.float32, device=dev)
    delta.index_copy_(1, cand.flat, model_k)
    return MeshSubminorResult(delta.view(n, height, width), iteration, value,
                              diverging, True)
