"""The ("chan", "tile") mesh, the mesh-partitioned Högbom minor loop, the
mesh's Clark subminor loop and the batched facets' placement.

Port of ``radler_tpu.parallel.mesh`` (``make_mesh``, ``mesh_pallas_eligible``,
``mesh_hogbom_loop``, ``mesh_subminor_clean`` and ``facet_axis_spec``).  The
``[N, H, W]`` cube is laid out over ``chan x tile`` shards: the planes over
``"chan"``, the image rows over ``"tile"``.  Each minor iteration runs one
kernel launch per shard, and the reference's thread-pool exchanges
(``parallel_deconvolution.cc:592-617``) become the collectives below:

* with a channel split (``chan > 1``) every shard runs kernel B4
  (:mod:`radler_tpu_torch.kernels.subtract_integrate`), and the joined
  integration is the sum of the shards' parts over ``"chan"``
  (:func:`psum_chan`, on the group that holds the tile's chan-0 shard),
  followed by the weighted argmax of each tile's rows;
* without one, every shard holds all planes of its rows and runs kernel B1
  (:mod:`radler_tpu_torch.kernels.hogbom_step`) with its row offset, which
  integrates and reduces the shard itself;
* the global peak is a max pair over the shards (:func:`argmax_over_shards`),
  and its ``[N]`` values a masked read, a sum over ``"tile"`` and a gather
  over ``"chan"`` (:func:`read_pixel`).

The shards spread over the groups of :attr:`Mesh.devices`, each group an
equal, contiguous run of the ``chan``-major shard order and a rectangular
block of the grid, on its own device (a group is a position in the tuple:
``("cpu",) * 4`` is four groups on the CPU, ``("cuda:0",) * 4`` four on one
card).  One process drives them all, as the JAX package's single
controller does: :func:`place` puts each group's block on its device, each
shard's kernel launches there, and each collective is a gather in shard
order followed by the one-device tensor ops, so that the result does not
depend on the groups.  Copies between cards are PyTorch's peer copies,
ordered against both cards' current streams: no host synchronize, and
one host read per ``CHUNK`` iterations, as on one device.  The cube, the
model and the loop state live on the lead, ``devices[0]``.

The batched facets spread over the groups too (:func:`facet_groups`, the
JAX package's ``facet_axis_spec``): each group's lockstep loop runs on its
card, the host keeping every card's loop going (:func:`run_together`), and
IUWT and ASP spread their images by rows (:mod:`radler_tpu_torch.parallel.
rows`).

The Clark subminor loop on the mesh (:func:`mesh_subminor_clean`) is each
tile cleaning its own candidates to the shared threshold; the tiles share
nothing else, so it runs as T independent loops, one launch of kernel B2
with a tile axis (:func:`radler_tpu_torch.kernels.subminor_loop.subminor_loop_tiles`)
on each group's device over its run of tiles (:func:`tile_runs`), and the
``"chan"`` split, which only shares out a tile's planes, is no part of it.
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


def _index_device(device: torch.device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _fits(chan: int, tile: int, groups: int) -> bool:
    """Whether ``chan x tile`` shards fall into ``groups`` equal runs of
    the ``chan``-major order, each a rectangular block of the grid."""
    per = chan * tile // groups
    return per > 0 and per * groups == chan * tile and (
        tile % per == 0 or per % tile == 0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``chan x tile`` mesh of shards over the groups of ``devices``.

    Group g holds the g-th equal, contiguous run of the shards in
    ``chan``-major order, which must be a rectangular ``[chan_g, tile_g]``
    block of the grid (:meth:`block`): the shards a group holds divide
    ``tile`` or are a multiple of it.  A group is a position in
    ``devices``, not a distinct device (``("cpu",) * 4`` is four groups on
    the CPU).  ``devices[0]``, the lead, is ``device``: the cube, the model
    and the loop state live there before and after a loop.  Without
    ``devices`` the mesh is one group on ``device``."""

    chan: int
    tile: int
    device: torch.device
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        device = torch.device(self.device)
        devices = tuple(torch.device(d) for d in self.devices) or (device,)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "devices", devices)
        groups = len(devices)
        if devices[0] != device:
            raise ValueError(f"Mesh: the lead {devices[0]} is not the "
                             f"mesh's device {device}")
        if not _fits(self.chan, self.tile, groups):
            raise ValueError(
                f"Mesh: {self.chan} x {self.tile} shards do not fall into "
                f"{groups} rectangular blocks")
        if groups > 1 and any(d.type == "cuda" and d.index is None
                              for d in devices):
            raise ValueError(f"Mesh: every card of {devices} needs its index")

    @property
    def size(self) -> int:
        return self.chan * self.tile

    @property
    def groups(self) -> int:
        return len(self.devices)

    def block(self, group: int) -> Tuple[int, int, int, int]:
        """Group ``group``'s block of the grid: ``(c0, chan_g, t0,
        tile_g)``, the shards ``[c0, c0 + chan_g) x [t0, t0 + tile_g)``."""
        per = self.size // self.groups
        start = group * per
        return (start // self.tile, max(1, per // self.tile),
                start % self.tile, min(per, self.tile))

    def group_of(self, c: int, t: int) -> int:
        """The group that holds shard ``(c, t)``."""
        return (c * self.tile + t) // (self.size // self.groups)

    def card(self, group: int) -> torch.device:
        """Group ``group``'s device, with its index."""
        return _index_device(self.devices[group])


def visible_cards(device) -> List[torch.device]:
    """The devices a mesh for a run on ``device`` spreads its shards over:
    the run's card first, then the other visible CUDA cards in index
    order; ``device`` alone for any other device."""
    device = _index_device(torch.device(device))
    if device.type != "cuda":
        return [device]
    return [device] + [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())
                       if i != device.index]


def peer_access(devices) -> List[List[bool]]:
    """Whether each device of ``devices`` reads the others' memory
    directly: True for the same device, CUDA's peer access between two
    cards.  Without it a copy between the two goes through the host, which
    is correct but slow."""
    devices = [_index_device(torch.device(d)) for d in devices]
    return [[a == b or (a.type == b.type == "cuda"
                        and torch.cuda.can_device_access_peer(a.index,
                                                              b.index))
             for b in devices] for a in devices]


def make_mesh(n_devices: int, n_channels: Optional[int] = None,
              device="cuda", cards=None) -> Mesh:
    """A ``("chan", "tile")`` mesh of ``n_devices`` shards.

    Channel-major, as in the JAX package (``mesh.py:25-61``): ``"chan"``
    takes the largest factor of ``n_devices`` that divides the channel
    count, so that channels, not rows, are split first; with the count
    unknown, 4 or 2 when that leaves more than one tile.  ``"tile"`` takes
    the rest.  The shards go to the first G of ``cards`` (the lead first;
    default ``device`` alone), G the largest count up to ``len(cards)``
    that divides ``n_devices`` into rectangular blocks (:class:`Mesh`).
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
    tile = n // chan
    cards = [torch.device(c) for c in (cards or [device])]
    groups = max(g for g in range(1, min(len(cards), n) + 1)
                 if _fits(chan, tile, g))
    return Mesh(chan, tile, cards[0], tuple(cards[:groups]))


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
# Placement and collectives
# ---------------------------------------------------------------------------


def _shard_view(cube: torch.Tensor, mesh: Mesh, group: int) -> torch.Tensor:
    n, height, width = cube.shape
    c0, chan_g, t0, tile_g = mesh.block(group)
    return cube.view(mesh.chan, n // mesh.chan, mesh.tile,
                     height // mesh.tile, width).transpose(1, 2)[
                         c0:c0 + chan_g, t0:t0 + tile_g]


def place(cube: torch.Tensor, mesh: Mesh, group: int = 0) -> torch.Tensor:
    """Group ``group``'s shards of the ``[N, H, W]`` cube, ``[chan_g,
    tile_g, N_loc, H_loc, W]``, one contiguous block on the group's
    device.  The lead group's is a view of ``cube`` where its layout
    already is that (one plane per shard, or one tile); any other group's
    is a copy, made on the streams of both devices."""
    view = _shard_view(cube, mesh, group)
    if group == 0:
        return view.contiguous()
    block = torch.empty(view.shape, dtype=cube.dtype,
                        device=mesh.card(group))
    return block.copy_(view)


def unplace(shards: torch.Tensor, cube: torch.Tensor, mesh: Mesh,
            group: int = 0) -> None:
    """Write group ``group``'s shards back into the ``[N, H, W]`` cube they
    came from."""
    view = _shard_view(cube, mesh, group)
    if shards.data_ptr() != view.data_ptr():
        view.copy_(shards)


def gather(blocks: List[torch.Tensor], mesh: Mesh,
           device: torch.device) -> torch.Tensor:
    """The groups' ``[chan_g, tile_g, ...]`` blocks as one ``[chan, tile,
    ...]`` tensor on ``device``, the mesh's lead (one group: its block)."""
    per_row = mesh.tile // mesh.block(0)[3]  # groups along a chan row
    return _cat_on([_cat_on(blocks[i:i + per_row], device, dim=1)
                    for i in range(0, len(blocks), per_row)], device)


def _cat_on(parts: List[torch.Tensor], device: torch.device,
            dim: int = 0) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device`` (one part:
    itself)."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts], dim)


# ---------------------------------------------------------------------------
# The batched facets' axis
# ---------------------------------------------------------------------------


def facet_axis_spec(mesh: Mesh, n_facets: int):
    """The mesh axes the facet axis lies over (``facet_axis_spec``,
    ``mesh.py:842-855`` of the JAX package): the whole mesh when the facet
    count divides its size, else ``"tile"``, else ``"chan"``, else None
    (every facet on every device)."""
    if n_facets % mesh.size == 0:
        return ("chan", "tile")
    if n_facets % mesh.tile == 0:
        return "tile"
    if n_facets % mesh.chan == 0:
        return "chan"
    return None


def facet_groups(mesh: Mesh, n_facets: int) -> List[int]:
    """The group that runs each facet, by :func:`facet_axis_spec`: the
    facets cut into equal blocks along the spec's axes, block ``(c, t)`` on
    the group that holds shard ``(c, t)``.  A block the JAX package
    replicates over an axis runs once, on the first such group (``(0, t)``
    over ``"chan"``, ``(c, 0)`` over ``"tile"``); without a spec every
    facet runs on the lead."""
    spec = facet_axis_spec(mesh, n_facets)
    if spec is None:
        return [0] * n_facets
    if spec == "tile":
        per = n_facets // mesh.tile
        return [mesh.group_of(0, f // per) for f in range(n_facets)]
    if spec == "chan":
        per = n_facets // mesh.chan
        return [mesh.group_of(f // per, 0) for f in range(n_facets)]
    per = n_facets // mesh.size
    return [mesh.group_of(*divmod(f // per, mesh.tile))
            for f in range(n_facets)]


def facet_runs(mesh: Optional[Mesh], n_facets: int
               ) -> List[Tuple[int, List[int]]]:
    """``(group, facets)`` of each group that runs facets, in group order
    (:func:`facet_groups`), each a contiguous run of facets (a facet's
    group grows with its index); one run of every facet on the lead
    without a mesh of several groups."""
    if mesh is None or mesh.groups == 1:
        return [(0, list(range(n_facets)))]
    owner = facet_groups(mesh, n_facets)
    return [(g, [f for f in range(n_facets) if owner[f] == g])
            for g in sorted(set(owner))]


def run_together(loops) -> list:
    """Drive generator loops, one a card, to their ends; return their
    results in order.  A loop yields once it has enqueued work and before
    it reads the device, so each round enqueues every card's next chunk
    before any card's read waits: the cards run at once, and the host
    reads each once a round."""
    loops = list(loops)
    results = [None] * len(loops)
    live = list(range(len(loops)))
    while live:
        for i in list(live):
            try:
                next(loops[i])
            except StopIteration as stop:
                results[i] = stop.value
                live.remove(i)
    return results


class CardCopies:
    """Copies of read-only tensors (PSF stacks, banks) on the cards that
    need them, one a name and card, kept across calls while the source is
    the kept tensor at the kept version (a new tensor, such as a perform's
    new PSF stack, is copied anew: no compare, no host read)."""

    def __init__(self):
        self._kept = {}

    def on(self, name, tensor: Optional[torch.Tensor],
           device: torch.device) -> Optional[torch.Tensor]:
        """``tensor`` on ``device``: itself there, else the kept copy."""
        if tensor is None or _index_device(tensor.device) == device:
            return tensor
        kept = self._kept.get((name, device))
        if kept is None or kept[0] is not tensor or (kept[0]._version
                                                     != kept[1]):
            kept = self._kept[name, device] = (tensor, tensor._version,
                                               tensor.to(device))
        return kept[2]


def shard_multiscale_inputs(mesh: Mesh,
                            *tensors: Optional[torch.Tensor]) -> None:
    """Check that the fused multiscale loop's state (the residual, the
    model, the banks, the search windows and the rms factor; None is
    skipped) lies on ``mesh``'s lead (``mesh.py:781`` of the JAX package
    lays it out over the mesh's devices).  The banks, the FFT work and the
    host decisions stay there; each subminor pass places the residual over
    the groups (:func:`place`) and gathers it back."""
    device = _index_device(mesh.device)
    for t in tensors:
        if t is not None and _index_device(t.device) != device:
            raise ValueError(f"a fused multiscale input lies on {t.device}, "
                             f"the mesh on {device}")


def psum_chan(parts, out: torch.Tensor) -> torch.Tensor:
    """The sum over ``"chan"`` of a tile's integration parts (``parts[c]``
    chan c's, each ``[..., H_loc, W]``, on ``out``'s device), into ``out``:
    a left fold in shard order, ``((p0 + p1) + p2) + ...``, so that one
    plane per shard adds in B1's own order."""
    torch.add(parts[0], parts[1], out=out)
    for c in range(2, len(parts)):
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


def pixel_reads(shards: torch.Tensor, base: torch.Tensor, y: torch.Tensor,
                x: torch.Tensor, row_starts: torch.Tensor) -> torch.Tensor:
    """Each shard's read of image pixel (y, x) in row-sharded ``shards``
    ``[..., tile, K, H_loc, W]`` (``row_starts`` their first image rows):
    its rows' value, 0 where it does not hold row y.  Returns ``[...,
    tile, K]``.  ``base`` is :func:`pixel_base` of ``shards``."""
    height_local, width = shards.shape[-2:]
    local_y = y - row_starts
    own = (local_y >= 0) & (local_y < height_local)
    at = local_y.clamp(0, height_local - 1) * width + x
    vals = torch.take(shards, base + at[:, None])
    return torch.where(own[:, None], vals, 0.0)


def read_pixel(shards: torch.Tensor, base: torch.Tensor, y: torch.Tensor,
               x: torch.Tensor, row_starts: torch.Tensor) -> torch.Tensor:
    """The values at image pixel (y, x) of row-sharded ``shards``: the
    :func:`pixel_reads` summed over ``"tile"`` (``values_at`` and
    ``image_at``, ``mesh.py:235-250``).  Returns ``[..., K]``, whose
    flattening is the gather over ``"chan"``."""
    return pixel_reads(shards, base, y, x, row_starts).sum(-2)


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

    The cube lies on the mesh's lead.  Each group's shards are placed on
    its device, and each shard's kernel launches there; the fit, the
    stopping rule and the loop state stay on the lead, whose state is
    copied to the other groups before their launches each iteration.  On
    CUDA tensors the shards run the kernels (``plain`` runs their plain
    versions, for comparison); on CPU tensors the plain versions.  The loop
    state stays on the devices, read once per ``CHUNK`` iterations.  Its
    semantics are the JAX mesh loop's, which may differ from the
    single-device loop's: among tiles with equal maxima the largest flat
    index wins; with a channel split and squared joins the comparison image
    is the summed part times weight^2 (no sqrt, no abs) and a peak is found
    when it exceeds 0; the peak's value is the joined integration of its
    gathered ``[N]`` values times the rms factor there.  Every collective
    keeps one order of operations whatever the groups, so a loop over
    several groups ends in the bits of the same loop over one.
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
    lead = residual.device
    if lead != mesh.card(0):
        raise ValueError(f"mesh_hogbom_loop: the cube is on "
                         f"{residual.device}, the mesh on {mesh.device}")
    chan, tile = mesh.chan, mesh.tile
    n_loc, h_loc = n // chan, height // tile
    P = meta.n_polarizations
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
            0, torch.arange(n, device=lead) // P).contiguous()
        shard_P = 1
    c_loc = n_loc // shard_P

    groups = range(mesh.groups)
    cards = [mesh.card(g) for g in groups]
    blocks = [mesh.block(g) for g in groups]
    res_sh = [place(residual, mesh, g) for g in groups]
    # With coefficients, the kernels' own model update goes to a scratch
    # cube and ``model`` (the [T*P, H, W] coefficient cube) gains its
    # values here, at the peak.
    mod_sh = ([place(model, mesh, g) for g in groups] if coefficients is None
              else [torch.empty_like(r) for r in res_sh])
    # The read-only inputs, copied to each device once a loop.
    psfs_on = [shard_psfs.to(card) for card in cards]
    weight_rows = None if weight is None else weight.view(tile, h_loc, width)
    if weight_rows is not None and mode == "squared" and not complete:
        # argmax of sqrt(s)·w is argmax of s·w² (w >= 0): no sqrt pass.
        weight_rows = weight_rows * weight_rows
    # The groups that hold chan 0 take their tiles' maxima; the others'
    # integration parts are folded there.
    folds = [g for g in groups if blocks[g][0] == 0]
    weight_on = {g: None if weight_rows is None else
                 weight_rows[blocks[g][2]:blocks[g][2] + blocks[g][3]].to(
                     cards[g]) for g in folds}
    rms_sh = None if rms is None else rms.view(tile, h_loc, width)
    row_starts = torch.arange(tile, device=lead) * h_loc
    first_index = row_starts * width
    rms_base = None if rms is None else pixel_base(rms_sh[:, None])
    res_base = [pixel_base(r) for r in res_sh]
    starts_on = [row_starts[t0:t0 + tile_g].to(card)
                 for (_, _, t0, tile_g), card in zip(blocks, cards)]
    chan_coefs = device_const(chan_np, lead)
    pol_coefs = device_const(pol_np, lead)
    if complete:
        step = hogbom_step_reference if plain else hogbom_step
        coefs_np = kernel_coefficients(mode, chan_np, pol_np)
        coefs_on = [device_const(coefs_np, card) for card in cards]
    else:
        step = subtract_integrate_reference if plain else subtract_integrate
        coefs_np = plane_coefficients(mode, chan_np, shard_P)
        coefs_on = [device_const(coefs_np, card).view(chan, n_loc)
                    for card in cards]
        pols_on = [device_const(pol_np, card) for card in cards]
        parts = [torch.zeros((chan_g, tile_g, h_loc, width), device=card)
                 for (_, chan_g, _, tile_g), card in zip(blocks, cards)]
        integ = {g: torch.empty((blocks[g][3], h_loc, width),
                                device=cards[g]) for g in folds}
        # Fold group f's terms in chan order: (group, local chan, local
        # tile) of each chan's part of f's tiles, and a buffer on f's
        # device for each part that another group holds.
        sources, inbox = {}, {}
        for f in folds:
            t0, tile_g = blocks[f][2], blocks[f][3]
            sources[f] = []
            for c in range(chan):
                g = mesh.group_of(c, t0)
                sources[f].append((g, c - blocks[g][0], t0 - blocks[g][2]))
                if g != f:
                    inbox[f, c] = torch.empty((tile_g, h_loc, width),
                                              device=cards[f])
    buffers, active0 = start_loop(residual, peak0, params, start_iteration,
                                  meta=meta, fitter=fitter)
    state = buffers.state
    # The loop state each group's launches read: the lead's own, and a
    # copy on every other group, refreshed each iteration.
    values_on = [buffers.values] + [torch.empty_like(buffers.values,
                                                     device=cards[g])
                                    for g in groups[1:]]
    state_on = [state] + [torch.empty_like(state, device=cards[g])
                          for g in groups[1:]]
    sel_on = [None] + [torch.empty((), dtype=torch.int64, device=cards[g])
                       for g in groups[1:]]
    coef_fit = None
    if coefficients is not None:
        coef_fit = CoefficientFit(*coefficients, buffers, model, params.gain,
                                  meta.n_channels, P)

    def shard_maxima():
        """Each tile's local maximum and its global flat index, on the
        lead."""
        for g in groups[1:]:
            values_on[g].copy_(buffers.values)
            state_on[g].copy_(state)
        lmax, lidx = [], []
        if complete:
            for g in groups:
                t0, tile_g = blocks[g][2], blocks[g][3]
                weight_g = weight_on[g]
                partials = [
                    step(res_sh[g][0, t], mod_sh[g][0, t], psfs_on[g],
                         values_on[g], state_on[g], coefs_on[g],
                         None if weight_g is None else weight_g[t],
                         mode=mode, n_polarizations=P,
                         allow_negative=allow_negative,
                         row_offset=(t0 + t) * h_loc)
                    for t in range(tile_g)
                ]
                # Blocks hold ascending pixel ranges: the first block with
                # the maximum holds the tile's smallest index among equal
                # maxima.
                tile_max, best = torch.stack([p[0] for p in partials]).max(
                    dim=1)
                lmax.append(tile_max)
                lidx.append(torch.stack([p[1] for p in partials]).gather(
                    1, best[:, None])[:, 0])
            return (_cat_on(lmax, lead),
                    _cat_on(lidx, lead).long() + first_index, FLT_MIN)
        for g in groups:
            c0, chan_g, t0, tile_g = blocks[g]
            for lc in range(chan_g):
                c = c0 + lc
                for t in range(tile_g):
                    step(res_sh[g][lc, t], mod_sh[g][lc, t],
                         psfs_on[g][c * c_loc:(c + 1) * c_loc],
                         values_on[g][c * n_loc:(c + 1) * n_loc],
                         state_on[g], coefs_on[g][c], pols_on[g],
                         parts[g][lc, t], mode=mode,
                         n_polarizations=shard_P, row_offset=(t0 + t) * h_loc)
        floor = 0.0 if mode == "squared" else FLT_MIN
        for f in folds:
            tile_g = blocks[f][3]
            terms = []
            for c, (g, lc, lt) in enumerate(sources[f]):
                part = parts[g][lc, lt:lt + tile_g]
                terms.append(part if g == f else inbox[f, c].copy_(part))
            cmp = psum_chan(terms, integ[f])
            if weight_on[f] is not None:
                cmp = cmp * weight_on[f]
            if mode != "squared" and allow_negative:
                cmp = cmp.abs()
            tile_max, best = cmp.view(tile_g, -1).max(dim=1)  # first of equal
            lmax.append(tile_max)
            lidx.append(best)
        return _cat_on(lmax, lead), _cat_on(lidx, lead) + first_index, floor

    def read_peak(gsel, y, x):
        """The ``[N]`` residual values at flat pixel ``gsel`` = (y, x), on
        the lead: each group reads its shards, and the reads are summed
        over ``"tile"`` on the lead."""
        reads = [pixel_reads(res_sh[0], res_base[0], y, x, starts_on[0])]
        for g in groups[1:]:
            sel = sel_on[g].copy_(gsel)
            reads.append(pixel_reads(res_sh[g], res_base[g], sel // width,
                                     sel % width, starts_on[g]))
        return gather(reads, mesh, lead).sum(-2).reshape(-1)

    def iterate():
        if coef_fit is not None:
            coef_fit.add()
        lmax, gidx, floor = shard_maxima()
        gmax, gsel = argmax_over_shards(lmax, gidx)
        y, x = gsel // width, gsel % width
        raw = read_peak(gsel, y, x)
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
    for g in groups:
        unplace(res_sh[g], residual, mesh, g)
        if coefficients is None:
            unplace(mod_sh[g], model, mesh, g)
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
    mask,  # [H, W] bool tensor or NumPy array, or None
    considered_threshold: float,
    *,
    meta,
    allow_negative: bool,
    borders: Tuple[int, int] = (0, 0),
) -> TileCandidates:
    """Each tile's candidates (``mesh.py:521-541`` of the JAX package,
    ``subminor_loop.cc:143-184`` run per row band), selected over the whole
    image at once (:func:`radler_tpu_torch.models.subminor.select_candidates`,
    inside ``borders`` and ``mask``): raster order keeps each tile's
    candidates together, a tile being ``y // H_loc``; the per-tile counts
    are one ``bincount`` and one host read.  K is the exact count: the JAX
    package's per-tile capacity clamp (2^20, brightest first) has no
    counterpart."""
    n, height, width = residual.shape
    dev = residual.device
    flat = select_candidates(residual, meta, rms_factor, mask,
                             considered_threshold, allow_negative, borders)
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


def tile_runs(mesh: Mesh) -> List[Tuple[int, int, int]]:
    """Where the Clark loop's tiles run: ``(first, last, group)`` of each
    group that takes tiles ``[first, last)``.  The loop places no cube and
    its tiles share nothing, so the T tiles spread over the G groups
    whatever the ``"chan"`` split: tile t on group ``t * G // T``."""
    T, G = mesh.tile, mesh.groups
    runs = []
    for g in range(G):
        first, last = -(-g * T // G), -(-(g + 1) * T // G)
        if first < last:
            runs.append((first, last, g))
    return runs


def _cut(t: Optional[torch.Tensor], k0: int, k1: int,
         device: torch.device) -> Optional[torch.Tensor]:
    """Candidates ``[k0, k1)`` of ``t`` (last axis), contiguous on
    ``device``."""
    return None if t is None else t[..., k0:k1].to(device).contiguous()


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
    mask,  # [H, W] bool tensor or NumPy array, or None
    considered_threshold: float,
    params: SubminorParams,
    *,
    meta,
    fitter=None,
    borders: Tuple[int, int] = (0, 0),
) -> MeshSubminorResult:
    """The Clark subminor loop on ``mesh`` (``mesh_subminor_clean`` and its
    program, ``mesh.py:488-752`` of the JAX package): every tile selects
    its candidates inside ``borders`` and ``mask``
    (:func:`select_tile_candidates`) and cleans them on its
    own to ``params.threshold``, from ``params.start_iteration`` up to
    ``params.max_iterations`` each (so the total may pass it, as the
    reference's per-sub-image counts do), in one launch of B2 with a tile
    axis on each group's device over its run of tiles (:func:`tile_runs`;
    the selection stays on the lead, and each run's state, PSFs and fit
    are copied to its device); the results are reduced as :func:`reduce_tile_results` does, and
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
    lead = residual.device
    if lead != mesh.card(0):
        raise ValueError(f"mesh_subminor_clean: the cube is on "
                         f"{residual.device}, the mesh on {mesh.device}")
    cand = select_tile_candidates(
        mesh, residual, rms_factor, mask, considered_threshold, meta=meta,
        allow_negative=params.allow_negative, borders=borders)
    if sum(cand.counts) == 0:
        # The reference's fallback FindPeak scans a zeroed scratch and finds
        # nothing (generic_clean.cc:156-162).
        return MeshSubminorResult(None, params.start_iteration, 0.0, False,
                                  False)
    psfs = psfs.contiguous()
    coef = linear_integration_coefficients(meta)
    bounds = np.concatenate([[0], np.cumsum(cand.counts)]).tolist()
    runs = []  # (tiles, the run's output or None, its model values)
    for first, last, group in tile_runs(mesh):
        card = mesh.card(group)
        k0, k1 = bounds[first], bounds[last]
        if k0 == k1:  # no candidate: every tile stops at once, value 0
            runs.append((last - first, None,
                         cand.residual_k.new_zeros((n, 0))))
            continue
        xs, ys = _cut(cand.xs, k0, k1, card), _cut(cand.ys, k0, k1, card)
        model_k = torch.zeros((n, k1 - k0), device=card)
        out = subminor_loop_tiles(
            _cut(cand.residual_k, k0, k1, card), model_k,
            _cut(cand.rms_k, k0, k1, card), xs, ys,
            psfs.to(card), torch.as_tensor(coef, device=card),
            fit_arguments(fitter, card, xs, ys), params,
            (cand.offsets[first:last + 1] - k0).to(card),
            cand.counts[first:last], n_polarizations=meta.n_polarizations)
        runs.append((last - first, out, model_k))
    # Every run is enqueued before the first host read.
    results = []
    for tiles, out, _ in runs:
        results += (read_tile_results(out) if out is not None else
                    [(params.start_iteration, 0.0, False)] * tiles)
    iteration, value, diverging = reduce_tile_results(
        results, params.start_iteration)
    model_k = _cat_on([m for _, _, m in runs], lead, dim=1)
    delta = torch.zeros((n, height * width), dtype=torch.float32, device=lead)
    delta.index_copy_(1, cand.flat, model_k)
    return MeshSubminorResult(delta.view(n, height, width), iteration, value,
                              diverging, True)
