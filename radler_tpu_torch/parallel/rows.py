"""Images spread by rows over the mesh's cards: the placement, the halo
exchange, the row-block decompose and the slab FFT.

Port of the JAX package's row placements of IUWT (``models/iuwt.py:
107-132``, ``_shard_rows``) and ASP (``models/asp.py:72-90``), where XLA
partitions the decompose, the statistics and the FFT convolutions over a
mesh's devices.  Here the host lays an image's rows out itself
(:class:`Rows`: one contiguous run of rows a part, each part on its
group's device) and runs each step on every part:

* row-local work (masks, sums over planes, comparisons) runs on each
  part's rows (:meth:`Rows.map`);
* a vertical convolution reads its part's rows with a halo from the
  neighbouring parts, copied in row order (:meth:`Rows.block`); the halo
  may span several parts;
* the à-trous decompose runs kernel B3 in its row-block mode
  (:func:`radler_tpu_torch.kernels.iuwt_atrous.atrous_rows`) on each
  part's block, one launch of the plan at a time, the halo exchanged
  before each;
* an FFT convolution is a slab FFT (:func:`convolve_rows`): the rfft along
  the rows on each part, an exchange of column blocks between all parts,
  the FFT along the columns and the product with the kernel's spectrum on
  each part's columns, and the way back;
* reductions send each part's partial to the lead, where they are combined
  in part order.

Copies between cards are PyTorch's peer copies, ordered against both
cards' current streams; nothing here synchronizes the host.  A failed copy
or launch raises: no step gathers an image to the lead because a card is
missing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..kernels.iuwt_atrous import (
    atrous_rows,
    launch_plan,
    launch_reach,
    iuwt_convolve,
)


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Rows ``[bounds[p], bounds[p + 1])`` of an image on ``devices[p]``;
    ``devices[0]`` is the mesh's lead."""

    bounds: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    @property
    def height(self) -> int:
        return self.bounds[-1]

    @property
    def parts(self) -> int:
        return len(self.devices)

    def rows(self, p: int) -> Tuple[int, int]:
        return self.bounds[p], self.bounds[p + 1]


def _merge(blocks: Sequence[Tuple[int, int, int]], mesh) -> Optional[RowLayout]:
    """A layout from ``(r0, r1, group)`` blocks in row order, neighbouring
    blocks of one group merged; None when one group holds every row."""
    merged: List[List[int]] = []
    for r0, r1, group in blocks:
        if r0 >= r1:
            continue
        if merged and merged[-1][2] == group:
            merged[-1][1] = r1
        else:
            merged.append([r0, r1, group])
    if len(merged) < 2:
        return None
    return RowLayout(tuple(b[0] for b in merged) + (merged[-1][1],),
                     tuple(mesh.card(b[2]) for b in merged))


def mesh_rows(mesh, height: int) -> Optional[RowLayout]:
    """IUWT's rows on ``mesh`` (``_shard_rows`` of the JAX package): over
    the whole mesh when the height divides by its size (shard ``(c, t)``
    the ``c * tile + t``-th run), else over ``"tile"`` (tile t's run on
    the group of ``(0, t)``, the first of those the JAX package replicates
    it over), else None (the lead alone, as the JAX package leaves the
    image unsharded)."""
    if mesh is None or mesh.groups == 1:
        return None
    if height % mesh.size == 0:
        per = height // mesh.size
        blocks = [(k * per, (k + 1) * per, mesh.group_of(*divmod(k, mesh.tile)))
                  for k in range(mesh.size)]
    elif height % mesh.tile == 0:
        per = height // mesh.tile
        blocks = [(t * per, (t + 1) * per, mesh.group_of(0, t))
                  for t in range(mesh.tile)]
    else:
        return None
    return _merge(blocks, mesh)


def tile_rows(mesh, height: int) -> Optional[RowLayout]:
    """ASP's rows on ``mesh`` (``models/asp.py:72-90`` of the JAX package):
    over ``"tile"``, the height padded to a multiple of the tiles (tile t's
    run of ``ceil(H / tile)`` rows, the last one short, on the group of
    ``(0, t)``); None when the rows lie on one group."""
    if mesh is None or mesh.groups == 1:
        return None
    per = -(-height // mesh.tile)
    return _merge([(t * per, min(height, (t + 1) * per), mesh.group_of(0, t))
                   for t in range(mesh.tile)], mesh)


@dataclasses.dataclass
class Rows:
    """An image, or a stack ``[*lead, H, W]`` of them, spread by rows:
    ``parts[p]`` holds rows ``layout.rows(p)`` on ``layout.devices[p]``."""

    parts: List[torch.Tensor]
    layout: RowLayout

    @classmethod
    def scatter(cls, image: torch.Tensor, layout: RowLayout) -> "Rows":
        """``image``'s rows laid out by ``layout`` (the lead's part is a
        copy too, so that the parts never alias ``image``)."""
        return cls([image[..., r0:r1, :].to(dev, copy=True).contiguous()
                    for (r0, r1), dev in zip(map(layout.rows,
                                                 range(layout.parts)),
                                             layout.devices)], layout)

    @property
    def lead(self) -> torch.device:
        return self.layout.devices[0]

    device = lead

    @property
    def shape(self) -> Tuple[int, ...]:
        return (*self.parts[0].shape[:-2], self.layout.height,
                self.parts[0].shape[-1])

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole image on ``device`` (default the lead)."""
        device = device or self.lead
        return torch.cat([p.to(device) for p in self.parts], dim=-2)

    def map(self, fn: Callable, *others) -> "Rows":
        """``fn`` on every part, with each Rows of ``others`` (same
        layout) by its part; other arguments pass as they are."""
        return Rows([fn(part, *(o.parts[p] if isinstance(o, Rows) else o
                                for o in others))
                     for p, part in enumerate(self.parts)], self.layout)

    def like(self, fill: float = 0.0) -> "Rows":
        """A Rows of this layout and shape filled with ``fill``."""
        return Rows([torch.full_like(p, fill) for p in self.parts],
                    self.layout)

    def block(self, p: int, reach: int) -> Tuple[torch.Tensor, int]:
        """Part ``p``'s rows with ``reach`` rows on each side, clipped to
        the image, on its device (the other parts' rows copied in row
        order), and the offset of its own first row in the block."""
        r0, r1 = self.layout.rows(p)
        a, b = max(0, r0 - reach), min(self.layout.height, r1 + reach)
        dev = self.layout.devices[p]
        pieces = []
        for q in range(self.layout.parts):
            q0, q1 = self.layout.rows(q)
            lo, hi = max(a, q0), min(b, q1)
            if lo < hi:
                pieces.append(self.parts[q][..., lo - q0:hi - q0, :].to(dev))
        block = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-2)
        return block.contiguous(), r0 - a

    def box(self, y1: int, x1: int, h: int, w: int,
            device=None) -> torch.Tensor:
        """Rows ``[y1, y1 + h)`` and columns ``[x1, x1 + w)`` on ``device``
        (default the lead), copied from the parts that hold them."""
        device = device or self.lead
        pieces = []
        for p in range(self.layout.parts):
            q0, q1 = self.layout.rows(p)
            lo, hi = max(y1, q0), min(y1 + h, q1)
            if lo < hi:
                pieces.append(self.parts[p][..., lo - q0:hi - q0,
                                            x1:x1 + w].to(device))
        return torch.cat(pieces, dim=-2).contiguous()

    def owner(self, y: int) -> int:
        """The part that holds row ``y``."""
        return next(p for p in range(self.layout.parts)
                    if self.layout.rows(p)[0] <= y < self.layout.rows(p)[1])

    def pixel(self, y: int, x: int) -> torch.Tensor:
        """The values at pixel (y, x), ``[*lead]``, a view on the part
        that holds row y."""
        p = self.owner(y)
        return self.parts[p][..., y - self.layout.rows(p)[0], x]

    def peaks(self, search: Callable, *others):
        """The peaks of a spread image from each part's: ``search(part,
        *others' parts)`` gives the part's ``(best, idx, *values)``,
        tensors of one shape (``idx`` the flat index within the part's
        plane, as :func:`~radler_tpu_torch.ops.peak_finder.masked_peaks`
        gives it); each element takes the first part whose ``best`` is the
        largest, as the whole image's argmax takes the first index among
        equal maxima.  Returns ``(best, flat index in the image, *values)``
        on the lead."""
        width = self.parts[0].shape[-1]
        found = [search(part, *(o.parts[p] if isinstance(o, Rows) else o
                                for o in others))
                 for p, part in enumerate(self.parts)]
        columns = []
        for k, column in enumerate(zip(*found)):
            if k == 1:
                column = [i + self.layout.rows(p)[0] * width
                          for p, i in enumerate(column)]
            columns.append(torch.stack([t.to(self.lead) for t in column]))
        first = torch.argmax(columns[0], dim=0)[None]
        return tuple(c.gather(0, first)[0] for c in columns)

    def sum(self) -> torch.Tensor:
        """The sum of every element, each part's added on the lead in part
        order."""
        total = self.parts[0].sum()
        for part in self.parts[1:]:
            total = total + part.sum().to(self.lead)
        return total


class RowCache:
    """Spread copies of fixed full-size tensors (windows, rms factors) and
    slab multipliers of fixed spectra, each kept while its source lives
    (the entry holds it), at most :attr:`KEPT` of them."""

    KEPT = 8

    def __init__(self):
        self._kept: dict = {}

    def keep(self, key, source, make):
        """``make()``, kept under ``key`` while ``source`` lives."""
        hit = self._kept.pop(key, None)
        if hit is None or hit[0] is not source:
            hit = (source, make())
        self._kept[key] = hit
        while len(self._kept) > self.KEPT:
            self._kept.pop(next(iter(self._kept)))
        return hit[1]

    def rows(self, t, layout: RowLayout):
        """``t`` laid out by ``layout`` (a Rows or None passes)."""
        if t is None or isinstance(t, Rows):
            return t
        return self.keep(("rows", id(t), layout), t,
                         lambda: Rows.scatter(t, layout))

    def spectrum(self, spectrum: torch.Tensor,
                 layout: RowLayout) -> "SlabSpectrum":
        """The slab multiplier of the rfft2 ``spectrum``."""
        return self.keep(("spectrum", id(spectrum), layout), spectrum,
                         lambda: SlabSpectrum(spectrum, layout))


def spread(image: torch.Tensor, layout: Optional[RowLayout]):
    """``image`` laid out by ``layout``, or itself without one."""
    return image if layout is None else Rows.scatter(image, layout)


def full(image) -> torch.Tensor:
    """A Rows gathered on its lead, or a tensor as it is."""
    return image.gather() if isinstance(image, Rows) else image


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------


def decompose_rows(image: Rows, n_scales: int) -> Rows:
    """:func:`radler_tpu_torch.ops.iuwt.decompose` of a spread image
    (``[*lead, H, W]``): returns ``[n_scales + 1, *lead, H, W]`` by rows.
    Each launch of the whole image's plan runs on every part's block
    (B3's row-block mode), after the exchange of the halo it reaches, so
    every pixel holds the whole-image decompose's bits."""
    height, width = image.layout.height, image.parts[0].shape[-1]
    coeffs = [part.new_empty((n_scales + 1, *part.shape))
              for part in image.parts]
    plan = launch_plan(n_scales, height, width)
    cur = image
    for i, step in enumerate(plan):
        last = i == len(plan) - 1
        nxt = []
        reach = launch_reach(step)
        for p, c in enumerate(coeffs):
            block, out0 = cur.block(p, reach)
            rows = image.parts[p].shape[-2]
            dst = c[n_scales] if last else torch.empty_like(image.parts[p])
            atrous_rows(block, step, out0, rows,
                        c[step.first_scale:step.first_scale + step.n_scales],
                        dst)
            nxt.append(dst)
        cur = Rows(nxt, image.layout)
    return Rows(coeffs, image.layout)


def smooth_rows(image: Rows, scale: int) -> Rows:
    """:func:`~radler_tpu_torch.kernels.iuwt_atrous.iuwt_convolve` of a
    spread image: each part's block with the vertical pass's halo."""
    reach = 2 * ((1 << scale) - 1)
    out = []
    for p, part in enumerate(image.parts):
        block, out0 = image.block(p, reach)
        out.append(iuwt_convolve(block, scale).narrow(
            -2, out0, part.shape[-2]))
    return Rows(out, image.layout)


def recompose_rows(scales: Rows, n_scales: int,
                   include_largest: bool) -> Rows:
    """:func:`radler_tpu_torch.ops.iuwt.recompose` of spread scales."""
    output = scales.map(lambda s: s[n_scales]) if include_largest else None
    for scale in range(n_scales - 1, -1, -1):
        plane = scales.map(lambda s, k=scale: s[k])
        if output is None:
            output = plane
        else:
            output = smooth_rows(output, scale + 1).map(torch.add, plane)
    return output if output is not None else scales.map(
        lambda s: torch.zeros_like(s[0]))


# ---------------------------------------------------------------------------
# The slab FFT
# ---------------------------------------------------------------------------


def column_bounds(width: int, parts: int) -> List[int]:
    """The rfft's ``width // 2 + 1`` columns cut into ``parts`` near-equal
    blocks."""
    cols = width // 2 + 1
    return [p * cols // parts for p in range(parts + 1)]


class SlabSpectrum:
    """A kernel's rfft2 spectrum (``[*lead, H, W // 2 + 1]``), each part's
    block of columns on its device: the multiplier of
    :func:`convolve_rows`."""

    def __init__(self, spectrum: torch.Tensor, layout: RowLayout):
        bounds = column_bounds(2 * (spectrum.shape[-1] - 1), layout.parts)
        self.layout = layout
        self.blocks = [spectrum[..., bounds[p]:bounds[p + 1]].to(dev)
                       .contiguous()
                       for p, dev in enumerate(layout.devices)]


# Bytes the last slab FFTs moved between parts on different cards, for
# the measurements (summed; the caller zeroes it).
exchange_bytes = [0]


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if t.device != device:
        exchange_bytes[0] += t.numel() * t.element_size()
    return t.to(device)


def convolve_rows(image: Rows, kernel: SlabSpectrum) -> Rows:
    """The circular centred convolution of a spread image with a kernel
    whose spectrum is ``kernel`` (:func:`radler_tpu_torch.ops.convolution.
    convolve_same` with :func:`~radler_tpu_torch.ops.convolution.
    prepare_kernel_fft`'s spectrum), as a slab FFT: the rfft along each
    part's rows, the column blocks exchanged so that each part holds its
    block of columns over every row, the FFT along the columns and the
    product with the kernel's block there, and the same way back.  Its
    bits are not ``rfft2``'s (the 1-D transforms round apart), and do not
    depend on the number of parts where the 1-D plans do not."""
    layout = image.layout
    width = image.parts[0].shape[-1]
    bounds = column_bounds(width, layout.parts)
    rows_f = [torch.fft.rfft(part, dim=-1) for part in image.parts]
    cols = []
    for q, dev in enumerate(layout.devices):
        c0, c1 = bounds[q], bounds[q + 1]
        slab = torch.cat([_move(r[..., c0:c1], dev) for r in rows_f], dim=-2)
        spec = torch.fft.fft(slab, dim=-2) * kernel.blocks[q]
        cols.append(torch.fft.ifft(spec, dim=-2))
    out = []
    for p, dev in enumerate(layout.devices):
        r0, r1 = layout.rows(p)
        row = torch.cat([_move(c[..., r0:r1, :], dev) for c in cols], dim=-1)
        out.append(torch.fft.irfft(row, n=width, dim=-1))
    return Rows(out, layout)
