"""Spatial (image-height) sharding of DepthNet serving (counterpart of
``endosr/parallel/spatial.py``).

JAX shards H over its mesh and XLA's SPMD partitioner inserts the halo
exchanges, the sums behind InstanceNorm's statistics and the collectives
behind the region-wise pooling. The port has no partitioner: a forward runs
on one horizontal slab of rows a rank inside a :func:`spatial` block, and
the port's ops make those exchanges themselves:

- every convolution of ``nn/layers.py`` (``conv2d_nhwc``: 3×3 stride 1,
  the stride-2 encoder convs, the 2×2 phase convs and the folded heads;
  ``_conv_transpose_nhwc``: the encoder's ``layer4``) first takes the rows
  its slab needs from its neighbours (:meth:`SpatialContext.halo`), zeros
  beyond the image, and convolves them without vertical padding, so each
  rank computes exactly its own output rows;
- the InstanceNorms (``instance_norm``, ``chained_instance_norm``, the
  ``in_stats`` route, the masked norms) and ``centered_conv``'s mean add
  their Σ, Σ² and pixel counts over the ranks in one fp32 all-reduce;
  ``centered_conv``'s border table applies the image's first and last
  rows on the first and last rank only; the fused epilogue takes the
  stats-in form of ``fused_in_mod``;
- the region-wise pooling sums its feature and mask sums over the ranks;
  a mask of another size is gathered whole (:meth:`SpatialContext.gather_rows`),
  resized and cut to this rank's rows;
- the ×4 phase-split head, the ×8 packed chains and their kernels
  (``packed_g123``, ``head_dot``, ``fused_tail``) and the hoisted-branch
  kernels (``fused_o_branch``, ``fused_modulation``) mix rows inside one
  launch: each runs unchanged on this rank's slab extended by a few rows
  of its neighbours (:meth:`SpatialContext.rows_local`), outside the
  block's rules, and its output is cropped to this rank's rows. The
  extension ends at the image's first and last row, so the kernels' own
  zero padding and border gates apply there; inside the image they touch
  only rows that the crop drops. The ×8 packed grid has LR + 1 rows: the
  last rank owns the extra (dead) row;
- the SR slabs are gathered, so every rank ends with the whole image.

The forwards cut the frame into whole 4-row units a rank, as even as they
go, the last slab also taking H mod 4 (:func:`row_layout`: 540 rows on 2
ranks are 272 + 268, 18 are 8 + 10). Every slab but the last then holds
an even number of rows at the encoder's half height and whole rows at its
quarter height, and a stride-2 conv gives each rank ⌈its rows / 2⌉; the
encoder's transposed ``layer4`` gives each rank twice its rows, the last
one row fewer (the image's 2n − 1). Each op finds its level's slabs from
its tensor's width (:class:`SpatialContext`). H a multiple of 4·N gives
``H / N`` rows a rank at every level. The kernels that work row by row
(``style_blend_dot``, ``style_dot_hwbm``, ``output_stage_x8``,
``output_stage``) run unchanged on a slab.

:func:`spatial_forward` runs DepthNet's unmasked forward, as JAX's does;
``FModelDepthCond.test`` with ``spatial_shard`` runs the masked, bucketed
forward (:func:`sharded_masked_forward`). :func:`spatial_jit` shards any
``fn(params, *arrays)`` built from the ops above: ``conv2d_nhwc``, the
norms, :func:`whole_mean` for a mean over the whole image, and any op
that works pixel by pixel or row by row (activations, channel matmuls,
``pixel_shuffle``, a nearest resize by a whole factor). An op that mixes
rows with no rule here raises ``NotImplementedError`` by name in a block:
``interpolate_bilinear`` and a nearest resize by another factor,
``PositionAttention`` and ``PositionAttentionEfficient`` (softmaxes over
H·W).

The exchanges are ``all_gather_into_tensor`` (halo rows, SR slabs) and
``all_reduce`` (sums), which NCCL and gloo carry for CUDA tensors alike
(gloo lets several ranks share one card; it cannot ``send`` / ``recv``
one, ``python3 chip_smoke.py --gloo-probe``).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from endosr_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["spatial_jit", "shard_spatial", "spatial_forward", "spatial",
           "active", "SpatialContext", "check_min_rows", "suspended",
           "whole_mean", "refuse", "sharded_masked_forward", "row_layout"]

_ACTIVE = contextvars.ContextVar("endosr_spatial", default=None)


def active():
    """The :class:`SpatialContext` of the enclosing :func:`spatial` block
    (of this thread or task), or None."""
    return _ACTIVE.get()


def check_min_rows(h: int, n: int, min_rows: int = 4) -> None:
    """Reject degenerate shards (JAX's ``_check_min_rows``): a stride-2
    conv whose input slabs hold a single row needs rows from two ranks
    away. Shipped generators downsample H by ≤ 4 before any strided conv,
    so H ≥ 4·N keeps every such input at ≥ 2 rows a slab."""
    if h < min_rows * n:
        raise ValueError(
            f"spatial sharding needs H ≥ {min_rows}·mesh ({min_rows * n}), "
            f"got {h} — smaller frames don't need sharding; run them on one "
            "chip (pass min_rows to relax for stride-1-only programs)")


def row_layout(h: int, n: int) -> list[int]:
    """The rows of each of ``n`` slabs of an ``h``-row frame for
    :func:`spatial_forward`: whole 4-row units, as even as they go (the
    first ranks one more), the last slab also taking ``h`` mod 4. Every
    slab then starts on a multiple of 4, so the encoder's two stride-2
    convs keep whole rows a rank; ``h`` a multiple of 4·n gives equal
    slabs."""
    u, r = divmod(h, 4)
    rows = [4 * (u // n + (k < u % n)) for k in range(n)]
    rows[-1] += r
    return rows


class SpatialContext:
    """This rank's place among the ``n`` row slabs of the mesh's group and
    the exchanges between them. ``rows``: each rank's rows of the frame
    (:func:`row_layout`) of ``width`` columns; None: equal slabs at every
    level (``spatial_jit``).

    With a layout, an op learns the slabs at its own level from its
    tensor's width, which every rank shares: W (the frame's rows), s·W (s
    times them: the upscaled maps and the SR), ⌈W/2⌉ and ⌈W/4⌉ (after the
    encoder's stride-2 convs: ⌈rows/2⌉, ⌈rows/4⌉) and 2⌈W/4⌉ − 1 (the
    encoder's transposed ``layer4``: twice the ⌈rows/4⌉, one row fewer on
    the last rank). Where two levels share a width (W mod 4 = 1), the one
    that fits this rank's rows is taken; both give every rank the same
    first row and differ at most in the last rank's row count, which only
    ``layer5``'s conv reads there, from its own slab."""

    def __init__(self, mesh: Mesh, rows: list[int] | None = None,
                 width: int | None = None):
        self.mesh = mesh
        self.group = mesh.get_group()
        self.rank = mesh.get_local_rank()
        self.n = mesh.size()
        if rows is not None and (len(rows) != self.n or width is None):
            raise ValueError(f"a layout of {len(rows)} slabs for {self.n} "
                             "ranks, or no width")
        self.rows, self.width = rows, width

    def _levels(self):
        """(width, offsets, counts, total) of every level of the layout."""
        c, w = self.rows, self.width
        o = [sum(c[:k]) for k in range(self.n)]
        h = sum(c)
        ceil = lambda a, d: -(-a // d)  # noqa: E731
        yield w, o, c, h
        for s in range(2, 65):
            yield s * w, [s * a for a in o], [s * a for a in c], s * h
        for d in (2, 4):
            yield (ceil(w, d), [a // d for a in o], [ceil(a, d) for a in c],
                   ceil(h, d))
        # layer4: 2n − 1 rows of n = ⌈h/4⌉
        t = [2 * ceil(a, 4) for a in c]
        t[-1] -= 1
        yield 2 * ceil(w, 4) - 1, [a // 2 for a in o], t, 2 * ceil(h, 4) - 1

    def slabs(self, rows: int, width: int):
        """(offsets, counts, total): every rank's first row and row count,
        and the image's rows, at the level where this rank's slab holds
        ``rows`` rows of ``width`` columns."""
        if self.rows is None:
            return [k * rows for k in range(self.n)], [rows] * self.n, \
                rows * self.n
        for w, o, c, h in self._levels():
            if w == width and c[self.rank] == rows:
                return o, c, h
        raise ValueError(f"a {rows}×{width} slab is at no level of the "
                         f"{self.rows}-row × {self.width} layout")

    def offset(self, rows: int, width: int) -> int:
        """The global index of this slab's first row (see :meth:`slabs`)."""
        return self.slabs(rows, width)[0][self.rank]

    def _gather(self, t):
        """[n, *t.shape]: every rank's ``t``, in rank order."""
        t = t.contiguous()
        out = t.new_empty((self.n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out.view((self.n,) + tuple(t.shape))

    def sum(self, *ts):
        """Each tensor summed over the ranks (one all-reduce in fp32 for
        all of them); returns a tuple, or the one tensor."""
        flat = torch.cat([t.reshape(-1).float() for t in ts])
        dist.all_reduce(flat, group=self.group)
        out, i = [], 0
        for t in ts:
            out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
            i += t.numel()
        return out[0] if len(out) == 1 else tuple(out)

    def halo(self, x, top: int, bottom: int):
        """NHWC slab ``x`` with ``top`` rows of the slab above and
        ``bottom`` rows of the slab below around it (zeros beyond the
        image's first and last rows). A halo may not exceed a slab."""
        if top == 0 and bottom == 0:
            return x
        b, h, w, c = x.shape
        least = min(self.slabs(h, w)[1])
        if top > least or bottom > least:
            raise ValueError(f"a halo of {top}/{bottom} rows exceeds a "
                             f"{least}-row slab: the frame is too small for "
                             f"{self.n} slabs")
        # every rank's last `top` and first `bottom` rows, gathered
        edges = self._gather(torch.cat([x[:, h - top:], x[:, :bottom]], 1))
        parts = []
        if top:
            parts.append(edges[self.rank - 1, :, :top] if self.rank > 0
                         else x.new_zeros((b, top, w, c)))
        parts.append(x)
        if bottom:
            parts.append(edges[self.rank + 1, :, top:] if self.rank < self.n - 1
                         else x.new_zeros((b, bottom, w, c)))
        return torch.cat(parts, dim=1)

    def conv_rows(self, x, kh: int, stride: int, pt: int, pb: int):
        """The rows a conv (kernel height ``kh``, ``stride``, vertical pads
        ``pt``/``pb``) needs for this slab's output rows, ⌈rows/stride⌉ of
        them, for a conv run with no vertical padding. Every slab must
        start on a multiple of the stride, all but the last hold a
        multiple of it, and the image's output have ⌈H/stride⌉ rows."""
        h = x.shape[1]
        offsets, counts, total = self.slabs(h, x.shape[2])
        if any(o % stride for o in offsets) or \
                any(c % stride for c in counts[:-1]) or \
                (total + pt + pb - kh) // stride + 1 != -(-total // stride):
            raise ValueError(
                f"a {kh}-row conv of stride {stride} with pads ({pt}, {pb}) "
                f"does not keep the {counts}-row slabs aligned")
        # rows pt above to (⌈h/s⌉ − 1)·s + kh − pt − h below this slab; the
        # halo is the same on every rank (the most any needs), then cut
        need = (-(-h // stride) - 1) * stride + kh - pt - h
        x = self.halo(x, pt, max(kh - pt - 1, 0))
        return x[:, :pt + h + need]

    def conv_transpose_rows(self, x, k: int, stride: int, padding: int,
                            conv):
        """A transposed conv's output rows for this slab, ``stride`` × its
        rows, the last slab's cut to the image's (H − 1)·stride − 2·padding
        + k rows (with a layout): ``conv`` (the transposed conv with its
        padding) runs on the slab and the input rows below it that reach
        its last output rows."""
        h = x.shape[1]
        # output row o reads input rows i with o = i·stride − padding + t,
        # 0 ≤ t < k: this slab's outputs read from `top` rows above it to
        # `bottom` rows below it
        top = (k - 1 - padding) // stride
        bottom = 1 + (padding - 1) // stride
        keep = h * stride
        if self.rows is not None and self.rank == self.n - 1:
            offsets, _, total = self.slabs(h, x.shape[2])
            keep = min(keep, (total - 1) * stride - 2 * padding + k
                       - offsets[-1] * stride)
        y = conv(self.halo(x, top, bottom))
        return y[:, top * stride:top * stride + keep]

    def gather_rows(self, y):
        """The whole image from every rank's slab ``y`` [B, h, ...] (rows
        stacked in rank order; the slabs' row counts are gathered first, so
        they may differ), on every rank."""
        counts = self._gather(torch.tensor([y.shape[1]], device=y.device))
        counts = [int(c) for c in counts.view(-1).tolist()]
        most = max(counts)
        if most != y.shape[1]:
            y = torch.cat([y, y.new_zeros((y.shape[0], most - y.shape[1])
                                          + tuple(y.shape[2:]))], 1)
        return torch.cat([p[:, :c] for p, c in zip(self._gather(y), counts)],
                         dim=1)

    def rows_local(self, xs, halo: int, fn, scale: int = 1):
        """``fn(*slabs)`` on this rank's slabs of ``xs`` (NHWC, one row
        count) extended by ``halo`` rows of each neighbour, none beyond
        the image's first or last row, run outside the block's rules (a
        kernel that mixes rows, with its own zero padding and border
        gates); returns its NHWC output cropped to this rank's rows,
        ``scale`` output rows an input row. ``fn``'s output rows
        ``scale·i`` … ``scale·i + scale − 1`` must belong to input row i,
        and none of those this rank keeps may read further than ``halo``
        rows."""
        h = xs[0].shape[1]
        top = halo if self.rank > 0 else 0
        bottom = halo if self.rank < self.n - 1 else 0
        ext = [self.halo(x, halo, halo)[:, halo - top:halo + h + bottom]
               for x in xs]
        with suspended():
            y = fn(*ext)
        return y[:, top * scale:(top + h) * scale]


@contextlib.contextmanager
def spatial(mesh: Mesh | None = None, rows: list[int] | None = None,
            width: int | None = None):
    """Run the block's DepthNet forwards on this rank's row slab (see the
    module's docstring); yields the :class:`SpatialContext` (``rows``,
    ``width``: its layout)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError("spatial sharding needs a process group: launch "
                           "the ranks with torchrun")
    if active() is not None:
        raise RuntimeError("spatial blocks do not nest")
    token = _ACTIVE.set(SpatialContext(mesh, rows, width))
    try:
        yield active()
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def suspended():
    """Inside a :func:`spatial` block, run the enclosed ops as on one
    device (on tensors that are whole, or on a slab a kernel treats as its
    own image); a no-op outside one."""
    token = _ACTIVE.set(None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def refuse(name: str) -> None:
    """Raise ``NotImplementedError`` naming ``name`` inside a spatial
    block: an op that mixes rows with no spatial rule."""
    if active() is not None:
        raise NotImplementedError(
            f"{name} mixes rows across the whole image and has no spatial "
            "rule: it cannot run on a row slab (spatial_forward, "
            "spatial_jit)")


def whole_mean(x, dims=(1, 2), keepdim: bool = True):
    """The mean of NHWC ``x`` over ``dims`` (H among them): in a spatial
    block over the whole image, the slabs' sums and counts added over the
    ranks in fp32; returns x's dtype."""
    sp = active()
    if sp is None or 1 not in dims:
        return x.mean(dim=dims, keepdim=keepdim)
    s = x.float().sum(dim=dims, keepdim=keepdim)
    n = torch.ones((), dtype=torch.float32, device=x.device)
    for d in dims:
        n = n * x.shape[d]
    s, n = sp.sum(s, n)
    return (s / n).to(x.dtype)


def shard_spatial(arrays, mesh: Mesh | None = None, min_rows: int = 4):
    """This rank's row slab of each NHWC array (numpy or tensor) of
    ``arrays`` (a tuple or list): H must divide by the mesh size, and each
    slab hold ≥ ``min_rows`` rows (:func:`check_min_rows`)."""
    mesh = mesh or get_mesh()
    n, r = mesh.size(), mesh.get_local_rank()

    def take(x):
        if x.ndim < 2 or x.shape[1] % n:
            raise AssertionError(f"H={x.shape[1]} must divide the {n}-way "
                                 "mesh")
        check_min_rows(x.shape[1], n, min_rows)
        k = x.shape[1] // n
        return x[:, r * k:(r + 1) * k]

    return type(arrays)(take(x) for x in arrays)


def _map_tensors(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return tree


def spatial_jit(fn, mesh: Mesh | None = None, n_array_args: int | None = None,
                min_rows: int = 4):
    """``call(params, *arrays)``: ``fn(params, *arrays)`` with every NHWC
    array argument (numpy or tensor, on every rank alike) cut to this
    rank's row slab and run in a :func:`spatial` block, every tensor of the
    output (a tensor, or tuples, lists and dicts of them) gathered whole
    on every rank. ``n_array_args``: how many arrays follow ``params`` (any
    number when None). H must divide the mesh and every array hold ≥
    ``min_rows`` rows a rank (:func:`check_min_rows`). ``fn`` may contain
    what the module's docstring lists; an op with no spatial rule raises
    ``NotImplementedError`` by name."""
    def call(params, *arrays):
        m = mesh or get_mesh()
        if m is None:
            raise RuntimeError("spatial_jit needs a process group: launch "
                               "the ranks with torchrun")
        if n_array_args is not None and len(arrays) != n_array_args:
            raise TypeError(f"expected {n_array_args} arrays, got "
                            f"{len(arrays)}")
        for a in arrays:
            if getattr(a, "ndim", 0) >= 2:
                check_min_rows(a.shape[1], m.size(), min_rows)
        slabs = [torch.as_tensor(a) for a in
                 shard_spatial(tuple(arrays), m, min_rows)]
        with spatial(m) as ctx:
            out = fn(params, *slabs)
            return _map_tensors(ctx.gather_rows, out)

    return call


def _run_slabs(net, params, arrays, kw, mesh, rows):
    """``net`` on this rank's slabs (``rows`` a rank) of the whole NHWC
    ``arrays`` in a :func:`spatial` block of that layout, under inference
    mode; the whole SR on every rank."""
    dev = next(net.parameters()).device
    r, h = mesh.get_local_rank(), arrays[0].shape[1]

    def take(t):
        # an input of another height (a depth map at its own size): the
        # same slabs scaled when it is a multiple of H, else equal ones
        f, n = t.shape[1] // h, mesh.size()
        if t.shape[1] == f * h:
            first, mine = f * sum(rows[:r]), f * rows[r]
        elif t.shape[1] % n == 0:
            first, mine = r * t.shape[1] // n, t.shape[1] // n
        else:
            raise AssertionError(f"an input of {t.shape[1]} rows beside a "
                                 f"{h}-row frame does not split into {n} "
                                 "slabs")
        return torch.as_tensor(t)[:, first:first + mine].to(dev)

    slabs = tuple(take(t) for t in arrays)
    args, kw = slabs[:3], {**kw, **({"pool_mask": slabs[3]}
                                    if len(slabs) > 3 else {})}
    with torch.inference_mode(), \
            spatial(mesh, rows, arrays[0].shape[2]) as ctx:
        if params is None:
            sr = net(*args, **kw)
        else:
            sr = torch.func.functional_call(net, params, args, kw)
        return ctx.gather_rows(sr)


def sharded_masked_forward(net, lq, depth_map, depth_mask, valid_hw,
                           pool_mask, mesh: Mesh | None = None, params=None):
    """DepthNet's masked forward (``valid_hw``, ``pool_mask``) of whole
    padded inputs [B, H, W, ·] (H a multiple of 4·N, W of 4; on every rank
    alike), this rank computing its row slab; returns the whole SR on
    every rank. ``params``: weights to run with instead of ``net``'s own
    (``torch.func.functional_call``)."""
    mesh = mesh or get_mesh()
    n = mesh.size()
    h = lq.shape[1]
    if h % (4 * n) or lq.shape[2] % 4:
        raise ValueError(f"the padded frame ({h}×{lq.shape[2]}) needs H a "
                         f"multiple of 4·{n} and W of 4")
    check_min_rows(h, n)
    return _run_slabs(net, params, (lq, depth_map, depth_mask, pool_mask),
                      {"valid_hw": valid_hw}, mesh, row_layout(h, n))


def spatial_forward(net, params, lq, depth_map, depth_mask,
                    mesh: Mesh | None = None):
    """H-sharded DepthNet forward over the mesh's ranks: JAX's
    ``net.apply(params, lq, depth_map, depth_mask)``, the unmasked forward,
    each rank computing its slab of rows (:func:`row_layout`). Every rank
    calls it with the same whole inputs (NHWC, host or device); H must be
    a multiple of the mesh size and ≥ 4 rows a rank (JAX's guards);
    nothing is padded. Returns the whole SR [B, s·H, s·W, 3] on every
    rank. ``params``: a ``state_dict`` to run with, or None for ``net``'s
    own weights."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError("spatial sharding needs a process group: launch "
                           "the ranks with torchrun")
    n, h = mesh.size(), lq.shape[1]
    if h % n:
        raise AssertionError(f"H={h} must divide the {n}-way mesh")
    check_min_rows(h, n)
    return _run_slabs(net, params, (lq, depth_map, depth_mask), {}, mesh,
                      row_layout(h, n))
