"""Spatial (image-height) sharding of DepthNet serving (counterpart of
``endosr/parallel/spatial.py``).

JAX shards H over its mesh and XLA's SPMD partitioner inserts the halo
exchanges, the sums behind InstanceNorm's statistics and the collectives
behind the region-wise pooling. The port has no partitioner, so it runs
the masked, bucketed forward (the one ``FModelDepthCond.test`` takes) on
one horizontal slab of rows a rank and makes those exchanges itself,
inside a :func:`spatial` block:

- every convolution of ``nn/layers.py`` (``conv2d_nhwc``: 3×3 stride 1,
  the stride-2 encoder convs, the 2×2 phase convs and the folded heads;
  ``_conv_transpose_nhwc``: the encoder's ``layer4``) first takes the rows
  its slab needs from its neighbours (:meth:`SpatialContext.halo`), zeros
  beyond the image, and convolves them without vertical padding, so each
  rank computes exactly its own output rows;
- the valid-region masks (``nn/layers.py::valid_mask``) are built in global
  row coordinates;
- the masked InstanceNorms add their sums and valid counts over the ranks,
  and the region-wise pooling its feature and mask sums, so the statistics
  and the [B,K,L] style matrix are the whole image's;
- the SR slabs are gathered, so every rank ends with the whole image.

Every level of the network keeps ``H / N`` rows a rank when the padded
height is a multiple of 4·N (``FModelDepthCond.test`` raises its bucket
to lcm(bucket, 4·N), as JAX does). The encoder's transposed ``layer4``
gives 2n − 1 rows; a slab computes 2·(its rows), and the extra last row
of the last slab is outside the valid region, which zeroes it before
``layer5`` reads it, as ``layer5``'s zero padding reads there unsharded.
The kernels of the masked path (``style_dot_hwbm``, ``output_stage``)
work row by row and run unchanged on a slab.

The exchanges are ``all_gather_into_tensor`` (halo rows, SR slabs) and
``all_reduce`` (sums), which NCCL and gloo carry for CUDA tensors alike
(gloo lets several ranks share one card; it cannot ``send`` / ``recv``
one, ``python3 chip_smoke.py --gloo-probe``).
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
import torch.distributed as dist

from endosr_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["spatial_jit", "shard_spatial", "spatial_forward", "spatial",
           "active", "SpatialContext", "check_min_rows"]

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


class SpatialContext:
    """This rank's place among the ``n`` row slabs of the mesh's group and
    the exchanges between them."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.group = mesh.get_group()
        self.rank = mesh.get_local_rank()
        self.n = mesh.size()

    def offset(self, rows: int) -> int:
        """The global index of this slab's first row, at a level where a
        slab holds ``rows`` rows."""
        return self.rank * rows

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
        if top > h or bottom > h:
            raise ValueError(f"a halo of {top}/{bottom} rows exceeds the "
                             f"{h}-row slab: the frame is too small for "
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
        ``pt``/``pb``) needs for this slab's output rows, for a conv run
        with no vertical padding. The output must have H / stride rows and
        the slab must start at a multiple of the stride."""
        h = x.shape[1]
        if h % stride or (h * self.n + pt + pb - kh) // stride + 1 \
                != h * self.n // stride:
            raise ValueError(
                f"a {kh}-row conv of stride {stride} with pads ({pt}, {pb}) "
                f"does not keep {h}-row slabs aligned")
        bottom = kh - stride - pt
        x = self.halo(x, pt, max(bottom, 0))
        return x if bottom >= 0 else x[:, :x.shape[1] + bottom]

    def conv_transpose_rows(self, x, k: int, stride: int, padding: int,
                            conv):
        """A transposed conv's output rows for this slab, ``stride`` × its
        rows (the full image's output taken as H·stride rows): ``conv``
        (the transposed conv with its padding) runs on the slab and the
        input rows below it that reach its last output rows."""
        h = x.shape[1]
        # output row o reads input rows i with o = i·stride − padding + t,
        # 0 ≤ t < k: this slab's outputs read from `top` rows above it to
        # `bottom` rows below it
        top = (k - 1 - padding) // stride
        bottom = 1 + (padding - 1) // stride
        y = conv(self.halo(x, top, bottom))
        return y[:, top * stride:top * stride + h * stride]

    def gather_rows(self, y):
        """The whole image from every rank's slab ``y`` [B, h, ...] (rows
        stacked in rank order), on every rank."""
        return torch.cat(list(self._gather(y)), dim=1)


@contextlib.contextmanager
def spatial(mesh: Mesh | None = None):
    """Run the block's DepthNet forwards on this rank's row slab (see the
    module's docstring); yields the :class:`SpatialContext`."""
    mesh = mesh or get_mesh()
    if mesh is None:
        raise RuntimeError("spatial sharding needs a process group: launch "
                           "the ranks with torchrun")
    if active() is not None:
        raise RuntimeError("spatial blocks do not nest")
    token = _ACTIVE.set(SpatialContext(mesh))
    try:
        yield active()
    finally:
        _ACTIVE.reset(token)


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


def spatial_jit(*args, **kwargs):
    """JAX's ``spatial_jit`` partitions any function through XLA's SPMD
    partitioner; the port has none. DepthNet's masked forward is sharded
    by :func:`spatial_forward` and ``FModelDepthCond.test``."""
    raise NotImplementedError(
        "spatial_jit is not ported: the port has no SPMD partitioner; "
        "DepthNet serves H-sharded through spatial_forward or "
        "FModelDepthCond.test with spatial_shard")


def _to_host(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


@torch.inference_mode()
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
    dev = next(net.parameters()).device
    slabs = [torch.as_tensor(t).to(dev) for t in
             shard_spatial((lq, depth_map, depth_mask, pool_mask), mesh,
                           min_rows=1)]
    args = (*slabs[:3],)
    kw = {"valid_hw": valid_hw, "pool_mask": slabs[3]}
    with spatial(mesh) as ctx:
        if params is None:
            sr = net(*args, **kw)
        else:
            sr = torch.func.functional_call(net, params, args, kw)
        return ctx.gather_rows(sr)


def spatial_forward(net, params, lq, depth_map, depth_mask,
                    mesh: Mesh | None = None):
    """H-sharded DepthNet forward over the mesh's ranks (every rank calls
    it with the same whole inputs, NHWC, host or device); returns the
    whole SR [B, s·H, s·W, 3] on every rank. ``params``: a ``state_dict``
    to run with, or None for ``net``'s own weights.

    JAX runs the unmasked forward through its partitioner; the port runs
    the masked program with ``valid_hw = (H, W)``, which the repo holds to
    the same bar: the frame is zero-padded to H a multiple of 4·N and W of
    4, and the output cropped back."""
    mesh = mesh or get_mesh()
    n = mesh.size()
    b, h, w = lq.shape[0], lq.shape[1], lq.shape[2]
    check_min_rows(h, n)
    from endosr_torch.ops.masks import pool_mask_np

    hb, wb = -(-h // (4 * n)) * (4 * n), -(-w // 4) * 4
    pad = ((0, 0), (0, hb - h), (0, wb - w), (0, 0))
    lq_p, d_p, m_p = (np.pad(_to_host(x), pad)
                      for x in (lq, depth_map, depth_mask))
    v3h, v3w = ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2
    pm = pool_mask_np(_to_host(depth_mask), (v3h, v3w), (hb // 4, wb // 4))
    sr = sharded_masked_forward(net, lq_p, d_p, m_p, (h, w), pm, mesh, params)
    s = sr.shape[1] // hb
    return sr[:, :h * s, :w * s]
