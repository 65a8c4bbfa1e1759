"""Group style dots of the SEAN depth-matrix branch.

``style_dot_hwbm`` ports ``endosr/kernels/style_dot.py::style_dot_hwbm``
(TPU kernel ``pallas_call`` at ``:111``, twin ``style_dot_reference`` at
``:48``): out[h,w,b,m] = Σ_j shifted[b,h,w,j]·v[b,j,m], fp32 accumulation,
one rounding to the storage type. It serves the masked (bucketed) forward,
where the blend below cannot run. [H,W,B,M] is only the index order of the
returned view: the bytes are a BHWC tensor, so per-instance channel slices
are BHWC views. It is bound by the bytes of that map (470 MB at M = 1792,
0.14 ms at the H100's 3.35 TB/s). ``endosr_torch/csrc/style_dot.cu`` holds
two hand-written kernels for it and :func:`style_dot_route` picks one by
shape, never by trial:

- ``"tc"``: bf16, J even and ≤ 96, M a multiple of 8 (any H·W, any B).
  ``style_dot_tc``: 128 pixels a block held as ``mma`` fragments in
  registers over all of M, v in 128-channel slices through a two-buffer
  ``cp.async`` ring, the product on the tensor cores, and the map written
  as 16-byte pieces from a per-warp staging tile.
- ``"cuda_core"``: everything else, float32 (exact) included: the K = 90
  dot in fp32 on the CUDA cores, 64 pixels × 64 channels a block.

``style_dot_hwbm.launches`` counts launches, ``style_dot_hwbm.routes``
counts them per route.

``style_blend_dot`` ports ``style_blend_dot`` of the same file (TPU kernel
``pallas_call`` at ``:284``, twin ``style_blend_reference`` at ``:197``):

    out[h,w,b,m] = (Σ_j shifted[b,h,w,j]·v[b,j,m]) + concat(convs)[h,w,b,m] + bias[m]

with the dot rounded to the storage type before the adds. The N conv
outputs are read in place through a device table of pointers, so no
concatenated copy (≈470 MB per flagship launch) is made. It is bound by
memory (≈0.96 GB per M=1792 launch, ≈0.29 ms at 3.35 TB/s). Two kernels,
picked by :func:`style_blend_route`:

- ``"tc"``: bf16, J even and ≤ 96, M and c2 multiples of 8, the convs'
  strides multiples of 8 with contiguous channels, and 16-byte aligned
  bases. ``style_blend_tc``: ``style_dot_tc``'s main loop with an epilogue
  that adds the conv slice (16-byte loads issued before the tile's product)
  and the bias, and stores 16 bytes.
- ``"cuda_core"``: everything else, float32 (exact) included: the CUDA-core
  dot with the adds in its scalar epilogue.

``style_blend_dot.launches`` counts launches, ``style_blend_dot.routes``
counts them per route. ``hwbc=True`` (``:197-272``; no JAX path passes it,
JAX's kernel tests do) takes ``shifted`` as [H,W,B,J], the mask-conv
producer's order: both kernels read its pixel rows through that layout's
strides (images J apart, pixels B·J apart), so no [B,H,W,J] copy is made,
and the result is exactly the [B,H,W,J] one's. Its launches count as routes
``"tc_hwbc"`` / ``"cuda_core_hwbc"``.
"""

from __future__ import annotations

import torch

from endosr_torch.kernels import _build
from endosr_torch.kernels._autograd import differentiable

__all__ = ["style_blend_dot", "style_blend_plain", "style_blend_route",
           "style_blend_vjp", "style_dot_hwbm", "style_dot_plain",
           "style_dot_route", "style_dot_vjp",
           "launch_blend_cuda_core", "launch_blend_tc", "launch_cuda_core",
           "launch_tc"]


def style_blend_plain(shifted, v, convs, bias, hwbc=False):
    """Plain PyTorch version: shifted [B,H,W,J] (``hwbc``: [H,W,B,J]), v
    [B,J,M], convs tuple of [H,W,B,2C] tensors with Σ2C = M, bias [M] →
    [H,W,B,M]."""
    if hwbc:
        shifted = shifted.permute(2, 0, 1, 3)
    dt = shifted.dtype
    y = torch.einsum("bhwj,bjm->bhwm", shifted, v).permute(1, 2, 0, 3).to(dt)
    return (y + torch.cat(list(convs), dim=-1)) + bias.to(dt)


def style_blend_route(dtype, j, m, c2, strides, aligned):
    """Which kernel a CUDA call of ``style_blend_dot`` takes: ``"tc"`` or
    ``"cuda_core"``. ``strides``: the convs' element strides (h, w, b,
    channel); ``aligned``: every conv's base is 16-byte aligned (the
    wrapper allocates the output aligned)."""
    if (dtype == torch.bfloat16 and j <= 96 and j % 2 == 0 and m % 8 == 0
            and c2 % 8 == 0 and strides[3] == 1
            and all(s % 8 == 0 for s in strides[:3]) and aligned):
        return "tc"
    return "cuda_core"


def _blend_operands(shifted, v, convs, bias, hwbc=False):
    """Checked, contiguous operands: (shifted, its image and pixel
    strides, v, the convs' device pointer table, their strides, c2, fp32
    bias, the [B,H,W,M] output buffer). ``hwbc``: shifted is [H,W,B,J]."""
    h, w, b, j = shifted.shape if hwbc else (
        shifted.shape[1], shifted.shape[2], shifted.shape[0], shifted.shape[3])
    m = v.shape[2]
    n = len(convs)
    c2 = convs[0].shape[3]
    if n * c2 != m or any(c.shape != (h, w, b, c2) for c in convs):
        raise ValueError(f"convs must be {n} × [{h},{w},{b},{c2}] with "
                         f"{n}·{c2} = M = {m}")
    st = convs[0].stride()
    if st[3] != 1 or any(c.stride() != st for c in convs):
        raise ValueError("convs must share strides with contiguous channels")
    dt, dev = shifted.dtype, shifted.device
    if v.dtype != dt or any(c.dtype != dt for c in convs):
        raise TypeError("shifted, v and convs must share one dtype")
    sh, vv = shifted.contiguous(), v.contiguous()
    sh = sh.clone() if sh.data_ptr() % 16 else sh
    vv = vv.clone() if vv.data_ptr() % 16 else vv
    bias32 = bias.float().contiguous()
    bias32 = bias32.clone() if bias32.data_ptr() % 16 else bias32
    # pinned + non_blocking: the host does not wait for the device's queue
    table = torch.tensor([c.data_ptr() for c in convs],
                         dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    out = torch.empty((b, h, w, m), dtype=dt, device=dev)
    ssb, ssp = (j, b * j) if hwbc else (h * w * j, j)
    return sh, (ssb, ssp), vv, table, st, c2, bias32, out


def launch_blend_cuda_core(shifted, v, convs, bias, hwbc=False):
    """Launch the CUDA-core blend (route ``"cuda_core"``) on CUDA operands
    → [B,H,W,M]; counts nothing."""
    fn = _build.load("style_dot")
    sh, (ssb, ssp), vv, table, st, c2, bias32, out = _blend_operands(
        shifted, v, convs, bias, hwbc)
    b, h, w, m = out.shape
    code = fn(_build.dtype_code(shifted.dtype), sh.data_ptr(), ssb, ssp,
              vv.data_ptr(), table.data_ptr(), st[0], st[1], st[2], c2,
              bias32.data_ptr(), out.data_ptr(), out.stride(1), out.stride(2),
              out.stride(0), b, h, w, shifted.shape[3], m,
              _build.stream_ptr(shifted.device))
    _build.check("style_dot", code)
    return out


def launch_blend_tc(shifted, v, convs, bias, hwbc=False):
    """Launch the tensor-core blend (route ``"tc"``) on CUDA operands →
    [B,H,W,M]; counts nothing."""
    fn = _build.load("style_dot", "style_blend_tc")
    sh, (ssb, ssp), vv, table, st, c2, bias32, out = _blend_operands(
        shifted, v, convs, bias, hwbc)
    b, h, w, m = out.shape
    code = fn(sh.data_ptr(), ssb, ssp, vv.data_ptr(), table.data_ptr(), st[0],
              st[1], st[2], c2, bias32.data_ptr(), out.data_ptr(), b, h, w,
              shifted.shape[3], m, _build.stream_ptr(shifted.device))
    _build.check("style_dot", code, "style_blend_tc")
    return out


def style_dot_vjp(shifted, v, g):
    """The backward of the group style dot (the JAX ``_bwd``,
    ``style_dot.py:137-142``): g [H,W,B,M] → (g_shifted, g_v), each
    product in its operands' promoted type, then cast to its input's
    type."""
    gt = g.permute(2, 0, 1, 3)
    ct = torch.promote_types(g.dtype, v.dtype)
    gs = torch.einsum("bhwm,bjm->bhwj", gt.to(ct), v.to(ct))
    ct = torch.promote_types(shifted.dtype, g.dtype)
    gv = torch.einsum("bhwj,bhwm->bjm", shifted.to(ct), gt.to(ct))
    return gs.to(shifted.dtype), gv.to(v.dtype)


def style_blend_vjp(shifted, v, n_conv, conv_dtype, bias_dtype, g,
                    hwbc=False):
    """The backward of :func:`style_blend_dot` (the JAX ``_blend_bwd``,
    ``style_dot.py:306-320``): the dot's two gradients as in
    :func:`style_dot_vjp` (with ``hwbc``, on the [B,H,W,J] view, g_shifted
    given back as [H,W,B,J]), each conv's gradient its channel slice of g
    (in the convs' type), the bias's g summed in fp32 (in the bias's
    type). Returns (g_shifted, g_v, (g_conv, ...), g_bias)."""
    gs, gv = style_dot_vjp(shifted.permute(2, 0, 1, 3) if hwbc else shifted,
                           v, g)
    if hwbc:
        gs = gs.permute(1, 2, 0, 3)
    c2 = g.shape[3] // n_conv
    gconvs = tuple(g[..., i * c2:(i + 1) * c2].to(conv_dtype)
                   for i in range(n_conv))
    gbias = g.float().sum(dim=(0, 1, 2)).to(bias_dtype)
    return gs, gv, gconvs, gbias


def style_blend_dot(shifted, v, convs, bias, hwbc=False):
    """Group style dot + conv adds + bias → [H, W, B, M] (the HWNC view of
    a BHWC tensor, so per-instance channel slices are BHWC views).
    ``hwbc``: ``shifted`` is [H,W,B,J] in place of [B,H,W,J].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`style_blend_route` names (and raises if it cannot).
    Under autograd the backward is :func:`style_blend_vjp`, which keeps
    only ``shifted`` and ``v``."""
    n = len(convs)
    cdt, bdt = convs[0].dtype, bias.dtype

    def vjp(saved, g):
        gs, gv, gconvs, gbias = style_blend_vjp(saved[0], saved[1], n, cdt,
                                                bdt, g, hwbc)
        return (gs, gv, *gconvs, gbias)

    return differentiable(
        lambda s, vv, *rest: _blend(s, vv, rest[:-1], rest[-1], hwbc), vjp,
        (shifted, v, *convs, bias), save=(True, True) + (False,) * (n + 1))


def _blend(shifted, v, convs, bias, hwbc=False):
    if shifted.device.type == "cpu":
        return style_blend_plain(shifted, v, convs, bias, hwbc)
    aligned = all(c.data_ptr() % 16 == 0 for c in convs)
    route = style_blend_route(shifted.dtype, shifted.shape[3], v.shape[2],
                              convs[0].shape[3], convs[0].stride(), aligned)
    launch = launch_blend_tc if route == "tc" else launch_blend_cuda_core
    out = launch(shifted, v, convs, bias, hwbc)
    style_blend_dot.launches += 1
    style_blend_dot.routes[route + "_hwbc" if hwbc else route] += 1
    return out.permute(1, 2, 0, 3)


style_blend_dot.launches = 0
style_blend_dot.routes = {"tc": 0, "cuda_core": 0, "tc_hwbc": 0,
                          "cuda_core_hwbc": 0}


def style_dot_plain(shifted, v):
    """Plain PyTorch version: [B,H,W,J] × [B,J,M] → [H,W,B,M]."""
    return torch.einsum("bhwj,bjm->bhwm", shifted, v).permute(1, 2, 0, 3)


def style_dot_route(dtype, j, m):
    """Which kernel a CUDA call of ``style_dot_hwbm`` takes: ``"tc"`` or
    ``"cuda_core"``."""
    if dtype == torch.bfloat16 and j <= 96 and j % 2 == 0 and m % 8 == 0:
        return "tc"
    return "cuda_core"


def _operands(shifted, v):
    """Contiguous, 16-byte aligned operands and the output buffer."""
    b, h, w, _ = shifted.shape
    sh, vv = shifted.contiguous(), v.contiguous()
    sh = sh.clone() if sh.data_ptr() % 16 else sh
    vv = vv.clone() if vv.data_ptr() % 16 else vv
    out = torch.empty((b, h, w, v.shape[2]), dtype=shifted.dtype,
                      device=shifted.device)
    return sh, vv, out


def launch_cuda_core(shifted, v):
    """Launch the CUDA-core dot (route ``"cuda_core"``) on CUDA operands →
    [B,H,W,M]; counts nothing."""
    fn = _build.load("style_dot", "style_dot_hwbm")
    b, h, w, j = shifted.shape
    sh, vv, out = _operands(shifted, v)
    code = fn(_build.dtype_code(shifted.dtype), sh.data_ptr(), vv.data_ptr(),
              out.data_ptr(), out.stride(1), out.stride(2), out.stride(0),
              b, h, w, j, v.shape[2], _build.stream_ptr(shifted.device))
    _build.check("style_dot", code, "style_dot_hwbm")
    return out


def launch_tc(shifted, v):
    """Launch the tensor-core dot (route ``"tc"``) on CUDA operands →
    [B,H,W,M]; counts nothing."""
    fn = _build.load("style_dot", "style_dot_tc")
    b, h, w, j = shifted.shape
    sh, vv, out = _operands(shifted, v)
    code = fn(sh.data_ptr(), vv.data_ptr(), out.data_ptr(), b, h * w, j,
              v.shape[2], _build.stream_ptr(shifted.device))
    _build.check("style_dot", code, "style_dot_tc")
    return out


def style_dot_hwbm(shifted, v):
    """Group style dot [B,H,W,J] × [B,J,M] → [H, W, B, M] (the HWNC view
    of a BHWC tensor), any B and M.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel :func:`style_dot_route` names (and raises if it cannot).
    Under autograd the backward is :func:`style_dot_vjp`."""
    return differentiable(_dot, lambda saved, g: style_dot_vjp(*saved, g),
                          (shifted, v))


def _dot(shifted, v):
    if shifted.device.type == "cpu":
        return style_dot_plain(shifted, v)
    b, _, _, j = shifted.shape
    if v.shape[:2] != (b, j):
        raise ValueError(f"v must be [{b},{j},M], got {tuple(v.shape)}")
    if v.dtype != shifted.dtype:
        raise TypeError("shifted and v must share one dtype")
    route = style_dot_route(shifted.dtype, j, v.shape[2])
    out = (launch_tc if route == "tc" else launch_cuda_core)(shifted, v)
    style_dot_hwbm.launches += 1
    style_dot_hwbm.routes[route] += 1
    return out.permute(1, 2, 0, 3)


style_dot_hwbm.launches = 0
style_dot_hwbm.routes = {"tc": 0, "cuda_core": 0}
