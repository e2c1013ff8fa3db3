"""The corr-lookup kernels: K1 (tent), K7 (shift), K8 (bdiag) and K1b, the
backward they share (csrc/corr_lookup*.cu).

Ports of scflow_tpu/ops/pallas/corr_lookup.py::corr_lookup_pallas_flat
(its three variants) and of `_lookup_bwd`, the backward that
`corr_lookup_pallas_diff` pairs with them.  `corr_lookup_flat` and
`corr_lookup_flat_bwd` call the torch.library custom ops
`scflow::corr_lookup` and `scflow::corr_lookup_bwd`, whose bodies launch a
CUDA kernel for CUDA tensors and run the plain version for CPU tensors;
there is no other route.  The forward op's registered autograd is K1b (the
coords' gradient only where they need one), and each op's fake body gives
the output's shape and dtype from the inputs' (what torch.export traces),
with the launch's checks that read no data.  Each variant keeps
its own plain version: 'shift' its one-hot-rows-then-blend formulation,
'tent' and 'bdiag' the tent formulation, which the TPU's bdiag kernel
computes as well (same weights, same sums, another matmul layout).

Maps are float32 or bfloat16 (the JAX package's dtype=bf16 pyramid), each
kernel built for both: a bf16 map launches the bf16 instance, which upcasts
each cell exactly to float32 and computes as the float32 one, as the Pallas
kernels read `m_ref[...].astype(float32)`.  Window centres, the output and
its gradient stay float32; K1b's level gradients come back in the map's
dtype, summed in float32 and rounded once (`_lookup_bwd`'s
`.astype(corr.dtype)`).  Each instance counts its own launches, so a bf16
map that reached a float32 kernel would show.
"""

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from scflow_tpu_torch.ops.cuda.build import CudaKernel, build_all, library_path

VARIANTS = ("tent", "shift", "bdiag")
MAP_DTYPES = (torch.float32, torch.bfloat16)
ROUTES = ("window", "generic")  # the launch routes (csrc/corr_common.cuh)
# coords, the maps' and sizes' host arrays, num_levels, radius, rows, out
_LOOKUP_ARGS = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
# coords, grad_out, the maps', sizes' and level grads' host arrays,
# num_levels, radius, rows, the coords grad (None: not wanted)
_BWD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
             ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
# float32 maps
KERNEL = CudaKernel("corr_lookup.cu", "corr_lookup_launch", _LOOKUP_ARGS)
SHIFT_KERNEL = CudaKernel("corr_lookup_shift.cu", "corr_lookup_shift_launch", _LOOKUP_ARGS)
BDIAG_KERNEL = CudaKernel("corr_lookup_bdiag.cu", "corr_lookup_bdiag_launch", _LOOKUP_ARGS)
BWD_KERNEL = CudaKernel("corr_lookup_bwd.cu", "corr_lookup_bwd_launch", _BWD_ARGS)
# bfloat16 maps: the same sources' bf16 instances
KERNEL_BF16 = CudaKernel("corr_lookup.cu", "corr_lookup_bf16_launch", _LOOKUP_ARGS)
SHIFT_KERNEL_BF16 = CudaKernel("corr_lookup_shift.cu", "corr_lookup_shift_bf16_launch",
                               _LOOKUP_ARGS)
BDIAG_KERNEL_BF16 = CudaKernel("corr_lookup_bdiag.cu", "corr_lookup_bdiag_bf16_launch",
                               _LOOKUP_ARGS)
BWD_KERNEL_BF16 = CudaKernel("corr_lookup_bwd.cu", "corr_lookup_bwd_bf16_launch", _BWD_ARGS)
FORWARD_KERNELS = {"tent": KERNEL, "shift": SHIFT_KERNEL, "bdiag": BDIAG_KERNEL}
FORWARD_KERNELS_BF16 = {"tent": KERNEL_BF16, "shift": SHIFT_KERNEL_BF16,
                        "bdiag": BDIAG_KERNEL_BF16}


def forward_kernel(variant: str, dtype: torch.dtype = torch.float32) -> CudaKernel:
    """The kernel a lookup of `variant` on maps of `dtype` launches."""
    return (FORWARD_KERNELS_BF16 if dtype == torch.bfloat16 else FORWARD_KERNELS)[variant]


def bwd_kernel(dtype: torch.dtype = torch.float32) -> CudaKernel:
    """The K1b instance for maps of `dtype`."""
    return BWD_KERNEL_BF16 if dtype == torch.bfloat16 else BWD_KERNEL


def _layout(source: str, symbol: str, *args) -> dict:
    """Calls a layout function of a built library: (args..., route, kernel
    launches per call, rows per group, largest templated radius, threads,
    dynamic shared memory) -> dict; raises RuntimeError with the CUDA error
    for a window the launch refuses."""
    build_all()
    fn = getattr(ctypes.CDLL(str(library_path(source))), symbol)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    ints = [ctypes.c_int() for _ in range(5)]
    smem = ctypes.c_longlong()
    err = fn(*args, *map(ctypes.byref, ints), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"{symbol}{args}: CUDA error {err}")
    route, launches, rows, max_radius, threads = (i.value for i in ints)
    return {"route": ROUTES[route], "launches": launches, "rows_per_group": rows,
            "max_radius": max_radius, "threads": threads, "smem_bytes": smem.value}


def window_layout(variant: str, num_levels: int, radius: int,
                  dtype: torch.dtype = torch.float32) -> dict:
    """How K1 ('tent'), K7 ('shift') or K8 ('bdiag') launches at (num_levels,
    radius) on maps of `dtype`, read from its built library
    (csrc/corr_common.cuh): the route ('window': the templated pipeline,
    one launch, where the radius is at most max_radius, the levels at most
    four and its two ring stages fit a block's shared memory; 'generic': the
    run-time-radius kernel, one launch per four levels), `launches` (kernel
    launches a call), rows_per_group, threads per block and smem_bytes of
    dynamic shared memory per block.  Builds the kernels (needs nvcc);
    raises RuntimeError for no levels or a negative radius."""
    return _layout(FORWARD_KERNELS[variant].source, f"corr_lookup_{variant}_layout",
                   num_levels, radius, int(dtype == torch.bfloat16))


def bwd_layout(num_levels: int, radius: int, want_coords: bool,
               dtype: torch.dtype = torch.float32) -> dict:
    """As window_layout, for K1b (csrc/corr_lookup_bwd.cu) with or without
    the flow gradient."""
    return _layout(BWD_KERNEL.source, "corr_lookup_bwd_layout", num_levels, radius,
                   int(want_coords), int(dtype == torch.bfloat16))


def check_variant(variant: str) -> str:
    if variant not in VARIANTS:
        raise ValueError(f"unknown lookup variant {variant!r}; expected one of {VARIANTS}")
    return variant


def check_window(variant: str, num_levels: int, radius: int) -> None:
    """Raise for a lookup no kernel takes: a negative radius or no levels.
    Every other window launches (the templated pipeline, or the generic
    kernel: window_layout)."""
    check_variant(variant)
    if radius < 0:
        raise ValueError(f"the lookup radius must be >= 0, not {radius}")
    if num_levels < 1:
        raise ValueError(f"the lookup needs at least one level, not {num_levels}")


def _level_sizes(pyramid: Sequence[torch.Tensor], rows: int):
    sizes = []
    for m in pyramid:
        s = math.isqrt(m.shape[1]) if m.dim() == 2 else -1
        if m.dim() != 2 or m.shape[0] != rows or s * s != m.shape[1]:
            raise ValueError(f"flat pyramid level must be ({rows}, S*S), got "
                             f"{tuple(m.shape)}")
        sizes.append(s)
    return sizes


def _upcast(m: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """A level's cells in the coordinates' float type (float32; float64 in
    float64 checks): a bfloat16 map's cells exactly, as the kernels read
    them."""
    return m.to(torch.promote_types(m.dtype, coords.dtype))


def _tent(u: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(u), min=0.0)


def _tent_weights(p: torch.Tensor, s: int, radius: int, tent=_tent) -> torch.Tensor:
    """(B,) level coordinate -> (B, k, s) weights tent((p + off) - cell)."""
    offs = torch.arange(-radius, radius + 1, dtype=p.dtype, device=p.device)
    grid = torch.arange(s, dtype=p.dtype, device=p.device)
    return tent(p[:, None, None] + offs[None, :, None] - grid[None, None, :])


def corr_lookup_flat_plain(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                           radius: int = 4, tent=_tent, round_weights: bool = False,
                           shapes: Optional[Sequence[Tuple[int, int]]] = None
                           ) -> torch.Tensor:
    """The tent formulation of scflow_tpu/ops/corr.py::corr_lookup on flat
    levels: out[b, j*k + i] = sum_{h,w} wy[b,i,h] wx[b,j,w] m[b,h,w] with
    wx[b,j,w] = tent(x_b / 2^l + j - r - w), j offsetting x, in float32 on
    the map's cells upcast exactly (a bf16 map's cells as the Pallas kernel
    reads them).  `tent` is max(0, 1 - |u|); ops/corr.py passes one with
    JAX's subgradients.  round_weights rounds the weights to the map's dtype
    first, as the JAX package's XLA lookup does (ops/corr.py::corr_lookup:
    `wy.astype(m.dtype)`); a no-op on float32 maps.  shapes: each level's
    (rows, cols), for maps that are not square (the kernels' levels are
    S x S, which None means)."""
    b = coords.shape[0]
    k = 2 * radius + 1
    if shapes is None:
        shapes = [(s, s) for s in _level_sizes(pyramid, b)]
    outs = []
    for lvl, (m, (sh, sw)) in enumerate(zip(pyramid, shapes)):
        wx = _tent_weights(coords[:, 0] / 2.0**lvl, sw, radius, tent)
        wy = _tent_weights(coords[:, 1] / 2.0**lvl, sh, radius, tent)
        if round_weights:
            wx, wy = (w.to(m.dtype).to(w.dtype) for w in (wx, wy))
        tmp = torch.bmm(wy, _upcast(m, coords).reshape(b, sh, sw))  # (B, i, w)
        out = torch.bmm(wx, tmp.transpose(1, 2))  # (B, j, i)
        outs.append(out.reshape(b, k * k))
    return torch.cat(outs, dim=-1)


def _window_cells(m: torch.Tensor, s: int, x0: torch.Tensor, y0: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """(B, k+1, k+1): m[b, y0 - r + d, x0 - r + e], zeros outside the map."""
    k1 = 2 * radius + 2
    steps = torch.arange(k1, dtype=x0.dtype, device=x0.device) - radius
    ys = y0[:, None] + steps  # (B, k+1)
    xs = x0[:, None] + steps
    iny = (ys >= 0) & (ys <= s - 1)
    inx = (xs >= 0) & (xs <= s - 1)
    yi = torch.where(iny, ys, 0).long()
    xi = torch.where(inx, xs, 0).long()
    cells = torch.gather(m, 1, (yi[:, :, None] * s + xi[:, None, :]).reshape(m.shape[0], -1))
    cells = cells.reshape(-1, k1, k1)
    return torch.where(iny[:, :, None] & inx[:, None, :], cells, torch.zeros_like(cells))


def corr_lookup_flat_shift_plain(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                                 radius: int = 4) -> torch.Tensor:
    """The shift formulation of the TPU's `_kernel_shift`: the window's k+1
    integer rows V[d] = m[y0 - r + d] (zeros outside; the TPU's one-hot
    picks are exact), blended T[i] = (1 - fy) V[i] + fy V[i + 1], then the
    same over columns, with x0 = floor(x), fx = x - x0."""
    b = coords.shape[0]
    k = 2 * radius + 1
    outs = []
    for lvl, (m, s) in enumerate(zip(pyramid, _level_sizes(pyramid, b))):
        px = coords[:, 0] / 2.0**lvl
        py = coords[:, 1] / 2.0**lvl
        x0, y0 = torch.floor(px), torch.floor(py)
        fx, fy = (px - x0)[:, None, None], (py - y0)[:, None, None]
        v = _window_cells(_upcast(m, coords), s, x0, y0, radius)  # (B, d, e)
        tmp = (1.0 - fy) * v[:, :-1] + fy * v[:, 1:]  # (B, i, e)
        out = (1.0 - fx) * tmp[:, :, :-1] + fx * tmp[:, :, 1:]  # (B, i, j)
        outs.append(out.transpose(1, 2).reshape(b, k * k))
    return torch.cat(outs, dim=-1)


PLAIN = {"tent": corr_lookup_flat_plain, "shift": corr_lookup_flat_shift_plain,
         "bdiag": corr_lookup_flat_plain}


def _check_inputs(pyramid, coords, extra=()):
    """The level sizes of a kernel launch; raises unless coords and `extra`
    are contiguous float32, the levels contiguous and all float32 or all
    bfloat16, on one device.  Reads shapes, dtypes and devices only, so the
    ops' fake bodies run it too; `_check_aligned` is the launch's check of
    the data pointers."""
    b = coords.shape[0]
    if coords.shape != (b, 2):
        raise ValueError(f"coords must be (B, 2), got {tuple(coords.shape)}")
    if not pyramid:
        raise ValueError("the lookup needs at least one pyramid level")
    sizes = _level_sizes(pyramid, b)
    for t in (coords, *pyramid, *extra):
        if t.device != coords.device or not t.is_contiguous():
            raise ValueError("the corr-lookup kernels need contiguous tensors on one device")
    if any(t.dtype != torch.float32 for t in (coords, *extra)):
        raise ValueError("the corr-lookup kernels need float32 coords and gradients")
    dtype = pyramid[0].dtype
    if dtype not in MAP_DTYPES or any(m.dtype != dtype for m in pyramid):
        raise ValueError(f"the levels must all be float32 or all bfloat16, got "
                         f"{[m.dtype for m in pyramid]}")
    return sizes


def _check_aligned(pyramid):
    """bfloat16 levels must start on 4-byte boundaries (the kernels read
    cell pairs)."""
    if pyramid[0].dtype == torch.bfloat16 and any(m.data_ptr() % 4 for m in pyramid):
        raise ValueError("bfloat16 levels must start on a 4-byte boundary")


def _check_op(pyramid, coords, radius: int, variant: str, extra=()):
    """The checks of a lookup op that need only shapes, dtypes and devices;
    returns the level sizes.  A CUDA tensor gets the launch's
    (`_check_inputs`); a CPU one the plain version's level rule.  The fake
    bodies add `check_window`, so that an export of a window no kernel
    takes stops at the trace; on the card the launch refuses it."""
    check_variant(variant)
    if coords.device.type == "cpu":
        return _level_sizes(pyramid, coords.shape[0])
    if coords.device.type != "cuda":
        raise ValueError(f"unsupported device {coords.device}")
    return _check_inputs(pyramid, coords, extra)


def _check_fake(pyramid, coords, radius: int, variant: str, extra=()):
    _check_op(pyramid, coords, radius, variant, extra)
    if coords.device.type == "cuda":
        check_window(variant, len(pyramid), radius)


def corr_lookup_flat(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                     radius: int = 4, variant: str = "tent") -> torch.Tensor:
    """pyramid: level l is (B, S_l*S_l), float32 or bfloat16 (every level
    alike); coords: (B, 2) float32 window centres (x, y) at level 0.
    Returns (B, L*(2r+1)^2) float32, level-major, tap index j*(2r+1) + i
    with j offsetting x.  variant picks the kernel: 'tent' K1, 'shift' K7,
    'bdiag' K8, each in the instance of the maps' dtype, at any level count
    and radius >= 0 (`window_layout` says which route and how many kernel
    launches; a negative radius raises RuntimeError from the launch).
    Calls the custom op `scflow::corr_lookup`, whose registered backward is
    K1b."""
    return torch.ops.scflow.corr_lookup(list(pyramid), coords, radius, variant)


@torch.library.custom_op("scflow::corr_lookup", mutates_args=())
def _corr_lookup_op(levels: List[torch.Tensor], coords: torch.Tensor, radius: int,
                    variant: str) -> torch.Tensor:
    """K1, K7 or K8 on CUDA tensors, the variant's plain version on CPU ones."""
    sizes = _check_op(levels, coords, radius, variant)
    if coords.device.type == "cpu":
        return PLAIN[variant](levels, coords, radius)
    _check_aligned(levels)
    b = coords.shape[0]
    k = 2 * radius + 1
    out = torch.empty((b, len(levels) * k * k), dtype=torch.float32, device=coords.device)
    if b == 0:
        return out
    kernel = forward_kernel(variant, levels[0].dtype)
    kernel.launch(coords.device, coords.data_ptr(), _pointers(levels), _ints(sizes), len(levels),
                  radius, b, out.data_ptr())
    return out


def _pointers(tensors) -> ctypes.Array:
    """The data pointers of `tensors` as a host array (the launch reads it
    before it returns)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


@_corr_lookup_op.register_fake
def _(levels, coords, radius, variant):
    _check_fake(levels, coords, radius, variant)
    k = 2 * radius + 1
    return coords.new_empty((coords.shape[0], len(levels) * k * k),
                            dtype=torch.promote_types(levels[0].dtype, coords.dtype))


def corr_lookup_flat_bwd_plain(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                               grad_out: torch.Tensor, radius: int = 4,
                               want_coords: bool = True
                               ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """`_lookup_bwd` in tensor code: grad_m[h,w] = sum_i wy[i,h] sum_j
    g[j,i] wx[j,w]; d/dcx = sum_l 2^-l sum g[j,i] dwx[j,w] t2[i,w] with
    t2 = wy m and dwx = -sign(ux) where |ux| < 1 (0 at the kinks), likewise
    d/dcy, in float32 on the cells upcast; the level grads are rounded once
    to the map's dtype.  Returns (grads of the levels, grad of coords or
    None)."""
    b = coords.shape[0]
    k = 2 * radius + 1
    g = grad_out.reshape(b, len(pyramid), k, k)  # [b, l, j, i]
    grads = []
    gcx = torch.zeros((b,), dtype=coords.dtype, device=coords.device)
    gcy = torch.zeros_like(gcx)
    for lvl, (m, s) in enumerate(zip(pyramid, _level_sizes(pyramid, b))):
        inv = 1.0 / 2.0**lvl
        offs = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
        grid = torch.arange(s, dtype=coords.dtype, device=coords.device)
        ux = coords[:, 0, None, None] * inv + offs[None, :, None] - grid[None, None, :]
        uy = coords[:, 1, None, None] * inv + offs[None, :, None] - grid[None, None, :]
        wx, wy = _tent(ux), _tent(uy)  # (B, k, S)
        gl = g[:, lvl]  # (B, j, i)
        a = torch.bmm(gl.transpose(1, 2), wx)  # (B, i, w)
        grads.append(torch.bmm(wy.transpose(1, 2), a).reshape(b, s * s).to(m.dtype))
        if want_coords:
            mm = _upcast(m, coords).reshape(b, s, s)
            dwx = torch.where(torch.abs(ux) < 1.0, -torch.sign(ux), torch.zeros_like(ux))
            dwy = torch.where(torch.abs(uy) < 1.0, -torch.sign(uy), torch.zeros_like(uy))
            t2 = torch.bmm(wy, mm)  # (B, i, w)
            gpx = (torch.bmm(gl.transpose(1, 2), dwx) * t2).sum(dim=(1, 2))
            t3 = torch.bmm(wx, mm.transpose(1, 2))  # (B, j, h)
            gpy = (torch.bmm(gl, dwy) * t3).sum(dim=(1, 2))
            gcx = gcx + gpx * inv
            gcy = gcy + gpy * inv
    return grads, (torch.stack([gcx, gcy], dim=-1) if want_coords else None)


def corr_lookup_flat_bwd(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                         grad_out: torch.Tensor, radius: int = 4, want_coords: bool = True
                         ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """The backward of `corr_lookup_flat` (any variant): K1b for CUDA
    tensors (the instance of the maps' dtype), its plain version for CPU
    tensors.  grad_out: (B, L*(2r+1)^2) float32; the level grads come back
    in the maps' dtype, the coords grad in float32.  Any level count and
    radius >= 0, as the forward (`bwd_layout`: the route and launches).
    Returns (grads of the levels, grad of coords or None).  Calls the custom
    op `scflow::corr_lookup_bwd`."""
    grads = torch.ops.scflow.corr_lookup_bwd(list(pyramid), coords, grad_out, radius,
                                             want_coords)
    return (grads[:-1], grads[-1]) if want_coords else (grads, None)


def _check_grad_out(pyramid, coords, grad_out, radius: int):
    b = coords.shape[0]
    k = 2 * radius + 1
    if grad_out.shape != (b, len(pyramid) * k * k):
        raise ValueError(f"grad_out must be ({b}, {len(pyramid) * k * k}), "
                         f"got {tuple(grad_out.shape)}")


@torch.library.custom_op("scflow::corr_lookup_bwd", mutates_args=())
def _corr_lookup_bwd_op(levels: List[torch.Tensor], coords: torch.Tensor,
                        grad_out: torch.Tensor, radius: int,
                        want_coords: bool) -> List[torch.Tensor]:
    """K1b on CUDA tensors, its plain version on CPU ones: the level grads,
    then the coords grad where asked for (the schema has no nested
    returns)."""
    sizes = _check_op(levels, coords, radius, "tent", (grad_out,))
    _check_grad_out(levels, coords, grad_out, radius)
    if coords.device.type == "cpu":
        grads, gc = corr_lookup_flat_bwd_plain(levels, coords, grad_out, radius, want_coords)
        return grads + ([gc] if want_coords else [])
    _check_aligned(levels)
    b = coords.shape[0]
    grads = [torch.empty_like(m) for m in levels]
    gc = torch.empty_like(coords) if want_coords else None
    if b > 0:
        bwd_kernel(levels[0].dtype).launch(
            coords.device, coords.data_ptr(), grad_out.data_ptr(), _pointers(levels),
            _ints(sizes), _pointers(grads), len(levels), radius, b,
            gc.data_ptr() if want_coords else None)
    return grads + ([gc] if want_coords else [])


@_corr_lookup_bwd_op.register_fake
def _(levels, coords, grad_out, radius, want_coords):
    _check_fake(levels, coords, radius, "tent", (grad_out,))
    _check_grad_out(levels, coords, grad_out, radius)
    grads = [torch.empty_like(m) for m in levels]
    return grads + ([torch.empty_like(coords)] if want_coords else [])


def _lookup_setup_context(ctx, inputs, output):
    levels, coords, radius, _ = inputs
    ctx.save_for_backward(coords, *levels)
    ctx.radius = radius


def _lookup_backward(ctx, grad):
    """K1b (the `corr_lookup_pallas_diff` pairing, whatever the forward
    variant): the level grads, and the coords grad only where the coords
    need one."""
    coords, *levels = ctx.saved_tensors
    want_coords = ctx.needs_input_grad[1]
    grads, g_coords = corr_lookup_flat_bwd(levels, coords, grad.contiguous(), ctx.radius,
                                           want_coords)
    return list(grads), g_coords, None, None


torch.library.register_autograd("scflow::corr_lookup", _lookup_backward,
                                setup_context=_lookup_setup_context)
