"""Fused UDF-MLP queries (port of emap_tpu/kernels/mlp_query.py): value +
spatial gradient for the training step and the extraction sweeps, and the
value alone for the extraction grid.

* `fold_weights`, `pack_weights`, `pe_perm`: the weight-norm fold and the
  packing into two buffers, in torch, so autograd carries the packed-weight
  gradients back to (g, v, b).
* `value_and_grad_plain`, `value_plain`: the plain PyTorch versions of the
  kernels' math, feature-major like the kernels (CPU tests, and the
  references the CUDA kernels are held against on the card).
* `value_and_grad`: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches csrc/mlp_query.cu (replaces
  emap_tpu/kernels/mlp_query.py::_pallas_value_and_grad) or raises.
  `value_and_grad.launches` counts the kernel launches.
  `value_and_grad_sliced` calls it over slices of at most SLICE_CAP points,
  which bounds the kernel's device scratch on the extraction's large calls.
* `value`: the same for csrc/mlp_value.cu (replaces
  emap_tpu/kernels/mlp_query.py::_pallas_value), with `value.launches`.
* `query_value`, `query_value_and_grad`: (M, 3) points in, padded to the
  tile, the counterparts of `pallas_udf_value` and
  `pallas_udf_value_and_grad` that the extraction calls.

Arrays are feature-major, (features, points). The kernels read the raw
points as (8, N) with 3 live rows and return udf (N,) and the spatial
gradient (8, N) with 3 live rows. N must be a multiple of POINT_TILE.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from emap_tpu_torch.fields.udf import UDFConfig, effective_weight, softplus100

POINT_TILE = 64  # points per CUDA block (csrc/mlp_common.cuh: P)
# Most points a value_and_grad launch takes in value_and_grad_sliced: the
# kernel's scratch is ~3,140 rows x N floats (3.3 GB at ABC width for this
# cap, ~41 GB for a whole 3,276,800-point line-direction sweep). At least
# the training step's 116,736 points, so a step stays one launch.
SLICE_CAP = 262_144
INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))
_UDF_TYPES = {"abs": 0, "square": 1, "sdf": 2}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pe_perm(cfg: UDFConfig) -> np.ndarray:
    """Columns of the interleaved PE layout [x, sin(f0 x), cos(f0 x), ...]
    in the kernels' blocked order [x, sin(F x), cos(F x)]."""
    d, m = cfg.d_in, cfg.multires
    sin_cols, cos_cols = [], []
    for k in range(m):
        base = d + 2 * d * k
        sin_cols += list(range(base, base + d))
        cos_cols += list(range(base + d, base + 2 * d))
    return np.array(list(range(d)) + sin_cols + cos_cols)


def layer_dims(cfg: UDFConfig):
    """[(in_dim_padded, out_dim)] per linear, lin0's input padded to 8."""
    d0_pad = round_up(cfg.dims[0], 8)
    return [(d0_pad if l == 0 else i, o) for l, i, o in cfg.layer_shapes()]


def fold_weights(params, cfg: UDFConfig, fuse_pe: bool = True):
    """[(w (out, in), b (out, 1))] per layer, weight norm folded; with
    fuse_pe the encoded-input columns (lin0 and the x block of a skip
    layer) are permuted to the blocked PE layout. lin0's input is
    zero-padded to a multiple of 8."""
    n_linear = len(cfg.dims) - 1
    d0 = cfg.dims[0]
    d0_pad = round_up(d0, 8)
    perm = None
    if fuse_pe:
        perm = torch.as_tensor(pe_perm(cfg))
    layers = []
    for l in range(n_linear):
        layer = params[f"lin{l}"]
        w = effective_weight(layer).to(torch.float32)
        if perm is not None:
            p = perm.to(w.device)
            if l == 0:
                w = w[:, p]
            elif l in cfg.skip_in:
                w = torch.cat([w[:, :-d0], w[:, -d0:][:, p]], dim=1)
        if l == 0 and d0_pad != d0:
            w = torch.nn.functional.pad(w, (0, d0_pad - d0))
        layers.append((w, layer["b"].to(torch.float32)[:, None]))
    return layers


def pack_weights(params, cfg: UDFConfig, fuse_pe: bool = True):
    """(W (row_max, sum_in), B (row_max, L)): layer l's block at column
    offset off_l, rows above out_l zero."""
    layers = fold_weights(params, cfg, fuse_pe)
    row_max = max(o for _, o in layer_dims(cfg))
    blocks = [torch.nn.functional.pad(w, (0, 0, 0, row_max - w.shape[0]))
              for w, _ in layers]
    biases = [torch.nn.functional.pad(b, (0, 0, 0, row_max - b.shape[0]))
              for _, b in layers]
    return torch.cat(blocks, dim=1), torch.cat(biases, dim=1)


def unpack_weights(w_pack, b_pack, cfg: UDFConfig):
    """[(w (out_l, in_l), b (out_l,))] per layer: the blocks of a pack laid
    out as pack_weights lays it out (weights or their gradients)."""
    dims = layer_dims(cfg)
    offs = np.concatenate([[0], np.cumsum([i for i, _ in dims])])
    return [(w_pack[:o, int(offs[l]): int(offs[l]) + i], b_pack[:o, l])
            for l, (i, o) in enumerate(dims)]


def kernel_layout(cfg: UDFConfig) -> np.ndarray:
    """The network shape as the int array the CUDA kernels parse
    (csrc/mlp_common.cuh: parse_layout)."""
    dims = layer_dims(cfg)
    offs = np.concatenate([[0], np.cumsum([i for i, _ in dims])])
    head = [len(dims), cfg.dims[0], round_up(cfg.dims[0], 8), cfg.multires,
            _UDF_TYPES[cfg.udf_type], int(offs[-1]), max(o for _, o in dims)]
    body = []
    for l, (i, o) in enumerate(dims):
        body += [i, o, int(offs[l]), int(l in cfg.skip_in)]
    return np.ascontiguousarray(head + body, dtype=np.int32)


def check_kernel_cfg(cfg: UDFConfig) -> None:
    """The shapes the fused kernels take: PE on 3-D points, a scalar head,
    no layer wider than 256."""
    if cfg.d_in != 3 or cfg.multires <= 0 or cfg.d_out != 1:
        raise ValueError("the fused kernels need d_in=3, multires>0, d_out=1;"
                         ' set pallas_train = "off" for other nets')
    if max(max(i, o) for i, o in layer_dims(cfg)) > 256:
        raise ValueError("the fused kernels take layers up to 256 wide; set "
                         'pallas_train = "off" for wider nets')


def pe_freqs(cfg: UDFConfig):
    return [float(2.0 ** k) for k in range(cfg.multires)]


def encode_fused(p: torch.Tensor, cfg: UDFConfig):
    """p (8, T) raw feature-major points -> (x (d0_pad, T) blocked layout
    [u, sin(F u), cos(F u), 0-pad], uf (3*multires, T))."""
    u = p[: cfg.d_in] * float(np.float32(cfg.scale))
    uf = torch.cat([u * f for f in pe_freqs(cfg)], dim=0)
    x = torch.cat([u, torch.sin(uf), torch.cos(uf)], dim=0)
    d0_pad = round_up(cfg.dims[0], 8)
    if d0_pad != x.shape[0]:
        x = torch.nn.functional.pad(x, (0, 0, 0, d0_pad - x.shape[0]))
    return x, uf


def pe_jac_fused(uf, g, cfg: UDFConfig):
    """(dPE/dx)^T applied to the encoded-space gradient g (d0_pad, T)
    -> (8, T) with the first 3 rows live."""
    d, m = cfg.d_in, cfg.multires
    cos_uf, sin_uf = torch.cos(uf), torch.sin(uf)
    du = g[:d]
    for k, f in enumerate(pe_freqs(cfg)):
        sl = slice(d * k, d * (k + 1))
        gs = g[d + d * k: d + d * (k + 1)]
        gc = g[d + d * m + d * k: d + d * m + d * (k + 1)]
        du = du + f * (cos_uf[sl] * gs - sin_uf[sl] * gc)
    du = du * float(np.float32(cfg.scale))
    return torch.nn.functional.pad(du, (0, 0, 0, 8 - d))


def pe_jacT_fused(uf, t8, cfg: UDFConfig):
    """Transpose of pe_jac_fused: (8, T) -> (d0_pad, T) blocked layout."""
    d = cfg.d_in
    t = t8[:d] * float(np.float32(cfg.scale))
    cos_uf, sin_uf = torch.cos(uf), torch.sin(uf)
    sin_rows = [f * cos_uf[d * k: d * (k + 1)] * t
                for k, f in enumerate(pe_freqs(cfg))]
    cos_rows = [-f * sin_uf[d * k: d * (k + 1)] * t
                for k, f in enumerate(pe_freqs(cfg))]
    out = torch.cat([t] + sin_rows + cos_rows, dim=0)
    d0_pad = round_up(cfg.dims[0], 8)
    return torch.nn.functional.pad(out, (0, 0, 0, d0_pad - out.shape[0]))


def dy_of_y0(y0, cfg: UDFConfig):
    """d udf / d y0 for the head, divided by scale."""
    if cfg.udf_type == "abs":
        return torch.sign(y0) / cfg.scale
    if cfg.udf_type == "square":
        return 2.0 * y0 / cfg.scale
    return torch.full_like(y0, 1.0 / cfg.scale)


def head_value(y0, cfg: UDFConfig):
    if cfg.udf_type == "abs":
        return torch.abs(y0) / cfg.scale
    if cfg.udf_type == "square":
        return y0 ** 2 / cfg.scale
    return y0 / cfg.scale


def value_and_grad_plain(x_T, w_pack, b_pack, cfg: UDFConfig):
    """Plain PyTorch version of the fused query: x_T (8, N) raw points ->
    (udf (N,), grad (8, N)). The same math as the kernel, feature-major:
    encode, forward keeping sigmoid(100 z), reverse through W^T, PE
    Jacobian."""
    layers = unpack_weights(w_pack, b_pack, cfg)
    L = len(layers)
    d0 = cfg.dims[0]
    x, uf = encode_fused(x_T, cfg)
    h = x
    sigmoids = []
    for l, (w, b) in enumerate(layers):
        if l in cfg.skip_in:
            h = torch.cat([h, x[:d0]], dim=0) * INV_SQRT2
        z = torch.matmul(w, h) + b[:, None]
        if l < L - 1:
            sigmoids.append(torch.sigmoid(100.0 * z))
            h = softplus100(z)
        else:
            h = z
    y0 = h[:1]
    udf = head_value(y0, cfg)
    g = dy_of_y0(y0, cfg)
    g_inputs = torch.zeros_like(x)
    for l in reversed(range(L)):
        g = torch.matmul(layers[l][0].T, g)  # (in_l, T)
        if l in cfg.skip_in:
            g_inputs = g_inputs + torch.nn.functional.pad(
                g[-d0:] * INV_SQRT2, (0, 0, 0, g_inputs.shape[0] - d0))
            g = g[:-d0] * INV_SQRT2
        elif l == 0:
            g_inputs = g_inputs + g
            continue
        g = g * sigmoids[l - 1]
    return udf[0], pe_jac_fused(uf, g_inputs, cfg)


def value_plain(x_T, w_pack, b_pack, cfg: UDFConfig):
    """Plain PyTorch version of the value kernel: x_T (8, N) raw points ->
    udf (N,). The forward of value_and_grad_plain without residuals."""
    layers = unpack_weights(w_pack, b_pack, cfg)
    L = len(layers)
    d0 = cfg.dims[0]
    x, _ = encode_fused(x_T, cfg)
    h = x
    for l, (w, b) in enumerate(layers):
        if l in cfg.skip_in:
            h = torch.cat([h, x[:d0]], dim=0) * INV_SQRT2
        z = torch.matmul(w, h) + b[:, None]
        h = softplus100(z) if l < L - 1 else z
    return head_value(h[0], cfg)


def check_operands(cfg: UDFConfig, tensors) -> int:
    """Validate the CUDA operands; returns N (points)."""
    check_kernel_cfg(cfg)
    x_T = tensors[0]
    n = x_T.shape[1]
    if x_T.shape[0] != 8 or n % POINT_TILE:
        raise ValueError(f"points must be (8, N) with N a multiple of "
                         f"{POINT_TILE}, got {tuple(x_T.shape)}")
    for t in tensors:
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError("kernel operands must be contiguous float32 "
                             "CUDA tensors")
        if t.device != x_T.device:
            raise ValueError("kernel operands must share one device")
    return n


def _query_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_query")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_value_and_grad_scratch_rows.argtypes = [vp]
        lib.emap_mlp_value_and_grad_scratch_rows.restype = ctypes.c_longlong
        lib.emap_mlp_value_and_grad.argtypes = [
            vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float, vp]
        lib.emap_mlp_value_and_grad.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def value_and_grad(x_T, w_pack, b_pack, cfg: UDFConfig):
    """(udf (N,), grad (8, N)) at raw points x_T (8, N). CPU tensors take
    value_and_grad_plain; CUDA tensors launch the kernel."""
    if not x_T.is_cuda:
        return value_and_grad_plain(x_T, w_pack, b_pack, cfg)
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    lib = _query_lib()
    layout = kernel_layout(cfg)
    rows = lib.emap_mlp_value_and_grad_scratch_rows(layout.ctypes.data)
    if rows < 0:
        raise ValueError("layout refused by the kernel")
    dev = x_T.device
    udf = torch.empty(n, device=dev, dtype=torch.float32)
    grad = torch.empty(8, n, device=dev, dtype=torch.float32)
    scratch = torch.empty(rows * n, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.emap_mlp_value_and_grad(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), udf.data_ptr(),
        grad.data_ptr(), scratch.data_ptr(), n, layout.ctypes.data,
        float(cfg.scale), stream)
    if err:
        raise RuntimeError(f"mlp_query kernel launch failed: CUDA error {err}")
    value_and_grad.launches += 1
    return udf, grad


value_and_grad.launches = 0


def value_and_grad_sliced(x_T, w_pack, b_pack, cfg: UDFConfig,
                          cap: int = SLICE_CAP):
    """value_and_grad over slices of at most `cap` points (a multiple of
    POINT_TILE), concatenated: one launch per slice on the card, so the
    kernel's scratch never exceeds `cap` points' worth. Points are
    independent, so the result does not depend on the slicing."""
    n = x_T.shape[1]
    if cap <= 0 or cap % POINT_TILE:
        raise ValueError(f"cap must be a positive multiple of {POINT_TILE}")
    if n <= cap:
        return value_and_grad(x_T, w_pack, b_pack, cfg)
    parts = [value_and_grad(x_T[:, s: s + cap].contiguous(), w_pack, b_pack,
                            cfg) for s in range(0, n, cap)]
    return (torch.cat([u for u, _ in parts]),
            torch.cat([g for _, g in parts], dim=1))


def _value_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_value")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_value_smem_bytes.argtypes = [vp]
        lib.emap_mlp_value_smem_bytes.restype = ctypes.c_longlong
        lib.emap_mlp_value.argtypes = [
            vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float, vp]
        lib.emap_mlp_value.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def value(x_T, w_pack, b_pack, cfg: UDFConfig):
    """udf (N,) at raw points x_T (8, N). CPU tensors take value_plain;
    CUDA tensors launch the kernel (no device scratch)."""
    if not x_T.is_cuda:
        return value_plain(x_T, w_pack, b_pack, cfg)
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    lib = _value_lib()
    layout = kernel_layout(cfg)
    if lib.emap_mlp_value_smem_bytes(layout.ctypes.data) < 0:
        raise ValueError("layout refused by the kernel")
    dev = x_T.device
    udf = torch.empty(n, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.emap_mlp_value(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), udf.data_ptr(),
        n, layout.ctypes.data, float(cfg.scale), stream)
    if err:
        raise RuntimeError(f"mlp_value kernel launch failed: CUDA error {err}")
    value.launches += 1
    return udf


value.launches = 0


def _packed_points(params, pts, cfg: UDFConfig):
    """(x_T (8, N) zero-padded to the tile, w_pack, b_pack, M) for (M, 3)
    points, on the points' device, outside autograd."""
    check_kernel_cfg(cfg)
    with torch.no_grad():
        w_pack, b_pack = pack_weights(params, cfg, fuse_pe=True)
    m = pts.shape[0]
    x_T = pts.new_zeros(8, round_up(max(m, 1), POINT_TILE),
                        dtype=torch.float32)
    x_T[:3, :m] = pts.detach().T.to(torch.float32)
    return x_T, w_pack.contiguous(), b_pack.contiguous(), m


def query_value(params, pts, cfg: UDFConfig):
    """udf (M,) at (M, 3) points through the value kernel (its plain
    version on the CPU): the counterpart of pallas_udf_value."""
    x_T, w_pack, b_pack, m = _packed_points(params, pts, cfg)
    return value(x_T, w_pack, b_pack, cfg)[:m]


def query_value_and_grad(params, pts, cfg: UDFConfig, cap: int = SLICE_CAP):
    """(udf (M,), grad (M, 3)) at (M, 3) points through the sliced
    value-and-gradient kernel: the counterpart of pallas_udf_value_and_grad.
    No autograd graph."""
    x_T, w_pack, b_pack, m = _packed_points(params, pts, cfg)
    udf, grad = value_and_grad_sliced(x_T, w_pack, b_pack, cfg, cap)
    return udf[:m], grad[:3, :m].T


def query_flops(cfg: UDFConfig) -> int:
    """FLOP a point of the fused query: forward and reverse products,
    2 * in * out each (the elementwise work is not counted)."""
    return 4 * sum(i * o for _, i, o in cfg.layer_shapes())


def value_flops(cfg: UDFConfig) -> int:
    """FLOP a point of the value kernel: the forward products only."""
    return 2 * sum(i * o for _, i, o in cfg.layer_shapes())


__all__ = [
    "POINT_TILE", "SLICE_CAP", "fold_weights", "pack_weights",
    "unpack_weights", "pe_perm", "layer_dims",
    "kernel_layout", "value_and_grad", "value_and_grad_plain",
    "value_and_grad_sliced", "value", "value_plain", "query_value",
    "query_value_and_grad", "query_flops", "value_flops",
]
