"""Fused UDF-MLP queries (port of emap_tpu/kernels/mlp_query.py): value +
spatial gradient for the training step and the extraction sweeps, and the
value alone for the extraction grid.

* `fold_weights`, `pack_weights`, `pe_perm`, `blocked_pe_columns`: the
  weight-norm fold and the packing into two buffers, in torch, so
  autograd carries the packed-weight gradients back to (g, v, b).
* `value_and_grad_plain`, `value_plain`: the plain PyTorch versions of the
  kernels' math, feature-major like the kernels (CPU tests, and the
  references the CUDA kernels are held against on the card).
* `value_and_grad`: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernels that replace
  emap_tpu/kernels/mlp_query.py::_pallas_value_and_grad, or raises: at the
  bf16 tier csrc/mlp_query_wgmma.cu (wgmma and TMA: a weight-pack prologue
  and the chain kernel), at the 3xTF32 tier csrc/mlp_query_tf32.cu (wgmma
  .tf32 and TMA: a pre-split weight-pack prologue and the chain kernel).
  `value_and_grad.launches` counts one call as one launch, and
  `value_and_grad.tier_launches` the same by kernel tier.
  `value_and_grad_mma_sync` runs csrc/mlp_query.cu (mma.sync) at either
  tier, for timing beside the wgmma kernels, and
  `value_and_grad_wgmma_parts` / `value_and_grad_tf32_parts` return what
  each launch of the wgmma kernels wrote; no path calls them.
* The wgmma chain engine's Python side (csrc/mlp_wgmma.cuh, shared with
  #2's kernels in kernels/mlp_train.py): `wgmma_layout` (the bf16 weight
  pack and #2's factor rows), `pack_weights_bf16` (the prologue's plain
  version), `query_wgmma_plan` (shared memory, registers and scratch of
  a launch of #1a's; refuses a net that does not fit) and
  `query_wgmma_launch_costs` (FLOP and bytes of each launch).
* The 3xTF32 kernel's Python side (csrc/mlp_query_tf32.cu):
  `query_tf32_layout` (the pre-split pack's blocks), `pack_weights_tf32`
  (the prologue's plain version, TF32 rounding in torch integer ops) and
  `unpack_weights_tf32`, `tf32x3_matmul` (one promoted 3xTF32 product, the
  kernels' numbers on the CPU), `query_tf32_plan` and
  `query_tf32_launch_costs`.
* `value_and_grad_sliced` calls `value_and_grad` over slices of at most
  SLICE_CAP points, which bounds the kernels' device scratch on the
  extraction's large calls.
* `value`: the same for the grid value kernels (replace
  emap_tpu/kernels/mlp_query.py::_pallas_value), with `value.launches` and
  `value.tier_launches`: at the 3xTF32 tier csrc/mlp_value_tf32.cu (wgmma
  .tf32 and TMA: the forward-only pre-split pack and a persistent kernel of
  two consumer warpgroups on one fp32 tile; `value_tf32_plan`,
  `value_tf32_launch_costs`), at the bf16 tier csrc/mlp_value_wgmma.cu
  (wgmma and TMA: the engine's bf16 pack and a persistent kernel of two
  consumer warpgroups, a 64-point tile each; `value_wgmma_plan`,
  `value_wgmma_launch_costs`). `value_mma_sync` runs csrc/mlp_value.cu
  (mma.sync) at either tier for timing beside the wgmma kernels, and
  `value_tf32_parts` / `value_wgmma_parts` return what each of their
  launches wrote; no path calls them.
* `query_value`, `query_value_and_grad`: (M, 3) points in, padded to the
  tile, the counterparts of `pallas_udf_value` and
  `pallas_udf_value_and_grad` that the extraction calls.

Arrays are feature-major, (features, points). The kernels read the raw
points as (8, N) with 3 live rows and return udf (N,) and the spatial
gradient (8, N) with 3 live rows. N must be a multiple of POINT_TILE.

Every product runs at cfg.precision, as the JAX package's `_kernel_dot`
(emap_tpu/kernels/mlp_query.py:249-278) runs it: the kernels have two
tiers (kernel_tier), one bf16 pass ("default": weights or their
transpose, activations, the chain's cotangents and the encoded rows
rounded to bf16, fp32 products and sums) and fp32 ("high", "highest":
3xTF32 on the tensor cores). Bias adds, softplus, sigmoids, the PE and its
Jacobian stay fp32. The sigmoid residuals that the reverse pass multiplies
by are the JAX package's (`f32_residuals`, mlp_query.py:313-319): fp32 in
the training query (f32_residuals=True, as emap_tpu/kernels/mlp_train.py
passes it), rounded to bf16 in the extraction query at "default" and
"high" (f32_residuals=False, as pallas_udf_value_and_grad runs it:
value_and_grad_sliced, query_value_and_grad), fp32 at "highest".
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from emap_tpu_torch.fields.udf import (
    UDFConfig,
    adjoint_tier,
    check_tier,
    effective_weight,
    round_bf16,
    softplus100,
)

POINT_TILE = 64  # points per CUDA block (csrc/mlp_common.cuh: P)
# Most points a value_and_grad launch takes in value_and_grad_sliced: the
# kernel's scratch is its sigmoid residuals, 2,000 rows x N floats at ABC
# width (2.1 GB for this cap, ~26 GB for a whole 3,276,800-point
# line-direction sweep). At least the training step's 116,736 points, so a
# step stays one launch.
SLICE_CAP = 262_144
INV_SQRT2 = float(np.float32(1.0 / np.sqrt(2.0)))
_UDF_TYPES = {"abs": 0, "square": 1, "sdf": 2}
# The name of each kernel tier code in the wrappers' tier_launches.
TIER_NAMES = ("3xtf32", "bf16")


def kernel_tier(name: str) -> int:
    """The kernels' code for a conf tier (csrc/mlp_mma.cuh: Tier): 1, one
    bf16 pass, for "default"; 0, three TF32 passes at fp32 accuracy, for
    "high" and "highest". Raises for a tier they lack."""
    return int(check_tier(name, "precision") == "default")


def tier_dot(a: torch.Tensor, b: torch.Tensor, tier: str) -> torch.Tensor:
    """a @ b as the kernels take it at a tier, for the plain versions: at
    "default" both operands rounded to bf16 first, then fp32 products and
    sums (TF32 off: `use_fp32_matmuls`); fp32 otherwise."""
    if kernel_tier(tier):
        return torch.matmul(round_bf16(a), round_bf16(b))
    return torch.matmul(a, b)


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


def blocked_pe_columns(w: torch.Tensor, cfg: UDFConfig) -> torch.Tensor:
    """w[:, pe_perm(cfg)] for a weight's d0 encoded-input columns, by a
    reshape and a transpose: no index tensor, so on the card no copy from
    the host, which a CUDA graph could not hold."""
    d, m, o = cfg.d_in, cfg.multires, w.shape[0]
    enc = w[:, d:].reshape(o, m, 2, d).transpose(1, 2).reshape(o, 2 * m * d)
    return torch.cat([w[:, :d], enc], dim=1)


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
    layers = []
    for l in range(n_linear):
        layer = params[f"lin{l}"]
        w = effective_weight(layer).to(torch.float32)
        if fuse_pe:
            if l == 0:
                w = blocked_pe_columns(w, cfg)
            elif l in cfg.skip_in:
                w = torch.cat([w[:, :-d0], blocked_pe_columns(w[:, -d0:],
                                                              cfg)], dim=1)
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
    no layer wider than 256, every layer's input a multiple of 4 wide (the
    tensor-core kernels copy weight rows in 16-byte pieces:
    csrc/mlp_mma.cuh, tc_layout_ok)."""
    if cfg.d_in != 3 or cfg.multires <= 0 or cfg.d_out != 1:
        raise ValueError("the fused kernels need d_in=3, multires>0, d_out=1;"
                         ' set pallas_train = "off" for other nets')
    dims = layer_dims(cfg)
    if max(max(i, o) for i, o in dims) > 256:
        raise ValueError("the fused kernels take layers up to 256 wide; set "
                         'pallas_train = "off" for wider nets')
    if any(i % 4 for i, _ in dims):
        raise ValueError("the fused kernels take layer inputs a multiple of 4 "
                         'wide (d_hidden % 4 == 0); set pallas_train = "off" '
                         "for other nets")


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


def bf16_residuals(cfg: UDFConfig, f32_residuals: bool) -> bool:
    """Whether the reverse pass multiplies by sigmoid(100 z) rounded to
    bf16: the JAX package's rule (mlp_query.py:313-319), at every tier but
    "highest" unless f32_residuals."""
    return not f32_residuals and cfg.precision != "highest"


def _plain_forward(x_T, w_pack, b_pack, cfg: UDFConfig):
    """The plain query's forward: (x, uf, layers, y0 (1, N), [sigmoid(100
    z_l) (out_l, N)] per hidden layer, fp32)."""
    layers = unpack_weights(w_pack, b_pack, cfg)
    L = len(layers)
    d0 = cfg.dims[0]
    x, uf = encode_fused(x_T, cfg)
    h = x
    sigmoids = []
    for l, (w, b) in enumerate(layers):
        if l in cfg.skip_in:
            h = torch.cat([h, x[:d0]], dim=0) * INV_SQRT2
        z = tier_dot(w, h, cfg.precision) + b[:, None]
        if l < L - 1:
            sigmoids.append(torch.sigmoid(100.0 * z))
            h = softplus100(z)
        else:
            h = z
    return x, uf, layers, h[:1], sigmoids


def value_and_grad_plain(x_T, w_pack, b_pack, cfg: UDFConfig,
                         f32_residuals: bool = True, residuals=None):
    """Plain PyTorch version of the fused query: x_T (8, N) raw points ->
    (udf (N,), grad (8, N)). The same math as the kernel, feature-major:
    encode, forward keeping sigmoid(100 z) (rounded to bf16, to nearest
    even, where bf16_residuals), reverse through W^T, PE Jacobian; every
    product at cfg.precision. `residuals`, [(out_l, N)] per hidden layer,
    replaces the sigmoids the reverse pass multiplies by (a kernel's own,
    side_residuals: its bf16 roundings of values an fp32 ulp from the plain
    version's may fall on either side of a rounding boundary)."""
    x, uf, layers, y0, sigmoids = _plain_forward(x_T, w_pack, b_pack, cfg)
    if residuals is not None:
        sigmoids = list(residuals)
    elif bf16_residuals(cfg, f32_residuals):
        sigmoids = [round_bf16(s) for s in sigmoids]
    d0 = cfg.dims[0]
    udf = head_value(y0, cfg)
    g = dy_of_y0(y0, cfg)
    g_inputs = torch.zeros_like(x)
    for l in reversed(range(len(layers))):
        g = tier_dot(layers[l][0].T, g, cfg.precision)  # (in_l, T)
        if l in cfg.skip_in:
            g_inputs = g_inputs + torch.nn.functional.pad(
                g[-d0:] * INV_SQRT2, (0, 0, 0, g_inputs.shape[0] - d0))
            g = g[:-d0] * INV_SQRT2
        elif l == 0:
            g_inputs = g_inputs + g
            continue
        g = g * sigmoids[l - 1]
    return udf[0], pe_jac_fused(uf, g_inputs, cfg)


def plain_residuals(x_T, w_pack, b_pack, cfg: UDFConfig):
    """[sigmoid(100 z_l) (out_l, N)] per hidden layer, fp32, as
    value_and_grad_plain's forward computes them."""
    return _plain_forward(x_T, w_pack, b_pack, cfg)[4]


def side_residuals(side, cfg: UDFConfig, n: int):
    """The sigmoid residuals a wgmma query kernel (csrc/mlp_query_wgmma.cu,
    csrc/mlp_query_tf32.cu) left in its side scratch, [(out_l, n)] per
    hidden layer in fp32. Per 64-point tile and hidden layer the scratch
    holds 256 x 64 values: slot (16 h + j) x 128 + t (csrc/mlp_wgmma.cuh:
    side_slot) of 4 values e holds feature 128 h + 8 j + 2 (t % 4) + (e & 1)
    of point 16 (t // 32) + (t % 32) // 4 + 8 (e >> 1); only the live
    8-feature groups are written."""
    dims = layer_dims(cfg)[:-1]
    tiles = -(-n // POINT_TILE)
    a = side[: tiles * len(dims) * WGMMA_FMAX * POINT_TILE].float().view(
        tiles, len(dims), 2, 16, 4, 8, 4, 2, 2)
    # (tile, layer, h, j, warp, lane // 4, lane % 4, e >> 1, e & 1) ->
    # (layer, feature (h, j, lane % 4, e & 1), point (tile, warp, e >> 1,
    # lane // 4))
    a = a.permute(1, 2, 3, 6, 8, 0, 4, 7, 5).reshape(
        len(dims), WGMMA_FMAX, tiles * POINT_TILE)
    return [a[l, :o, :n] for l, (_, o) in enumerate(dims)]


def value_plain(x_T, w_pack, b_pack, cfg: UDFConfig):
    """Plain PyTorch version of the value kernel: x_T (8, N) raw points ->
    udf (N,). The forward of value_and_grad_plain without residuals, at
    cfg.precision."""
    layers = unpack_weights(w_pack, b_pack, cfg)
    L = len(layers)
    d0 = cfg.dims[0]
    x, _ = encode_fused(x_T, cfg)
    h = x
    for l, (w, b) in enumerate(layers):
        if l in cfg.skip_in:
            h = torch.cat([h, x[:d0]], dim=0) * INV_SQRT2
        z = tier_dot(w, h, cfg.precision) + b[:, None]
        h = softplus100(z) if l < L - 1 else z
    return head_value(h[0], cfg)


def check_operands(cfg: UDFConfig, tensors) -> int:
    """Validate the CUDA operands and cfg's tiers (a tier the kernels lack
    raises); returns N (points)."""
    check_kernel_cfg(cfg)
    kernel_tier(cfg.precision)
    kernel_tier(adjoint_tier(cfg))
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


# The wgmma chain engine (csrc/mlp_wgmma.cuh) that #1a at the bf16 tier
# (csrc/mlp_query_wgmma.cu) and #2 at the bf16 pair
# (csrc/mlp_train_wgmma.cu) share: the widest layer (the rows of the weight
# pack and of the activation tiles), points a block (two warpgroups of 64)
# and the shared memory a block may take on the H100.
WGMMA_FMAX = 256
WGMMA_BLOCK_POINTS = 128
SMEM_LIMIT = 232_448
# a consumer thread's fp32 accumulators: the running sum and the 64-deep
# chunk's of one m64n128 half (setmaxnreg: consumers 232, the producer
# warpgroup 40)
ENGINE_REGISTERS = {"accumulators": 2 * 64, "consumer": 232, "producer": 40}
# rows of the query kernel's d udf / d x-tilde block
# (csrc/mlp_query_wgmma.cu: GIN_ROWS): the encoded input's d0p at most
QUERY_GIN_ROWS = 64


def wgmma_layout(cfg: UDFConfig) -> dict:
    """The wgmma kernels' layout (csrc/mlp_wgmma.cuh: parse_wgmma): per
    layer kpad = in_l and opad = out_l rounded up to 64; the bf16 weight
    pack's column of each layer (offb) and its width (ldwb); the rows of
    #2's factors U_l, Q-hat_l (kpad_l each), R_l, Z-hat_l (opad_l each) in
    the (frows, N) factor array."""
    dims = layer_dims(cfg)
    kpad = [round_up(i, 64) for i, _ in dims]
    opad = [round_up(o, 64) for _, o in dims]
    offb = [sum(kpad[:l]) for l in range(len(dims))]
    rows, row = {"U": [], "Q": [], "R": [], "Z": []}, 0
    for k, o in zip(kpad, opad):
        for name, size in (("U", k), ("Q", k), ("R", o), ("Z", o)):
            rows[name].append(row)
            row += size
    return {"dims": dims, "kpad": kpad, "opad": opad, "offb": offb,
            "ldwb": sum(kpad), "rows": rows, "frows": row}


def check_engine_cfg(cfg: UDFConfig) -> dict:
    """wgmma_layout(cfg) for a net the wgmma kernels take. Raises
    ValueError, on every device, for one they do not: check_kernel_cfg's
    refusals and a layer wider than WGMMA_FMAX."""
    check_kernel_cfg(cfg)
    lay = wgmma_layout(cfg)
    if max(max(i, o) for i, o in lay["dims"]) > WGMMA_FMAX:
        raise ValueError(f"the wgmma kernels take layers up to {WGMMA_FMAX} "
                         "wide")
    return lay


def engine_smem() -> dict:
    """The shared memory every chain-engine block holds, by part (bytes):
    the weight ring and the two consumers' two activation tiles."""
    box = 64 * 64 * 2
    tile = WGMMA_FMAX * 64 * 2  # a warpgroup's activation tile, bf16
    return {"weight ring (4 stages of a 64 x 128 bf16 chunk)": 4 * 2 * box,
            "activation tiles (2 warpgroups x 2)": 4 * tile,
            "mbarriers": 2 * 4 * 8, "alignment": 1024}


def pack_weights_bf16(w_pack, cfg: UDFConfig):
    """The wgmma kernels' weight pack: (WGMMA_FMAX, ldwb) bf16 with layer
    l's block of w_pack at column offb_l, its in_l columns zero-padded to
    kpad_l and rows past rmax zero; each value rounded to bf16 as tier_dot
    rounds it. The plain version of their prologue (pack_kernel)."""
    lay = wgmma_layout(cfg)
    out = torch.zeros(WGMMA_FMAX, lay["ldwb"], dtype=torch.bfloat16,
                      device=w_pack.device)
    off = 0
    for (i, _), col in zip(lay["dims"], lay["offb"]):
        out[: w_pack.shape[0], col: col + i] = w_pack[:, off: off + i].to(
            torch.bfloat16)
        off += i
    return out


def check_query_cfg(cfg: UDFConfig) -> dict:
    """wgmma_layout(cfg) for a net both wgmma query kernels take. Raises
    ValueError, on every device, for one they do not: check_engine_cfg's
    refusals and an encoded input wider than their QUERY_GIN_ROWS-row
    d udf / d x-tilde block."""
    lay = check_engine_cfg(cfg)
    d0p = lay["dims"][0][0]
    if d0p > QUERY_GIN_ROWS:
        raise ValueError(f"the wgmma query kernels take an encoded input up "
                         f"to {QUERY_GIN_ROWS} wide, not {d0p}")
    return lay


def query_wgmma_plan(cfg: UDFConfig, n: int) -> dict:
    """Shared memory, registers and device scratch of one launch of #1a's
    wgmma kernels at n points, as csrc/mlp_query_wgmma.cu reckons them
    (emap_mlp_query_wgmma_sizes). Raises ValueError for a net they do not
    take, on every device: check_engine_cfg's refusals, an encoded input
    wider than QUERY_GIN_ROWS, or a plan past the block's shared memory."""
    lay = check_query_cfg(cfg)
    dims = lay["dims"]
    parts = dict(engine_smem(), **{
        "d udf / d x-tilde (2 warpgroups x 64 rows x 64 fp32)":
            2 * QUERY_GIN_ROWS * 64 * 4,
        "head sums and d udf / d y0": (2 * 2 * 64 + 2 * 64) * 4,
    })
    smem = sum(parts.values())
    if smem > SMEM_LIMIT:
        raise ValueError(f"the wgmma query kernel needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    blocks = -(-n // WGMMA_BLOCK_POINTS)
    return {
        "smem": smem, "smem_parts": parts,
        "registers": dict(ENGINE_REGISTERS), "blocks": blocks,
        "wb": WGMMA_FMAX * lay["ldwb"],
        # sigmoid(100 z_l) of each hidden layer: WGMMA_FMAX fp32 a point
        "side": 2 * blocks * (len(dims) - 1) * WGMMA_FMAX * 64,
    }


def query_wgmma_launch_costs(cfg: UDFConfig, n: int) -> dict:
    """Each launch of #1a's wgmma kernels at n points: the FLOP of its
    products (2 * in * out each, unpadded shapes, forward and reverse) and
    the bytes it must move (each input read once, each output written
    once), and the sigmoid side arrays' device traffic of the chain kernel
    beside them: written once and read once, fp32, the live 8-feature
    groups of each hidden layer (roundup(out_l, 8) a point)."""
    lay = wgmma_layout(cfg)
    dims = lay["dims"]
    shapes = [(i, o) for _, i, o in cfg.layer_shapes()]
    L, rmax, ldw = len(dims), max(o for _, o in dims), sum(
        i for i, _ in dims)
    f32, bf16 = 4, 2
    w_bytes, wb_bytes = f32 * rmax * ldw, bf16 * WGMMA_FMAX * lay["ldwb"]
    side = 2 * f32 * n * sum(round_up(o, 8) for _, o in dims[:-1])
    return {
        "pack": {"flops": 0, "bytes": w_bytes + wb_bytes},
        # points (8, n) in; udf (n,) and grad (8, n) out; the bf16 pack,
        # the head's fp32 row and the biases
        "query": {"flops": 4 * sum(i * o for i, o in shapes) * n,
                  "bytes": f32 * 17 * n + wb_bytes + f32 * dims[-1][0]
                  + f32 * rmax * L, "side_bytes": side},
    }


# The 3xTF32 kernel (csrc/mlp_query_tf32.cu): a block is 64 points, a
# producer warpgroup and two consumer warpgroups (one 128-wide half of each
# product's outputs each), a ring of TF32_STAGES weight chunks (128 outputs
# x 32 contraction steps, fp32 hi and lo: 32 KB) and one fp32 activation
# tile, whose A fragments each consumer splits in registers.
TF32_BLOCK_POINTS = 64
TF32_STAGES = 4
TF32_CHUNK = 32  # contraction steps a chunk: one 128-byte row of fp32
# Within each 8-column group of the pack, the feature at position p: the A
# fragment's k positions q and q + 4 hold the pair of features 2q, 2q + 1
# that an accumulator fragment holds (csrc/mlp_query_tf32.cu: tf32_perm).
TF32_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
# a consumer thread's fp32 accumulators (running sum and chunk, one m64n128
# half) and its split A fragments of a chunk (4 k8 steps x 4, hi and lo)
TF32_REGISTERS = {"accumulators": 2 * 64, "a_fragments": 2 * 4 * 4,
                  "consumer": 232, "producer": 40}


def query_tf32_layout(cfg: UDFConfig) -> dict:
    """The 3xTF32 pack's blocks (csrc/mlp_query_tf32.cu: parse_tf32): per
    hidden layer l (the head is fp32 FMA), its forward block (out_l rows,
    kf_l = in_l rounded up to TF32_CHUNK columns) at column offf_l and its
    transposed block (in_l rows, kt_l = out_l rounded up) at column ldf +
    offt_l of a (2 x WGMMA_FMAX, ldp) fp32 array, hi rows above lo rows."""
    dims = layer_dims(cfg)[:-1]
    kf = [round_up(i, TF32_CHUNK) for i, _ in dims]
    kt = [round_up(o, TF32_CHUNK) for _, o in dims]
    offf = [sum(kf[:l]) for l in range(len(dims))]
    offt = [sum(kt[:l]) for l in range(len(dims))]
    return {"dims": dims, "kf": kf, "kt": kt, "offf": offf, "offt": offt,
            "ldf": sum(kf), "ldt": sum(kt), "ldp": sum(kf) + sum(kt)}


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an fp32 tensor (the kernels' tf32_rna): the
    magnitude rounded to 10 mantissa bits, ties away from zero, on the
    int32 view."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(a: torch.Tensor):
    """(hi, lo) = (rna(a), rna(a - hi)): the kernels' split3."""
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _perm_columns(k: int, perm, device) -> torch.Tensor:
    """Column c of a k-wide block holds feature (c & ~7) | perm[c & 7]."""
    c = torch.arange(k, device=device)
    return (c & ~7) | torch.as_tensor(perm, device=device)[c & 7]


def pack_weights_tf32(w_pack, cfg: UDFConfig,
                      transposed: bool = True) -> torch.Tensor:
    """The 3xTF32 kernels' weight pack, (2 x WGMMA_FMAX, ldp) fp32: each
    hidden layer's block of w_pack (forward) and its transpose, at their
    query_tf32_layout columns, the columns of each 8-group in TF32_PERM
    order, zeros past the live rows and columns; hi = rna(w) in the first
    WGMMA_FMAX rows, lo = rna(w - hi) in the rest. Without `transposed`,
    the value kernel's forward-only pack: the first ldf columns alone. The
    plain version of the prologue (pack_tf32_kernel)."""
    lay = query_tf32_layout(cfg)
    dev = w_pack.device
    full = torch.zeros(WGMMA_FMAX, lay["ldp"] if transposed else lay["ldf"],
                       dtype=torch.float32, device=dev)
    off = 0
    for (i, o), kf, kt, cf, c_t in zip(lay["dims"], lay["kf"], lay["kt"],
                                       lay["offf"], lay["offt"]):
        w = w_pack[:o, off: off + i].to(torch.float32)
        off += i
        wf = torch.zeros(o, kf, dtype=torch.float32, device=dev)
        wf[:, :i] = w
        wt = torch.zeros(i, kt, dtype=torch.float32, device=dev)
        wt[:, :o] = w.T
        full[:o, cf: cf + kf] = wf[:, _perm_columns(kf, TF32_PERM, dev)]
        if transposed:
            ct = lay["ldf"] + c_t
            full[:i, ct: ct + kt] = wt[:, _perm_columns(kt, TF32_PERM, dev)]
    hi, lo = split_tf32(full)
    return torch.cat([hi, lo], dim=0)


def unpack_weights_tf32(pack, cfg: UDFConfig):
    """[(W_l (out_l, in_l), W_l^T (in_l, out_l))] per hidden layer from a
    3xTF32 pack: hi + lo in fp32 with the column order undone; W_l^T None
    from a forward-only pack (ldf columns)."""
    lay = query_tf32_layout(cfg)
    whole = pack[:WGMMA_FMAX] + pack[WGMMA_FMAX:]
    inv = [TF32_PERM.index(p) for p in range(8)]
    out = []
    for (i, o), kf, kt, cf, c_t in zip(lay["dims"], lay["kf"], lay["kt"],
                                       lay["offf"], lay["offt"]):
        fwd = whole[:, cf: cf + kf][:, _perm_columns(kf, inv, pack.device)]
        if pack.shape[1] == lay["ldf"]:
            out.append((fwd[:o, :i], None))
            continue
        ct = lay["ldf"] + c_t
        trans = whole[:, ct: ct + kt][:, _perm_columns(kt, inv,
                                                       pack.device)]
        out.append((fwd[:o, :i], trans[:i, :o]))
    return out


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) in fp32 as the 3xTF32 kernels sum it: each
    TF32_CHUNK-deep chunk's k8 steps, lo*hi, hi*lo, then hi*hi, into a
    fresh accumulator that is then added to the running sum (the plain
    twin of one promoted product; a k8 step's own sum order is the tensor
    cores')."""
    k = a.shape[1]
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    for c in range(0, k, TF32_CHUNK):
        part = torch.zeros_like(acc)
        for s in range(c, min(c + TF32_CHUNK, k), 8):
            ks = slice(s, min(s + 8, k))
            part = part + al[:, ks] @ bh[ks]
            part = part + ah[:, ks] @ bl[ks]
            part = part + ah[:, ks] @ bh[ks]
        acc = acc + part
    return acc


def query_tf32_plan(cfg: UDFConfig, n: int) -> dict:
    """Shared memory, registers and device scratch of one launch of the
    3xTF32 query kernels at n points, as csrc/mlp_query_tf32.cu reckons them
    (emap_mlp_query_tf32_sizes), and the ring entries a block streams.
    Raises ValueError for a net they do not take (check_query_cfg) or a
    plan past the block's shared memory, on every device."""
    check_query_cfg(cfg)
    lay = query_tf32_layout(cfg)
    chunk = WGMMA_FMAX // 2 * TF32_CHUNK * 4  # 128 x 32 fp32
    parts = {
        f"weight ring ({TF32_STAGES} stages of 128 x 32 fp32, hi and lo)":
            TF32_STAGES * 2 * chunk,
        "activation tile (64 points x 256 fp32)": 64 * WGMMA_FMAX * 4,
        "d udf / d x-tilde (64 rows x 64 fp32)": QUERY_GIN_ROWS * 64 * 4,
        "head sums and d udf / d y0": (4 * 64 + 64) * 4,
        "mbarriers": 2 * TF32_STAGES * 8, "alignment": 1024,
    }
    smem = sum(parts.values())
    if smem > SMEM_LIMIT:
        raise ValueError(f"the 3xTF32 query kernel needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    # ring entries of a block: each product's chunks x its 128-wide halves,
    # 64 or 128 rows of hi and of lo each
    entries, stream = 0, 0
    for (i, o), kf, kt in zip(lay["dims"], lay["kf"], lay["kt"]):
        for n_out, k in ((o, kf), (i, kt)):
            for h in range(-(-n_out // 128)):
                rows = 128 if n_out - 128 * h > 64 else 64
                entries += k // TF32_CHUNK
                stream += k // TF32_CHUNK * 2 * rows * TF32_CHUNK * 4
    blocks = -(-n // TF32_BLOCK_POINTS)
    return {
        "smem": smem, "smem_parts": parts,
        "registers": dict(TF32_REGISTERS), "blocks": blocks,
        "stages": TF32_STAGES, "pack": 2 * WGMMA_FMAX * lay["ldp"],
        # sigmoid(100 z_l) of each hidden layer: WGMMA_FMAX a point, fp32
        # or bf16 elements
        "side": blocks * len(lay["dims"]) * WGMMA_FMAX * 64,
        "entries_per_block": entries, "stream_bytes_per_block": stream,
    }


def query_tf32_launch_costs(cfg: UDFConfig, n: int,
                            f32_residuals: bool = True) -> dict:
    """Each launch of the 3xTF32 query kernels at n points: the FLOP of its
    products (2 * in * out each, unpadded shapes, forward and reverse; the
    kernel does three TF32 passes of each) and the bytes it must move (each
    input read once, each output written once); beside them the chain
    kernel's sigmoid side-array traffic (written once and read once, the
    live 8-feature groups, fp32 or bf16 as bf16_residuals) and the weight
    chunks its blocks stream from L2 (stream_bytes_per_block x blocks)."""
    lay = query_tf32_layout(cfg)
    dims = layer_dims(cfg)
    shapes = [(i, o) for _, i, o in cfg.layer_shapes()]
    L, rmax, ldw = len(dims), max(o for _, o in dims), sum(
        i for i, _ in dims)
    f32 = 4
    w_bytes, pk_bytes = f32 * rmax * ldw, f32 * 2 * WGMMA_FMAX * lay["ldp"]
    elem = 2 if bf16_residuals(cfg, f32_residuals) else 4
    side = 2 * elem * n * sum(round_up(o, 8) for _, o in dims[:-1])
    plan = query_tf32_plan(cfg, n)
    return {
        "pack": {"flops": 0, "bytes": w_bytes + pk_bytes},
        # points (8, n) in; udf (n,) and grad (8, n) out; the pack, the
        # head's fp32 row and the biases
        "query": {"flops": 4 * sum(i * o for i, o in shapes) * n,
                  "bytes": f32 * 17 * n + pk_bytes + f32 * dims[-1][0]
                  + f32 * rmax * L, "side_bytes": side,
                  "stream_bytes": plan["blocks"]
                  * plan["stream_bytes_per_block"]},
    }


# The 3xTF32 value kernel (csrc/mlp_value_tf32.cu): a persistent grid of
# one block an SM (H100_SMS on the H100), each block a producer warpgroup
# and two consumer warpgroups that walk 64-point tiles through every layer
# together in one fp32 tile, a layer's outputs in passes of 64 (m64n64k8),
# the consumers taking alternate passes, each with a ring of
# VALUE_TF32_STAGES entries of its own (64 output rows x 32 contraction
# steps, hi and lo: 16 KB) fed by a producer warp of its own.
H100_SMS = 132
VALUE_TF32_CONSUMERS = 2
VALUE_TF32_STAGES = 3
VALUE_TF32_PASS = 64  # outputs of a pass: one m64n64 product
# a consumer thread's fp32 registers: a pass's accumulators and its chunk's,
# two sets of split A fragments (4 k8 steps x 4, hi and lo: the next
# chunk's split while the current chunk's products run) and the first
# pass's activated outputs, held until both consumers have read the tile,
# within the 168 registers a thread that ptxas compiles the kernel to (the
# launch bound: 65,536 / 384 threads; setmaxnreg gives the consumers 232
# and the producer warpgroup 40 at run time, not to the compiler)
VALUE_TF32_REGISTERS = {"pass_accumulators": 32, "chunk_accumulators": 32,
                        "a_fragments": 2 * 2 * 4 * 4, "held": 32,
                        "compiled": 168, "consumer": 232, "producer": 40}


def value_tf32_plan(cfg: UDFConfig, n: int, sms: int = H100_SMS) -> dict:
    """Shared memory, registers, launch shape and the weight stream of one
    launch of the 3xTF32 value kernels at n points on a card of `sms` SMs,
    as csrc/mlp_value_tf32.cu reckons them (emap_mlp_value_tf32_sizes):
    the forward-only pack, the ring entries and the bytes a 64-point tile
    streams from L2 (and the 128 x 32 weight chunks they make). Raises
    ValueError for a net the kernels do not take (check_engine_cfg's
    refusals, a skip at the head) or a plan past the block's shared
    memory, on every device."""
    lay = check_engine_cfg(cfg)
    if cfg.n_layers in cfg.skip_in:
        raise ValueError("the 3xTF32 value kernel takes no skip at the head")
    tl = query_tf32_layout(cfg)
    entry = 2 * VALUE_TF32_PASS * TF32_CHUNK * 4  # hi and lo, fp32
    parts = {
        f"weight rings (2 consumers x {VALUE_TF32_STAGES} stages of 64 x "
        f"32 fp32, hi and lo)": VALUE_TF32_CONSUMERS * VALUE_TF32_STAGES
        * entry,
        "activation tile (64 points x 256 fp32)": 64 * WGMMA_FMAX * 4,
        "head sums (2 consumers x 64 points)": VALUE_TF32_CONSUMERS * 64 * 4,
        "mbarriers": 2 * VALUE_TF32_CONSUMERS * VALUE_TF32_STAGES * 8,
        "alignment": 1024,
    }
    smem = sum(parts.values())
    if smem > SMEM_LIMIT:
        raise ValueError(f"the 3xTF32 value kernel needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    # a tile's ring entries: each layer's passes x its chunks
    entries = sum(-(-o // VALUE_TF32_PASS) * kf // TF32_CHUNK
                  for (_, o), kf in zip(lay["dims"][:-1], tl["kf"]))
    chunks = sum(-(-o // 128) * kf // TF32_CHUNK
                 for (_, o), kf in zip(lay["dims"][:-1], tl["kf"]))
    tiles = -(-n // TF32_BLOCK_POINTS)
    return {
        "smem": smem, "smem_parts": parts,
        "registers": dict(VALUE_TF32_REGISTERS),
        "blocks": min(sms, tiles), "tiles": tiles,
        "stages": VALUE_TF32_STAGES, "pack": 2 * WGMMA_FMAX * tl["ldf"],
        "entries_per_tile": entries, "chunks_per_tile": chunks,
        "stream_bytes_per_tile": entries * entry,
    }


def value_tf32_launch_costs(cfg: UDFConfig, n: int) -> dict:
    """Each launch of the 3xTF32 value kernels at n points: the FLOP of its
    products (2 * in * out each, unpadded shapes; the kernel does three
    TF32 passes of each) and the bytes it must move (each input read once,
    each output written once), and beside them the weight entries its
    tiles stream from L2 (stream_bytes_per_tile x tiles)."""
    tl = query_tf32_layout(cfg)
    dims = layer_dims(cfg)
    rmax, ldw = max(o for _, o in dims), sum(i for i, _ in dims)
    f32 = 4
    w_bytes, pk_bytes = f32 * rmax * ldw, f32 * 2 * WGMMA_FMAX * tl["ldf"]
    plan = value_tf32_plan(cfg, n)
    return {
        "pack": {"flops": 0, "bytes": w_bytes + pk_bytes},
        # points (8, n) in, udf (n,) out; the pack, the head's fp32 row and
        # the biases
        "value": {"flops": value_flops(cfg) * n,
                  "bytes": f32 * 9 * n + pk_bytes + f32 * dims[-1][0]
                  + f32 * rmax * len(dims),
                  "stream_bytes": plan["tiles"]
                  * plan["stream_bytes_per_tile"]},
    }


# The bf16 value kernel (csrc/mlp_value_wgmma.cu): the chain engine's ring
# and activation tiles (engine_smem) in a persistent grid of one block an
# SM, each block's two consumer warpgroups taking one 64-point tile each of
# a pair, so each 64 x 128 weight chunk serves WGMMA_BLOCK_POINTS points;
# the biases of up to VALUE_WGMMA_LAYERS hidden layers and the head's row
# wait in shared memory.
VALUE_WGMMA_LAYERS = 15  # csrc/mlp_common.cuh: MAXL - 1
# a consumer thread's fp32 registers: a 128-wide half's running sum and its
# 64-deep chunk's, within the 168 a thread that ptxas compiles a 384-thread
# block to (setmaxnreg gives the consumers 232 and the producer warpgroup
# 40 at run time)
VALUE_WGMMA_REGISTERS = {"accumulators": 64, "chunk_accumulators": 64,
                         "compiled": 168, "consumer": 232, "producer": 40}
# the special function unit's operations a softplus (ex2, lg2), and its
# results a clock an SM on the H100 (NVIDIA's table of the throughput of
# native arithmetic instructions, compute capability 9.0)
VALUE_WGMMA_SFU_OPS = 2
SFU_PER_SM_CLOCK = 16


def value_wgmma_plan(cfg: UDFConfig, n: int, sms: int = H100_SMS) -> dict:
    """Shared memory, registers, launch shape and the weight stream of one
    launch of the bf16 value kernels at n points on a card of `sms` SMs, as
    csrc/mlp_value_wgmma.cu reckons them (emap_mlp_value_wgmma_sizes): the
    bf16 pack (wb elements), the 64-point tiles and their pairs (one a
    block at a time), and the 64 x 128 weight chunks, and their bytes, a
    pair streams from L2. Raises ValueError for a net the kernels do not
    take (check_engine_cfg's refusals, a skip at the head) or a plan past
    the block's shared memory, on every device."""
    lay = check_engine_cfg(cfg)
    if cfg.n_layers in cfg.skip_in:
        raise ValueError("the bf16 value kernel takes no skip at the head")
    dims = lay["dims"]
    parts = dict(engine_smem(), **{
        f"biases ({VALUE_WGMMA_LAYERS} hidden layers x {WGMMA_FMAX} fp32)":
            VALUE_WGMMA_LAYERS * WGMMA_FMAX * 4,
        f"head row ({WGMMA_FMAX} fp32)": WGMMA_FMAX * 4,
    })
    smem = sum(parts.values())
    if smem > SMEM_LIMIT:
        raise ValueError(f"the bf16 value kernel needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    # a pair's chunks: each hidden layer's 128-wide halves x its 64-deep
    # chunks
    chunks = sum(-(-o // 128) * k // 64
                 for (_, o), k in zip(dims[:-1], lay["kpad"]))
    tiles = -(-n // POINT_TILE)
    pairs = -(-tiles // 2)
    return {
        "smem": smem, "smem_parts": parts,
        "registers": dict(VALUE_WGMMA_REGISTERS),
        "blocks": min(sms, pairs), "tiles": tiles, "pairs": pairs,
        "stages": 4, "wb": WGMMA_FMAX * lay["ldwb"],
        "chunks_per_pair": chunks,
        "stream_bytes_per_pair": chunks * 2 * 64 * 64 * 2,
    }


def value_wgmma_launch_costs(cfg: UDFConfig, n: int) -> dict:
    """Each launch of the bf16 value kernels at n points: the FLOP of its
    products (2 * in * out each, unpadded shapes) and the bytes it must move
    (each input read once, each output written once), and beside them the
    weight chunks its pairs of tiles stream from L2 (stream_bytes_per_pair
    x pairs) and the special function unit's operations of its softplus
    (VALUE_WGMMA_SFU_OPS for each hidden output of each point)."""
    lay = wgmma_layout(cfg)
    dims = lay["dims"]
    rmax, ldw = max(o for _, o in dims), sum(i for i, _ in dims)
    f32, bf16 = 4, 2
    w_bytes, wb_bytes = f32 * rmax * ldw, bf16 * WGMMA_FMAX * lay["ldwb"]
    plan = value_wgmma_plan(cfg, n)
    return {
        "pack": {"flops": 0, "bytes": w_bytes + wb_bytes},
        # points (8, n) in, udf (n,) out; the bf16 pack, the head's fp32 row
        # and the biases
        "value": {"flops": value_flops(cfg) * n,
                  "bytes": f32 * 9 * n + wb_bytes + f32 * dims[-1][0]
                  + f32 * rmax * len(dims),
                  "stream_bytes": plan["pairs"]
                  * plan["stream_bytes_per_pair"],
                  "sfu_ops": VALUE_WGMMA_SFU_OPS * n
                  * sum(o for _, o in dims[:-1])},
    }


def _query_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_query")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_value_and_grad_scratch_rows.argtypes = [vp]
        lib.emap_mlp_value_and_grad_scratch_rows.restype = ctypes.c_longlong
        lib.emap_mlp_value_and_grad.argtypes = [
            vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float,
            ctypes.c_int, vp]
        lib.emap_mlp_value_and_grad.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def _query_wgmma_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_query_wgmma")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_query_wgmma_sizes.argtypes = [vp, ctypes.c_longlong, vp]
        lib.emap_mlp_query_wgmma_sizes.restype = ctypes.c_int
        lib.emap_mlp_query_wgmma.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, vp]
        lib.emap_mlp_query_wgmma.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def _query_tf32_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_query_tf32")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_query_tf32_sizes.argtypes = [vp, ctypes.c_longlong, vp]
        lib.emap_mlp_query_tf32_sizes.restype = ctypes.c_int
        lib.emap_mlp_query_tf32.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, vp]
        lib.emap_mlp_query_tf32.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def query_wgmma_sizes(cfg: UDFConfig, n: int) -> dict:
    """The wgmma query library's own reckoning of a launch at n points
    (card only; the CPU reckons query_wgmma_plan): wb, side, smem,
    blocks."""
    out = (ctypes.c_longlong * 4)()
    if _query_wgmma_lib().emap_mlp_query_wgmma_sizes(
            kernel_layout(cfg).ctypes.data, n, out):
        raise ValueError("layout refused by the wgmma query kernel")
    return dict(zip(("wb", "side", "smem", "blocks"), list(out)))


def query_tf32_sizes(cfg: UDFConfig, n: int) -> dict:
    """The 3xTF32 query library's own reckoning of a launch at n points
    (card only; the CPU reckons query_tf32_plan): pack, side, smem,
    blocks."""
    out = (ctypes.c_longlong * 4)()
    if _query_tf32_lib().emap_mlp_query_tf32_sizes(
            kernel_layout(cfg).ctypes.data, n, out):
        raise ValueError("layout refused by the 3xTF32 query kernel")
    return dict(zip(("pack", "side", "smem", "blocks"), list(out)))


def _side(n_elems, cfg, f32_residuals, dev):
    """The sigmoid side arrays' scratch: bf16 where bf16_residuals, else
    fp32."""
    bf16 = bf16_residuals(cfg, f32_residuals)
    return torch.empty(n_elems, device=dev,
                       dtype=torch.bfloat16 if bf16 else torch.float32)


def _launch_wgmma(x_T, w_pack, b_pack, cfg, n, f32_residuals):
    """(udf, grad, scratch): the wgmma launches and the scratch they
    wrote."""
    lib = _query_wgmma_lib()
    plan = query_wgmma_plan(cfg, n)
    dev = x_T.device
    udf = torch.empty(n, device=dev, dtype=torch.float32)
    grad = torch.empty(8, n, device=dev, dtype=torch.float32)
    wb = torch.empty(plan["wb"], device=dev, dtype=torch.bfloat16)
    side = _side(plan["side"], cfg, f32_residuals, dev)
    err = lib.emap_mlp_query_wgmma(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), udf.data_ptr(),
        grad.data_ptr(), wb.data_ptr(), side.data_ptr(), n,
        kernel_layout(cfg).ctypes.data, float(cfg.scale), 1,
        int(bf16_residuals(cfg, f32_residuals)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_query_wgmma kernel launch failed: CUDA "
                           f"error {err}")
    return udf, grad, {"wb": wb.view(WGMMA_FMAX, -1), "side": side}


def _launch_tf32(x_T, w_pack, b_pack, cfg, n, f32_residuals):
    """(udf, grad, scratch): the 3xTF32 launches and the pack they
    wrote."""
    lib = _query_tf32_lib()
    plan = query_tf32_plan(cfg, n)
    dev = x_T.device
    udf = torch.empty(n, device=dev, dtype=torch.float32)
    grad = torch.empty(8, n, device=dev, dtype=torch.float32)
    pack = torch.empty(plan["pack"], device=dev, dtype=torch.float32)
    side = _side(plan["side"], cfg, f32_residuals, dev)
    err = lib.emap_mlp_query_tf32(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), udf.data_ptr(),
        grad.data_ptr(), pack.data_ptr(), side.data_ptr(), n,
        kernel_layout(cfg).ctypes.data, float(cfg.scale), 0,
        int(bf16_residuals(cfg, f32_residuals)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_query_tf32 kernel launch failed: CUDA "
                           f"error {err}")
    return udf, grad, {"pack": pack.view(2 * WGMMA_FMAX, -1), "side": side}


def _launch_mma_sync(x_T, w_pack, b_pack, cfg, n, tier):
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
        float(cfg.scale), tier, stream)
    if err:
        raise RuntimeError(f"mlp_query kernel launch failed: CUDA error {err}")
    return udf, grad


def value_and_grad(x_T, w_pack, b_pack, cfg: UDFConfig,
                   f32_residuals: bool = True):
    """(udf (N,), grad (8, N)) at raw points x_T (8, N), at cfg.precision,
    with the sigmoid residuals as bf16_residuals(cfg, f32_residuals) says.
    CPU tensors take value_and_grad_plain; CUDA tensors launch the kernels:
    mlp_query_wgmma.cu's at the bf16 tier, mlp_query_tf32.cu's at
    3xTF32."""
    if not x_T.is_cuda:
        return value_and_grad_plain(x_T, w_pack, b_pack, cfg, f32_residuals)
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    tier = kernel_tier(cfg.precision)
    launch = _launch_wgmma if tier == 1 else _launch_tf32
    udf, grad = launch(x_T, w_pack, b_pack, cfg, n, f32_residuals)[:2]
    value_and_grad.launches += 1
    value_and_grad.tier_launches[TIER_NAMES[tier]] += 1
    return udf, grad


value_and_grad.launches = 0
value_and_grad.tier_launches = dict.fromkeys(TIER_NAMES, 0)


def value_and_grad_wgmma_parts(x_T, w_pack, b_pack, cfg: UDFConfig,
                               f32_residuals: bool = True):
    """One launch of #1a's wgmma kernels on CUDA tensors at cfg (the bf16
    tier) with what each launch wrote: udf, grad, wb (the prologue's bf16
    pack) and side (the sigmoid residuals: side_residuals), to hold each
    launch against its plain version. Counted in no launch count; no path
    calls it."""
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    if kernel_tier(cfg.precision) != 1:
        raise ValueError("the wgmma query kernels run the bf16 tier only")
    udf, grad, scratch = _launch_wgmma(x_T, w_pack, b_pack, cfg, n,
                                       f32_residuals)
    return dict(scratch, udf=udf, grad=grad)


def value_and_grad_tf32_parts(x_T, w_pack, b_pack, cfg: UDFConfig,
                              f32_residuals: bool = True):
    """One launch of the 3xTF32 query kernels on CUDA tensors at cfg
    ("high" or "highest") with what each launch wrote: udf, grad, pack (the
    prologue's pre-split pack) and side (the sigmoid residuals:
    side_residuals), to hold each launch against its plain version. Counted
    in no launch count; no path calls it."""
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    if kernel_tier(cfg.precision) != 0:
        raise ValueError("the 3xTF32 query kernels run the fp32 tiers only")
    udf, grad, scratch = _launch_tf32(x_T, w_pack, b_pack, cfg, n,
                                      f32_residuals)
    return dict(scratch, udf=udf, grad=grad)


def value_and_grad_mma_sync(x_T, w_pack, b_pack, cfg: UDFConfig):
    """csrc/mlp_query.cu at cfg's tier, on CUDA tensors, with fp32
    residuals: the mma.sync design timed beside the wgmma kernels. Counted
    in no launch count; no path calls it."""
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    return _launch_mma_sync(x_T, w_pack, b_pack, cfg, n,
                            kernel_tier(cfg.precision))


def value_and_grad_sliced(x_T, w_pack, b_pack, cfg: UDFConfig,
                          cap: int = SLICE_CAP, f32_residuals: bool = False):
    """value_and_grad over slices of at most `cap` points (a multiple of
    POINT_TILE), concatenated: one launch per slice on the card, so the
    kernel's scratch never exceeds `cap` points' worth. Points are
    independent, so the result does not depend on the slicing. The
    residuals default to the JAX extraction query's
    (pallas_udf_value_and_grad: f32_residuals=False)."""
    n = x_T.shape[1]
    if cap <= 0 or cap % POINT_TILE:
        raise ValueError(f"cap must be a positive multiple of {POINT_TILE}")
    if n <= cap:
        return value_and_grad(x_T, w_pack, b_pack, cfg, f32_residuals)
    parts = [value_and_grad(x_T[:, s: s + cap].contiguous(), w_pack, b_pack,
                            cfg, f32_residuals) for s in range(0, n, cap)]
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
            vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float,
            ctypes.c_int, vp]
        lib.emap_mlp_value.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def _value_tf32_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_value_tf32")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_value_tf32_sizes.argtypes = [vp, ctypes.c_longlong, vp]
        lib.emap_mlp_value_tf32_sizes.restype = ctypes.c_int
        lib.emap_mlp_value_tf32.argtypes = [
            vp, vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float,
            ctypes.c_int, vp]
        lib.emap_mlp_value_tf32.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def _value_wgmma_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_value_wgmma")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_value_wgmma_sizes.argtypes = [vp, ctypes.c_longlong, vp]
        lib.emap_mlp_value_wgmma_sizes.restype = ctypes.c_int
        lib.emap_mlp_value_wgmma.argtypes = [
            vp, vp, vp, vp, vp, ctypes.c_longlong, vp, ctypes.c_float,
            ctypes.c_int, vp]
        lib.emap_mlp_value_wgmma.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def value_wgmma_sizes(cfg: UDFConfig, n: int) -> dict:
    """The bf16 value library's own reckoning of a launch at n points on the
    current card (card only; the CPU reckons value_wgmma_plan): wb, smem,
    blocks, tiles."""
    out = (ctypes.c_longlong * 4)()
    if _value_wgmma_lib().emap_mlp_value_wgmma_sizes(
            kernel_layout(cfg).ctypes.data, n, out):
        raise ValueError("layout refused by the bf16 value kernel")
    return dict(zip(("wb", "smem", "blocks", "tiles"), list(out)))


def value_tf32_sizes(cfg: UDFConfig, n: int) -> dict:
    """The 3xTF32 value library's own reckoning of a launch at n points on
    the current card (card only; the CPU reckons value_tf32_plan): pack,
    smem, blocks, tiles."""
    out = (ctypes.c_longlong * 4)()
    if _value_tf32_lib().emap_mlp_value_tf32_sizes(
            kernel_layout(cfg).ctypes.data, n, out):
        raise ValueError("layout refused by the 3xTF32 value kernel")
    return dict(zip(("pack", "smem", "blocks", "tiles"), list(out)))


def _launch_value_tf32(x_T, w_pack, b_pack, cfg, n):
    """(udf, scratch): the 3xTF32 value launches and the pack they
    wrote."""
    lib = _value_tf32_lib()
    plan = value_tf32_plan(cfg, n)
    dev = x_T.device
    udf = torch.empty(n, device=dev, dtype=torch.float32)
    pack = torch.empty(plan["pack"], device=dev, dtype=torch.float32)
    err = lib.emap_mlp_value_tf32(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), udf.data_ptr(),
        pack.data_ptr(), n, kernel_layout(cfg).ctypes.data,
        float(cfg.scale), 0, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_value_tf32 kernel launch failed: CUDA "
                           f"error {err}")
    return udf, {"pack": pack.view(2 * WGMMA_FMAX, -1)}


def _launch_value_wgmma(x_T, w_pack, b_pack, cfg, n):
    """(udf, scratch): the bf16 value launches and the pack they wrote."""
    lib = _value_wgmma_lib()
    plan = value_wgmma_plan(cfg, n)
    dev = x_T.device
    udf = torch.empty(n, device=dev, dtype=torch.float32)
    wb = torch.empty(plan["wb"], device=dev, dtype=torch.bfloat16)
    err = lib.emap_mlp_value_wgmma(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), udf.data_ptr(),
        wb.data_ptr(), n, kernel_layout(cfg).ctypes.data, float(cfg.scale), 1,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_value_wgmma kernel launch failed: CUDA "
                           f"error {err}")
    return udf, {"wb": wb.view(WGMMA_FMAX, -1)}


def _launch_value_mma_sync(x_T, w_pack, b_pack, cfg, n, tier):
    lib = _value_lib()
    layout = kernel_layout(cfg)
    if lib.emap_mlp_value_smem_bytes(layout.ctypes.data) < 0:
        raise ValueError("layout refused by the kernel")
    dev = x_T.device
    udf = torch.empty(n, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.emap_mlp_value(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), udf.data_ptr(),
        n, layout.ctypes.data, float(cfg.scale), tier, stream)
    if err:
        raise RuntimeError(f"mlp_value kernel launch failed: CUDA error {err}")
    return udf


def value(x_T, w_pack, b_pack, cfg: UDFConfig):
    """udf (N,) at raw points x_T (8, N), at cfg.precision. CPU tensors take
    value_plain; CUDA tensors launch the kernels: mlp_value_tf32.cu's at
    the 3xTF32 tier, mlp_value_wgmma.cu's at the bf16 tier."""
    if not x_T.is_cuda:
        return value_plain(x_T, w_pack, b_pack, cfg)
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    tier = kernel_tier(cfg.precision)
    launch = _launch_value_wgmma if tier == 1 else _launch_value_tf32
    udf = launch(x_T, w_pack, b_pack, cfg, n)[0]
    value.launches += 1
    value.tier_launches[TIER_NAMES[tier]] += 1
    return udf


value.launches = 0
value.tier_launches = dict.fromkeys(TIER_NAMES, 0)


def value_tf32_parts(x_T, w_pack, b_pack, cfg: UDFConfig):
    """One launch of the 3xTF32 value kernels on CUDA tensors at cfg
    ("high" or "highest") with what each launch wrote: udf and pack (the
    prologue's forward-only pack), to hold each launch against its plain
    version. Counted in no launch count; no path calls it."""
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    if kernel_tier(cfg.precision) != 0:
        raise ValueError("the 3xTF32 value kernels run the fp32 tiers only")
    udf, scratch = _launch_value_tf32(x_T, w_pack, b_pack, cfg, n)
    return dict(scratch, udf=udf)


def value_wgmma_parts(x_T, w_pack, b_pack, cfg: UDFConfig):
    """One launch of the bf16 value kernels on CUDA tensors at cfg
    ("default") with what each launch wrote: udf and wb (the prologue's
    bf16 pack), to hold each launch against its plain version. Counted in
    no launch count; no path calls it."""
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    if kernel_tier(cfg.precision) != 1:
        raise ValueError("the bf16 value kernels run the bf16 tier only")
    udf, scratch = _launch_value_wgmma(x_T, w_pack, b_pack, cfg, n)
    return dict(scratch, udf=udf)


def value_mma_sync(x_T, w_pack, b_pack, cfg: UDFConfig):
    """csrc/mlp_value.cu at cfg's tier, on CUDA tensors: the mma.sync design
    timed beside mlp_value_tf32.cu (3xTF32) and mlp_value_wgmma.cu (bf16).
    Counted in no launch count; no path calls it."""
    n = check_operands(cfg, (x_T, w_pack, b_pack))
    return _launch_value_mma_sync(x_T, w_pack, b_pack, cfg, n,
                                  kernel_tier(cfg.precision))


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


def query_value_and_grad(params, pts, cfg: UDFConfig, cap: int = SLICE_CAP,
                         f32_residuals: bool = False):
    """(udf (M,), grad (M, 3)) at (M, 3) points through the sliced
    value-and-gradient kernel: the counterpart of pallas_udf_value_and_grad,
    with its bf16 sigmoid residuals unless f32_residuals. No autograd
    graph."""
    x_T, w_pack, b_pack, m = _packed_points(params, pts, cfg)
    udf, grad = value_and_grad_sliced(x_T, w_pack, b_pack, cfg, cap,
                                      f32_residuals)
    return udf[:m], grad[:3, :m].T


def query_flops(cfg: UDFConfig) -> int:
    """FLOP a point of the fused query: forward and reverse products,
    2 * in * out each (the elementwise work is not counted)."""
    return 4 * sum(i * o for _, i, o in cfg.layer_shapes())


def value_flops(cfg: UDFConfig) -> int:
    """FLOP a point of the value kernel: the forward products only."""
    return 2 * sum(i * o for _, i, o in cfg.layer_shapes())


__all__ = [
    "POINT_TILE", "SLICE_CAP", "TIER_NAMES", "kernel_tier",
    "tier_dot", "fold_weights", "pack_weights",
    "unpack_weights", "pe_perm", "blocked_pe_columns", "layer_dims",
    "kernel_layout", "value_and_grad", "value_and_grad_plain",
    "value_and_grad_sliced", "value_and_grad_mma_sync",
    "value_and_grad_wgmma_parts", "value_and_grad_tf32_parts", "value",
    "value_plain", "query_value", "query_value_and_grad", "query_flops",
    "value_flops", "wgmma_layout", "pack_weights_bf16", "query_wgmma_plan",
    "query_wgmma_launch_costs", "bf16_residuals", "query_tf32_layout",
    "pack_weights_tf32", "unpack_weights_tf32", "tf32x3_matmul",
    "query_tf32_plan", "query_tf32_launch_costs", "plain_residuals",
    "side_residuals", "value_tf32_plan", "value_tf32_launch_costs",
    "value_tf32_parts", "value_mma_sync", "value_wgmma_plan",
    "value_wgmma_launch_costs", "value_wgmma_parts",
]
