"""The numeric design of the field query's tensor-core kernels
(emap_tpu_torch/csrc/mlp_mma.cuh), emulated on the CPU at ABC width.

The kernels split every operand x of a matrix product into hi = rna(x) and
lo = rna(x - hi), rna the rounding of `cvt.rna.tf32.f32` (10 mantissa
bits, ties away from zero), and sum lo*hi + hi*lo + hi*hi in fp32. A
product of two TF32 values is exact in fp32, so fp32 matmuls of the split
operands reproduce the tensor cores up to the order of the sums. Here every
torch.matmul of the plain versions (kernels/mlp_query.py::
value_and_grad_plain and value_plain, kernels/mlp_train.py::
train_bwd_plain) runs that way,
and the result is held block by block against the fp32 plain versions and
against the JAX package's Pallas kernels at precision "highest" in
interpret mode. The tensor cores' truncating accumulation is not emulated:
tests/test_torch_cuda.py holds the kernels themselves on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu.fields import udf as judf
from emap_tpu.kernels import mlp_query as jq
from emap_tpu.kernels import mlp_train as jt
from emap_tpu_torch.ckpt.convert import params_from_numpy
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq
from emap_tpu_torch.kernels import mlp_train as tt

N = 256  # two 128-point tiles of the interpret-mode Pallas kernels
# 3xTF32 against fp32: the split drops lo*lo and rounds lo, ~2^-22 of each
# product, far below the 1e-4 gate the card holds the kernels to; the sums
# of 256-wide dot products and of 256 points add fp32 roundoff of their own
# order. 1e-5 a block leaves room for both and catches a dropped cross
# term (~2^-11).
RTOL = 1e-5


# cvt.rna.tf32.f32 on an fp32 tensor and the kernels' split3, as the
# 3xTF32 pack's plain version computes them
tf32_rna = tq.tf32_rna
split3 = tq.split_tf32


def matmul_3xtf32(matmul):
    def mm(a, b):
        ah, al = split3(a)
        bh, bl = split3(b)
        return (matmul(al, bh) + matmul(ah, bl)) + matmul(ah, bh)
    return mm


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.fixture(scope="module")
def abc():
    """(JAX cfg at "highest", port cfg, packed JAX weights, packed port
    weights, points, ubar, gbar, JAX params): the ABC-width net with seeded
    noise on every weight, 256 points from a numpy seed."""
    jcfg = judf.UDFConfig(precision="highest")
    tcfg = tudf.UDFConfig()
    jp = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(0),
                                                       jcfg))
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape))
                      .astype(np.float32), jp)
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, tcfg, device="cpu")["udf"]
    wj, bj = jq.pack_weights(jax.tree.map(jnp.asarray, jp), jcfg,
                             fuse_pe=True)
    wt, bt = (t.detach() for t in tq.pack_weights(tp, tcfg, fuse_pe=True))
    x = np.zeros((8, N), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, N))
    ubar = rng.normal(size=(1, N)).astype(np.float32)
    gbar = np.zeros((8, N), np.float32)
    gbar[:3] = rng.normal(size=(3, N))
    return jcfg, tcfg, (wj, bj), (wt, bt), x, ubar, gbar, jp


def test_tf32_split_is_exact_to_fp32_roundoff():
    """rna keeps 10 mantissa bits with ties away from zero; hi + lo
    carries x to ~2^-22, and each half is a TF32 value."""
    one = torch.tensor([1.0, -1.0], dtype=torch.float32)
    tie = one * (1.0 + 2.0 ** -11)  # halfway between two TF32 values
    below = torch.nextafter(tie, torch.zeros_like(tie))
    assert torch.equal(tf32_rna(tie), one * (1.0 + 2.0 ** -10))
    assert torch.equal(tf32_rna(below), one)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=4096)
                        .astype(np.float32))
    hi, lo = split3(x)
    for half in (hi, lo):
        assert int((half.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21


def test_3xtf32_value_and_grad_at_abc_width(abc, monkeypatch):
    """The forward + spatial-gradient math with 3xTF32 products against
    fp32 (value_and_grad_plain) and the Pallas kernel at "highest"."""
    jcfg, tcfg, (wj, bj), (wt, bt), x, _, _, _ = abc
    xt = torch.as_tensor(x)
    u32, g32 = tq.value_and_grad_plain(xt, wt, bt, tcfg)
    monkeypatch.setattr(torch, "matmul", matmul_3xtf32(torch.matmul))
    u3, g3 = tq.value_and_grad_plain(xt, wt, bt, tcfg)
    monkeypatch.undo()
    uj, gj = jq._pallas_value_and_grad(jnp.asarray(x), wj, bj, jcfg, 128,
                                       True, f32_residuals=True, fuse_pe=True)
    assert not torch.equal(g3, g32)  # the emulation did run
    for got, f32, ref in ((u3, u32, uj), (g3, g32, gj)):
        assert max_rel(got, f32) < RTOL
        assert max_rel(got, ref) < RTOL


def test_3xtf32_value_at_abc_width(abc, monkeypatch):
    """The grid value kernel's math (encode, 8 hidden products, head) with
    3xTF32 products against fp32 (value_plain) and the Pallas value kernel
    at "highest" (host PE, unpermuted weights, as pallas_udf_value calls
    it)."""
    jcfg, tcfg, _, (wt, bt), x, _, _, jp = abc
    xt = torch.as_tensor(x)
    u32 = tq.value_plain(xt, wt, bt, tcfg)
    monkeypatch.setattr(torch, "matmul", matmul_3xtf32(torch.matmul))
    u3 = tq.value_plain(xt, wt, bt, tcfg)
    monkeypatch.undo()
    wj, bj = jq.pack_weights(jax.tree.map(jnp.asarray, jp), jcfg)
    uj = jq._pallas_value(jq._encode_host(jnp.asarray(x[:3].T), jcfg), wj,
                          bj, jcfg, 128, True)
    assert not torch.equal(u3, u32)  # the emulation did run
    assert max_rel(u3, u32) < RTOL
    assert max_rel(u3, uj) < RTOL


def test_3xtf32_train_bwd_at_abc_width(abc, monkeypatch):
    """The second-order backward's math (forward recompute, the four
    chains, the weight-gradient contraction over the points) with 3xTF32
    products against fp32 (train_bwd_plain) and the Pallas kernel at
    "highest", each layer's W-bar and b-bar block against its own largest
    entry."""
    jcfg, tcfg, (wj, bj), (wt, bt), x, ubar, gbar, _ = abc
    args = (torch.as_tensor(x), wt, bt, torch.as_tensor(ubar),
            torch.as_tensor(gbar), tcfg)
    f32 = tt.train_bwd_plain(*args)
    monkeypatch.setattr(torch, "matmul", matmul_3xtf32(torch.matmul))
    got = tt.train_bwd_plain(*args)
    monkeypatch.undo()
    ref = jt._pallas_train_bwd(jnp.asarray(x), wj, bj, jnp.asarray(ubar),
                               jnp.asarray(gbar), jcfg, 128, True,
                               fuse_pe=True)
    ref = tuple(torch.as_tensor(np.array(r)) for r in ref)
    assert not torch.equal(got[0], f32[0])
    blocks = [tq.unpack_weights(*out, tcfg) for out in (got, f32, ref)]
    assert len(blocks[0]) == 9
    for l, (g, f, r) in enumerate(zip(*blocks)):
        for i, name in enumerate(("W", "b")):
            assert max_rel(g[i], f[i]) < RTOL, (l, name)
            assert max_rel(g[i], r[i]) < RTOL, (l, name)
