"""The port's CUDA kernels on the card, against their plain PyTorch
versions and against plain autograd. Marked `cuda`: they skip without a
GPU. This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq
from emap_tpu_torch.kernels import mlp_train as tt

CFGS = {
    "toy-abs": tudf.UDFConfig(d_hidden=64, n_layers=8, multires=6),
    "toy-square": tudf.UDFConfig(d_hidden=64, n_layers=8, multires=6,
                                 udf_type="square"),
    "abc": tudf.UDFConfig(),
}


def max_rel(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def net(cfg, device):
    """Geometric init plus seeded noise, so no layer sits at its init
    pattern."""
    gen = torch.Generator().manual_seed(0)
    params = tudf.init_udf_params(gen, cfg, device="cpu")
    return {k: {n: (t + 0.05 * torch.randn(t.shape, generator=gen))
                .to(device) for n, t in layer.items()}
            for k, layer in params.items()}


def points(n, device, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, n), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, n))
    ubar = rng.normal(size=(1, n)).astype(np.float32)
    gbar = np.zeros((8, n), np.float32)
    gbar[:3] = rng.normal(size=(3, n))
    return (torch.as_tensor(a).to(device) for a in (x, ubar, gbar))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_kernels_match_plain(cuda, name):
    """Both kernels against their plain versions on the same inputs (max
    rel 1e-4: float32 sums in another order, measured ~1e-6) and one launch
    counted each. The weight and bias gradients are held layer by layer,
    each block against its own largest entry."""
    cfg = CFGS[name]
    x, ubar, gbar = points(4096, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))

    def blocks(out, bwd):
        u, g = out
        return [u, g] + [t for layer in tq.unpack_weights(*bwd, cfg)
                         for t in layer]

    before = (tq.value_and_grad.launches, tt.train_bwd.launches)
    got = blocks(tq.value_and_grad(x, w, b, cfg),
                 tt.train_bwd(x, w, b, ubar, gbar, cfg))
    torch.cuda.synchronize()
    want = blocks(tq.value_and_grad_plain(x, w, b, cfg),
                  tt.train_bwd_plain(x, w, b, ubar, gbar, cfg))
    assert len(want) == 2 + 2 * len(tq.layer_dims(cfg))
    for i, (g, wt) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all())
        assert max_rel(g, wt) < 1e-4, i
    assert (tq.value_and_grad.launches, tt.train_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_train_query_grads_match_autograd(cuda):
    """(g, v, b) gradients of a loss on the value and the spatial gradient:
    the kernel pair through its autograd.Function vs double-backward
    autograd of the plain field, <= 3e-4 max rel per leaf (the bound the
    JAX package holds its fused kernels to)."""
    cfg = CFGS["toy-abs"]
    rng = np.random.default_rng(2)
    n = 1000  # not a multiple of the 64-point tile: padding is exercised
    pts = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32,
                          device=cuda)
    w_u = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                          device=cuda)
    w_g = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                          device=cuda)

    def grads(query):
        params = net(cfg, cuda)
        leaves = [t.requires_grad_(True) for layer in params.values()
                  for t in layer.values()]
        u, g = query(params, pts, cfg)
        loss = (torch.sum(w_u * u) + torch.sum(w_g * g)
                + 0.1 * torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2))
        return torch.autograd.grad(loss, leaves)

    for gk, ga in zip(grads(tt.udf_train_value_and_gradient),
                      grads(tudf.udf_value_and_gradient)):
        assert max_rel(gk, ga) < 3e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [262_144, 300_032])
def test_cuda_extraction_kernels_match_plain(cuda, n):
    """At ABC width: the value kernel, and the value-and-gradient kernel
    through the extraction's slicing wrapper (one launch per SLICE_CAP
    points), against their plain versions, max rel 1e-4 per output. Above
    the cap the slices concatenate to the unsliced launch bit for bit (each
    point is computed alone)."""
    cfg = CFGS["abc"]
    x, _, _ = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = (tq.value.launches, tq.value_and_grad.launches)
    u = tq.value(x, w, b, cfg)
    us, gs = tq.value_and_grad_sliced(x, w, b, cfg)
    torch.cuda.synchronize()
    slices = -(-n // tq.SLICE_CAP)
    assert (tq.value.launches, tq.value_and_grad.launches) == (
        before[0] + 1, before[1] + slices)
    up = tq.value_plain(x, w, b, cfg)
    uvp, gvp = tq.value_and_grad_plain(x, w, b, cfg)
    for got, want in ((u, up), (us, uvp), (gs, gvp)):
        assert bool(torch.isfinite(got).all())
        assert max_rel(got, want) < 1e-4
    if slices > 1:
        uu, gu = tq.value_and_grad(x, w, b, cfg)
        assert torch.equal(us, uu) and torch.equal(gs, gu)


@pytest.mark.cuda
def test_cuda_point_queries_pad_to_the_tile(cuda):
    """query_value / query_value_and_grad on (M, 3) points with M not a
    multiple of the 64-point tile, against the plain field and autograd."""
    cfg = CFGS["toy-abs"]
    params = net(cfg, cuda)
    pts = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (1000, 3)),
                          dtype=torch.float32, device=cuda)
    u = tq.query_value(params, pts, cfg)
    uv, g = tq.query_value_and_grad(params, pts, cfg, cap=256)
    ua, ga = tudf.udf_value_and_gradient(params, pts, cfg)
    assert u.shape == uv.shape == (1000,) and g.shape == (1000, 3)
    assert max_rel(u, ua.detach()) < 1e-4 and max_rel(uv, ua.detach()) < 1e-4
    assert max_rel(g, ga.detach()) < 1e-4
