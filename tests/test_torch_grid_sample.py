"""The routing of dreamfusion_torch.ops.grid_sample.grid_sample_3d, on the
CPU.

On CPU tensors grid_sample_3d is the plain version, bit for bit. The
kernel route (kernel G, CUDA only) is driven here through its autograd
Function with plain stand-ins for the two launches, by a fixture that
lets CPU float32 grids take the route: a query whose position needs no
gradient (DVGO's render, its backward) goes through the Function, one
whose position does (the editing field's and OSR's autograd normals, a
position that requires grad) keeps the written-out gather, and torch's
deterministic mode swaps the atomic backward for the ordered one. The
kernels themselves are compared with the plain version on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from dreamfusion_torch.ops import grid_sample as gs


def _inputs(C, seed=0, n=(6, 40)):
    """A [C, 7, 6, 5] grid and positions [*n, 3] in [-0.3, 1.3] (past the
    box on every side), some exactly on the faces."""
    g = torch.Generator().manual_seed(seed)
    grid = torch.randn(C, 7, 6, 5, generator=g)
    x = torch.rand(*n, 3, generator=g) * 1.6 - 0.3
    x.view(-1, 3)[:4] = torch.tensor([[0.0, 0.5, 1.0], [1.0, 1.0, 1.0],
                                  [0.0, 0.0, 0.0], [0.25, 1.0, 0.0]])
    return grid, x


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU float32 grids take the kernel route, with the plain version and
    the ordered backward standing in for kernel G's launches; returns the
    stand-ins' call counts."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(grid, x01):
        calls["fwd"] += 1
        return gs.grid_sample_3d_plain(grid, x01)

    def bwd(x01, cot, shape):
        calls["bwd"] += 1
        return gs.grid_sample_bwd_ordered(x01, cot, shape)

    monkeypatch.setattr(gs, "kernel_grid",
                        lambda grid: grid.dtype == torch.float32)
    monkeypatch.setattr(gs, "grid_sample_fwd_cuda", fwd)
    monkeypatch.setattr(gs, "grid_sample_bwd_cuda", bwd)
    return calls


def _grads(fn, grid, x, cot, x_grad=False):
    """(out, d grid, d x or None) of sum(fn(grid, x) * cot)."""
    grid = grid.clone().requires_grad_(True)
    x = x.clone().requires_grad_(x_grad)
    out = fn(grid, x)
    (out * cot).sum().backward()
    return out.detach(), grid.grad, x.grad


@pytest.mark.parametrize("C", [1, 12])
def test_cpu_route_is_the_plain_version_bitwise(C):
    grid, x = _inputs(C)
    cot = torch.randn(*x.shape[:-1], C)
    for x_grad in (False, True):
        got = _grads(gs.grid_sample_3d, grid, x, cot, x_grad)
        want = _grads(gs.grid_sample_3d_plain, grid, x, cot, x_grad)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
    assert not gs.kernel_grid(grid)


@pytest.mark.parametrize("differentiable", [True, False])
@pytest.mark.parametrize("requires_grad", [True, False])
@pytest.mark.parametrize("grad_mode", [True, False])
def test_position_needs_grad(differentiable, requires_grad, grad_mode):
    x = torch.rand(4, 3, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_mode):
        got = gs.position_needs_grad(x, differentiable)
    assert got == (differentiable and requires_grad and grad_mode)


@pytest.mark.parametrize("deterministic", [False, True])
@pytest.mark.parametrize("C", [1, 12])
def test_kernel_route_matches_plain(kernel_route, C, deterministic):
    """The Function's forward is the stand-in's, reshaped to the position's
    prefix; its grid gradient equals autograd's through the plain gather,
    with DVGO's masked (all-zero) cotangents skipped; the position gets no
    gradient; deterministic mode takes the ordered backward."""
    grid, x = _inputs(C, seed=C)
    mask = ((x < 0) | (x > 1)).any(-1, keepdim=True)
    cot = torch.where(mask, 0.0, torch.randn(*x.shape[:-1], C))
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        out, d_grid, _ = _grads(gs.grid_sample_3d, grid, x, cot)
    finally:
        torch.use_deterministic_algorithms(before)
    assert kernel_route == {"fwd": 1, "bwd": 0 if deterministic else 1}
    out_p, d_p, _ = _grads(gs.grid_sample_3d_plain, grid, x, cot)
    assert out.shape == out_p.shape and torch.equal(out, out_p)
    torch.testing.assert_close(d_grid, d_p, rtol=0,
                               atol=1e-6 * float(d_p.abs().max()))
    # differentiable=True with a position that requires grad, but under
    # no_grad: the kernel route, no gradient kept
    with torch.no_grad():
        gs.grid_sample_3d(grid, x.clone().requires_grad_(True))
    assert kernel_route["fwd"] == 2


def test_ordered_backward_matches_autograd():
    """grid_sample_bwd_ordered against autograd's backward of the plain
    gather: all-zero rows skipped, a NaN cotangent kept (it reaches its
    8 corners as it does through the plain gather)."""
    grid, x = _inputs(3, seed=5, n=(200,))
    cot = torch.randn(200, 3)
    cot[10:150] = 0.0
    cot[160, 1] = float("nan")
    cot[170, 0] = 0.0
    _, d_p, _ = _grads(gs.grid_sample_3d_plain, grid, x, cot)
    d = gs.grid_sample_bwd_ordered(x, cot, grid.shape)
    assert d.shape == grid.shape and d.is_contiguous()
    assert int(d.isnan().sum()) == int(d_p.isnan().sum()) > 0
    finite = d_p.isfinite()
    torch.testing.assert_close(d, d_p, rtol=0, equal_nan=True,
                               atol=1e-6 * float(d_p[finite].abs().max()))
    zero = gs.grid_sample_bwd_ordered(x, torch.zeros_like(cot), grid.shape)
    assert torch.equal(zero, torch.zeros_like(grid))


def _dvgo_field(seed=0):
    from dreamfusion_torch.models.dvgo import DVGOField

    f = DVGOField(world_size=(10, 9, 8), k0_dim=4, rgbnet_name="resmlp",
                  rgbnet_width=16, posbase_pe=2, viewbase_pe=2,
                  alpha_init=1e-2)
    f.reset_parameters(torch.Generator().manual_seed(seed))
    return f


def _dvgo_step(field):
    """Loss and gradients of one render of 24 rays from z = 3 toward the
    box (most samples past it)."""
    rng = np.random.default_rng(0)
    o = torch.from_numpy((np.array([[0.1, 0.2, 3.0]])
                          + 0.1 * rng.normal(size=(24, 3))).astype(np.float32))
    d = torch.from_numpy((np.array([[0.0, 0.0, -1.0]])
                          + 0.2 * rng.normal(size=(24, 3))).astype(np.float32))
    field.zero_grad()
    r = field.render(o, d, d / d.norm(dim=-1, keepdim=True), near=2.0,
                     far=6.0, bg=1.0, n_samples=48,
                     jitter=torch.full((24, 1), 0.5))
    loss = ((r["rgb_marched"] - 0.3) ** 2).mean() + r["raw_alpha"].mean()
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in field.named_parameters()}


def test_dvgo_render_takes_the_kernel_route(kernel_route, monkeypatch):
    """DVGO's render samples the density at every sample and k0 at the
    live ones, neither with a position gradient: 2 forwards and 2
    backwards, each of them the Function's, with the plain route's loss
    and gradients."""
    loss, grads = _dvgo_step(_dvgo_field())
    assert kernel_route == {"fwd": 2, "bwd": 2}
    monkeypatch.setattr(gs, "kernel_grid", lambda grid: False)
    loss_p, grads_p = _dvgo_step(_dvgo_field())
    assert kernel_route == {"fwd": 2, "bwd": 2}
    assert torch.equal(loss, loss_p)
    for k in grads_p:
        torch.testing.assert_close(
            grads[k], grads_p[k], rtol=0,
            atol=1e-6 * float(grads_p[k].abs().max()) + 1e-12, msg=k)


def test_position_gradients_keep_the_plain_gather(kernel_route, monkeypatch):
    """A position that requires grad, the editing field's autograd normal
    and OSR's second-order normal (create_graph) take the written-out
    gather: no stand-in runs, and each gives the plain route's values and
    gradients bit for bit."""
    from dreamfusion_torch.models.kailu import DVGOEditNetwork
    from dreamfusion_torch.models.zoo import get_field

    grid, x = _inputs(2, seed=7)
    cot = torch.randn(*x.shape[:-1], 2)
    got = _grads(gs.grid_sample_3d, grid, x, cot, x_grad=True)
    assert kernel_route == {"fwd": 0, "bwd": 0}

    g = torch.Generator().manual_seed(3)
    edit = DVGOEditNetwork(world_size=(8, 8, 8), k0_dim=4, rgbnet_width=16)
    edit.reset_parameters(g)
    pts = torch.rand(64, 3, generator=g) * 2.4 - 1.2
    normal = edit.raw_normal(pts)

    osr = get_field("osr_fine", world_size=(8, 8, 8), k0_dim=4,
                    rgbnet_name="shadowmlp", rgbnet_width=16, rgbnet_depth=3)
    osr.reset_parameters(g)
    n_osr = osr.alpha_gradient(pts)
    (n_osr ** 2).sum().backward()
    d_density = osr.density.grad.clone()
    assert kernel_route == {"fwd": 0, "bwd": 0}

    monkeypatch.setattr(gs, "kernel_grid", lambda grid: False)
    want = _grads(gs.grid_sample_3d, grid, x, cot, x_grad=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(normal, edit.raw_normal(pts))
    osr.zero_grad()
    n_plain = osr.alpha_gradient(pts)
    (n_plain ** 2).sum().backward()
    assert torch.equal(n_osr, n_plain)
    assert torch.equal(d_density, osr.density.grad)
    assert float(d_density.abs().max()) > 0
