"""Parity of the port's hash grid encoder and encoder factory with the JAX
package, on the CPU. Inputs come from numpy seeds and go through both.

The hashed grid type's table gradient is the JAX package's kernel K1c
(ops/pallas_scatter.py::matmul_scatter_add); the port's counterpart is
kernel E, whose plain version runs here. The f32 XLA scatter
(scatter_impl="xla") is the oracle; K1c itself, in interpret mode, rounds
its updates to bf16 and is a looser second check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.ops import encoders as jenc
from dreamfusion_tpu.ops.grid_encoder import GridEncoderSpec as JSpec

from dreamfusion_torch.ops import encoders as tenc
from dreamfusion_torch.ops import grid_encoder as tge
from dreamfusion_torch.ops.grid_encoder import GridEncoderSpec as TSpec

DEFAULT = dict()                       # L=16, C=2, base 16, scale 2, 2^19
SMALL = dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
             per_level_scale=1.5, log2_hashmap_size=9)
SPECS = {"default": DEFAULT, "small": SMALL}


def _t(x):
    return torch.from_numpy(np.array(x))


def _points(n, seed):
    """Uniform points in the box, with points on its faces and corners, on
    one face, and outside it on both sides."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    k = n // 32
    x[:k] = np.where(rng.uniform(size=(k, 3)) < 0.5, -1.0, 1.0)
    x[k:2 * k, 0] = 1.0
    x[2 * k:3 * k, 1] = -1.0
    x[3 * k:4 * k] = rng.uniform(-1.3, -1.001, (k, 3))
    x[4 * k:5 * k] = rng.uniform(1.001, 1.3, (k, 3))
    return x


def _jax_rows(js, x):
    """The JAX encoder's corner rows [L, 8, B] and weights, as its forward
    builds them (grid_encoder.py:470-500)."""
    xT = ((jnp.asarray(x) + 1.0) / 2.0).T
    rows, ws = [], []
    for lvl in range(js.num_levels):
        pos = xT * js.geometry[0][lvl] + 0.5
        pg = jnp.floor(pos)
        frac = pos - pg
        pg = pg.astype(jnp.uint32)
        fn = js._corner_index_fn(lvl)
        r8, w8 = [], []
        for c in range(8):
            w = jnp.ones_like(frac[0])
            cc = []
            for d in range(3):
                bit = (c >> d) & 1
                w = w * (frac[d] if bit else 1.0 - frac[d])
                cc.append(pg[d] + 1 if bit else pg[d])
            r8.append(fn(jnp.stack(cc, -1)))
            w8.append(w)
        rows.append(np.stack([np.asarray(r) for r in r8]))
        ws.append(np.stack([np.asarray(w) for w in w8]))
    return np.stack(rows), np.stack(ws)


def test_hashed_levels_and_corner_rows_equal_jax_exactly():
    """(a) Default 16-level hash spec: levels 3-11, 14 and 15 hash; 12 and
    13 do not, because the uint32 stride wraps below the table size. The 8
    corner rows of 2,048 points are equal to the JAX package's, exactly,
    box faces and out-of-range points included."""
    js, ts = JSpec(scatter_impl="xla"), TSpec()
    assert js.geometry == ts.geometry and ts.table_size == 7_131_240
    pattern = [js._corner_offsets(l) is None for l in range(16)]
    assert pattern == [l in (3, 4, 5, 6, 7, 8, 9, 10, 11, 14, 15)
                       for l in range(16)]
    assert list(ts.hashed_levels) == pattern
    for l in range(16):
        assert ts._corner_offsets(l) == js._corner_offsets(l)
    x = _points(2048, 0)
    rows, w, oob = ts.residuals_rows(_t(x))
    jrows, jw = _jax_rows(js, x)
    assert rows.dtype == torch.int32 and rows.shape == (16, 8, 2048)
    np.testing.assert_array_equal(rows.numpy(), jrows)
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-7)
    assert oob.sum() == 2 * (2048 // 32)
    assert int(rows.min()) >= 0 and int(rows.max()) < ts.table_size


@pytest.mark.parametrize("name", ["default", "small"])
def test_hash_forward_and_table_grad_match_jax_xla(name):
    """(b), (c) Forward atol 1e-7; table gradient against the f32 XLA
    scatter to 1e-5 of its largest entry (another summation order);
    out-of-range inputs read zeros and add nothing to the gradient."""
    kw = SPECS[name]
    js, ts = JSpec(scatter_impl="xla", **kw), TSpec(**kw)
    assert any(ts.hashed_levels)
    rng = np.random.default_rng(1)
    B = 1024
    emb = rng.uniform(-0.1, 0.1, (ts.table_size, 2)).astype(np.float32)
    x = _points(B, 2)
    cot = rng.normal(size=(B, ts.output_dim)).astype(np.float32)

    et = _t(emb).requires_grad_(True)
    out_t = ts(et, _t(x))
    (out_t * _t(cot)).sum().backward()
    out_j, vjp = jax.vjp(lambda e: js(e, jnp.asarray(x)), jnp.asarray(emb))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-7)
    oob = (np.abs(x) > 1).any(-1)
    assert oob.any() and not np.abs(out_t.detach().numpy()[oob]).any()
    g_j = np.asarray(vjp(jnp.asarray(cot))[0])
    np.testing.assert_allclose(et.grad.numpy(), g_j,
                               atol=1e-5 * np.abs(g_j).max())

    # kernel E's contract on the same residuals: its plain version equals
    # the autograd table gradient exactly
    rows, w, _ = ts.residuals_rows(_t(x))
    cot_t = torch.where(torch.from_numpy(oob)[:, None], 0.0, _t(cot))
    d = tge.grid_encoder_bwd_rows_plain(
        rows, w, cot_t.reshape(B, ts.num_levels, 2), ts.table_size)
    np.testing.assert_array_equal(d.numpy(), et.grad.numpy())


@pytest.mark.parametrize("name,B", [("default", 256), ("small", 64)])
def test_hash_table_grad_matches_k1c_in_interpret_mode(name, B):
    """(c) Against K1c itself (scatter_impl="interpret" runs
    matmul_scatter_add in the Pallas interpreter for every level): 2e-2 of
    the largest entry, since K1c rounds its updates to bf16."""
    kw = SPECS[name]
    js, ts = JSpec(scatter_impl="interpret", **kw), TSpec(**kw)
    rng = np.random.default_rng(3)
    emb = rng.uniform(-1e-4, 1e-4, (ts.table_size, 2)).astype(np.float32)
    x = rng.uniform(-0.9, 0.9, (B, 3)).astype(np.float32)
    cot = rng.normal(size=(B, ts.output_dim)).astype(np.float32)
    g_j = np.asarray(jax.grad(lambda e: jnp.sum(js(e, jnp.asarray(x))
                                                * cot))(jnp.asarray(emb)))
    et = _t(emb).requires_grad_(True)
    (ts(et, _t(x)) * _t(cot)).sum().backward()
    scale = np.abs(g_j).max()
    assert scale > 0
    np.testing.assert_allclose(et.grad.numpy() / scale, g_j / scale,
                               atol=2e-2)


def _face_points(ts, n, seed):
    """Points in [-1, 1]^3 half of which lie on cell faces of a random level
    (per dimension with probability 1/2: x01 = (m - 0.5) / scale, x = 2 x01
    - 1), the rest uniform, with some outside the box."""
    rng = np.random.default_rng(seed)
    scales, resolutions = ts.geometry[0], ts.geometry[1]
    lvl = rng.integers(0, ts.num_levels, n)
    m = np.floor(rng.uniform(size=(n, 3))
                 * np.array(resolutions)[lvl][:, None])
    x01 = ((m - 0.5) / np.array(scales)[lvl][:, None]).astype(np.float32)
    face = (rng.uniform(size=(n, 3)) < 0.5) & (np.arange(n) % 2 == 0)[:, None]
    x = np.where(face, x01 * 2 - 1, _points(n, seed + 1))
    return x.astype(np.float32)


def _kernel_e_rows(table, x01):
    """Kernel E's per-(sample, level) arithmetic in numpy float32 / uint32,
    from its constant table: pos = x01 * scale + shift, floor, frac, corner
    0 clamped to [0, 2^32 - 1], the weights multiplied in dimension order,
    and each corner's row by the XOR hash or the affine sum, % size +
    offset. -> (rows [L, 8, B] int64, weights [L, 8, B] f32)."""
    f32, u32 = np.float32, np.uint32
    tab = table.numpy()
    scale, shift = tab[:, 0].view(f32), tab[:, 1].view(f32)
    strides = tab[:, 4:7].view(u32)
    primes = np.array([1, 2654435761, 805459861], u32)
    rows, weights = [], []
    for l in range(tab.shape[0]):
        pos = (x01 * scale[l]).astype(f32) + shift[l]
        pg = np.floor(pos)
        frac = (pos - pg).astype(f32)
        cell = np.where(pg > 0, np.minimum(pg.astype(np.float64), 2 ** 32 - 1),
                        0).astype(np.uint64).astype(u32)
        r8, w8 = [], []
        for c in range(8):
            bits = np.array([(c >> d) & 1 for d in range(3)], u32)
            co = cell + bits
            if tab[l, 7]:
                h = co[:, 0] ^ (co[:, 1] * primes[1]) ^ (co[:, 2] * primes[2])
            else:
                h = (co * strides[l]).sum(-1, dtype=u32)
            r8.append((h % u32(tab[l, 2])).astype(np.int64) + int(tab[l, 3]))
            w = np.ones(x01.shape[0], f32)
            for d in range(3):
                w = w * (frac[:, d] if bits[d] else f32(1) - frac[:, d])
            w8.append(w)
        rows.append(np.stack(r8))
        weights.append(np.stack(w8))
    return np.stack(rows), np.stack(weights)


@pytest.mark.parametrize("name", ["default", "small"])
def test_kernel_e_arithmetic_gives_the_corner_rows_exactly(name):
    """Kernel E's arithmetic, emulated from rows_level_table (the scale as
    the float32 torch multiplies by, the strides, the hashed flag), gives
    the rows and weights of spec.corner_rows bit for bit, on cell faces and
    outside the box; the table's hashed flags are spec.hashed_levels."""
    ts = TSpec(**SPECS[name])
    table = ts.rows_level_table(torch.device("cpu"))
    assert table.shape == (ts.num_levels, 8)
    assert table[:, 7].tolist() == [int(h) for h in ts.hashed_levels]
    x = _face_points(ts, 4096, 8)
    x01 = ((x + 1.0) / 2.0).astype(np.float32)
    rows, w = ts.corner_rows(_t(x01))
    e_rows, e_w = _kernel_e_rows(table, x01)
    np.testing.assert_array_equal(rows.numpy(), e_rows)
    np.testing.assert_array_equal(w.numpy(), e_w)


def _find_node(grad_fn, name):
    seen, todo = set(), [grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        if type(fn).__name__ == name:
            return fn
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return None


@pytest.mark.parametrize("name,B", [("default", 256), ("small", 64)])
def test_hash_table_grad_through_saved_x01_matches_k1c(name, B):
    """The encoder's backward on the CPU, the port's kernel-E path through
    the one saved residual x01 [B, 3] and the plain version, against the
    JAX hashed encoder's table gradient (grid_encoder.py:261-282): K1c in
    interpret mode to 2e-2 of the largest entry (its updates are rounded to
    bf16) and the f32 XLA scatter to 1e-5, on points on cell faces and
    outside the box."""
    kw = SPECS[name]
    ts = TSpec(**kw)
    rng = np.random.default_rng(9)
    emb = rng.uniform(-1e-4, 1e-4, (ts.table_size, 2)).astype(np.float32)
    x = _face_points(ts, B, 10)
    cot = rng.normal(size=(B, ts.output_dim)).astype(np.float32)
    et = _t(emb).requires_grad_(True)
    out = ts(et, _t(x))
    node = _find_node(out.grad_fn, "_EncodeLevelsBackward")
    saved = node.saved_tensors
    assert len(saved) == 1 and saved[0].shape == (B, 3)
    assert saved[0].dtype == torch.float32
    (out * _t(cot)).sum().backward()
    for impl, tol in (("interpret", 2e-2), ("xla", 1e-5)):
        js = JSpec(scatter_impl=impl, **kw)
        g_j = np.asarray(jax.grad(lambda e: jnp.sum(js(e, jnp.asarray(x))
                                                    * cot))(jnp.asarray(emb)))
        scale = np.abs(g_j).max()
        assert scale > 0
        np.testing.assert_allclose(et.grad.numpy() / scale, g_j / scale,
                                   atol=tol)


def test_hash_spec_without_hashed_level_takes_kernel_a_path(monkeypatch):
    """(d) A hash spec small enough that no level hashes is all affine and
    _EncodeLevels's backward takes kernel A's path (on the card), like the
    JAX package's oct path; for a spec with a hashed level it takes kernel
    E's. The tiled spec's residuals are the JAX package's."""
    kw = dict(num_levels=3, base_resolution=4, log2_hashmap_size=19)
    js, ts = JSpec(scatter_impl="xla", **kw), TSpec(**kw)
    assert ts.gridtype == "hash" and not any(ts.hashed_levels)
    assert all(js._corner_offsets(l) is not None for l in range(3))
    calls = []
    for fn in ("grid_encoder_bwd", "grid_encoder_bwd_rows"):
        orig = getattr(tge, fn)
        monkeypatch.setattr(tge, fn, lambda *a, _o=orig, _n=fn: (
            calls.append(_n), _o(*a))[1])
    rng = np.random.default_rng(4)
    x = _points(256, 5)
    emb = rng.uniform(-0.1, 0.1, (ts.table_size, 2)).astype(np.float32)
    et = _t(emb).requires_grad_(True)
    out = ts(et, _t(x))
    out.sum().backward()
    assert calls == ["grid_encoder_bwd"]
    out_j, vjp = jax.vjp(lambda e: js(e, jnp.asarray(x)), jnp.asarray(emb))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-7)
    g_j = np.asarray(vjp(jnp.ones_like(out_j))[0])
    np.testing.assert_allclose(et.grad.numpy(), g_j,
                               atol=1e-5 * np.abs(g_j).max())
    hashed = TSpec(**SMALL)
    eh = torch.zeros(hashed.table_size, 2, requires_grad=True)
    hashed(eh, _t(x)).sum().backward()
    assert calls == ["grid_encoder_bwd", "grid_encoder_bwd_rows"]

    tiled_kw = dict(num_levels=16, log2_hashmap_size=16,
                    desired_resolution=2048, gridtype="tiled")
    jt, tt = JSpec(**tiled_kw), TSpec(**tiled_kw)
    base, w, _ = tt.residuals(_t(x))
    jrows, jw = _jax_rows(jt, x)
    offsets = np.array(tt.geometry[3])[:, None]
    np.testing.assert_array_equal(base.numpy(), jrows[:, 0] - offsets)
    np.testing.assert_allclose(w.numpy(), jw, atol=1e-7)


@pytest.mark.parametrize("gridtype", ["hash", "tiled"])
def test_differentiable_inputs_match_jax(gridtype):
    """(e) differentiable_inputs=True: plain autograd through the gather;
    values 1e-7, d/dx and the table gradient 1e-5 of the largest entry."""
    kw = dict(SMALL, gridtype=gridtype, differentiable_inputs=True)
    js, ts = JSpec(scatter_impl="xla", **kw), TSpec(**kw)
    rng = np.random.default_rng(6)
    B = 128
    emb = rng.uniform(-0.1, 0.1, (ts.table_size, 2)).astype(np.float32)
    x = rng.uniform(-0.95, 0.95, (B, 3)).astype(np.float32)
    cot = rng.normal(size=(B, ts.output_dim)).astype(np.float32)
    et, xt = _t(emb).requires_grad_(True), _t(x).requires_grad_(True)
    out = ts(et, xt)
    (out * _t(cot)).sum().backward()
    out_j, vjp = jax.vjp(lambda e, p: js(e, p), jnp.asarray(emb),
                         jnp.asarray(x))
    ge_j, gx_j = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-7)
    assert np.abs(gx_j).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), gx_j,
                               atol=1e-5 * np.abs(gx_j).max())
    np.testing.assert_allclose(et.grad.numpy(), ge_j,
                               atol=1e-5 * np.abs(ge_j).max())
    # without the flag no gradient reaches the positions
    x2 = _t(x).requires_grad_(True)
    TSpec(**dict(kw, differentiable_inputs=False))(_t(emb), x2)
    assert x2.grad is None


# the -O field's tiled spec (903,480 rows) and a hash spec whose levels are
# all affine
TILED_O = dict(num_levels=16, log2_hashmap_size=16, desired_resolution=2048,
               gridtype="tiled")
AFFINE_HASH = dict(num_levels=3, base_resolution=4, log2_hashmap_size=19)
ENCODE_CASES = {"tiled -O, f32 table": (TILED_O, torch.float32),
                "tiled -O, bf16 table": (TILED_O, torch.bfloat16),
                "hash without a hashed level": (AFFINE_HASH, torch.float32),
                "hash, small": (SMALL, torch.float32),
                "hash, default": (DEFAULT, torch.float32)}


def _table(ts, seed):
    rng = np.random.default_rng(seed)
    return _t(rng.uniform(-0.1, 0.1, (ts.table_size, 2)).astype(np.float32))


@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_no_grad_encode_builds_no_residuals(case, monkeypatch):
    """Under no_grad, and with grad on but a table that needs none, the
    encoder takes the residual-free forward (kernel H's plain version):
    residuals, residuals_rows and the autograd function raise if called.
    Its output is bitwise the grad path's, on cell faces, box faces and
    outside the box, whose rows read exactly 0. Both paths run the one
    forward, GridEncoderSpec.encode, so this holds that the grad path adds
    nothing to it; the forward's rows are held against kernel A's level
    table by test_torch_scatter.py::test_kernel_a_level_table and against
    the JAX package by (d) and test_hash_forward_and_table_grad_match_jax_xla."""
    kw, dtype = ENCODE_CASES[case]
    ts = TSpec(**kw)
    et = _table(ts, 11).requires_grad_(True)
    x = _t(_face_points(ts, 512, 12))
    oob = (x.abs() > 1).any(-1)
    ref = ts(et.to(dtype), x)
    assert ref.requires_grad and oob.any()

    def boom(*a, **k):
        raise AssertionError("residuals built for a forward without grad")

    for name in ("residuals", "residuals_rows"):
        monkeypatch.setattr(TSpec, name, boom)
    monkeypatch.setattr(tge._EncodeLevels, "apply", boom)
    with torch.no_grad():
        got = ts(et.to(dtype), x)
    frozen = ts(et.detach().to(dtype), x)
    assert torch.equal(got, ref.detach()) and torch.equal(frozen, got)
    assert not got[oob].any() and got[~oob].any()


@pytest.mark.parametrize("name", ["tiled -O", "small", "default"])
def test_table_grad_is_the_plain_backward_of_the_residuals(name):
    """With grad, the table gradient is unchanged by the residual-free
    forward: bitwise the plain backward on the residuals (kernel A's
    grid_encoder_bwd_plain on residuals() for the tiled spec, kernel E's
    grid_encoder_bwd_rows_plain on corner_rows(x01) for a hashed one), the
    cotangent of out-of-box samples zero; and plain autograd through the
    gather (differentiable_inputs) to 1e-5 of its largest entry (another
    summation order)."""
    kw = TILED_O if name == "tiled -O" else SPECS[name]
    ts = TSpec(**kw)
    B, L = 512, ts.num_levels
    et = _table(ts, 13).requires_grad_(True)
    x = _t(_face_points(ts, B, 14))
    cot = _t(np.random.default_rng(15).normal(size=(B, ts.output_dim))
             .astype(np.float32))
    (ts(et, x) * cot).sum().backward()
    xT, oob = ts._unit_positions(x, 1.0)
    cot_in = torch.where(oob[:, None], 0.0, cot).reshape(B, L, 2)
    if any(ts.hashed_levels):
        d = tge.grid_encoder_bwd_rows_plain(*ts.corner_rows(xT.t()), cot_in,
                                            ts.table_size)
    else:
        base, w, _ = ts.residuals(x)
        d = tge.grid_encoder_bwd_plain(base, w, cot_in,
                                       tge._level_consts(ts, x.device))
    assert torch.equal(et.grad, d) and d.abs().max() > 0
    ep = _table(ts, 13).requires_grad_(True)
    (TSpec(**kw, differentiable_inputs=True)(ep, x) * cot).sum().backward()
    assert (ep.grad - d).abs().max() <= 1e-5 * d.abs().max()


@pytest.mark.parametrize("encoding,out_dim", [
    ("None", 3), ("frequency", 39), ("sphere_harmonics", 16),
    ("hashgrid", 32), ("tiledgrid", 32)])
def test_get_encoder_strings_and_output_dims(encoding, out_dim):
    """(f) The five strings of the factory, their output dims and values
    against the JAX package's; an unknown string raises."""
    jfn, jdim = jenc.get_encoder(encoding)
    tfn, tdim = tenc.get_encoder(encoding)
    assert tdim == jdim == out_dim
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    if encoding in ("hashgrid", "tiledgrid"):
        assert tfn.gridtype == jfn.gridtype == encoding[:4].replace(
            "tile", "tiled")
        emb = rng.uniform(-0.1, 0.1, (tfn.table_size, 2)).astype(np.float32)
        got, ref = tfn(_t(emb), _t(x)), jfn(jnp.asarray(emb), jnp.asarray(x))
    else:
        got, ref = tfn(_t(x)), jfn(jnp.asarray(x))
    assert got.shape == (64, out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.raises(NotImplementedError, match="Unknown encoding"):
        tenc.get_encoder("fourier")
    with pytest.raises(ValueError, match="gridtype"):
        TSpec(gridtype="dense")


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(degree):
    """(f) Real spherical harmonics, degrees 1-8, 1e-5."""
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = tenc.sh_encode(_t(d), degree)
    assert got.shape == (256, tenc.sh_output_dim(degree))
    assert tenc.sh_output_dim(degree) == jenc.sh_output_dim(degree)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jenc.sh_encode(jnp.asarray(d),
                                                         degree)), atol=1e-5)
    with pytest.raises(ValueError, match="degree"):
        tenc.sh_encode(_t(d), 9)
