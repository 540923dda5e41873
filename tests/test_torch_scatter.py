"""Kernel A's algorithm (csrc/grid_encoder_bwd.cu), emulated in numpy on
the CPU, against the JAX package's table gradient.

The kernel cannot run here, so ``emulate_kernel_a`` repeats what it does:
per level, warps of 32 consecutive samples (a block takes a run of 2,048
samples, so the warps fall on multiples of 32), __match_any_sync groups on
corner 0's row, segmented float2 suffix sums over each contiguous run of a
group, and one update of the 8 rows by the run's first lane. The samples are
ray-ordered, as the renderer gives them, so neighbouring lanes share cells
at the coarse levels.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.ops.grid_encoder import GridEncoderSpec as JSpec
from dreamfusion_tpu.ops.pallas_scatter import (matmul_scatter_add_oct,
                                                matmul_scatter_add_oct_binned)

from dreamfusion_torch.ops import grid_encoder as ge

F32 = np.float32
LANES = np.arange(32)
MAIN_KW = dict(input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
               log2_hashmap_size=16, desired_resolution=2048)
# the level of 4,096 rows that the K1b kernel takes in the JAX package
K1B_KW = dict(input_dim=3, num_levels=1, level_dim=2, base_resolution=15,
              log2_hashmap_size=16)


def _ffs(x):
    """CUDA's __ffs: 1 + index of the lowest set bit, 0 for 0."""
    low = x & -x
    return np.where(x == 0, 0, np.log2(np.maximum(low, 1)).astype(np.int64) + 1)


def emulate_kernel_a(base, w, cot, consts):
    """d_emb [T, 2] f32 by kernel A's algorithm. base [L, B] int32, w [L, 8,
    B] f32, cot [B, L, 2] f32 (numpy)."""
    L, B = base.shape
    table = consts.table.cpu().numpy().astype(np.int64)
    d = np.zeros((consts.total, 2), F32)
    js = np.arange(math.ceil(B / 32) * 32)
    inside = js < B
    jc = np.minimum(js, B - 1)
    for l in range(L):
        size, offset, coff = table[l, 0], table[l, 1], table[l, 2:10]
        c = np.where(inside[:, None], cot[jc, l], 0).astype(F32)   # [n, 2]
        live = (c != 0).any(-1)
        key = np.where(live, base[l, jc].astype(np.int64), 0xFFFFFFFF)
        v = (w[l][:, jc].T[:, :, None] * c[:, None, :]).astype(F32)
        v = v.reshape(-1, 32, 16)                                  # warps
        key, live = key.reshape(-1, 32), live.reshape(-1, 32)
        keep = live.any(-1)                    # warps with a live lane
        v, key, live = v[keep], key[keep], live[keep]
        same = key[:, :, None] == key[:, None, :]
        group = (same * (1 << LANES)).sum(-1)                      # [nw, 32]
        up = ~(group >> LANES) & 0xFFFFFFFF
        run = np.where(up != 0, _ffs(up) - 1, 32 - LANES)
        prev = (group >> np.maximum(LANES - 1, 0)) & 1
        head = live & ((LANES == 0) | (prev == 0))
        longest = np.where(live, run, 1).max(-1, keepdims=True)
        for off in (1, 2, 4, 8, 16):
            down = v[:, np.minimum(LANES + off, 31)]
            add = ((off < run) & (off < longest))[..., None]
            v = np.where(add, (v + down).astype(F32), v)
        rows = key[head][:, None] + coff[None, :]
        rows = np.where(rows >= size, rows - size, rows)           # [h, 8]
        upd = v[head].reshape(-1, 8, 2)
        np.add.at(d, offset + rows.reshape(-1), upd.reshape(-1, 2))
    return d


def _ray_samples(seed, R, K, compact):
    """R rays marched on the renderer's lattice (step 2 sqrt(3) / 512 of the
    [-1, 1] box), K slots a ray with a live prefix. compact=True keeps the
    live samples only, ray after ray (the compacted steps' order); False
    keeps the dense [R, K] layout with dead tails (the dense steps)."""
    rng = np.random.default_rng(seed)
    step = 2 * math.sqrt(3) / 512
    o = rng.uniform(-0.6, 0.6, (R, 3))
    d = rng.normal(size=(R, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = rng.uniform(0, step, (R, 1)) + step * np.arange(K)
    x = np.clip(o[:, None] + d[:, None] * t[..., None], -1, 1)
    valid = np.arange(K)[None] < rng.integers(K // 4, K + 1, (R, 1))
    if compact:
        return x[valid].astype(F32), np.ones(int(valid.sum()), bool)
    return x.reshape(-1, 3).astype(F32), valid.reshape(-1)


def _inputs(spec, x, valid, seed):
    base, w, _ = spec.residuals(torch.from_numpy(x))
    L, B = base.shape
    cot = np.random.default_rng(seed).normal(size=(B, L, 2)).astype(F32)
    cot *= valid[:, None, None]
    return base.numpy(), w.numpy(), cot


@pytest.mark.parametrize("kw", [
    dict(MAIN_KW, gridtype="tiled"), dict(K1B_KW, gridtype="tiled"),
    # small levels only, and large levels only
    dict(input_dim=3, num_levels=4, level_dim=2, base_resolution=8,
         per_level_scale=1.5, log2_hashmap_size=12, gridtype="tiled"),
    dict(input_dim=3, num_levels=3, level_dim=2, base_resolution=64,
         log2_hashmap_size=19, gridtype="tiled")])
def test_kernel_a_level_table(kw):
    """Kernel A's table ([L, 10]: size, offset, 8 corner offsets in [0,
    size)) gives, for corner c of a sample, the row that the index function
    gives corner 0's coordinates plus the bits of c: the kernel derives the
    8 rows from corner 0's alone."""
    spec = ge.GridEncoderSpec(**kw)
    consts = ge._level_consts(spec, torch.device("cpu"))
    _, _, sizes, offsets, total = spec.geometry
    table = consts.table.numpy()
    assert table.shape == (spec.num_levels, 10) and consts.total == total
    assert (table[:, 0] == sizes).all() and (table[:, 1] == offsets).all()
    assert ((table[:, 2:] >= 0) & (table[:, 2:] < table[:, :1])).all()
    x = torch.from_numpy(
        np.random.default_rng(5).uniform(-1, 1, (500, 3)).astype(F32))
    base, _, _ = spec.residuals(x)
    xT, _ = spec._unit_positions(x, 1.0)
    for lvl in range(spec.num_levels):
        pos_grid, _ = spec._level_corners(xT, lvl)
        assert torch.equal(ge._corner_rows(consts, base, lvl),
                           spec._level_rows(pos_grid, lvl))
    assert ge._level_consts(
        ge.GridEncoderSpec(**MAIN_KW, gridtype="tiled"),
        torch.device("cpu")).table[:3, 0].tolist() == [4920, 13824, 32768]


@pytest.mark.parametrize("compact", [True, False])
def test_kernel_a_emulation_matches_jax_table_gradient(compact):
    """The emulated kernel on ray-ordered samples at the main path's 16-level
    tiled spec equals the JAX encoder's f32 table gradient (scatter_impl
    "xla") to 1e-5 of the largest entry: both sum in f32, in other orders.
    The coarse levels aggregate: fewer updates than live samples."""
    tspec = ge.GridEncoderSpec(**MAIN_KW, gridtype="tiled")
    jspec = JSpec(scatter_impl="xla", gridtype="tiled", **MAIN_KW)
    x, valid = _ray_samples(1, 160 if compact else 72, 128, compact)
    base, w, cot = _inputs(tspec, x, valid, 2)
    B = x.shape[0]
    consts = ge._level_consts(tspec, torch.device("cpu"))
    got = emulate_kernel_a(base, w, cot, consts)
    emb = np.zeros((tspec.table_size, 2), F32)
    _, vjp = jax.vjp(lambda e: jspec(e, jnp.asarray(x)), jnp.asarray(emb))
    (ref,) = vjp(jnp.asarray(cot.reshape(B, -1)))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    # neighbouring lanes share cells at level 0: runs longer than one lane
    key = np.where(cot[:, 0].any(-1), base[0], -1)[: B // 32 * 32]
    key = key.reshape(-1, 32)
    heads = ((key[:, 1:] != key[:, :-1]) & (key[:, 1:] >= 0)).sum() \
        + (key[:, 0] >= 0).sum()
    assert heads * 4 < int(valid.sum())


def _bf16_bound(base_l, w_l, cot_l, size, coff, rel):
    """rel * sum of |update| per row: the bound on a sum of updates each
    rounded to bf16 (relative error 2^-9 per rounding)."""
    a = np.zeros((size, 2), F32)
    for c in range(8):
        rows = (base_l.astype(np.int64) + coff[c]) % size
        np.add.at(a, rows, np.abs(w_l[c][:, None] * cot_l))
    return rel * a + 1e-7


@pytest.mark.parametrize("kw,lvl,binned", [
    (K1B_KW, 0, False), (MAIN_KW, 1, True), (MAIN_KW, 2, True)],
    ids=["oct, 4,096 rows", "binned, level 1", "binned, level 2"])
def test_kernel_a_emulation_matches_pallas_scatter(kw, lvl, binned):
    """The emulated kernel against the TPU kernels it replaces, in interpret
    mode, one level each: matmul_scatter_add_oct on a level of 4,096 rows,
    matmul_scatter_add_oct_binned on larger ones, followed by the JAX
    encoder's inverse rolls of the corner columns. The TPU kernels round
    each update to bf16 (pallas_scatter.py:27-32; the binned one rounds w
    and the cotangent apart), so a row may differ by 2^-9 (2^-8 binned) of
    the sum of its updates' magnitudes; the bound is 2^-8 (2^-7)."""
    tspec = ge.GridEncoderSpec(**kw, gridtype="tiled")
    x, valid = _ray_samples(3, 32, 128, compact=True)
    base, w, cot = _inputs(tspec, x, valid, 4)
    consts = ge._level_consts(tspec, torch.device("cpu"))
    got = emulate_kernel_a(base, w, cot, consts)
    size, offset = int(consts.sizes[lvl]), int(consts.offsets[lvl])
    coff = consts.table[lvl, 2:10].numpy()
    fn = matmul_scatter_add_oct_binned if binned else matmul_scatter_add_oct
    d_oct = np.asarray(fn(jnp.asarray(base[lvl]), jnp.asarray(w[lvl]),
                          jnp.asarray(cot[:, lvl]), size, interpret=True))
    ref = sum(np.roll(d_oct[:, 2 * c:2 * c + 2], int(coff[c]), axis=0)
              for c in range(8))
    bound = _bf16_bound(base[lvl], w[lvl], cot[:, lvl], size, coff,
                        2.0 ** (-7 if binned else -8))
    err = np.abs(got[offset:offset + size] - ref)
    assert (err <= bound).all(), float((err - bound).max())
    assert np.abs(ref).max() > 0
