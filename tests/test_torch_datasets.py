"""The port's datasets (dreamfusion_torch/datasets: loaders, rays,
provider) against the JAX package's, on the CPU:

- read_png against imageio, bit for bit: 8-bit grey, grey + alpha, RGB and
  RGBA written by PIL with its adaptive row filters (types 0-4), 16-bit
  grey, and the port's own write_png (grey, RGB, RGBA);
- each format of tests/test_datasets.py (blender, toydesk,
  standard_blendedmvs with JPEGs, tankstemple360 and omniscenes with
  JPEGs, stanford3D with 16-bit depth PNGs, nsvf / tankstemple pose dirs),
  plus llff (spherified and not), deepvoxels and DTU, written in tmp_path
  and loaded by both packages: every array of the dict equal;
- rays of a view (pinhole, panoramic, NDC, random jitter), the gathering
  samplers, the provider's suffix grammar and batches, the dataset
  decorators: equal;
- ErrorMapRaySampler with the JAX package's draws injected: the same
  batches and error maps over four steps.
"""

import json
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamfusion_tpu.datasets import loaders as jl
from dreamfusion_tpu.datasets import provider as jp
from dreamfusion_tpu.datasets import rays as jr

from dreamfusion_torch.datasets import loaders as tl
from dreamfusion_torch.datasets import provider as tp
from dreamfusion_torch.datasets import rays as tr
from dreamfusion_torch.training.trainer import write_png


def _equal(a, b, path=""):
    """Recursive exact equality of two load_data results."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif a is None or isinstance(a, (bool, str)):
        assert a == b, path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


# -- PNG reader ------------------------------------------------------------------

@pytest.mark.parametrize("mode,shape", [("L", (37, 29)), ("LA", (20, 31, 2)),
                                        ("RGB", (40, 33, 3)),
                                        ("RGBA", (41, 30, 4))])
def test_read_png_equals_imageio(tmp_path, mode, shape):
    rng = np.random.RandomState(0)
    noise = (rng.rand(*shape) * 255).astype(np.uint8)
    ramp = np.broadcast_to(np.linspace(0, 255, shape[0]).reshape(
        (shape[0],) + (1,) * (len(shape) - 1)), shape).astype(np.uint8)
    filters = set()
    for i, arr in enumerate((noise, ramp, noise // 2 + ramp // 2)):
        p = str(tmp_path / f"{mode}_{i}.png")
        Image.fromarray(arr, mode=mode).save(p, optimize=True)
        got, ref = tl.read_png(p), imageio.imread(p)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tl._imread(p), jl._imread(p))
        filters |= _row_filters(p)
    assert len(filters) >= 2


def _row_filters(path):
    """The set of row filter types in a PNG's image data."""
    import struct
    import zlib

    data = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif data[pos + 4:pos + 8] == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (stride + 1)] for y in range(h)}


def test_read_png_16_bit_and_write_png_round_trip(tmp_path):
    rng = np.random.RandomState(1)
    d = (rng.rand(12, 9) * 65535).astype(np.uint16)
    imageio.imwrite(str(tmp_path / "d.png"), d)
    got = tl.read_png(str(tmp_path / "d.png"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, imageio.imread(str(tmp_path / "d.png")))
    all_filters = set()
    for shape in ((7, 5), (7, 5, 3), (7, 5, 4)):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        p = str(tmp_path / f"w{len(shape)}_{shape[-1]}.png")
        write_png(p, img)
        np.testing.assert_array_equal(tl.read_png(p), img)
        np.testing.assert_array_equal(imageio.imread(p), img)
        all_filters |= _row_filters(p)
    assert all_filters == {0}
    with open(tmp_path / "x.jpg", "wb") as f:
        f.write(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tl.read_png(str(tmp_path / "x.jpg"))


# -- formats ---------------------------------------------------------------------

def _img(path, arr):
    """PIL's writer (a JPEG for a .jpg name), as tests/test_datasets.py."""
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def _blender(tmp, rng):
    base = tmp / "lego"
    for split, n in [("train", 3), ("val", 2), ("test", 2)]:
        frames = []
        os.makedirs(base / split)
        for i in range(n):
            _img(str(base / split / f"r_{i}.png"), rng.rand(16, 16, 4))
            c2w = np.eye(4)
            c2w[2, 3] = 4.0 + i
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(base / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return {"dataset_type": "blender", "datadir": str(base), "testskip": 2}


def _toydesk(tmp, rng):
    base = tmp / "scenes" / "our_desk_1"
    os.makedirs(base)
    frames = []
    for i in range(4):
        _img(str(base / f"r_{i}.png"), rng.rand(8, 8, 3))
        pose = np.eye(4)
        pose[0, 3] = i
        frames.append({"file_path": f"./r_{i}", "idx": i,
                       "transform_matrix": pose.tolist()})
    with open(base / "transforms_full.json", "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    split = tmp / "split" / "our_desk_1_train_0.8"
    os.makedirs(split)
    (split / "train.txt").write_text("0\n1\n2\n")
    (split / "test.txt").write_text("3\n")
    return {"dataset_type": "toydesk", "datadir": str(base)}


def _blendedmvs(tmp, rng):
    base = tmp / "scan"
    os.makedirs(base / "cams")
    os.makedirs(base / "blended_images")
    n = 5
    (base / "cams" / "pair.txt").write_text(
        "\n".join([str(n)] + sum([[str(i), "0"] for i in range(n)], [])))
    for i in range(n):
        ext = np.eye(4)
        ext[2, 3] = -(2.0 + i * 0.1)
        K = np.array([[10.0, 0, 4], [0, 10, 4], [0, 0, 1]])
        words = (["extrinsic"] + [str(v) for v in ext.reshape(-1)]
                 + ["intrinsic"] + [str(v) for v in K.reshape(-1)])
        (base / "cams" / f"{i:08d}_cam.txt").write_text(" ".join(words))
        _img(str(base / "blended_images" / f"{i:08d}_masked.jpg"),
             rng.rand(8, 8, 3))
    return {"dataset_type": "standard_blendedmvs", "datadir": str(base)}


def _tt360(tmp, rng):
    base = tmp / "tt360"
    os.makedirs(base)
    n = 4
    np.save(base / "Ks.npy", np.tile(np.array([[10.0, 0, 4], [0, 10, 4],
                                               [0, 0, 1]]), (n, 1, 1)))
    np.save(base / "Rs.npy", np.tile(np.eye(3), (n, 1, 1)))
    np.save(base / "ts.npy", rng.rand(n, 3))
    for i in range(n):
        _img(str(base / f"im_{i:02d}.jpg"), rng.rand(8, 8, 3))
        np.save(base / f"dm_{i:02d}.npy", rng.rand(8, 8) * 3 + 1)
    return {"dataset_type": "tankstemple360", "datadir": str(base)}


def _omni(tmp, rng):
    omni = tmp / "pano"
    os.makedirs(omni)
    (tmp / "pose").mkdir()
    for i in range(4):
        _img(str(omni / f"seq_{i:03d}.jpg"), rng.rand(8, 16, 3))
        pose = np.hstack([np.eye(3), np.array([[i], [0], [2.0]])])
        np.savetxt(tmp / "pose" / f"seq_{i:03d}.txt", pose)
    return {"dataset_type": "omniscenes", "datadir": str(omni)}


def _stanford(tmp, rng):
    base = tmp / "area"
    for sub in ("pose", "rgb", "depth"):
        os.makedirs(base / sub)
    for i in range(3):
        _img(str(base / "rgb" / f"{i:03d}.png"), rng.rand(8, 16, 3))
        depth = (rng.rand(8, 16) * 5000 + 100).astype(np.uint16)
        depth[0, 0] = 65535
        imageio.imwrite(str(base / "depth" / f"{i:03d}.png"), depth)
        with open(base / "pose" / f"{i:03d}.json", "w") as f:
            json.dump({"camera_rt_matrix":
                       np.hstack([np.eye(3), [[0], [0], [2.0 + i]]]).tolist()},
                      f)
    return {"dataset_type": "stanford3D", "datadir": str(base)}


def _posedir(kind):
    def make(tmp, rng):
        base = tmp / "scan"
        os.makedirs(base / "pose")
        os.makedirs(base / "rgb")
        for i, split in enumerate([0, 0, 1, 2]):
            pose = np.eye(4)
            pose[:3, 3] = [i, 0, 4]
            np.savetxt(base / "pose" / f"{split}_{i:03d}.txt", pose)
            _img(str(base / "rgb" / f"{split}_{i:03d}.png"),
                 rng.rand(8, 8, 4 if kind == "nsvf" else 3))
        np.savetxt(base / "intrinsics.txt",
                   np.array([[10.0, 0, 4], [0, 10, 4], [0, 0, 1]]))
        return {"dataset_type": kind, "datadir": str(base)}
    return make


def _llff(spherify):
    def make(tmp, rng):
        base = tmp / "fern"
        os.makedirs(base / "images_2")
        n = 9
        rows = []
        for i in range(n):
            ang = 0.3 * i
            R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                          [-np.sin(ang), 0, np.cos(ang)]])
            t = np.array([np.sin(ang), 0.1 * i, np.cos(ang)]) * 2.0
            hwf = np.array([[12.0], [16.0], [20.0]])
            rows.append(np.concatenate([np.hstack([R, t[:, None], hwf])
                                        .reshape(-1), [1.5 + 0.1 * i, 6.0]]))
            _img(str(base / "images_2" / f"{i:03d}.png"), rng.rand(6, 8, 3))
        np.save(base / "poses_bounds.npy", np.stack(rows))
        return {"dataset_type": "llff", "datadir": str(base), "factor": 2,
                "spherify": spherify, "llffhold": 4}
    return make


def _deepvoxels(tmp, rng):
    base = tmp / "dv"
    for split in ("train", "validation", "test"):
        d = base / split / "greek"
        os.makedirs(d / "rgb")
        os.makedirs(d / "pose")
        (d / "intrinsics.txt").write_text("480.0 256.0 256.0 0.\n")
        for i in range(2):
            _img(str(d / "rgb" / f"{i:05d}.png"), rng.rand(8, 8, 3))
            pose = np.eye(4)
            pose[:3, 3] = [0.5 * i, 0, 1.5]
            np.savetxt(d / "pose" / f"{i:05d}.txt", pose.reshape(1, 16))
    return {"dataset_type": "deepvoxels", "datadir": str(base),
            "scene": "greek"}


def _dtu(tmp, rng):
    base = tmp / "dtu"
    os.makedirs(base / "image")
    mats = {}
    for i in range(9):
        K = np.array([[30.0, 0.5, 8], [0, 31.0, 6], [0, 0, 1]])
        ang = 0.2 * i
        R = np.array([[np.cos(ang), 0, -np.sin(ang)], [0, 1, 0],
                      [np.sin(ang), 0, np.cos(ang)]])
        t = np.array([[0.1 * i], [0.0], [3.0]])
        P = np.eye(4)
        P[:3, :4] = K @ np.hstack([R, t])
        mats[f"world_mat_{i}"] = P
        mats[f"scale_mat_{i}"] = np.diag([1.2, 1.2, 1.2, 1.0])
        _img(str(base / "image" / f"{i:06d}.png"), rng.rand(12, 16, 3))
    np.savez(base / "cameras.npz", **mats)
    return {"dataset_type": "DTU", "datadir": str(base)}


FORMATS = {"blender": _blender, "toydesk": _toydesk,
           "standard_blendedmvs": _blendedmvs, "tankstemple360": _tt360,
           "omniscenes": _omni, "stanford3D": _stanford,
           "nsvf": _posedir("nsvf"), "tankstemple": _posedir("tankstemple"),
           "llff": _llff(False), "llff_spherify": _llff(True),
           "deepvoxels": _deepvoxels, "DTU": _dtu}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_formats_load_equal_arrays(tmp_path, fmt):
    args = FORMATS[fmt](tmp_path, np.random.RandomState(0))
    ref = jl.load_data(dict(args))
    got = tl.load_data(dict(args))
    assert len(got["i_train"]) > 0
    _equal(got, ref)


# -- rays, samplers, provider ----------------------------------------------------------

def test_rays_of_a_view_match():
    K = np.array([[20.0, 0, 8], [0, 21.0, 7], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.3, -0.2, 4.0]
    for kw in ({}, {"inverse_y": True, "flip_x": True}, {"flip_y": True,
               "mode": "lefttop"}, {"ndc": True}, {"img_type": "panoramic"}):
        _equal(tr.get_rays_of_a_view(14, 16, K, c2w, **kw),
               jr.get_rays_of_a_view(14, 16, K, c2w, **kw), str(kw))
    _equal(tr.get_rays_np(6, 5, K, c2w, mode="random",
                          rng=np.random.RandomState(3)),
           jr.get_rays_np(6, 5, K, c2w, mode="random",
                          rng=np.random.RandomState(3)))


def _scene(tmp_path):
    args = _blender(tmp_path, np.random.RandomState(0))
    data = tl.load_data(args)
    data["depths"] = np.random.RandomState(2).rand(
        len(data["images"]), 16, 16).astype(np.float32)
    return data


@pytest.mark.parametrize("sampler", ["random", "in_alpha_channel",
                                     "in_maskcache", "random_depth"])
def test_gather_training_rays_match(tmp_path, sampler):
    data = _scene(tmp_path)
    if sampler == "in_alpha_channel":   # keep the alpha channel
        data["images"] = np.concatenate(
            [data["images"], (np.random.RandomState(4).rand(
                *data["images"].shape[:3], 1) > 0.5).astype(np.float32)], -1)

    def mask_fn(o, d):
        return (o[:, 0] + d[:, 1]) > 0

    kw = dict(split="i_train", ray_sampler=sampler, mask_fn=mask_fn)
    _equal(tr.gather_training_rays(data, {}, **kw),
           jr.gather_training_rays(data, {}, **kw))


def test_provider_batches_and_decorators_match(tmp_path):
    data = _scene(tmp_path)
    for name in ("nerf", "nerf_test", "nerf_swap_noaug", "nerf_partial",
                 "nerf_rand", "nerf_ordered"):
        params = {"name": name, "data_dict": data, "batch_size": 100,
                  "total": 5, "selected": 2, "alpha": 0.3, "repeat": 2}
        assert tp.DatasetFactory.analyze_name(name, params) == \
            jp.DatasetFactory.analyze_name(name, params)
        tpv, jpv = tp.DataProvider(dict(params)), jp.DataProvider(dict(params))
        for a, b in ((tpv.train_dl, jpv.train_dl), (tpv.val_dl, jpv.val_dl),
                     (tpv.test_dl, jpv.test_dl)):
            assert len(a) == len(b)
            for _ in range(2):          # two epochs: two shuffles
                _equal(list(a), list(b), name)
    base = tp.ArrayDataset(np.arange(12.0), np.arange(12.0)[::-1] * 2)
    jbase = jp.ArrayDataset(np.arange(12.0), np.arange(12.0)[::-1] * 2)
    _equal(tp.ConcatDataset([base, base]).arrays,
           jp.ConcatDataset([jbase, jbase]).arrays)
    _equal(tp.OrderDataset(base).arrays, jp.OrderDataset(jbase).arrays)
    _equal(tp.RandDataset(base, 0.5, seed=3).arrays,
           jp.RandDataset(jbase, 0.5, seed=3).arrays)


def test_error_map_sampler_matches_with_jax_draws():
    """Four batches from both samplers, the port's cells and jitter drawn
    as the JAX package draws them (its key chain and categorical), each
    batch's per-ray error fed back through update_last."""
    rng = np.random.RandomState(1)
    data = dict(HW=np.tile([20, 24], (3, 1)),
                Ks=np.tile(np.array([[8.0, 0, 12], [0, 8.0, 10], [0, 0, 1]]),
                           (3, 1, 1)),
                poses=np.tile(np.eye(4), (3, 1, 1)),
                images=rng.rand(3, 20, 24, 3).astype(np.float32),
                i_train=np.arange(3))
    keys = {"key": jax.random.PRNGKey(0)}

    def draw_fn(em):
        keys["key"], k = jax.random.split(keys["key"])
        k_cell, k_jx, k_jy = jax.random.split(k, 3)
        logits = jnp.log(jnp.clip(jnp.asarray(em.numpy()).reshape(-1),
                                  1e-12, None))
        cells = jax.random.categorical(k_cell, logits, shape=(32,))
        jit = jnp.stack([jax.random.uniform(k_jx, (32,)),
                         jax.random.uniform(k_jy, (32,))])
        return (torch.from_numpy(np.array(cells)),
                torch.from_numpy(np.array(jit)))

    js = jr.ErrorMapRaySampler(data, {}, batch_size=32, seed=0)
    ts = tr.ErrorMapRaySampler(data, {}, batch_size=32, seed=0,
                               draw_fn=draw_fn)
    for step, (a, b) in enumerate(zip(iter(ts), iter(js))):
        _equal(a, b, f"step {step}")
        err = np.random.RandomState(step).rand(32).astype(np.float32)
        ts.update_last(err)
        js.update_last(err)
        _equal(ts.error_map, js.error_map)
        if step == 3:
            break
    assert np.abs(ts.error_map - 1).max() > 0
