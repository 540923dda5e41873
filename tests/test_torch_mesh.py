"""The port's mesh export (export/mesh.py and its own csrc/mesh_native.cpp,
built by ops/cuda.py) against the JAX package's, on the CPU:

- marching_tetrahedra, rasterize_uv and nearest_inpaint of the port's
  library against the JAX package's (its csrc/libmesh_native.so) on the
  same seeded inputs: bitwise (both are the same source, compiled in ISO
  C++ mode, where neither compiler contracts a*b+c into an FMA);
- per_face_uv_atlas (vectorised in the port) bitwise against JAX's loop;
- export_textured_mesh on one density field: the same OBJ text and MTL,
  and the same texture pixels (the PNG encoders differ, so the decoded
  pixels are compared);
- main(argv) with --save_mesh on a tiny -O config writes the three files;
- a failed native build raises and nothing falls back.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dreamfusion_tpu.export import mesh as jmesh

from dreamfusion_torch.export import mesh as tmesh
from dreamfusion_torch.ops import cuda


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_native():
    lib = jmesh._load_native()
    assert lib, "the JAX package's libmesh_native.so did not load"
    return lib


def _blobby_grid(n, seed):
    """A smooth random field on an n^3 grid: a ball plus noise."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, n, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    return (20.0 * (0.6 - r) + rng.normal(size=r.shape)).astype(np.float32)


@pytest.mark.parametrize("shape,seed", [((20, 20, 20), 0), ((17, 23, 9), 1)])
def test_marching_tetrahedra_matches_jax(jax_native, shape, seed):
    g = _blobby_grid(max(shape), seed)[:shape[0], :shape[1], :shape[2]]
    jv, jt = jmesh.marching_tetrahedra(g, 0.5)
    tv, tt = tmesh.marching_tetrahedra(g, 0.5)
    assert len(tt) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("n_faces,size", [(1, 16), (37, 64), (500, 128)])
def test_uv_atlas_and_rasterize_match_jax(jax_native, n_faces, size):
    uvs = tmesh.per_face_uv_atlas(n_faces, size)
    np.testing.assert_array_equal(uvs, jmesh.per_face_uv_atlas(n_faces, size))
    fid, bary = tmesh.rasterize_uv(uvs, size, size)
    jfid, jbary = jmesh.rasterize_uv(uvs, size, size)
    assert (fid >= 0).any()
    np.testing.assert_array_equal(fid, jfid)
    np.testing.assert_array_equal(bary, jbary)


def test_nearest_inpaint_matches_jax(jax_native):
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=(48, 40)) < 0.15
    img = rng.uniform(size=(48, 40, 3)).astype(np.float32)
    got = tmesh.nearest_inpaint(mask, img, dilate=3)
    want = jmesh.nearest_inpaint(mask, img.copy(), dilate=3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)


def _fields():
    """The same density field for both packages: a box of unequal sides,
    written with a subtraction before the one product and max / abs
    between products, so that no compiler can fuse a multiply-add and both
    give the same bits."""
    def jfn(x):
        m = jnp.maximum(jnp.maximum(jnp.abs(x[:, 0]), jnp.abs(x[:, 1]) * 1.25),
                        jnp.abs(x[:, 2] + 0.1))
        return {"sigma": (0.55 - m) * 40.0, "albedo": (x + 1.0) * 0.5}

    def tfn(x):
        m = torch.maximum(torch.maximum(x[:, 0].abs(), x[:, 1].abs() * 1.25),
                          (x[:, 2] + 0.1).abs())
        return {"sigma": (0.55 - m) * 40.0, "albedo": (x + 1.0) * 0.5}

    return jfn, tfn


def test_export_textured_mesh_matches_jax(jax_native, tmp_path):
    jfn, tfn = _fields()
    kw = dict(resolution=24, density_thresh=10.0, mean_density=3.0,
              tex_size=96, chunk=5000)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jmesh.export_textured_mesh(jfn, str(jdir), **kw)
    stats, timings = {}, {}
    path = tmesh.export_textured_mesh(tfn, str(tdir), device="cpu",
                                      stats=stats, timings=timings, **kw)
    assert path == str(tdir / "mesh.obj")
    assert (tdir / "mesh.obj").read_text() == (jdir / "mesh.obj").read_text()
    assert (tdir / "mesh.mtl").read_text() == (jdir / "mesh.mtl").read_text()
    got = np.asarray(Image.open(tdir / "albedo.png"))
    want = np.asarray(Image.open(jdir / "albedo.png"))
    assert got.shape == (96, 96, 3)
    np.testing.assert_array_equal(got, want)
    assert stats["threshold"] == 3.0 and stats["faces"] > 100
    assert set(timings) == {"density", "iso", "bake", "write"}
    lines = (tdir / "mesh.obj").read_text().splitlines()
    assert sum(line.startswith("v ") for line in lines) == stats["vertices"]
    assert sum(line.startswith("f ") for line in lines) == stats["faces"]


def test_empty_mesh_raises(tmp_path):
    with pytest.raises(ValueError, match="empty mesh"):
        tmesh.export_textured_mesh(
            lambda x: {"sigma": torch.zeros(len(x)),
                       "albedo": torch.zeros(len(x), 3)},
            str(tmp_path), resolution=8, tex_size=16, chunk=4096,
            device="cpu")


def test_main_save_mesh_writes_the_files(tmp_path, monkeypatch):
    """--save_mesh through the port's main on a tiny -O config: the test
    orbit, then mesh.obj, mesh.mtl and albedo.png under <workspace>/mesh.
    The freshly trained field's density is cut at the grid's mean. main
    asks for the 256^3 lattice, as the JAX package's; the test runs the
    export at 32^3 (256^3 is minutes of CPU work)."""
    from dreamfusion_torch.main import main
    from dreamfusion_torch.training.trainer import Trainer

    asked, save_mesh = [], Trainer.save_mesh

    def at_32(self, resolution=256, **kw):
        asked.append(resolution)
        return save_mesh(self, resolution=32, **kw)

    monkeypatch.setattr(Trainer, "save_mesh", at_32)

    ws = tmp_path / "ws"
    tr = main(["-O", "--text", "a cube", "--guidance", "none", "--iters",
               "2", "--h", "8", "--w", "8", "--grid_size", "8",
               "--max_steps", "32", "--H", "12", "--W", "12",
               "--test_size", "1", "--device", "cpu", "--save_mesh",
               "--workspace", str(ws)])
    assert tr.step == 2 and asked == [256]
    for f in ("mesh.obj", "mesh.mtl", "albedo.png"):
        assert (ws / "mesh" / f).stat().st_size > 0, f
    obj = (ws / "mesh" / "mesh.obj").read_text().splitlines()
    assert obj[0] == "mtllib mesh.mtl "
    assert any(line.startswith("f ") for line in obj)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails: the build raises with its output, and the
    export functions raise too; no numpy path stands in."""
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda, "_libs", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed for mesh_native.cpp"):
        cuda.build(["mesh_native"])
    with pytest.raises(RuntimeError, match="mesh_native.cpp"):
        tmesh.marching_tetrahedra(np.ones((4, 4, 4), np.float32), 0.5)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run the compiler"):
        tmesh.rasterize_uv(np.zeros((1, 3, 2), np.float32), 4, 4)
    assert not os.path.exists(tmp_path / "build" / "libmesh_native.so")


def test_library_is_the_ports_own(monkeypatch):
    """The export loads only the library built from the port's source into
    dreamfusion_torch/build, never the JAX package's csrc/ library."""
    loaded = []
    real = cuda.ctypes.CDLL

    def spy(path, *a, **kw):
        loaded.append(os.path.abspath(str(path)))
        return real(path, *a, **kw)

    monkeypatch.setattr(cuda, "_libs", {})
    monkeypatch.setattr(cuda.ctypes, "CDLL", spy)
    tmesh.marching_tetrahedra(_blobby_grid(6, 0), 0.5)
    assert loaded == [str(cuda.BUILD_DIR / "libmesh_native.so")]
    assert str(cuda.PKG_DIR) in loaded[0]
