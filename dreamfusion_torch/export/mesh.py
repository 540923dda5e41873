"""Textured mesh export: iso-surface, UV atlas, texture bake (counterpart
of dreamfusion_tpu/export/mesh.py; reference nerf/renderer.py:121-299).

1. density query of the resolution^3 lattice of [-1, 1]^3 on the field's
   device, chunk by chunk (the lattice points are formed per chunk from
   their flat index, so no host array of the lattice exists); the sigma
   grid comes to the host once; threshold = min(mean_density,
   density_thresh);
2. iso-surface by marching tetrahedra (the port's native library,
   csrc/mesh_native.cpp, built by ops/cuda.py with the host compiler);
3. UV atlas: per-face right-triangle charts in a grid (per_face_uv_atlas);
4. UV rasterization (native) and the baked texels' albedo, queried on the
   device in chunks;
5. nearest-texel seam inpaint (native);
6. ``mesh.obj``, ``mesh.mtl`` and ``albedo.png``, written as the JAX
   package writes them.

The native library is required: a failed build raises (the JAX package's
numpy fallbacks rasterize coarser, so they are not the same function).
"""

from __future__ import annotations

import ctypes
import math
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.ops import cuda


def _check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"mesh_native {fn} returned {rc}")


# ---------------------------------------------------------------------------
# iso-surface extraction
# ---------------------------------------------------------------------------

def marching_tetrahedra(grid: np.ndarray, iso: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """grid [nx, ny, nz] float32 -> (verts [V,3] f32 in voxel coords,
    tris [T,3] int32); six tetrahedra a cell, vertices shared by edge."""
    grid = np.ascontiguousarray(grid, np.float32)
    if grid.ndim != 3 or min(grid.shape) < 2:
        raise ValueError(f"grid must be 3-D with every side >= 2, got "
                         f"{grid.shape}")
    fn = cuda.function("marching_tetrahedra")
    nx, ny, nz = grid.shape
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    _check(fn(grid.ctypes.data, nx, ny, nz, iso, None, ctypes.byref(nv), None,
              ctypes.byref(nt)), "marching_tetrahedra")
    verts = np.zeros((nv.value, 3), np.float32)
    tris = np.zeros((nt.value, 3), np.int32)
    _check(fn(grid.ctypes.data, nx, ny, nz, iso, verts.ctypes.data,
              ctypes.byref(nv), tris.ctypes.data, ctypes.byref(nt)),
           "marching_tetrahedra")
    return verts, tris


# ---------------------------------------------------------------------------
# per-face UV atlas
# ---------------------------------------------------------------------------

def per_face_uv_atlas(n_faces: int, tex_size: int, margin: float = 0.125
                      ) -> np.ndarray:
    """Each face a right-triangle chart; two faces share each square cell
    of a ceil(sqrt(cells))^2 grid. -> uvs [F, 3, 2] in [0, 1]. The corners
    are computed in float64 with the JAX package's expressions, then
    rounded to float32, so they are its numbers."""
    cells = (n_faces + 1) // 2
    g = int(math.ceil(math.sqrt(cells)))
    cw = 1.0 / g
    m = margin * cw
    f = np.arange(n_faces)
    cell = f // 2
    cxr = (cell % g) * cw
    cyr = (cell // g) * cw
    lower = (f % 2) == 0
    lo = np.stack([np.stack([cxr + m, cyr + m], -1),
                   np.stack([cxr + cw - 2 * m, cyr + m], -1),
                   np.stack([cxr + m, cyr + cw - 2 * m], -1)], 1)
    up = np.stack([np.stack([cxr + cw - m, cyr + cw - m], -1),
                   np.stack([cxr + 2 * m, cyr + cw - m], -1),
                   np.stack([cxr + cw - m, cyr + 2 * m], -1)], 1)
    return np.where(lower[:, None, None], lo, up).astype(np.float32)


def rasterize_uv(uvs: np.ndarray, H: int, W: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """uvs [F, 3, 2] -> (face_id [H,W] int32, -1 where empty;
    bary [H,W,2] float32), texel centres tested against each chart."""
    uvs = np.ascontiguousarray(uvs, np.float32)
    if uvs.ndim != 3 or uvs.shape[1:] != (3, 2):
        raise ValueError(f"uvs must be [F, 3, 2], got {uvs.shape}")
    face_id = np.full((H, W), -1, np.int32)
    bary = np.zeros((H, W, 2), np.float32)
    _check(cuda.function("rasterize_uv")(uvs.ctypes.data, uvs.shape[0], H, W,
                                         face_id.ctypes.data,
                                         bary.ctypes.data), "rasterize_uv")
    return face_id, bary


def nearest_inpaint(mask: np.ndarray, image: np.ndarray, dilate: int = 3
                    ) -> np.ndarray:
    """Fill the texels outside `mask` from the nearest texel inside it
    within chamfer distance `dilate` (renderer.py:240-256)."""
    H, W = mask.shape
    img = np.array(image, np.float32, order="C")
    if img.shape[:2] != (H, W):
        raise ValueError(f"image {img.shape} does not match mask {mask.shape}")
    m8 = np.ascontiguousarray(mask.astype(np.uint8))
    _check(cuda.function("nearest_inpaint")(
        m8.ctypes.data, img.ctypes.data, H, W,
        img.shape[-1] if img.ndim == 3 else 1, dilate), "nearest_inpaint")
    return img


# ---------------------------------------------------------------------------
# full export
# ---------------------------------------------------------------------------

@torch.no_grad()
def query_sigma_grid(density_fn: Callable, resolution: int,
                     device: torch.device, chunk: int) -> np.ndarray:
    """sigma on the resolution^3 lattice of np.linspace(-1, 1) (x slowest),
    queried in chunks on `device`; one copy to the host at the end."""
    lin = torch.from_numpy(np.linspace(-1, 1, resolution,
                                       dtype=np.float32)).to(device)
    n = resolution ** 3
    sig = torch.empty(n, dtype=torch.float32, device=device)
    for s in range(0, n, chunk):
        idx = torch.arange(s, min(s + chunk, n), device=device)
        pts = torch.stack([lin[idx // resolution ** 2],
                           lin[(idx // resolution) % resolution],
                           lin[idx % resolution]], -1)
        sig[s:s + idx.shape[0]] = density_fn(pts)["sigma"].float()
    return sig.cpu().numpy().reshape(resolution, resolution, resolution)


def _texts(a: np.ndarray) -> list:
    """float32 array -> nested list of each value's text as an f-string
    prints a numpy float32 (the repr of the value as a Python float), each
    distinct value formatted once: the vertices share lattice coordinates
    and the atlas corners take few values."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    vals, inv = np.unique(bits, return_inverse=True)
    strs = np.array([f"{v}" for v in vals.view(np.float32).tolist()],
                    dtype=object)
    return strs[inv.reshape(-1)].reshape(a.shape).tolist()


def write_obj(out_dir: str, name: str, verts: np.ndarray, tris: np.ndarray,
              uvs: np.ndarray) -> str:
    """mesh.obj (one vt per face corner) and mesh.mtl, the JAX package's
    text (renderer.py:266-298)."""
    obj_path = os.path.join(out_dir, f"{name}mesh.obj")
    uv = uvs.reshape(-1, 2)
    with open(obj_path, "w") as fp:
        fp.write(f"mtllib {name}mesh.mtl \n")
        fp.writelines(f"v {a} {b} {c} \n" for a, b, c in _texts(verts))
        fp.writelines(f"vt {u} {w} \n" for u, w in zip(
            _texts(uv[:, 0]), _texts(np.float32(1) - uv[:, 1])))
        fp.write("usemtl mat0 \n")
        fp.writelines(f"f {a}/{3 * i + 1} {b}/{3 * i + 2} {c}/{3 * i + 3} \n"
                      for i, (a, b, c) in enumerate((tris + 1).tolist()))
    with open(os.path.join(out_dir, f"{name}mesh.mtl"), "w") as fp:
        fp.write("newmtl mat0 \nKa 1.000000 1.000000 1.000000 \n"
                 "Kd 1.000000 1.000000 1.000000 \n"
                 "Ks 0.000000 0.000000 0.000000 \nTr 1.000000 \n"
                 f"illum 1 \nNs 0.000000 \nmap_Kd {name}albedo.png \n")
    return obj_path


@torch.no_grad()
def export_textured_mesh(density_fn: Callable, out_dir: str, *,
                         resolution: int = 256, density_thresh: float = 10.0,
                         mean_density: Optional[float] = None,
                         tex_size: int = 1024, chunk: int,
                         name: str = "", device=None,
                         timings: Optional[Dict[str, float]] = None,
                         stats: Optional[Dict] = None) -> str:
    """density_fn(x [N,3] on `device`) -> {'sigma': [N], 'albedo': [N,3]}.
    Writes <name>mesh.obj, <name>mesh.mtl and <name>albedo.png into
    out_dir and returns the .obj path. chunk: the points (lattice points,
    then texels) given to density_fn a call. device: the GPU unless "cpu"
    is given. timings (optional) receives the seconds of the stages density,
    iso, bake and write (the density and bake stages end in a copy to the
    host, so they include the device's work); stats (optional) the
    threshold and the vertex and face counts."""
    from dreamfusion_torch.training.trainer import write_png

    device = resolve_device(device)
    timings = {} if timings is None else timings
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    grid = query_sigma_grid(density_fn, resolution, device, chunk)
    t1 = time.perf_counter()
    timings["density"] = t1 - t0

    thresh = density_thresh if mean_density is None else min(mean_density,
                                                             density_thresh)
    verts, tris = marching_tetrahedra(grid, thresh)
    if len(verts) == 0:
        raise ValueError("empty mesh: no density above threshold "
                         f"{thresh} at resolution {resolution}")
    verts = verts / (resolution - 1.0) * 2.0 - 1.0   # voxel -> [-1, 1]
    t2 = time.perf_counter()
    timings["iso"] = t2 - t1

    uvs = per_face_uv_atlas(len(tris), tex_size)
    face_id, bary = rasterize_uv(uvs, tex_size, tex_size)
    mask = face_id >= 0
    tex = np.zeros((tex_size, tex_size, 3), np.float32)
    yy, xx = np.nonzero(mask)
    f = face_id[yy, xx]
    w0 = bary[yy, xx, 0:1]
    w1 = bary[yy, xx, 1:2]
    w2 = 1.0 - w0 - w1
    tv = verts[tris[f]]                                   # [M, 3, 3]
    surf = torch.from_numpy(w0 * tv[:, 0] + w1 * tv[:, 1] + w2 * tv[:, 2])
    albedo = torch.empty(len(surf), 3, dtype=torch.float32, device=device)
    for s in range(0, len(surf), chunk):
        albedo[s:s + chunk] = density_fn(
            surf[s:s + chunk].to(device))["albedo"].float()
    tex[yy, xx] = albedo.cpu().numpy()
    tex = nearest_inpaint(mask, tex, dilate=3)
    t3 = time.perf_counter()
    timings["bake"] = t3 - t2

    write_png(os.path.join(out_dir, f"{name}albedo.png"),
              (np.clip(tex, 0, 1) * 255).astype(np.uint8))
    obj_path = write_obj(out_dir, name, verts, tris, uvs)
    timings["write"] = time.perf_counter() - t3
    if stats is not None:
        stats.update(threshold=float(thresh), vertices=len(verts),
                     faces=len(tris))
    return obj_path
