"""Multi-view dataset format loaders (numpy; the port's copy of
dreamfusion_tpu/datasets/loaders.py).

Rebuilds datasets/nerf/lib/load_data.py:20-197: a `load_data(cfg)` dispatch
returning the uniform dict {hwf, HW, Ks, near, far, near_clip, i_train,
i_val, i_test, poses, render_poses, images, depths, irregular_shape}.

All 13 reference formats: blender (nerf_synthetic transforms_*.json), llff
(poses_bounds.npy), nsvf / tankstemple / blendedmvs (pose/*.txt + rgb/ +
intrinsics.txt), standard_blendedmvs (MVS cams/pair.txt), deepvoxels,
DTU (cameras.npz via native RQ decomposition), toydesk, stanford3D
(panoramic + metric depth), tankstemple360 (Ks/Rs/ts npy), omniScenes
(panoramic), co3d (gzip json annotations).

Images are read by ``read_png`` here, with zlib and struct only (8-bit
grey, grey + alpha, RGB and RGBA, 16-bit grey; filter types 0-4; no
interlace), which gives what imageio gives. A JPEG or any other file that
is not a PNG goes to imageio, imported where it is read; without imageio
that raises, naming the file.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import zlib
from typing import Dict

import numpy as np


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (0 grey, 2 RGB, 4 grey + alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4) of `raw` -> uint8 [h,
    stride]. Sub and Up are vectorised; Average and Paeth, whose bytes
    depend on the byte `bpp` to their left, run byte by byte."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: a running sum per byte lane
            cur = line.copy()
            for lane in range(bpp):
                cur[lane::bpp] = np.cumsum(line[lane::bpp]) & 0xFF
        elif ftype == 2:        # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth
            ln, up, cr = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = cr[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    cr[x] = (ln[x] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cr[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(cr, np.int64)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 (or, at 16 bits, uint16) [H, W] for grey, else
    [H, W, C]: the array imageio gives for the same file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _PNG_CHANNELS or interlace != 0 or depth not in (8, 16) \
            or (depth == 16 and ctype != 0):
        raise ValueError(
            f"{path}: PNG colour type {ctype}, bit depth {depth}, interlace "
            f"{interlace}; read_png takes 8-bit grey, grey + alpha, RGB or "
            "RGBA and 16-bit grey, not interlaced")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = px.reshape(h, w, 2).view(">u2")[..., 0].astype(np.uint16)
        return img
    img = px.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _read_image(path: str) -> np.ndarray:
    """The raw pixel array of an image file: PNGs by read_png, anything
    else (JPEG, EXR) by imageio, imported here."""
    with open(path, "rb") as f:
        if f.read(8) == _PNG_SIGNATURE:
            return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            f"{path} is not a PNG; reading it needs imageio, which is not "
            "installed") from e
    return imageio.imread(path)


def _imread(path: str) -> np.ndarray:
    return (_read_image(path) / 255.0).astype(np.float32)


def _pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Orbit render pose (reference: lib/load_blender.py:8-33)."""
    def trans_t(t):
        return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t],
                         [0, 0, 0, 1]], np.float32)

    def rot_phi(p):
        return np.array([[1, 0, 0, 0], [0, np.cos(p), -np.sin(p), 0],
                         [0, np.sin(p), np.cos(p), 0], [0, 0, 0, 1]], np.float32)

    def rot_theta(t):
        return np.array([[np.cos(t), 0, -np.sin(t), 0], [0, 1, 0, 0],
                         [np.sin(t), 0, np.cos(t), 0], [0, 0, 0, 1]], np.float32)

    c2w = trans_t(radius)
    c2w = rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = rot_theta(theta / 180.0 * np.pi) @ c2w
    return np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float32) @ c2w


def default_render_poses(n: int = 40, phi: float = -30.0, radius: float = 4.0):
    return np.stack([_pose_spherical(a, phi, radius)
                     for a in np.linspace(-180, 180, n + 1)[:-1]])


# -- blender (nerf_synthetic) ------------------------------------------------------

def load_blender_data(basedir: str, testskip: int = 1):
    splits = ["train", "val", "test"]
    all_imgs, all_poses, i_split = [], [], []
    count = 0
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            meta = json.load(f)
        skip = 1 if s == "train" else max(testskip, 1)
        idxs = []
        for frame in meta["frames"][::skip]:
            fp = os.path.join(basedir, frame["file_path"] + ".png")
            all_imgs.append(_imread(fp))
            all_poses.append(np.array(frame["transform_matrix"], np.float32))
            idxs.append(count)
            count += 1
        i_split.append(np.array(idxs))
        camera_angle_x = float(meta["camera_angle_x"])
    imgs = np.stack(all_imgs)
    poses = np.stack(all_poses)
    H, W = imgs.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    return imgs, poses, default_render_poses(), [H, W, focal], i_split


# -- llff (poses_bounds.npy) --------------------------------------------------------

def load_llff_data(basedir: str, factor: int = 8, bd_factor: float = 0.75,
                   recenter: bool = True, spherify: bool = False,
                   llffhold: int = 8):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    img_dir = os.path.join(basedir, f"images_{factor}" if factor > 1 else "images")
    if not os.path.isdir(img_dir):
        img_dir = os.path.join(basedir, "images")
        factor = 1
    img_files = sorted(
        f for f in glob.glob(os.path.join(img_dir, "*"))
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    imgs = np.stack([_imread(f)[..., :3] for f in img_files])

    poses[:2, 4, :] = np.array(imgs.shape[1:3]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / factor

    # llff drb -> rub coordinate fix (the classic column swap)
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :],
                            poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)   # [N, 3, 5]
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = _recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = _spherify_poses(poses, bds)
    else:
        render_poses = np.stack([p[:3, :4] for p in poses])  # input orbit

    i_test = np.array([np.argmin(
        np.sum(np.square(poses[:, :3, 3]
                         - poses[:, :3, 3].mean(0)), -1))])
    return imgs, poses, bds, render_poses, i_test


def _spherify_poses(poses, bds):
    """Recenter around the point closest to all camera axes, normalize to
    unit radius, and generate a circular render path at the cameras' mean
    height (behavioral parity with load_llff.py:210-267 — 360 inward-facing
    capture support)."""
    def norm(v):
        return v / np.linalg.norm(v)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    # least-squares point nearest all camera view lines
    A = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b = -A @ rays_o
    center = np.squeeze(
        -np.linalg.inv((np.transpose(A, (0, 2, 1)) @ A).mean(0)) @ b.mean(0))

    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = norm(up)
    vec1 = norm(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = norm(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    bottom = np.array([[0, 0, 0, 1.0]])
    w2c = np.linalg.inv(np.concatenate([c2w, bottom], 0))
    p44 = np.concatenate(
        [poses[:, :3, :4], np.tile(bottom[None], (poses.shape[0], 1, 1))], 1)
    reset = (w2c[None] @ p44)[:, :3, :4]

    rad = np.sqrt(np.mean(np.sum(np.square(reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    reset[:, :3, 3] *= sc
    bds = bds * sc

    zh = np.mean(reset[:, :3, 3], 0)[2]
    radcircle = np.sqrt(max(1.0 - zh ** 2, 1e-12))
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        cam = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        v2 = norm(cam)
        v0 = norm(np.cross(v2, np.array([0, 0, -1.0])))
        v1 = norm(np.cross(v2, v0))
        new_poses.append(np.stack([v0, v1, v2, cam], 1))
    new_poses = np.stack(new_poses, 0).astype(np.float32)

    hwf = poses[0, :3, 4:]
    reset = np.concatenate(
        [reset, np.broadcast_to(hwf, reset[:, :3, :1].shape)], -1)
    return reset.astype(np.float32), new_poses, bds


def _recenter_poses(poses):
    def viewmatrix(z, up, pos):
        vec2 = z / np.linalg.norm(z)
        vec0 = np.cross(up, vec2)
        vec0 = vec0 / np.linalg.norm(vec0)
        vec1 = np.cross(vec2, vec0)
        return np.stack([vec0, vec1, vec2, pos], 1)

    hwf = poses[:, :3, 4:]
    center = poses[:, :3, 3].mean(0)
    z = poses[:, :3, 2].sum(0)
    up = poses[:, :3, 1].sum(0)
    c2w = np.concatenate([viewmatrix(z, up, center),
                          np.array([[0, 0, 0, 1.0]])], 0)
    bottom = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4),
                     (poses.shape[0], 1, 1))
    p44 = np.concatenate([poses[:, :3, :4], bottom], 1)
    poses_fixed = (np.linalg.inv(c2w) @ p44)[:, :3, :4]
    return np.concatenate([poses_fixed, hwf], -1).astype(np.float32)


# -- pose/*.txt + rgb/*.png conventions (nsvf, tankstemple, standard bmvs) --------

def load_posedir_data(basedir: str, n_sets: int = 3):
    """(reference: lib/load_nsvf.py, load_tankstemple.py) — filenames start
    with the split digit."""
    pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(
        p for ext in ("*png", "*jpg") for p in
        glob.glob(os.path.join(basedir, "rgb", ext)))
    all_poses, all_imgs = [], []
    i_split = [[] for _ in range(n_sets)]
    for i, (pp, rp) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = min(int(os.path.split(rp)[-1][0]), n_sets - 1)
        all_imgs.append(_imread(rp))
        all_poses.append(np.loadtxt(pp).astype(np.float32))
        i_split[i_set].append(i)
    imgs = np.stack(all_imgs)
    poses = np.stack(all_poses)
    H, W = imgs[0].shape[:2]
    K = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    if K.ndim == 1:
        focal = float(K.reshape(-1)[0])
        K = None
    else:
        focal = float(K[0, 0])
    traj = os.path.join(basedir, "test_traj.txt")
    if os.path.isfile(traj):
        render_poses = np.loadtxt(traj).reshape(-1, 4, 4).astype(np.float32)
    else:
        render_poses = poses[i_split[-1]] if i_split[-1] else poses[:1]
    return imgs, poses, render_poses, [H, W, focal], K, [np.array(s) for s in i_split]


# -- deepvoxels ----------------------------------------------------------------

def load_deepvoxels_data(basedir: str, scene: str):
    """(reference: lib/load_deepvoxels.py) — train/validation/test dirs with
    pose/*.txt, rgb/*.png and a shared intrinsics.txt."""
    def parse_intrinsics(fp, H, W):
        with open(fp) as f:
            vals = f.readline().split()
        focal, cx, cy = float(vals[0]), float(vals[1]), float(vals[2])
        return focal * W / 512.0  # deepvoxels intrinsics are for 512 px

    splits = ["train", "validation", "test"]
    all_imgs, all_poses, i_split = [], [], []
    count = 0
    H = W = None
    focal = None
    for s in splits:
        d = os.path.join(basedir, s, scene)
        rgbs = sorted(glob.glob(os.path.join(d, "rgb", "*.png")))
        poses = sorted(glob.glob(os.path.join(d, "pose", "*.txt")))
        idxs = []
        for rp, pp in zip(rgbs, poses):
            img = _imread(rp)[..., :3]
            if H is None:
                H, W = img.shape[:2]
                focal = parse_intrinsics(os.path.join(d, "intrinsics.txt"), H, W)
            all_imgs.append(img)
            all_poses.append(np.loadtxt(pp).reshape(4, 4).astype(np.float32))
            idxs.append(count)
            count += 1
        i_split.append(np.array(idxs))
    imgs = np.stack(all_imgs)
    poses = np.stack(all_poses)
    return imgs, poses, poses[i_split[2]], [H, W, focal], i_split


# -- dtu -------------------------------------------------------------------------

def load_dtu_data_np(basedir: str):
    """(reference: lib/load_dtu.py) — cameras.npz world_mat/scale_mat +
    image/*.png, IDR convention; projection decomposed without cv2."""
    cam = np.load(os.path.join(basedir, "cameras.npz"))
    img_files = sorted(glob.glob(os.path.join(basedir, "image", "*.png")))
    n = len(img_files)
    imgs = np.stack([_imread(f)[..., :3] for f in img_files])
    poses, Ks = [], []
    for i in range(n):
        P = (cam[f"world_mat_{i}"] @ cam.get(f"scale_mat_{i}", np.eye(4)))[:3, :4]
        K, R, t = _decompose_projection(P)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = (-R.T @ t).ravel()
        # IDR -> OpenGL camera convention (flip y, z)
        c2w[:3, 1:3] *= -1
        poses.append(c2w)
        Ks.append(K)
    poses = np.stack(poses)
    Ks = np.stack(Ks).astype(np.float32)
    H, W = imgs.shape[1:3]
    i = np.arange(n)
    i_split = [i[i % 8 != 0], i[i % 8 == 0], i[i % 8 == 0]]
    return imgs, poses, poses[i_split[2]], [H, W, float(Ks[0, 0, 0])], Ks, i_split


def _decompose_projection(P):
    """RQ-decompose P = K [R | t] with positive-diagonal K."""
    M = P[:3, :3]
    # RQ via QR of reversed matrix
    Pm = np.flipud(np.eye(3))
    q, r = np.linalg.qr((Pm @ M).T)
    K = Pm @ r.T @ Pm
    R = Pm @ q.T
    sg = np.diag(np.sign(np.diag(K)))
    K = K @ sg
    R = sg @ R
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    t = np.linalg.inv(K) @ P[:3, 3]
    return (K / K[2, 2]).astype(np.float32), R.astype(np.float32), t


# -- toydesk (transforms_full.json + split dirs) ------------------------------------

_TOYDESK_FIX_ROT = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)


def load_toydesk_data(basedir: str):
    """(reference: lib/load_toydesk.py)"""
    with open(os.path.join(basedir, "transforms_full.json")) as fp:
        meta = json.load(fp)
    if basedir.rstrip("/").endswith("our_desk_1"):
        near, far = 0.3, 9.0
    elif basedir.rstrip("/").endswith("our_desk_2"):
        near, far = 0.8, 24.0
    else:
        raise NotImplementedError("toydesk scene must be our_desk_1/our_desk_2")
    imgs, poses, avail = [], [], []
    for frame in meta["frames"]:
        imgs.append(_imread(os.path.join(basedir, frame["file_path"] + ".png")))
        pose = np.array(frame["transform_matrix"])
        pose[:3, :3] = pose[:3, :3] @ _TOYDESK_FIX_ROT
        poses.append(pose)
        avail.append(frame["idx"])
    idx_convert = {i: k for k, i in enumerate(avail)}
    suffix = basedir.rstrip("/").split("/")[-1]
    split_path = os.path.join(basedir, "..", "..", "split", suffix + "_train_0.8")

    def load_split(p):
        return [int(l) for l in open(p).read().splitlines() if l]

    train_idx = np.array([idx_convert[i] for i in
                          load_split(os.path.join(split_path, "train.txt"))
                          if i in idx_convert])
    test_idx = np.array([idx_convert[i] for i in
                         load_split(os.path.join(split_path, "test.txt"))
                         if i in idx_convert])
    imgs = np.asarray(imgs, np.float32)
    poses = np.asarray(poses, np.float32)
    H, W = imgs[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    return (imgs, poses, default_render_poses(radius=4.0),
            [H, W, focal], [train_idx, test_idx, test_idx], near, far)


# -- stanford 2D-3D-S panoramas (pose jsons + rgb/depth pngs) -------------------------

def load_stanford3d_data(basedir: str):
    """(reference: lib/load_stanford.py) — panoramic rgb + metric depth."""
    cam_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*.json")))
    img_paths = sorted(glob.glob(os.path.join(basedir, "rgb", "*.png")))
    depth_paths = sorted(glob.glob(os.path.join(basedir, "depth", "*.png")))
    images = np.stack([_imread(p)[..., :3] for p in img_paths])

    def convert_d(d):
        d = d.astype(np.float64)
        d[d == 65535] = 0
        return d / 512.0

    depths = np.stack([convert_d(_read_image(p)) for p in depth_paths])

    def load_cam(path):
        cfg = json.load(open(path))
        return np.linalg.inv(np.array(cfg["camera_rt_matrix"]
                                      + [[0.0, 0.0, 0.0, 1.0]]))

    cams = np.stack([load_cam(p) for p in cam_paths]).astype(np.float32)
    tot = len(images)
    perm = np.random.RandomState(seed=233).permutation(tot)
    i_split = [perm, perm[int(tot * 0.8):], perm[int(tot * 0.8):]]
    H, W = images[0].shape[:2]
    return (images, cams, depths, cams[i_split[-1]], [H, W, 1],
            np.zeros((3, 3)), i_split)


# -- standard BlendedMVS (cams/pair.txt + *_cam.txt + blended_images) ------------------

def _load_mvs_cam(path: str):
    """4x4 w2c + 4x4 K from an MVS cam txt (lib/load_standard_blendedmvs.py:6-28)."""
    words = open(path).read().split()
    ext = np.array(words[1:17], np.float32).reshape(4, 4)
    K = np.eye(4, dtype=np.float32)
    K[:3, :3] = np.array(words[18:27], np.float32).reshape(3, 3)
    return np.linalg.inv(ext), K


def load_standard_blendedmvs_data(basedir: str):
    cluster = open(os.path.join(basedir, "cams", "pair.txt")).read().splitlines()
    n = int(cluster[0])
    img_paths, cam_paths = [], []
    for idx in range(n):
        ref = int(cluster[2 * idx + 1])
        for suffix in (".jpg", ".png"):
            p = os.path.join(basedir, "blended_images", f"{ref:08d}_masked{suffix}")
            if os.path.isfile(p):
                img_paths.append(p)
                cam_paths.append(os.path.join(basedir, "cams", f"{ref:08d}_cam.txt"))
                break
    images = np.stack([_imread(p) for p in img_paths])
    cams = np.stack([_load_mvs_cam(p)[0] for p in cam_paths])
    K = _load_mvs_cam(cam_paths[0])[1][:3, :3]
    tot = len(images)
    perm = np.random.RandomState(seed=233).permutation(tot)
    i_split = [perm[: int(tot * 0.8)], perm[int(tot * 0.8):],
               perm[int(tot * 0.8):]]
    H, W = images[0].shape[:2]
    return images, cams, cams[i_split[-1]], [H, W, float(K[0, 0])], K, i_split


# -- tanks&temples 360 (Ks/Rs/ts npy + im_*.jpg + dm_*.npy) ---------------------------

def load_tankstemple360_data(basedir: str):
    rgb_paths = sorted(glob.glob(os.path.join(basedir, "im_*.jpg")))
    depth_paths = sorted(glob.glob(os.path.join(basedir, "dm_*.npy")))
    Ks = np.load(os.path.join(basedir, "Ks.npy"))
    Rs = np.load(os.path.join(basedir, "Rs.npy"))
    Ts = np.load(os.path.join(basedir, "ts.npy"))
    poses, imgs, depths = [], [], []
    for i in range(len(Ks)):
        w2c = np.eye(4)
        w2c[:3, :3] = Rs[i]
        w2c[:3, 3] = Ts[i]
        poses.append(np.linalg.inv(w2c).astype(np.float32))
        imgs.append(_imread(rgb_paths[i]))
        depths.append(np.load(depth_paths[i]))
    imgs = np.stack(imgs)
    poses = np.stack(poses)
    depths = np.stack(depths)
    tot = len(imgs)
    perm = np.random.RandomState(seed=233).permutation(tot)
    i_split = [perm[: int(tot * 0.8)], perm[int(tot * 0.8):],
               perm[int(tot * 0.8):]]
    H, W = imgs[0].shape[:2]
    return (imgs, poses, depths, poses[i_split[-1]],
            [H, W, float(Ks[0][0, 0])], Ks[0], i_split)


# -- omniScenes (panoramic seq_*.jpg + pose txts) -------------------------------------

def load_omniScenes_data(basedir: str):
    cam_paths = sorted(glob.glob(os.path.join(
        basedir.replace("pano", "pose"), "seq_*txt")))
    img_paths = sorted(glob.glob(os.path.join(
        basedir.replace("pose", "pano"), "seq_*jpg")))

    def load_cam(path):
        w = np.array(open(path).read().split()[:12], np.float32).reshape(3, 4)
        cam = np.eye(4, dtype=np.float32)
        cam[:3] = w
        return np.linalg.inv(cam)

    images = np.stack([_imread(p) for p in img_paths])
    cams = np.stack([load_cam(p) for p in cam_paths])
    tot = len(images)
    perm = np.random.RandomState(seed=233).permutation(tot)
    i_split = [perm[: int(tot * 0.8)], perm[int(tot * 0.8):],
               perm[int(tot * 0.8):]]
    H, W = images[0].shape[:2]
    return images, cams, cams[i_split[-1]], [H, W, 1], np.zeros((3, 3)), i_split


# -- co3d (gzip json annotations, per-image K) ---------------------------------------

def load_co3d_data(args):
    """(reference: lib/load_co3d.py) — needs annot_path/split_path/
    sequence_name/datadir on `args`."""
    import gzip

    with gzip.open(args.annot_path, "rt", encoding="utf8") as z:
        annot = [v for v in json.load(z)
                 if v["sequence_name"] == args.sequence_name]
    with open(args.split_path) as f:
        split = json.load(f)
    train_im, test_im = set(), set()
    for k, lst in split.items():
        for v in lst:
            if v[0] == args.sequence_name:
                (train_im if "known" in k else test_im).add(v[-1])

    imgs, masks, poses, Ks = [], [], [], []
    i_split = [[], []]
    for meta in annot:
        fname = meta["image"]["path"]
        sid = 0 if fname in train_im else 1
        if meta["mask"]["mass"] == 0:
            continue
        mask = _imread(os.path.join(args.datadir, meta["mask"]["path"]))
        if mask.max() < 0.5:
            continue
        Rt = np.concatenate([meta["viewpoint"]["R"],
                             np.array(meta["viewpoint"]["T"])[:, None]], 1)
        poses.append(np.linalg.inv(np.concatenate([Rt, [[0, 0, 0, 1]]])))
        imgs.append(_imread(os.path.join(args.datadir, fname)))
        masks.append(mask)
        half_wh = np.float32(meta["image"]["size"][::-1]) * 0.5
        pp = -1.0 * (np.float32(meta["viewpoint"]["principal_point"]) - 1.0) * half_wh
        fl = np.float32(meta["viewpoint"]["focal_length"]) * half_wh
        Ks.append(np.array([[fl[0], 0, pp[0]], [0, fl[1], pp[1]], [0, 0, 1]]))
        i_split[sid].append(len(imgs) - 1)
    imgs = np.array(imgs, dtype=object if len({im.shape for im in imgs}) > 1
                    else None)
    masks = np.array(masks, dtype=imgs.dtype)
    poses = np.stack(poses)
    Ks = np.stack(Ks)
    i_split.append(i_split[-1])
    H, W = np.array([im.shape[:2] for im in imgs]).mean(0).astype(int)
    focal = float(Ks[:, [0, 1], [0, 1]].mean())
    return (imgs, masks, poses, poses[i_split[-1]], [H, W, focal], Ks,
            [np.array(s) for s in i_split])


# -- dispatch (load_data.py:20-197) -----------------------------------------------

def inward_nearfar_heuristic(cam_o: np.ndarray, ratio: float = 0.05):
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = float(dist.max())
    return far * ratio, far


def load_data(args) -> Dict:
    """args: object/dict with dataset_type, datadir, and per-format options."""
    if isinstance(args, dict):
        from types import SimpleNamespace

        args = SimpleNamespace(**args)
    get = lambda k, d=None: getattr(args, k, d)
    K, depths, near_clip = None, None, None
    dt = args.dataset_type

    if dt == "blender":
        images, poses, render_poses, hwf, i_split = load_blender_data(
            args.datadir, testskip=get("testskip", 1))
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        if images.shape[-1] == 4:
            bkgd = np.array(get("bkgd", (1.0, 1.0, 1.0)))
            images = images[..., :3] * images[..., 3:] + (1 - images[..., 3:]) * bkgd
    elif dt == "llff":
        images, poses, bds, render_poses, i_test = load_llff_data(
            args.datadir, get("factor", 8), spherify=get("spherify", False))
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if get("llffhold", 8) > 0:
            i_test = np.arange(images.shape[0])[::get("llffhold", 8)]
        i_val = i_test
        i_train = np.array([i for i in range(len(images)) if i not in i_test])
        if get("ndc", False):
            near, far = 0.0, 1.0
        else:
            near, far = float(bds.min()) * 0.9, float(bds.max())
    elif dt in ("nsvf", "tankstemple", "blendedmvs"):
        # blendedmvs aliases the tankstemple loader (lib/load_blendedmvs.py:1)
        images, poses, render_poses, hwf, K, i_split = load_posedir_data(
            args.datadir, n_sets=3 if dt == "nsvf" else 2 + 1)
        i_train, i_val, i_test = (i_split + [i_split[-1]])[:3]
        ratio = 0.0 if dt == "tankstemple" else 0.05
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio)
        if images.shape[-1] == 4:
            bkgd = np.array(get("bkgd", (1.0, 1.0, 1.0)))
            images = images[..., :3] * images[..., 3:] + (1 - images[..., 3:]) * bkgd
    elif dt == "standard_blendedmvs":
        images, poses, render_poses, hwf, K, i_split = \
            load_standard_blendedmvs_data(args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
    elif dt == "toydesk":
        images, poses, render_poses, hwf, i_split, near, far = \
            load_toydesk_data(args.datadir)
        i_train, i_val, i_test = i_split
        near_clip = 6.0
    elif dt == "stanford3D":
        images, poses, depths, render_poses, hwf, K, i_split = \
            load_stanford3d_data(args.datadir)
        i_train, i_val, i_test = i_split
        near, far = max(0.0, float(depths.min()) - 1e-2), float(depths.max()) + 1e-2
    elif dt == "tankstemple360":
        images, poses, depths, render_poses, hwf, K, i_split = \
            load_tankstemple360_data(args.datadir)
        i_train, i_val, i_test = i_split
        nz = depths[depths != 0]
        near, far = max(0.0, float(nz.min()) - 1e-2), float(depths.max()) + 1e-2
        near_clip = far / 10
        if images.shape[-1] == 4:
            bkgd = np.array(get("bkgd", (1.0, 1.0, 1.0)))
            images = images[..., :3] * images[..., 3:] + (1 - images[..., 3:]) * bkgd
    elif dt == "omniscenes":
        images, poses, render_poses, hwf, K, i_split = \
            load_omniScenes_data(args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
    elif dt == "co3d":
        images, masks, poses, render_poses, hwf, K, i_split = \
            load_co3d_data(args)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0)
        bkgd = np.array(get("bkgd", (1.0, 1.0, 1.0)))
        for i in range(len(images)):
            m = masks[i][..., None]
            images[i] = images[i][..., :3] * m + (1.0 - m) * bkgd
    elif dt == "deepvoxels":
        images, poses, render_poses, hwf, i_split = load_deepvoxels_data(
            args.datadir, get("scene", "greek"))
        i_train, i_val, i_test = i_split
        hemi_R = float(np.mean(np.linalg.norm(poses[:, :3, 3], axis=-1)))
        near, far = hemi_R - 1.0, hemi_R + 1.0
    elif dt == "DTU":
        images, poses, render_poses, hwf, K, i_split = load_dtu_data_np(args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0)
    else:
        raise NotImplementedError(f"Unknown dataset type {dt}")

    H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
    HW = np.array([im.shape[:2] for im in images])
    irregular_shape = images.dtype == np.dtype("object")
    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                     np.float32)
    Ks = K[None].repeat(len(poses), 0) if K.ndim == 2 else K
    render_poses = np.asarray(render_poses)[..., :4]
    if near_clip is None:
        near_clip = near * 0.7 + far * 0.3
    return dict(hwf=[H, W, focal], HW=HW, Ks=Ks, near=near, far=far,
                near_clip=near_clip, i_train=np.asarray(i_train),
                i_val=np.asarray(i_val), i_test=np.asarray(i_test),
                poses=np.asarray(poses), render_poses=render_poses,
                images=images, depths=depths, irregular_shape=irregular_shape)
