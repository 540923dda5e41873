// Host-side mesh-extraction core of dreamfusion_torch's mesh export
// (export/mesh.py), the port's own copy of the JAX package's
// csrc/mesh_native.cpp.
//
// Replaces the reference's mesh-export native dependencies (PyMCubes
// marching cubes, xatlas UV unwrap, nvdiffrast UV rasterization, sklearn
// KNN inpaint -- nerf/renderer.py:121-299) with self-contained C++:
//
//  - marching_tetrahedra: iso-surface extraction by splitting each grid cell
//    into 6 tetrahedra (table-free, watertight; a different but equivalent
//    algorithm to the reference's marching cubes)
//  - rasterize_uv: per-triangle UV chart rasterization for texture baking
//    (each face gets its own right-triangle chart in a grid atlas)
//  - nearest_inpaint: two-pass chamfer distance transform with index
//    propagation (the atlas-seam antialiasing, renderer.py:240-256)
//
// Plain C interface, loaded with ctypes. Built at first use by
// dreamfusion_torch/ops/cuda.py: g++ -O3 -fPIC -std=c++17 -shared (ISO
// C++ mode does not contract a*b+c into an FMA, and no -march flag is
// given, so the results do not depend on the host CPU).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>

extern "C" {

// ---------------------------------------------------------------------------
// marching tetrahedra
// ---------------------------------------------------------------------------

namespace {

struct V3 { float x, y, z; };

inline V3 lerp_edge(const V3& a, const V3& b, float va, float vb, float iso) {
    float denom = vb - va;
    float t = (std::fabs(denom) > 1e-12f) ? (iso - va) / denom : 0.5f;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    return {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

// the 6-tetrahedra decomposition of a unit cube (indices into the cube's 8
// corners, corner k = (k&1, (k>>1)&1, (k>>2)&1) in (x, y, z))
static const int TETS[6][4] = {
    {0, 5, 1, 3}, {0, 5, 3, 7}, {0, 5, 7, 4},
    {0, 7, 3, 2}, {0, 7, 2, 6}, {0, 7, 6, 4},
};

struct MeshAccum {
    std::vector<float> verts;     // xyz triples
    std::vector<int32_t> tris;    // index triples
    std::unordered_map<uint64_t, int32_t> edge_cache;

    int32_t vertex_on_edge(uint64_t key_a, uint64_t key_b, const V3& p) {
        if (key_a > key_b) std::swap(key_a, key_b);
        // 21-bit grid-corner ids packed; collision-free for grids < 2^21 cells
        uint64_t key = key_a * 0x9E3779B97F4A7C15ull ^ key_b;
        auto it = edge_cache.find(key);
        if (it != edge_cache.end()) return it->second;
        int32_t idx = (int32_t)(verts.size() / 3);
        verts.push_back(p.x); verts.push_back(p.y); verts.push_back(p.z);
        edge_cache.emplace(key, idx);
        return idx;
    }
};

inline void emit_tet(MeshAccum& m, const V3 pos[4], const float val[4],
                     const uint64_t ids[4], float iso) {
    int inside = 0;
    int code = 0;
    for (int i = 0; i < 4; i++) {
        if (val[i] > iso) { code |= (1 << i); inside++; }
    }
    if (inside == 0 || inside == 4) return;

    // collect crossing edges; orientations chosen so normals point outward
    // (from >iso region to <iso region) consistently enough for export
    int in_idx[4], out_idx[4];
    int ni = 0, no = 0;
    for (int i = 0; i < 4; i++) {
        if (code & (1 << i)) in_idx[ni++] = i; else out_idx[no++] = i;
    }
    auto vert = [&](int i, int o) {
        V3 p = lerp_edge(pos[i], pos[o], val[i], val[o], iso);
        return m.vertex_on_edge(ids[i], ids[o], p);
    };
    if (inside == 1) {
        int a = in_idx[0];
        int32_t v0 = vert(a, out_idx[0]);
        int32_t v1 = vert(a, out_idx[1]);
        int32_t v2 = vert(a, out_idx[2]);
        m.tris.push_back(v0); m.tris.push_back(v1); m.tris.push_back(v2);
    } else if (inside == 3) {
        int a = out_idx[0];
        int32_t v0 = vert(in_idx[0], a);
        int32_t v1 = vert(in_idx[1], a);
        int32_t v2 = vert(in_idx[2], a);
        m.tris.push_back(v0); m.tris.push_back(v2); m.tris.push_back(v1);
    } else {  // 2 in / 2 out -> quad = two triangles
        int i0 = in_idx[0], i1 = in_idx[1], o0 = out_idx[0], o1 = out_idx[1];
        int32_t a = vert(i0, o0);
        int32_t b = vert(i0, o1);
        int32_t c = vert(i1, o1);
        int32_t d = vert(i1, o0);
        m.tris.push_back(a); m.tris.push_back(b); m.tris.push_back(c);
        m.tris.push_back(a); m.tris.push_back(c); m.tris.push_back(d);
    }
}

}  // namespace

// First call with out_* null to get counts, then with buffers to fill.
// Returns 0 on success. State is recomputed each call (a stateless ABI
// keeps ctypes simple; export/mesh.py times the two calls together).
int marching_tetrahedra(const float* grid, int nx, int ny, int nz, float iso,
                        float* out_verts, int64_t* n_verts,
                        int32_t* out_tris, int64_t* n_tris) {
    MeshAccum m;
    const int64_t sy = nz, sx = (int64_t)ny * nz;
    for (int x = 0; x < nx - 1; x++) {
        for (int y = 0; y < ny - 1; y++) {
            for (int z = 0; z < nz - 1; z++) {
                float cval[8];
                V3 cpos[8];
                uint64_t cid[8];
                for (int k = 0; k < 8; k++) {
                    int cx = x + (k & 1), cy = y + ((k >> 1) & 1), cz = z + ((k >> 2) & 1);
                    cval[k] = grid[cx * sx + cy * sy + cz];
                    cpos[k] = {(float)cx, (float)cy, (float)cz};
                    cid[k] = ((uint64_t)cx << 42) | ((uint64_t)cy << 21) | (uint64_t)cz;
                }
                for (int t = 0; t < 6; t++) {
                    V3 pos[4]; float val[4]; uint64_t ids[4];
                    for (int k = 0; k < 4; k++) {
                        pos[k] = cpos[TETS[t][k]];
                        val[k] = cval[TETS[t][k]];
                        ids[k] = cid[TETS[t][k]];
                    }
                    emit_tet(m, pos, val, ids, iso);
                }
            }
        }
    }
    if (out_verts && out_tris) {
        std::memcpy(out_verts, m.verts.data(), m.verts.size() * sizeof(float));
        std::memcpy(out_tris, m.tris.data(), m.tris.size() * sizeof(int32_t));
    }
    *n_verts = (int64_t)(m.verts.size() / 3);
    *n_tris = (int64_t)(m.tris.size() / 3);
    return 0;
}

// ---------------------------------------------------------------------------
// UV-atlas rasterization (texture baking)
// ---------------------------------------------------------------------------

// Rasterize triangles given per-face UVs into (face_id, bary0, bary1) maps.
// uvs: [F, 3, 2] in [0,1]; outputs are HxW (face_id -1 = empty).
int rasterize_uv(const float* uvs, int64_t F, int H, int W,
                 int32_t* face_id, float* bary) {
    for (int64_t i = 0; i < (int64_t)H * W; i++) face_id[i] = -1;
    for (int64_t f = 0; f < F; f++) {
        const float* t = uvs + f * 6;
        float x0 = t[0] * W, y0 = t[1] * H;
        float x1 = t[2] * W, y1 = t[3] * H;
        float x2 = t[4] * W, y2 = t[5] * H;
        int minx = (int)std::floor(std::fmin(x0, std::fmin(x1, x2)));
        int maxx = (int)std::ceil(std::fmax(x0, std::fmax(x1, x2)));
        int miny = (int)std::floor(std::fmin(y0, std::fmin(y1, y2)));
        int maxy = (int)std::ceil(std::fmax(y0, std::fmax(y1, y2)));
        if (minx < 0) minx = 0;
        if (miny < 0) miny = 0;
        if (maxx > W - 1) maxx = W - 1;
        if (maxy > H - 1) maxy = H - 1;
        float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
        if (std::fabs(denom) < 1e-12f) continue;
        for (int py = miny; py <= maxy; py++) {
            for (int px = minx; px <= maxx; px++) {
                float cx = px + 0.5f, cy = py + 0.5f;
                float w0 = ((y1 - y2) * (cx - x2) + (x2 - x1) * (cy - y2)) / denom;
                float w1 = ((y2 - y0) * (cx - x2) + (x0 - x2) * (cy - y2)) / denom;
                float w2 = 1.0f - w0 - w1;
                const float eps = -1e-4f;
                if (w0 >= eps && w1 >= eps && w2 >= eps) {
                    int64_t idx = (int64_t)py * W + px;
                    face_id[idx] = (int32_t)f;
                    bary[idx * 2] = w0;
                    bary[idx * 2 + 1] = w1;
                }
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// nearest-neighbor inpaint (two-pass chamfer index propagation)
// ---------------------------------------------------------------------------

int nearest_inpaint(uint8_t* mask, float* image, int H, int W, int C,
                    int dilate) {
    std::vector<int32_t> src((int64_t)H * W, -1);
    std::vector<float> dist((int64_t)H * W, 1e30f);
    for (int64_t i = 0; i < (int64_t)H * W; i++) {
        if (mask[i]) { src[i] = (int32_t)i; dist[i] = 0.f; }
    }
    auto relax = [&](int64_t i, int64_t j, float w) {
        if (j < 0 || j >= (int64_t)H * W) return;
        if (src[j] >= 0 && dist[j] + w < dist[i]) {
            dist[i] = dist[j] + w;
            src[i] = src[j];
        }
    };
    const float D = 1.41421356f;
    for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++) {
            int64_t i = (int64_t)y * W + x;
            if (dist[i] == 0.f) continue;
            if (x > 0) relax(i, i - 1, 1.f);
            if (y > 0) relax(i, i - W, 1.f);
            if (x > 0 && y > 0) relax(i, i - W - 1, D);
            if (x < W - 1 && y > 0) relax(i, i - W + 1, D);
        }
    for (int y = H - 1; y >= 0; y--)
        for (int x = W - 1; x >= 0; x--) {
            int64_t i = (int64_t)y * W + x;
            if (dist[i] == 0.f) continue;
            if (x < W - 1) relax(i, i + 1, 1.f);
            if (y < H - 1) relax(i, i + W, 1.f);
            if (x < W - 1 && y < H - 1) relax(i, i + W + 1, D);
            if (x > 0 && y < H - 1) relax(i, i + W - 1, D);
        }
    for (int64_t i = 0; i < (int64_t)H * W; i++) {
        if (!mask[i] && src[i] >= 0 && dist[i] <= (float)dilate) {
            for (int c = 0; c < C; c++)
                image[i * C + c] = image[(int64_t)src[i] * C + c];
        }
    }
    return 0;
}

}  // extern "C"
