// Per-ray walk of the threaded (skip-link) BVH, shared by the CUDA kernel
// (bvh_walk_cuda.cu, one thread per ray) and the host build
// (crt_native.cpp, crt_traverse) that the CPU tests compare with
// cpu_ray_tracer_tpu/ops/traverse_bvh.py.
//
// It is the XLA walk of ops/traverse_bvh.py done for one ray: the slab test
// against the running best t, Möller–Trumbore on each leaf triangle in slot
// order (ops/intersect.py), the cursor following the ray octant's hit link
// into an interior node whose box is hit and the miss link otherwise, the
// cursor parking at -1, and any-hit parking on the first hit.  The
// arithmetic follows the XLA version operation by operation; min/max
// propagate NaN as XLA's do (a zero direction component makes 0 * inf).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define CRT_HD __host__ __device__ __forceinline__
#else
#define CRT_HD static inline
#endif

// Threaded BVH tables (accel/types.py BVHArrays), row-major.
struct CrtBVH {
    const float *node_min;      // [M, 3]
    const float *node_max;      // [M, 3]
    const int32_t *left_first;  // [M] first leaf slot
    const int32_t *tri_count;   // [M] 0 = interior
    const int32_t *hit_link;    // [8, M]
    const int32_t *miss_link;   // [8, M]
    const int32_t *tri_indices; // [slots] into the triangle pool
    int32_t num_nodes;
    int32_t root;
};

// Triangle pool (accel/types.py TrianglePool).
struct CrtTris {
    const float *v0;  // [N, 3]
    const float *e1;  // [N, 3]
    const float *e2;  // [N, 3]
    const int32_t *obj_id;
    const int32_t *mat_id;
};

struct CrtHit {
    float t, u, v;
    int32_t tri, obj, mat, traversed, tested;
};

#define CRT_TRI_EPS 1e-4f

CRT_HD float crt_min(float a, float b) { return (a < b || a != a) ? a : b; }
CRT_HD float crt_max(float a, float b) { return (a > b || a != a) ? a : b; }

CRT_HD CrtHit crt_walk_ray(const CrtBVH &bvh, const CrtTris &tris,
                           const float *o, const float *d, float t0,
                           int any_hit) {
    const float ox = o[0], oy = o[1], oz = o[2];
    const float dx = d[0], dy = d[1], dz = d[2];
    const float rx = 1.0f / dx, ry = 1.0f / dy, rz = 1.0f / dz;
    const int oct = (dx < 0.0f) + 2 * (dy < 0.0f) + 4 * (dz < 0.0f);
    const int32_t *hit_link = bvh.hit_link + (int64_t)oct * bvh.num_nodes;
    const int32_t *miss_link = bvh.miss_link + (int64_t)oct * bvh.num_nodes;
    const int max_steps = 2 * bvh.num_nodes + 4;

    CrtHit h;
    h.t = t0;
    h.u = 0.0f;
    h.v = 0.0f;
    h.tri = -1;
    h.traversed = 0;
    h.tested = 0;
    int cur = bvh.root;
    for (int step = 0; cur >= 0 && step < max_steps; ++step) {
        h.traversed++;
        const float *lo = bvh.node_min + 3 * (int64_t)cur;
        const float *hi = bvh.node_max + 3 * (int64_t)cur;
        const float t1x = (lo[0] - ox) * rx, t2x = (hi[0] - ox) * rx;
        const float t1y = (lo[1] - oy) * ry, t2y = (hi[1] - oy) * ry;
        const float t1z = (lo[2] - oz) * rz, t2z = (hi[2] - oz) * rz;
        const float tmin = crt_max(crt_max(crt_min(t1x, t2x), crt_min(t1y, t2y)), crt_min(t1z, t2z));
        const float tmax = crt_min(crt_min(crt_max(t1x, t2x), crt_max(t1y, t2y)), crt_max(t1z, t2z));
        const bool box_hit = (tmax >= tmin) && (tmin < h.t) && (tmax > 0.0f);
        const int count = bvh.tri_count[cur];
        if (box_hit && count > 0) {
            const int first = bvh.left_first[cur];
            for (int k = 0; k < count; ++k) {
                const int tid = bvh.tri_indices[first + k];
                const float *v0 = tris.v0 + 3 * (int64_t)tid;
                const float *e1 = tris.e1 + 3 * (int64_t)tid;
                const float *e2 = tris.e2 + 3 * (int64_t)tid;
                // h = d x e2, a = e1 . h
                const float hx = dy * e2[2] - dz * e2[1];
                const float hy = dz * e2[0] - dx * e2[2];
                const float hz = dx * e2[1] - dy * e2[0];
                const float a = e1[0] * hx + e1[1] * hy + e1[2] * hz;
                const float f = 1.0f / ((a < 0.0f ? -a : a) < 1e-30f ? 1e-30f : a);
                const float sx = ox - v0[0], sy = oy - v0[1], sz = oz - v0[2];
                const float u = f * (sx * hx + sy * hy + sz * hz);
                // q = s x e1
                const float qx = sy * e1[2] - sz * e1[1];
                const float qy = sz * e1[0] - sx * e1[2];
                const float qz = sx * e1[1] - sy * e1[0];
                const float v = f * (dx * qx + dy * qy + dz * qz);
                const float t = f * (e2[0] * qx + e2[1] * qy + e2[2] * qz);
                const bool hit = (a < 0.0f ? -a : a) >= CRT_TRI_EPS && u >= 0.0f &&
                                 u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                                 t > CRT_TRI_EPS && t < h.t;
                if (hit) {
                    h.t = t;
                    h.u = u;
                    h.v = v;
                    h.tri = tid;
                }
                h.tested++;
            }
        }
        cur = (box_hit && count == 0) ? hit_link[cur] : miss_link[cur];
        if (any_hit && h.tri >= 0) cur = -1;
    }
    h.obj = h.tri >= 0 ? tris.obj_id[h.tri] : -1;
    h.mat = h.tri >= 0 ? tris.mat_id[h.tri] : -1;
    return h;
}
