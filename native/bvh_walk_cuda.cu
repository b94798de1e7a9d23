// CUDA kernel for the BVH walk, called from JAX through the foreign function
// interface (cpu_ray_tracer_tpu/ops/bvh_kernel.py registers the handler
// `CrtBvhWalk` as the FFI target "crt_bvh_walk" for the CUDA platform).
//
// One thread walks one ray (bvh_walk.h), so each warp retires when its own
// slowest ray is done, where XLA's batched walk iterates until the slowest
// ray of the whole batch is done.  The node and triangle tables are read
// straight from device memory; at the scene sizes this repository renders
// they sit in the 50 MB L2.
//
// Build: make -C native cuda   (nvcc -gencode arch=compute_90a,code=sm_90a)

#include <cuda_runtime.h>

#include "bvh_walk.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
crt_walk_kernel(CrtBVH bvh, CrtTris tris, const float *__restrict__ o,
                const float *__restrict__ d, const float *__restrict__ t0,
                int64_t n, int any_hit, float *__restrict__ t_out,
                float *__restrict__ bary, int32_t *__restrict__ tri,
                int32_t *__restrict__ obj, int32_t *__restrict__ mat,
                int32_t *__restrict__ traversed, int32_t *__restrict__ tested) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const CrtHit h = crt_walk_ray(bvh, tris, o + 3 * i, d + 3 * i, t0[i], any_hit);
    t_out[i] = h.t;
    bary[2 * i] = h.u;
    bary[2 * i + 1] = h.v;
    tri[i] = h.tri;
    obj[i] = h.obj;
    mat[i] = h.mat;
    traversed[i] = h.traversed;
    tested[i] = h.tested;
}

ffi::Error CrtBvhWalkImpl(
    cudaStream_t stream, ffi::Buffer<ffi::F32> o, ffi::Buffer<ffi::F32> d,
    ffi::Buffer<ffi::F32> t0, ffi::Buffer<ffi::F32> node_min,
    ffi::Buffer<ffi::F32> node_max, ffi::Buffer<ffi::S32> left_first,
    ffi::Buffer<ffi::S32> tri_count, ffi::Buffer<ffi::S32> hit_link,
    ffi::Buffer<ffi::S32> miss_link, ffi::Buffer<ffi::S32> tri_indices,
    ffi::Buffer<ffi::F32> v0, ffi::Buffer<ffi::F32> e1,
    ffi::Buffer<ffi::F32> e2, ffi::Buffer<ffi::S32> obj_id,
    ffi::Buffer<ffi::S32> mat_id, int32_t root, int32_t any_hit,
    ffi::ResultBuffer<ffi::F32> t_out, ffi::ResultBuffer<ffi::F32> bary,
    ffi::ResultBuffer<ffi::S32> tri, ffi::ResultBuffer<ffi::S32> obj,
    ffi::ResultBuffer<ffi::S32> mat, ffi::ResultBuffer<ffi::S32> traversed,
    ffi::ResultBuffer<ffi::S32> tested) {
    const int64_t n = (int64_t)t0.element_count();
    if ((int64_t)o.element_count() != 3 * n || (int64_t)d.element_count() != 3 * n) {
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "crt_bvh_walk: o and d must be [R, 3] beside t0 [R]");
    }
    const int64_t num_nodes = (int64_t)tri_count.element_count();
    if ((int64_t)hit_link.element_count() != 8 * num_nodes ||
        (int64_t)miss_link.element_count() != 8 * num_nodes || root < 0 ||
        root >= num_nodes) {
        return ffi::Error(ffi::ErrorCode::kInvalidArgument,
                          "crt_bvh_walk: link tables must be [8, M] and root in [0, M)");
    }
    if (n == 0) return ffi::Error::Success();
    const CrtBVH bvh{node_min.typed_data(), node_max.typed_data(),
                     left_first.typed_data(), tri_count.typed_data(),
                     hit_link.typed_data(),   miss_link.typed_data(),
                     tri_indices.typed_data(), (int32_t)num_nodes, root};
    const CrtTris tris{v0.typed_data(), e1.typed_data(), e2.typed_data(),
                       obj_id.typed_data(), mat_id.typed_data()};
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    crt_walk_kernel<<<(unsigned)blocks, kBlock, 0, stream>>>(
        bvh, tris, o.typed_data(), d.typed_data(), t0.typed_data(), n, any_hit,
        t_out->typed_data(), bary->typed_data(), tri->typed_data(),
        obj->typed_data(), mat->typed_data(), traversed->typed_data(),
        tested->typed_data());
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
    }
    return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(CrtBvhWalk, CrtBvhWalkImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // o [R, 3]
                                  .Arg<ffi::Buffer<ffi::F32>>()  // d [R, 3]
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t0 [R]
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_min
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_max
                                  .Arg<ffi::Buffer<ffi::S32>>()  // left_first
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tri_count
                                  .Arg<ffi::Buffer<ffi::S32>>()  // hit_link
                                  .Arg<ffi::Buffer<ffi::S32>>()  // miss_link
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tri_indices
                                  .Arg<ffi::Buffer<ffi::F32>>()  // v0
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e1
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e2
                                  .Arg<ffi::Buffer<ffi::S32>>()  // obj_id
                                  .Arg<ffi::Buffer<ffi::S32>>()  // mat_id
                                  .Attr<int32_t>("root")
                                  .Attr<int32_t>("any_hit")
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t
                                  .Ret<ffi::Buffer<ffi::F32>>()   // bary [R, 2]
                                  .Ret<ffi::Buffer<ffi::S32>>()   // tri_idx
                                  .Ret<ffi::Buffer<ffi::S32>>()   // obj_id
                                  .Ret<ffi::Buffer<ffi::S32>>()   // mat_id
                                  .Ret<ffi::Buffer<ffi::S32>>()   // traversed
                                  .Ret<ffi::Buffer<ffi::S32>>()); // tested
