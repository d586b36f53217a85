// Binary-BVH ray traversal for NVIDIA GPUs (sm_90a), called from JAX through
// the XLA FFI as the custom call "lf_bvh_traverse".
//
// One thread per ray, each with a private stack of node ids.  The semantics
// are those of the XLA traversal in ops/intersect.py (_make_traverse), step
// for step, so both paths return the same (t, prim, b1, b2, found, tests):
//   - child boxes are tested when their parent is popped, against
//     [t_lo, min(t_hi, best_t)], and pushed far child first, so the near
//     child (smaller slab entry, ties to the left) pops first;
//   - a popped leaf tests every primitive it holds, and `tests` counts them;
//   - the any-hit variant stops after the first leaf that yields a hit.
// Only the memory layout differs: see pack_scene in ops/traverse.py.
//   nodes (M + 1, 16) f32: per node the left and right child boxes
//     [lmin xyz, lmax xyz, rmin xyz, rmax xyz] and two int32 links (bit
//     cast): interior -> (left, right), leaf -> (start, -count).  Row M
//     holds the root's own box in its first six slots.
//   prims (P, 12) f32 in leaf order: a triangle is [p0, e1, e2, id, 0, 0],
//   a sphere [center, radius, 0 x 5, id, 0, 0]; id >= num_tris is a sphere.

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStack = 64;
constexpr float kInf = 1e30f;
constexpr int kBlock = 128;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// Slab test (bbox.cpp:12-49).  Returns whether the box is hit inside
// [lo, hi] and writes the entry distance.
__device__ __forceinline__ bool ray_box(const float* o, const float* inv,
                                        float mnx, float mny, float mnz,
                                        float mxx, float mxy, float mxz,
                                        float lo, float hi, float* t_entry) {
  const float t1x = (mnx - o[0]) * inv[0], t2x = (mxx - o[0]) * inv[0];
  const float t1y = (mny - o[1]) * inv[1], t2y = (mxy - o[1]) * inv[1];
  const float t1z = (mnz - o[2]) * inv[2], t2z = (mxz - o[2]) * inv[2];
  const float t_min =
      fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  const float t_max =
      fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  *t_entry = t_min;
  return (t_min <= t_max) && (t_max >= lo) && (t_min <= hi);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(int64_t n, const float* __restrict__ ray_o,
                    const float* __restrict__ ray_d,
                    const float* __restrict__ ray_lo,
                    const float* __restrict__ ray_hi,
                    const float4* __restrict__ nodes, int64_t num_nodes,
                    const float4* __restrict__ prims, int32_t num_tris,
                    float* __restrict__ out_t, int32_t* __restrict__ out_prim,
                    float* __restrict__ out_b1, float* __restrict__ out_b2,
                    int32_t* __restrict__ out_found,
                    int32_t* __restrict__ out_tests) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const float o[3] = {ray_o[3 * lane], ray_o[3 * lane + 1], ray_o[3 * lane + 2]};
  const float d[3] = {ray_d[3 * lane], ray_d[3 * lane + 1], ray_d[3 * lane + 2]};
  const float t_lo = ray_lo[lane];
  const float t_hi = ray_hi[lane];

  float best_t = kInf, best_b1 = 0.f, best_b2 = 0.f;
  int32_t best_prim = -1, tests = 0;
  bool found = false;

  // NaN-safe reciprocal: a zero component becomes +-1e-12 before the divide
  float inv[3];
  bool finite = true;
  for (int a = 0; a < 3; ++a) {
    const float c = d[a] >= 0.f ? fmaxf(d[a], 1e-12f) : fminf(d[a], -1e-12f);
    inv[a] = 1.0f / c;
    finite = finite && !isnan(o[a]) && !isnan(d[a]);
  }

  int32_t stack[kStack];
  int sp = 0;
  {
    const float4 r0 = nodes[4 * num_nodes];
    const float4 r1 = nodes[4 * num_nodes + 1];
    float t_entry;
    // an empty interval (dead lane: t_hi < t_lo) visits nothing
    if (finite && t_lo <= t_hi &&
        ray_box(o, inv, r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, t_lo, t_hi,
                &t_entry)) {
      stack[sp++] = 0;
    }
  }

  while (sp > 0) {
    if (kAnyHit && found) break;
    const int32_t node = stack[--sp];
    const float4 link = nodes[4 * node + 3];
    const int32_t c0 = __float_as_int(link.x);
    const int32_t c1 = __float_as_int(link.y);
    if (c1 < 0) {
      // leaf: test every primitive it holds
      const int32_t count = -c1;
      for (int32_t i = 0; i < count; ++i) {
        const int64_t slot = static_cast<int64_t>(c0) + i;
        const float4 g0 = prims[3 * slot];
        const float4 g1 = prims[3 * slot + 1];
        const float4 g2 = prims[3 * slot + 2];
        const int32_t pid = __float_as_int(g2.y);
        const float hi = fminf(t_hi, best_t);
        if (pid < num_tris) {
          // Moller-Trumbore (triangle.cpp:25-68)
          const float e1x = g0.w, e1y = g1.x, e1z = g1.y;
          const float e2x = g1.z, e2y = g1.w, e2z = g2.x;
          const float sx = o[0] - g0.x, sy = o[1] - g0.y, sz = o[2] - g0.z;
          const float s1x = d[1] * e2z - d[2] * e2y;
          const float s1y = d[2] * e2x - d[0] * e2z;
          const float s1z = d[0] * e2y - d[1] * e2x;
          const float s2x = sy * e1z - sz * e1y;
          const float s2y = sz * e1x - sx * e1z;
          const float s2z = sx * e1y - sy * e1x;
          const float det = dot3(s1x, s1y, s1z, e1x, e1y, e1z);
          const float inv_det = det != 0.f ? 1.0f / det : 0.f;
          const float t = dot3(s2x, s2y, s2z, e2x, e2y, e2z) * inv_det;
          const float b1 = dot3(s1x, s1y, s1z, sx, sy, sz) * inv_det;
          const float b2 = dot3(s2x, s2y, s2z, d[0], d[1], d[2]) * inv_det;
          const bool valid = det != 0.f && t >= t_lo && t <= hi && b1 >= 0.f &&
                             b1 <= 1.f && b2 >= 0.f && b2 <= 1.f &&
                             b1 + b2 <= 1.f;
          if (valid) {
            found = true;
            if (t < best_t) {
              best_t = t;
              best_prim = pid;
              best_b1 = b1;
              best_b2 = b2;
            }
          }
        } else {
          // sphere quadratic (sphere.cpp:11-111)
          const float ocx = o[0] - g0.x, ocy = o[1] - g0.y, ocz = o[2] - g0.z;
          const float r = g0.w;
          const float a = dot3(d[0], d[1], d[2], d[0], d[1], d[2]);
          const float b = 2.0f * dot3(ocx, ocy, ocz, d[0], d[1], d[2]);
          const float cc = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
          const float disc = b * b - 4.0f * a * cc;
          const float sq = sqrtf(fmaxf(disc, 0.f));
          const float t1 = (-b - sq) / (2.0f * a);
          const float t2 = (-b + sq) / (2.0f * a);
          const bool t1_ok = t1 >= t_lo && t1 <= hi;
          const bool t2_ok = t2 >= t_lo && t2 <= hi;
          const float t = t1_ok ? t1 : t2;
          if (disc >= 0.f && (t1_ok || t2_ok)) {
            found = true;
            if (t < best_t) {
              best_t = t;
              best_prim = pid;
            }
          }
        }
        ++tests;
      }
      continue;
    }
    // interior: test both child boxes, push the far one first
    const float4 a0 = nodes[4 * node];
    const float4 a1 = nodes[4 * node + 1];
    const float4 a2 = nodes[4 * node + 2];
    const float hi = fminf(t_hi, best_t);
    float l_t, r_t;
    const bool l_ok =
        ray_box(o, inv, a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, t_lo, hi, &l_t);
    const bool r_ok =
        ray_box(o, inv, a1.z, a1.w, a2.x, a2.y, a2.z, a2.w, t_lo, hi, &r_t);
    const bool near_is_left = l_t <= r_t;
    const int32_t far_node = near_is_left ? c1 : c0;
    const bool far_ok = near_is_left ? r_ok : l_ok;
    const int32_t near_node = near_is_left ? c0 : c1;
    const bool near_ok = near_is_left ? l_ok : r_ok;
    if (far_ok && sp < kStack) stack[sp++] = far_node;
    if (near_ok && sp < kStack) stack[sp++] = near_node;
  }

  out_t[lane] = best_t;
  out_prim[lane] = best_prim;
  out_b1[lane] = best_b1;
  out_b2[lane] = best_b2;
  out_found[lane] = found ? 1 : 0;
  out_tests[lane] = tests;
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> o,
                        ffi::Buffer<ffi::F32> d, ffi::Buffer<ffi::F32> t_lo,
                        ffi::Buffer<ffi::F32> t_hi,
                        ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::F32> prims,
                        ffi::ResultBuffer<ffi::F32> t,
                        ffi::ResultBuffer<ffi::S32> prim,
                        ffi::ResultBuffer<ffi::F32> b1,
                        ffi::ResultBuffer<ffi::F32> b2,
                        ffi::ResultBuffer<ffi::S32> found,
                        ffi::ResultBuffer<ffi::S32> tests, int32_t num_tris,
                        int32_t any_hit) {
  const int64_t n = static_cast<int64_t>(t_lo.element_count());
  if (o.element_count() != 3 * n || d.element_count() != 3 * n ||
      t_hi.element_count() != n) {
    return ffi::Error::InvalidArgument("lf_bvh_traverse: ray arrays disagree");
  }
  if (nodes.element_count() % 16 != 0 || nodes.element_count() < 32 ||
      prims.element_count() % 12 != 0) {
    return ffi::Error::InvalidArgument("lf_bvh_traverse: bad packed scene");
  }
  if (n == 0) return ffi::Error::Success();
  const int64_t num_nodes = static_cast<int64_t>(nodes.element_count()) / 16 - 1;
  const auto* node4 = reinterpret_cast<const float4*>(nodes.typed_data());
  const auto* prim4 = reinterpret_cast<const float4*>(prims.typed_data());
  const int64_t grid = (n + kBlock - 1) / kBlock;
  if (any_hit) {
    traverse_kernel<true><<<grid, kBlock, 0, stream>>>(
        n, o.typed_data(), d.typed_data(), t_lo.typed_data(),
        t_hi.typed_data(), node4, num_nodes, prim4, num_tris,
        t->typed_data(), prim->typed_data(), b1->typed_data(),
        b2->typed_data(), found->typed_data(), tests->typed_data());
  } else {
    traverse_kernel<false><<<grid, kBlock, 0, stream>>>(
        n, o.typed_data(), d.typed_data(), t_lo.typed_data(),
        t_hi.typed_data(), node4, num_nodes, prim4, num_tris,
        t->typed_data(), prim->typed_data(), b1->typed_data(),
        b2->typed_data(), found->typed_data(), tests->typed_data());
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("lf_bvh_traverse launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LfBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // o
                                  .Arg<ffi::Buffer<ffi::F32>>()  // d
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_lo
                                  .Arg<ffi::Buffer<ffi::F32>>()  // t_hi
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // prims
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // prim
                                  .Ret<ffi::Buffer<ffi::F32>>()  // b1
                                  .Ret<ffi::Buffer<ffi::F32>>()  // b2
                                  .Ret<ffi::Buffer<ffi::S32>>()  // found
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tests
                                  .Attr<int32_t>("num_tris")
                                  .Attr<int32_t>("any_hit"));
