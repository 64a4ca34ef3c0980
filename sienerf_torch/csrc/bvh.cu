// K3: the stackless BVH walk of mesh rays, for Hopper (sm_90a).
//
// No TPU kernel computes this: the JAX package walks the BVH as a batched
// loop of masked gathers (geom/bvh.py::bvh_raytrace), and so does the
// port's plain version, sienerf_torch/geom/bvh.py::bvh_raytrace_plain,
// which stays the CPU route and the yardstick of this kernel.
//
// What it computes.  The BVH is TriangleBVH.as_device_arrays' flat layout:
// nodes in DFS order, each with its box, its skip link (the node after its
// subtree, -1 at the end) and, for a leaf, its first triangle and count
// (at most leaf_size); triangles as a, b - a, c - a.  One thread walks one
// ray with one node pointer:
// - the box test against the best t so far (the slab test on the inverse
//   direction, a tiny component replaced by +-1e-12);
// - at a leaf whose box passes, Moller-Trumbore on each of its triangles
//   in order; the leaf's first minimum is taken (strict < within the
//   leaf), and replaces the best only if strictly nearer;
// - then node + 1 (an interior node whose box passes) or the skip link.
// Every operation is the plain version's on the card, rounded as PyTorch's
// CUDA kernels round it: a cross product's a*b - c*d as fma(a, b, -(c*d)),
// a dot product's three terms added as (x + z) + y, one division for the
// inverse direction and one for 1 / det; nothing else fuses (-fmad=false).
// So t, u, v and the triangle ids are the plain walk's bits on the card
// (tests/test_torch_hybrid_cell.py; PERF.md: 0 differences on 10 M rays of
// the benchmark scene).  The walk runs until every ray is done: each step
// moves the pointer forward (node + 1 or a skip link past the subtree),
// so a ray ends within the node count.
//
// Two entry points, one template:
// - closest hit: t (inf on a miss), triangle id (-1 on a miss), u, v;
// - any hit (shadow rays): one byte a ray, 1 when some triangle lies
//   within t_max; the walk ends at the first hit.  Before that hit it is
//   the closest-hit walk step for step, so it answers as the closest
//   hit's id >= 0.  A ray mask (nullable) leaves the masked rays
//   unwalked, so a caller sends every pixel and needs no compaction.
// Origins and directions are rows of three f32 with a row stride each (0
// for one origin shared by every ray), t_max one f32 or one a ray.
//
// What bounds it on an H100.  A ray's work is data-dependent (the boxes
// its line meets, its leaves); the nodes and triangles of a 208,353-
// triangle scene (5 + 7.5 MB) stay in the 50 MB L2, so the walk is bound
// by its instructions and the divergence of a warp's rays, not by HBM.
// The benchmark (perfbench/bvh_work.py, k3_roofline) bounds it by the box
// and triangle tests a plain walk makes at the F32 rate, or by the
// compulsory bytes, whichever is longer.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (sienerf_torch/ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr float DIR_EPS = 1e-12f;  // the slab test's tiny direction component
constexpr float MT_EPS = 1e-9f;    // Moller-Trumbore's |det| and t floor

struct Bvh {
  const float* bmin;  // (M, 3)
  const float* bmax;  // (M, 3)
  const long long* skip;
  const long long* first;
  const long long* count;
  const float* ta;   // (T, 3) a
  const float* tab;  // (T, 3) b - a
  const float* tac;  // (T, 3) c - a
  long long n_tris;
};

struct Out {
  float* t;
  long long* id;
  float* u;
  float* v;
  uint8_t* hit;
};

// a*b - c*d as torch.linalg.cross rounds it (on the CPU and on the card):
// the second product rounded, the first fused into the subtraction
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

// x . y as torch's CUDA sum over a last dimension of 3 adds x * y: the
// first and last terms, then the middle one (the CPU's sum adds in order)
__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1, float x2,
                                      float y2) {
  return (x0 * y0 + x2 * y2) + x1 * y1;
}

__device__ __forceinline__ float inv_component(float d) {
  const float safe = fabsf(d) < DIR_EPS ? (d < 0.0f ? -DIR_EPS : DIR_EPS) : d;
  return 1.0f / safe;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK) bvh_walk_kernel(
    Bvh bvh, const float* __restrict__ orig, long long o_stride,
    const float* __restrict__ dirs, long long d_stride, long long n, float t_max_all,
    const float* __restrict__ t_max_ray, const uint8_t* __restrict__ mask, int leaf_size,
    Out out) {
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (r < n) {
    const bool walk = mask == nullptr || mask[r] != 0;
    const float ox = orig[r * o_stride], oy = orig[r * o_stride + 1],
                oz = orig[r * o_stride + 2];
    const float dx = dirs[r * d_stride], dy = dirs[r * d_stride + 1],
                dz = dirs[r * d_stride + 2];
    const float ix = inv_component(dx), iy = inv_component(dy), iz = inv_component(dz);
    const float t_max = t_max_ray != nullptr ? t_max_ray[r] : t_max_all;
    float best_t = fminf(INFINITY, t_max);
    long long best_id = -1;
    float best_u = 0.0f, best_v = 0.0f;
    long long node = walk ? 0 : -1;
    while (node >= 0) {
      const float* lo = bvh.bmin + node * 3;
      const float* hi = bvh.bmax + node * 3;
      const float t0x = (__ldg(lo) - ox) * ix, t1x = (__ldg(hi) - ox) * ix;
      const float t0y = (__ldg(lo + 1) - oy) * iy, t1y = (__ldg(hi + 1) - oy) * iy;
      const float t0z = (__ldg(lo + 2) - oz) * iz, t1z = (__ldg(hi + 2) - oz) * iz;
      const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
      const float tmax_box = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
      const bool box_hit = (tmax_box >= fmaxf(tmin, 0.0f)) && (tmin < best_t);
      const long long cnt = __ldg(bvh.count + node);
      if (box_hit && cnt > 0) {
        const long long f0 = __ldg(bvh.first + node);
        float lt = INFINITY, lu = 0.0f, lv = 0.0f;
        int lj = -1;
        for (int j = 0; j < leaf_size; ++j) {
          if (j >= cnt) break;
          long long tid = f0 + j;
          tid = tid < 0 ? 0 : (tid > bvh.n_tris - 1 ? bvh.n_tris - 1 : tid);
          const float* a = bvh.ta + tid * 3;
          const float* ab = bvh.tab + tid * 3;
          const float* ac = bvh.tac + tid * 3;
          const float ax = __ldg(a), ay = __ldg(a + 1), az = __ldg(a + 2);
          const float abx = __ldg(ab), aby = __ldg(ab + 1), abz = __ldg(ab + 2);
          const float acx = __ldg(ac), acy = __ldg(ac + 1), acz = __ldg(ac + 2);
          // pvec = d x ac
          const float px = cross_term(dy, acz, dz, acy);
          const float py = cross_term(dz, acx, dx, acz);
          const float pz = cross_term(dx, acy, dy, acx);
          const float det = dot3(abx, px, aby, py, abz, pz);
          const bool ok = fabsf(det) > MT_EPS;
          const float inv_det = ok ? 1.0f / det : 0.0f;
          const float tvx = ox - ax, tvy = oy - ay, tvz = oz - az;
          const float u = dot3(tvx, px, tvy, py, tvz, pz) * inv_det;
          // qvec = tvec x ab
          const float qx = cross_term(tvy, abz, tvz, aby);
          const float qy = cross_term(tvz, abx, tvx, abz);
          const float qz = cross_term(tvx, aby, tvy, abx);
          const float v = dot3(dx, qx, dy, qy, dz, qz) * inv_det;
          const float t = dot3(acx, qx, acy, qy, acz, qz) * inv_det;
          const bool hit = ok && u >= 0.0f && v >= 0.0f && (u + v) <= 1.0f && t > MT_EPS &&
                           t < best_t && t < t_max;
          if (hit && t < lt) {
            lt = t;
            lu = u;
            lv = v;
            lj = j;
          }
        }
        if (lj >= 0 && lt < best_t) {
          best_t = lt;
          best_id = f0 + lj;
          best_u = lu;
          best_v = lv;
          if constexpr (ANY) break;
        }
      }
      node = (box_hit && cnt <= 0) ? node + 1 : __ldg(bvh.skip + node);
    }
    if constexpr (ANY) {
      out.hit[r] = best_id >= 0 ? 1 : 0;
    } else {
      out.t[r] = best_id >= 0 ? best_t : INFINITY;
      out.id[r] = best_id;
      out.u[r] = best_u;
      out.v[r] = best_v;
    }
  }
}

template <bool ANY>
cudaError_t launch(const Bvh& bvh, const float* o, long long os, const float* d, long long ds,
                   long long n, float t_max, const float* t_max_ray, const uint8_t* mask,
                   int leaf_size, const Out& out, cudaStream_t stream) {
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  bvh_walk_kernel<ANY><<<(unsigned)blocks, BLOCK, 0, stream>>>(
      bvh, o, os, d, ds, n, t_max, t_max_ray, mask, leaf_size, out);
  return cudaGetLastError();
}

}  // namespace

// bmin, bmax (M, 3) f32; skip, first, count (M,) int64; tri_a, tri_ab,
// tri_ac (T, 3) f32, all contiguous.  orig, dirs: rows of 3 contiguous f32
// at row strides o_stride, d_stride (elements; 0 shares one row).
// t_max_ray (nullable): one f32 a ray, else t_max for all.  mask
// (nullable): one byte a ray, 0 leaves it unwalked (a miss).  any_hit != 0
// writes hit (one byte a ray); else t, id (int64), u, v.
extern "C" int bvh_walk_launch(
    const void* bmin, const void* bmax, const void* skip, const void* first,
    const void* count, const void* tri_a, const void* tri_ab, const void* tri_ac,
    long long n_tris, const void* orig, long long o_stride, const void* dirs,
    long long d_stride, long long n, float t_max, const void* t_max_ray,
    const void* mask, int leaf_size, int any_hit, void* t, void* id, void* u, void* v,
    void* hit, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_tris <= 0 || leaf_size <= 0 || (n + BLOCK - 1) / BLOCK > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const Bvh bvh{(const float*)bmin, (const float*)bmax, (const long long*)skip,
                (const long long*)first, (const long long*)count, (const float*)tri_a,
                (const float*)tri_ab, (const float*)tri_ac, n_tris};
  const Out out{(float*)t, (long long*)id, (float*)u, (float*)v, (uint8_t*)hit};
#define K3_ARGS                                                                  \
  bvh, (const float*)orig, o_stride, (const float*)dirs, d_stride, n, t_max,    \
      (const float*)t_max_ray, (const uint8_t*)mask, leaf_size, out, (cudaStream_t)stream
  const cudaError_t e = any_hit ? launch<true>(K3_ARGS) : launch<false>(K3_ARGS);
#undef K3_ARGS
  return (int)e;
}

extern "C" const char* bvh_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
