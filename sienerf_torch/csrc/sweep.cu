// K2: front-to-back slab-sweep composite, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/sweep_pallas.py::_sweep_kernel
// (entry sweep_composite_pallas).  Plain PyTorch version:
// sienerf_torch/ops/sweep.py::sweep_composite (the reference's
// ops/sweep.py::_composite_over); the slab intervals below have theirs in
// ops/sweep.py::slab_intervals.
//
// What it computes.  The Pallas kernel walks a (row tile, slab) grid in
// order and keeps the carry (rgb, T, best weight, best t) in VMEM across
// the sequential slab axis, resampling each slab with two MXU matmuls.
// Blocks on Hopper run in no order, so the sequential axis is a loop inside
// the thread: one thread per intermediate pixel composites the slabs of
// the schedule front to back with the carry in registers.  Per slab it
// evaluates the slab's affine map gu = (o_b + x_rel*e_b - lo)/pitch,
// gv = (o_c + x_rel*e_c - lo)/pitch in the reference's operation order and
// reads the texels directly instead of multiplying by interpolation
// matrices:
//   nearest: the matrices are one-hot and exact in bf16, so the texel at
//            ceil(g - 0.5) (g in [0, R], else zero) IS the matmul result;
//   linear:  the two nonzero hat weights per axis, rounded to bf16, a row
//            pass over the 2x2 texels rounded to bf16, then the column
//            pass.  A product of two bf16 values is exact in f32 and each
//            sum has two nonzero terms, so this reproduces the two f32
//            matmuls bit for bit.
// The inner-square cascade-ownership zeroing, the phase blend of planes j
// and j+1 in bf16, the t_stop cap and the data flip (read data plane R-j)
// follow the plain version.  The schedule may be a contiguous slice of
// slab_schedule's (a rank's share of the sharded sweep, composited from
// T = 1), and the best weight may be written beside the maps (the sharded
// sweep folds the ranks' partials with it).  A sample that cannot contribute (out of the
// lattice, zeroed, in front of `near`, behind `t_stop`) adds exactly
// nothing there, so it is skipped; once T < minT every later alpha is 0.
//
// What bounds it on an H100 (fox 720p: Hi=896, Wi=1536, S=768 over a
// 0.41 GB volume).  Early termination and the zeroed inner squares leave
// most of the volume unread: chip_smoke.py counts the texels this run's
// live samples touch and ~30 flops and one exp per live sample, and the
// larger time is the bound (operations, about 0.05 ms).  That is not the
// floor of a serial loop with a data-dependent exit: only a tenth of the
// 1.06 G (pixel, slab) pairs are live, the bytes are few (tens of MB), and
// what costs time is the instructions of a warp-iteration (a warp runs on
// while any of its lanes is live) and the set-up of each warp's list.
//
// Design.
// - Only slabs that can be live are walked.  Within one cascade gu, gv and
//   t_hat are affine in the slab index j, so the slabs with 0 <= gu, gv <= R
//   and near <= t_hat <= t_stop form one interval per cascade and pixel.
//   Each thread computes its K intervals once, in f64 with a margin that
//   covers the f32 evaluation error (a superset: inside it every test still
//   runs in f32, so the texel chosen cannot change).  A warp merges its
//   lanes' intervals and compacts the schedule into its own list of slabs;
//   the loop runs over that list in lockstep.
// - What every pixel shares of a schedule entry (x_rel, cascade, j, the
//   inner flag, the offsets of its data planes) and of a cascade (pitch, lo)
//   is computed once a block into shared memory (768 entries: 18 KB), so an
//   iteration reads it as two 16-byte broadcasts, never from global memory.
//   Where pitch is a power of two (R is), / pitch is * (1 / pitch), which is
//   the same bits; any other pitch keeps the division.
// - A texel is 8 bytes: with channel-last storage (channel stride 1) the
//   four channels of a sample are one vector load (template flag CL).  A
//   volume with any other channel stride takes four 2-byte loads
//   (CL = false); both instantiations are checked on the card.
// - The loop takes DEPTH list entries at a time: the tests, the affine
//   maps and the texel loads of all of them first (addresses depend on the
//   slab, not on the carry), then their exp and carry updates.  A sample
//   whose sigma is 0 changes nothing of the carry and skips them.
// - Slabs are not staged through shared memory.  A stage was built and
//   measured (a ring of stages a warp, each filled by cp.async with the
//   bounding box of the warp's texels in one slab, two entries ahead): it
//   agreed with the plain version and was 1.4-1.9x slower on all three axes
//   (PERF.md), so it is not in the kernel.  The loop is not bound by load
//   latency (1, 2, 4 or 8 loads in flight take the same time within a
//   tenth) and the bytes are too few for the sector waste of axes 1 and 2 to
//   matter (tens of MB a frame); a stage adds four warp reductions, a copy
//   and a shared read to every sample where the direct path has one load.
// - Exit together: a warp leaves the loop when every lane is below minT
//   (one vote), and its 32 pixels form a 16x2 tile (32x1 and 8x4 measured
//   within 3 % of it).
// - Counting (template flag COUNT, launched only while the program's
//   recorder records, sienerf_torch/tracing.py): each thread counts the
//   samples it composites (alive, inside the lattice, in nearest mode not
//   on a zeroed inner-square texel), a block sums them and adds the sum
//   to one device int64 with one atomicAdd.  The plain version counts the
//   same samples in stats["samples"], except in slabs whose sigma is zero
//   everywhere, which it skips: the kernel cannot see that without reading
//   the whole slab.  With COUNT false the kernel is the code it was.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (sienerf_torch/ops/cuda_lib.py).  -fmad=false keeps every multiply-add in
// the plain version's rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int TILE_W = 32, TILE_H = 8;  // pixels of a block
constexpr int WARP_W = 16, WARP_H = 2;  // pixels of a warp
// list entries whose loads are in flight together
constexpr int DEPTH = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Strides {
  long long k, s, c, u, v;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The four bf16 channels of one texel as loaded, before any arithmetic on
// them: a loop can start several such loads and only then use the first.
template <bool CL>
struct Raw;
template <>
struct Raw<true> {
  uint2 w;
};
template <>
struct Raw<false> {
  unsigned short c[4];
};

template <bool CL>
__device__ __forceinline__ Raw<CL> load_raw(const __nv_bfloat16* __restrict__ q,
                                            long long sc) {
  Raw<CL> r;
  if constexpr (CL) {
    r.w = __ldg(reinterpret_cast<const uint2*>(q));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      r.c[c] = __ldg(reinterpret_cast<const unsigned short*>(q + c * sc));
  }
  return r;
}

template <bool CL>
__device__ __forceinline__ void unpack(const Raw<CL>& r, float (&t)[4]) {
  if constexpr (CL) {
    t[0] = __uint_as_float(r.w.x << 16);
    t[1] = __uint_as_float(r.w.x & 0xFFFF0000u);
    t[2] = __uint_as_float(r.w.y << 16);
    t[3] = __uint_as_float(r.w.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) t[c] = __uint_as_float((uint32_t)r.c[c] << 16);
  }
}

// What one list entry needs from memory, and what its tests left.  flags:
// bit 0 the sample is live; bit 1 + t tap t was loaded (a tap in range that
// was not loaded is a zeroed inner-square texel).  Taps of a bilinear
// sample: t = du + 2 dv over (u0 + du, v0 + dv); a nearest sample has one.
template <bool CL, bool LINEAR, bool PHASE>
struct Fetched {
  static constexpr int NT = LINEAR ? 4 : 1;
  Raw<CL> a[NT];
  Raw<CL> b[PHASE ? NT : 1];  // plane j+1, for the phase blend
  float t_hat, dt, gu, gv;
  unsigned flags;
};

// What every pixel shares of one schedule entry.
struct __align__(16) Entry {
  float x_rel;     // x (+ phase * pitch) - o_a
  int mj;          // cascade | inner << 8 | j << 16
  long long base;  // element offset of the entry's data plane
};

// Where a sample that passed the texel-free tests falls.
struct Loc {
  long long base;  // element offset of its data plane
  float gu, gv, t_hat, dt;
  int s;           // schedule entry
  bool masked;     // the slab's inner square belongs to the finer cascade
};

// Intersect [jl, jh] with the j for which lo <= a + b*j <= hi, widened by
// one slab on either side (which also covers the rounding of rb = 1/b);
// false when no j is left.
__device__ __forceinline__ bool clip(double a, double b, double rb, double lo,
                                     double hi, double& jl, double& jh) {
  if (b == 0.0) return a >= lo && a <= hi;
  const double t1 = (lo - a) * rb, t2 = (hi - a) * rb;
  jl = fmax(jl, ceil(fmin(t1, t2)) - 1.0);
  jh = fmin(jh, floor(fmax(t1, t2)) + 1.0);
  return jl <= jh;
}

template <bool CL, bool LINEAR, bool PHASE, bool COUNT>
__global__ void __launch_bounds__(BLOCK) sweep_kernel(
    const __nv_bfloat16* __restrict__ vol, Strides st,
    const float* __restrict__ sched, int S, int K, const float* __restrict__ o_c,
    const float* __restrict__ eb, const float* __restrict__ ec,
    const float* __restrict__ t_stop, int Hi, int Wi, int R, float near_d,
    float min_t, float phase, int data_flip, float* __restrict__ C, float* __restrict__ op_out,
    float* __restrict__ t_out, float* __restrict__ bt_out, float* __restrict__ bw_out,
    unsigned long long* __restrict__ live_count) {
  // shared, built once a block from what every pixel shares: per schedule
  // entry its x_rel, packed cascade | inner << 8 | j << 16 and the offsets
  // of its data plane (and of the next one, for the phase blend); per
  // cascade pitch, its reciprocal where it is a power of two (else 0) and
  // lo; every warp's merged intervals (ja | jb << 16) and its list of slabs
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* s_e = reinterpret_cast<Entry*>(smem);
  float4* s_casc = reinterpret_cast<float4*>(s_e + S);
  long long* s_base2 = reinterpret_cast<long long*>(s_casc + K);
  uint32_t* s_wiv = reinterpret_cast<uint32_t*>(s_base2 + S);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_wiv + K * WARPS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float o0 = o_c[0], o1 = o_c[1], o2 = o_c[2];
  const float Rf = (float)R;
  for (int s = tid; s < S; s += BLOCK) {
    const float* e = sched + 5 * s;  // casc, j, x, pitch, inner
    const int m = (int)e[0], j = (int)e[1];
    const float pitch = e[3];
    float x = e[2];
    if (PHASE) x = x + phase * pitch;
    const int jd = data_flip ? R - j : j;
    const int jn = min(max(jd + (data_flip ? -1 : 1), 0), R);
    Entry en;
    en.x_rel = x - o0;
    en.mj = m | (e[4] != 0.f ? 0x100 : 0) | (j << 16);
    en.base = m * st.k + jd * st.s;
    s_e[s] = en;
    s_base2[s] = m * st.k + jn * st.s;
  }
  // Every cascade's pitch from its own formula (slab_schedule's f32 of
  // 2^m / R), not from the schedule: a slice of the schedule (a rank's
  // share of the sharded sweep) need not hold any cascade's slab 0, and
  // the intervals below are computed for every cascade.
  for (int m = tid; m < K; m += BLOCK) {
    const float pitch = (float)(ldexp(1.0, m) / (double)R);
    // x / 2^k == x * 2^-k bit for bit; any other pitch keeps the division
    const float rp = (__float_as_uint(pitch) & 0x7FFFFFu) == 0u ? 1.f / pitch : 0.f;
    s_casc[m] = make_float4(pitch, rp, 0.5f - 0.5f * pitch * Rf, 0.f);
  }
  __syncthreads();

  // the warp's pixel tile inside the block's 32 x 8
  constexpr int across = TILE_W / WARP_W;
  const int w = blockIdx.x * TILE_W + (warp % across) * WARP_W + lane % WARP_W;
  const int h = blockIdx.y * TILE_H + (warp / across) * WARP_H + lane / WARP_W;
  const bool inb = h < Hi && w < Wi;
  const long long pix = (long long)min(h, Hi - 1) * Wi + min(w, Wi - 1);
  const float e_b = eb[min(h, Hi - 1)], e_c = ec[min(w, Wi - 1)];
  const float L = sqrtf(1.f + e_b * e_b + e_c * e_c);
  const float stop = t_stop ? t_stop[pix] : INFINITY;
  const int q1 = R / 4, q3 = 3 * R / 4;
  // phase weights as the reference rounds them: bf16(phase), bf16(1 - that)
  const float ph = bf16r(phase);
  const float om = bf16r(1.f - ph);

  // -- this pixel's live interval of j in every cascade (a superset)
  const double es[2] = {e_b, e_c}, os[2] = {o1, o2};
  const double res[2] = {e_b != 0.f ? 1.0 / e_b : 0.0, e_c != 0.f ? 1.0 / e_c : 0.0};
  const double rL = 1.0 / L;
  for (int m = 0; m < K; ++m) {
    const float4 cs = s_casc[m];
    const double pitch = cs.x, rp = cs.y != 0.f ? (double)cs.y : 1.0 / pitch;
    const double side = pitch * R, lo = 0.5 - 0.5 * side;
    const double xs = lo + (PHASE ? (double)phase * pitch : 0.0) - o0;  // x_rel at j = 0
    const double xmax = 2.0 * side + 1.0 + fabs((double)o0);
    const double eps = 32.0 / 16777216.0;
    double jl = 0.0, jh = R - 1.0;
    bool some = inb;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const double d = eps * (fabs(os[a]) + fabs(lo) + xmax * fabs(es[a]) + 1.0) * rp;
      some = some && clip((os[a] + xs * es[a] - lo) * rp, es[a], res[a], -d, R + d, jl, jh);
    }
    const double dt = eps * xmax * L;
    some = some && clip(xs * L, pitch * L, rp * rL, near_d - dt, (double)stop + dt, jl, jh);
    const uint32_t ja = some ? (uint32_t)jl : (uint32_t)R;
    const uint32_t jb = some ? (uint32_t)jh + 1u : 0u;
    const uint32_t wa = __reduce_min_sync(FULL, ja), wb = __reduce_max_sync(FULL, jb);
    if (lane == 0) s_wiv[warp * K + m] = wa | (wb << 16);
  }
  __syncwarp();

  // -- the warp's list of slabs, in schedule order
  uint16_t* list = s_list + warp * S;
  int n_list = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    bool on = false;
    if (s < S) {
      const int mj = s_e[s].mj;
      const uint32_t iv = s_wiv[warp * K + (mj & 0xFF)], j = (uint32_t)(mj >> 16);
      on = j >= (iv & 0xFFFFu) && j < (iv >> 16);
    }
    const unsigned b = __ballot_sync(FULL, on);
    if (on) list[n_list + __popc(b & ((1u << lane) - 1u))] = (uint16_t)s;
    n_list += __popc(b);
  }
  __syncwarp();

  float c0 = 0.f, c1 = 0.f, c2 = 0.f, T = 1.f, op = 0.f, bw = 0.f, bt = 0.f;
  [[maybe_unused]] unsigned n_live = 0u;  // with COUNT: the samples this thread composites
  using Fet = Fetched<CL, LINEAR, PHASE>;

  // The tests of list entry idx that need no texel: false if the sample
  // cannot be live, else where it falls.
  auto locate = [&](int idx, Loc& lc) -> bool {
    if (idx >= n_list || T < min_t) return false;
    const int s = list[idx];
    const Entry en = s_e[s];
    const float4 cs = s_casc[en.mj & 0xFF];  // pitch, 1/pitch or 0, lo
    const float x_rel = en.x_rel;
    lc.t_hat = x_rel * L;
    if (!(lc.t_hat >= near_d) || !(lc.t_hat <= stop)) return false;
    const float nu = o1 + x_rel * e_b - cs.z, nv = o2 + x_rel * e_c - cs.z;
    lc.gu = cs.y != 0.f ? nu * cs.y : nu / cs.x;
    lc.gv = cs.y != 0.f ? nv * cs.y : nv / cs.x;
    if (!(lc.gu >= 0.f && lc.gu <= Rf && lc.gv >= 0.f && lc.gv <= Rf)) return false;
    lc.s = s;
    lc.masked = (en.mj & 0x100) != 0;
    lc.base = en.base;
    lc.dt = cs.x * L;
    return true;
  };

  // Everything of list entry idx that does not depend on the carry: the
  // tests, the affine map, the texel loads (started, not yet used).
  auto fetch = [&](int idx, Fet& f) {
    f.flags = 0u;
    Loc lc;
    if (!locate(idx, lc)) return;
    const float gu = lc.gu, gv = lc.gv;
    const bool masked = lc.masked;
    const __nv_bfloat16* p1 = vol + lc.base;
    const __nv_bfloat16* p2 = PHASE ? vol + s_base2[lc.s] : p1;
    unsigned flags = 1u;
    if (!LINEAR) {
      const int u = (int)ceilf(gu - 0.5f), v = (int)ceilf(gv - 0.5f);
      if (masked && u > q1 && u < q3 && v > q1 && v < q3) return;
      const long long off = u * st.u + v * st.v;
      f.a[0] = load_raw<CL>(p1 + off, st.c);
      if (PHASE) f.b[0] = load_raw<CL>(p2 + off, st.c);
      flags |= 2u;
    } else {
      const int u0 = (int)floorf(gu), v0 = (int)floorf(gv);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int u = u0 + (t & 1), v = v0 + (t >> 1);
        if (u > R || v > R) continue;
        if (masked && u > q1 && u < q3 && v > q1 && v < q3) continue;
        const long long off = u * st.u + v * st.v;
        f.a[t] = load_raw<CL>(p1 + off, st.c);
        if (PHASE) f.b[t] = load_raw<CL>(p2 + off, st.c);
        flags |= 2u << t;
      }
      f.gu = gu;
      f.gv = gv;
    }
    f.t_hat = lc.t_hat;
    f.dt = lc.dt;
    f.flags = flags;
  };

  // tap t of a fetched entry: the (phase-blended) texel, or the zero of an
  // inner-square texel that was not loaded
  auto tap = [&](const Fet& f, int t, float (&v)[4]) {
    if (!(f.flags & (2u << t))) {
      v[0] = v[1] = v[2] = v[3] = 0.f;
      return;
    }
    unpack<CL>(f.a[t], v);
    if (PHASE) {
      float b[4];
      unpack<CL>(f.b[t], b);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = bf16r(bf16r(v[c] * om) + bf16r(b[c] * ph));
    }
  };

  // one resampled value [s*r, s*g, s*b, s] into the carry
  auto composite = [&](const float (&sv)[4], float t_hat, float dt) {
    const float sigma = fmaxf(sv[3], 0.f);
    if (!(sigma > 0.f)) return;  // alpha = 0: nothing of the carry changes
    const float inv = fmaxf(sigma, 1e-10f);
    const float alpha = 1.f - expf(-sigma * dt);
    const float wgt = T * alpha;
    c0 = c0 + wgt * (sv[0] / inv);
    c1 = c1 + wgt * (sv[1] / inv);
    c2 = c2 + wgt * (sv[2] / inv);
    T = T * (1.f - alpha);
    op = op + wgt;
    if (wgt > bw) {
      bw = wgt;
      bt = t_hat;
    }
  };

  auto accumulate = [&](const Fet& f) {
    if (!(f.flags & 1u) || T < min_t) return;
    if constexpr (COUNT) ++n_live;
    float sv[4];
    if (!LINEAR) {
      tap(f, 0, sv);
    } else {
      const float gu = f.gu, gv = f.gv;
      const int u0 = (int)floorf(gu), v0 = (int)floorf(gv);
      const bool u1ok = u0 + 1 <= R, v1ok = v0 + 1 <= R;
      const float wa0 = bf16r(fmaxf(0.f, 1.f - fabsf(gu - (float)u0)));
      const float wa1 = u1ok ? bf16r(fmaxf(0.f, 1.f - fabsf(gu - (float)(u0 + 1)))) : 0.f;
      const float wb0 = bf16r(fmaxf(0.f, 1.f - fabsf(gv - (float)v0)));
      const float wb1 = v1ok ? bf16r(fmaxf(0.f, 1.f - fabsf(gv - (float)(v0 + 1)))) : 0.f;
      float t00[4], t10[4], t01[4], t11[4];
      tap(f, 0, t00);
      tap(f, 1, t10);
      tap(f, 2, t01);
      tap(f, 3, t11);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // row pass at columns v0 and v0+1, rounded to bf16 as the reference's
        // first matmul output is
        float r0 = wa0 * t00[c];
        if (u1ok) r0 = r0 + wa1 * t10[c];
        float acc = wb0 * bf16r(r0);
        if (v1ok) {
          float r1 = wa0 * t01[c];
          if (u1ok) r1 = r1 + wa1 * t11[c];
          acc = acc + wb1 * bf16r(r1);
        }
        sv[c] = acc;
      }
    }
    composite(sv, f.t_hat, f.dt);
  };

  // D entries at a time: all their loads are in flight before the first is
  // used (a bilinear sample holds 4, with phase 8, texels, so fewer)
  constexpr int D = LINEAR ? (PHASE ? 1 : 2) : DEPTH;
  for (int base = 0; base < n_list; base += D) {
    if (__all_sync(FULL, !inb || T < min_t)) break;  // every later alpha is 0
    Fet f[D];
#pragma unroll
    for (int d = 0; d < D; ++d) fetch(base + d, f[d]);
#pragma unroll
    for (int d = 0; d < D; ++d) accumulate(f[d]);
  }
  if constexpr (COUNT) {  // every thread of the block is here: no early return above
    __shared__ unsigned s_live[WARPS];
    const unsigned w_live = __reduce_add_sync(FULL, n_live);
    if (lane == 0) s_live[warp] = w_live;
    __syncthreads();
    if (tid == 0) {
      unsigned long long b = 0ull;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) b += s_live[i];
      if (b != 0ull) atomicAdd(live_count, b);
    }
  }
  if (inb) {
    C[pix * 3] = c0;
    C[pix * 3 + 1] = c1;
    C[pix * 3 + 2] = c2;
    op_out[pix] = op;
    t_out[pix] = T;
    bt_out[pix] = bt;
    if (bw_out != nullptr) bw_out[pix] = bw;
  }
}

size_t smem_bytes(int S, int K) {
  return (size_t)S * (sizeof(Entry) + 8) + (size_t)K * 16 + (size_t)K * WARPS * 4 +
         (size_t)WARPS * S * 2;
}

template <bool CL, bool LINEAR, bool PHASE, bool COUNT>
cudaError_t launch(const void* vol, const Strides& st, const void* sched, int S,
                   int K, const void* o_c, const void* eb, const void* ec,
                   const void* t_stop, int hi, int wi, int R, float near_d,
                   float min_t, float phase, int data_flip, void* C, void* op, void* T, void* bt,
                   void* bw, void* live_count, cudaStream_t stream) {
  const size_t bytes = smem_bytes(S, K);
  auto kern = sweep_kernel<CL, LINEAR, PHASE, COUNT>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((wi + TILE_W - 1) / TILE_W, (hi + TILE_H - 1) / TILE_H);
  kern<<<grid, BLOCK, bytes, stream>>>(
      (const __nv_bfloat16*)vol, st, (const float*)sched, S, K, (const float*)o_c,
      (const float*)eb, (const float*)ec, (const float*)t_stop, hi, wi, R, near_d,
      min_t, phase, data_flip, (float*)C, (float*)op, (float*)T, (float*)bt, (float*)bw,
      (unsigned long long*)live_count);
  return cudaGetLastError();
}

}  // namespace

// vol: bf16 volume with element strides (sk, ss, sc, su, sv) over
// (cascade, slab, channel, u, v); channel_last != 0 promises sc == 1 and
// 8-byte-aligned texels.  sched: (n_slabs, 5) f32 rows of cascade, j, x,
// pitch, inner flag: slab_schedule's rows, or a contiguous slice of them
// (composited from T = 1).  bw, when not null, receives the best weight.
// live_count, when not null, is a device int64 that the counting variant
// adds the samples it composites to.
extern "C" int sweep_composite_launch(
    const void* vol, long long sk, long long ss, long long sc, long long su,
    long long sv, int channel_last, const void* sched, int n_slabs,
    int n_cascades, const void* o_c, const void* eb, const void* ec,
    const void* t_stop, int hi, int wi, int resolution, float near_d,
    float min_t, int use_phase, float phase, int linear, int data_flip,
    void* C, void* op, void* T, void* bt, void* bw, void* live_count, void* stream) {
  if (resolution > 32767 || n_slabs > 65535 || n_cascades > 255)
    return (int)cudaErrorInvalidValue;
  const Strides st{sk, ss, sc, su, sv};
#define SWEEP_ARGS                                                  \
  vol, st, sched, n_slabs, n_cascades, o_c, eb, ec, t_stop, hi, wi, \
      resolution, near_d, min_t, phase, data_flip, C, op, T, bt, bw, \
      live_count, (cudaStream_t)stream
#define SWEEP_PHASE(CL, LIN, CNT)                                          \
  (use_phase ? launch<CL, LIN, true, CNT>(SWEEP_ARGS)                      \
             : launch<CL, LIN, false, CNT>(SWEEP_ARGS))
#define SWEEP_PICK(CL, LIN) \
  (live_count ? SWEEP_PHASE(CL, LIN, true) : SWEEP_PHASE(CL, LIN, false))
  cudaError_t e;
  if (channel_last)
    e = linear ? SWEEP_PICK(true, true) : SWEEP_PICK(true, false);
  else
    e = linear ? SWEEP_PICK(false, true) : SWEEP_PICK(false, false);
#undef SWEEP_PICK
#undef SWEEP_PHASE
#undef SWEEP_ARGS
  return (int)e;
}

extern "C" const char* sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
