// K1: per-vertex shade of the baked lattice, for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/shade_pallas.py::_shade_kernel /
// _shade_block (entry shade_volume_pallas).  Plain PyTorch version:
// sienerf_torch/ops/shade.py::shade_planes (the reference's
// engines/nerf_sweep.py::_shade_planes).
//
// What it computes, for every vertex (m, i, j, k) of the K*(R+1)^3 bake:
//   raw16 = int16 row * scale[m]           (f32; sentinel -32768 -> zero out)
//   sigma = density_act(raw16[0])
//   d     = unit(vertex - camera)           SH16(d), tcnn degree-4 basis
//   X     = bf16([SH16; raw16])            32 -> 64 -> 64 -> 3 ReLU MLP,
//           f32 accumulation, bf16 rounding between layers
//   out   = bf16([rgb_act(.) * sigma; sigma])
// written channel-last: storage (K, R+1, R+1, R+1, 4) bf16, the four
// channels of vertex v at bytes [8v, 8v+8), in the flat vertex order of the
// rows.  Callers see the permuted view (K, R+1, 4, R+1, R+1); the sweep
// kernel reads a sample as one 8-byte load and takes camera axes 1 and 2
// through strides.
//
// Bound on an H100 (fox bake, R=256, K=3: 50.9 M vertices, 26.7 M kept).
// Bytes, counted as the algorithm needs them (chip_smoke.py's bound): a
// kept vertex reads its 32-byte row, a culled one its 2-byte sentinel,
// every vertex writes 8 bytes: 1.31 GB, 0.39 ms at 3.35 TB/s.  Counted as
// the card moves them, in whole 32-byte sectors, a culled row costs 32
// bytes too: 1.63 GB of rows + 0.41 GB written = 2.04 GB, 0.61 ms.  The MLP
// is 12,672 flop a kept vertex, 0.338 TFLOP, 0.34 ms at the bf16 tensor
// peak; so bytes bound the kernel, by either counting.
//
// Design.
// - Kept vertices are compacted first.  On the fox bake the culled vertices
//   do not come in long runs: of its 1,591,369 tiles of 32 consecutive
//   vertices 1,169,499 hold a kept vertex and only 407,917 are full, so
//   shading tile by tile would run the arithmetic below on 40 % more rows
//   than are kept.  A warp walks its tiles (32 consecutive vertices, lane l
//   loads row l: two 16-byte loads, 1 KB contiguous a warp), writes zeros
//   for the culled ones and appends the kept ones (raw row, (m, i, j, k),
//   vertex id; ballot + popc give the slot) to a ring of 64 rows in shared
//   memory.  The (m, i, j, k) come from the tile's first vertex by carries
//   (tiles may straddle planes and cascades, and R may be tiny; no division
//   a tile).  Whenever the ring holds 32 rows the warp shades them as one
//   full batch, lane l owning row l; a last, short batch drains the ring.
// - The owner computes the direction, SH16 and the dequantised fields of
//   its vertex in the plain version's f32 operation order (-fmad=false),
//   rounds X to bf16 and writes one 64-byte row of a per-warp shared-memory
//   tile (80-byte row pitch: 16-byte stores and ldmatrix are then free of
//   bank conflicts).  No lane computes another lane's vertex, and no branch
//   diverges on the lane.  Loading fragments straight from global memory
//   (a quad sharing a vertex) was not taken: each lane of a quad would
//   compute a different four of the sixteen SH functions, which diverges
//   four ways, or the quad repeats the divisions and the square root four
//   times.
// - The MLP runs on the tensor cores: mma.sync.m16n8k16 bf16 with f32
//   accumulation, vertices as the M rows, two m16 tiles a warp.  X comes
//   from the shared tile with ldmatrix.x4.  The f32 accumulators of two
//   neighbouring n8 tiles have the register layout of one k16 A fragment,
//   so relu + bf16 rounding (cvt.rn.relu.bf16x2.f32) turns layer l's
//   output into layer l+1's A operand in registers: hidden activations
//   never touch shared or device memory.  Each layer runs in two halves
//   of 32 outputs to bound the live accumulators (32 f32 a half), and
//   layer 3 (64 -> 3, padded to one n8 tile) accumulates as layer 2's
//   halves arrive.
// - Weights: bf16, packed on the host in fragment order (ops/shade.py::
//   pack_shade_weights): for each (k16, pair of n8) tile the 16 bytes lane
//   l needs, so a B fragment pair is one conflict-free 16-byte shared
//   load.  13 KB a block instead of 24.8 KB of f32.  Each B fragment
//   serves both m16 tiles.  A product of two bf16 values is exact in f32;
//   only the summation order inside the tensor core differs from the
//   plain version.
// - Streaming: persistent warps (blocks = SMs x resident blocks, 4 blocks
//   of 4 warps an SM at 128 registers) walk the tiles with a stride, so
//   that a culled region is spread over all warps.  Each lane loads its
//   row directly where it appends it.  Loading the next tile's rows a tile
//   ahead, into registers or as an L2 prefetch, changed nothing measurable
//   (the other warps of the SM cover the latency), and rows are consumed
//   once, by the lane that loads them, so a cp.async ring would only add
//   a copy: neither is in the kernel.
// - Output: the final accumulator goes through the warp's shared tile to
//   the owner, which applies the activation, premultiplies and stores 8
//   bytes at its vertex (a batch's vertices ascend, mostly in runs).
// - Registers: the fragments of one hidden layer (32) and the 32
//   accumulators of a half layer are live together, so the kernel sits at
//   the 128 registers that 16 warps an SM allow.  The loop's constants
//   (camera, strides) are re-read from shared memory where used, and the
//   owner reads its vertex id and sigma's field from the ring again after
//   the MLP, which keeps ptxas free of spills.
//
// Where it stands (PERF.md has the numbers): about 5x the bytes bound.
// With the MLP compiled out the rest still takes a large part of the time,
// a prefetch does not move it and fewer independent mma chains slow it: it
// is bound by latency at 16 warps an SM
// (the f32 divisions and square root of the direction, then dependent mma
// chains), not by the tensor pipe or by memory.  The same chaining through wgmma
// (A from registers, B through shared-memory descriptors) agreed with the
// plain version and was slower, since a warpgroup then waits on each small
// group of products.  The split of the roles (warps that prepare X tiles,
// MLP warpgroups that consume them from a shared-memory ring) is
// shade_general_kernel below; on this network it gives this kernel's bits
// and is slower (PERF.md), so the fox stays here.
//
// Other colour MLPs (0-3 hidden layers, widths 64 and 128 in configs/nerf/)
// take shade_general_kernel below: producer warps walk the lattice and
// prepare X, consumer warpgroups run every layer on wgmma with the hidden
// activations in registers.  Nets it cannot hold (widths above 256, or
// weights that leave it no room) take shade_wide_kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (sienerf_torch/ops/cuda_lib.py).  -fmad=false keeps the position and
// SH arithmetic in the reference's operation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 16;         // baked fields per vertex
// 4 warps x 4 blocks an SM; 2 x 8 and 4 x 3 measured within the spread of
// repeated timings, and 8 warps a block would need 57 KB of static shared
// memory.
constexpr int WARPS = 4;
constexpr int BLOCK = 32 * WARPS;
constexpr int MIN_BLOCKS = 4;  // blocks an SM that the register budget allows
constexpr int TILE = 32;       // vertices a warp shades at once
constexpr int XPITCH = 20;     // 32-bit words per row of the X tile (80 bytes)
constexpr int MAX_CASCADES = 8;
// packed weights, in 32-bit words (two bf16 each)
constexpr int W1_WORDS = 2 * 4 * 32 * 4;   // 2 k16 x 4 n8-pairs x 32 lanes x 4
constexpr int W2_WORDS = 4 * 4 * 32 * 4;
constexpr int W3_WORDS = 4 * 32 * 2;       // 4 k16 x one n8 tile x 32 lanes x 2
constexpr int W_WORDS = W1_WORDS + W2_WORDS + W3_WORDS;

enum { ACT_NONE = 0, ACT_RELU = 1, ACT_LOGISTIC = 2, ACT_EXPONENTIAL = 3 };

__device__ __forceinline__ float activation(float x, int act, float clamp) {
  if (act == ACT_EXPONENTIAL) return expf(fminf(fmaxf(x, -clamp), clamp));
  if (act == ACT_RELU) return fmaxf(x, 0.f);
  if (act == ACT_LOGISTIC) return 1.f / (1.f + expf(-x));
  return x;
}

// two f32 -> one word of two bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// the same with relu first (relu and rounding commute)
__device__ __forceinline__ uint32_t pack_relu_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const uint32_t* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// One hidden layer for two m16 tiles, relu(h_in @ W), 32 outputs at a time.
// `a_in[mt][kt]` are the KT k16 fragments of the input, `wp` the layer's
// packed weights.  The accumulators of n8 tiles (2t, 2t+1) are the A
// fragment of k16 tile t of the next layer: `half_done(nh, frag)` gets the
// two fragments (k16 tiles 2nh, 2nh+1) of both m16 tiles.  32 accumulators
// are live at a time, in 8 independent mma chains.  (16 at a time in 4
// chains was slower: the chains hide the tensor pipe's latency.)
template <int KT, typename F>
__device__ __forceinline__ void hidden_layer(const uint32_t (&a_in)[2][KT][4],
                                             const uint32_t* __restrict__ wp, int lane,
                                             F half_done) {
#pragma unroll
  for (int nh = 0; nh < 2; ++nh) {
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const uint4 b = *reinterpret_cast<const uint4*>(
            wp + ((kt * 4 + nh * 2 + np) * 32 + lane) * 4);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_16816(acc[mt][2 * np], a_in[mt][kt], b.x, b.y);
          mma_16816(acc[mt][2 * np + 1], a_in[mt][kt], b.z, b.w);
        }
      }
    }
    uint32_t frag[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        frag[mt][t][0] = pack_relu_bf16(acc[mt][2 * t][0], acc[mt][2 * t][1]);
        frag[mt][t][1] = pack_relu_bf16(acc[mt][2 * t][2], acc[mt][2 * t][3]);
        frag[mt][t][2] = pack_relu_bf16(acc[mt][2 * t + 1][0], acc[mt][2 * t + 1][1]);
        frag[mt][t][3] = pack_relu_bf16(acc[mt][2 * t + 1][2], acc[mt][2 * t + 1][3]);
      }
    half_done(nh, frag);
  }
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) shade_kernel(
    const int16_t* __restrict__ rows, const float* __restrict__ scale,
    const float* __restrict__ cam, const uint32_t* __restrict__ wpacked,
    uint2* __restrict__ out, int R, int K, long long n_vert, int p0, int dact, int ract) {
  __shared__ __align__(16) uint32_t s_w[W_WORDS];
  __shared__ __align__(16) uint32_t s_x[WARPS][TILE * XPITCH];
  __shared__ __align__(16) uint4 s_ring_raw[WARPS][2 * 64];
  __shared__ __align__(8) uint2 s_ring_pos[WARPS][64];
  __shared__ __align__(8) long long s_ring_v[WARPS][64];
  __shared__ __align__(16) float s_scale[MAX_CASCADES * NF];
  for (int t = threadIdx.x; t < W_WORDS / 4; t += BLOCK)
    reinterpret_cast<uint4*>(s_w)[t] = __ldg(reinterpret_cast<const uint4*>(wpacked) + t);
  for (int t = threadIdx.x; t < K * NF; t += BLOCK) s_scale[t] = scale[t];
  // Loop constants live in shared memory and are read where they are used
  // (volatile, so that they hold no register across the MLP): the camera,
  // 1/(R+1), and the warps' stride as (planes' offset, planes, cascades).
  __shared__ float s_cam[4];
  __shared__ uint32_t s_step[3];
  if (threadIdx.x == 0) {
    const uint32_t Rv0 = R + 1, plane0 = Rv0 * Rv0;
    const long long step = (long long)gridDim.x * WARPS * TILE;
    const uint32_t step_p = (uint32_t)(step / plane0);
    s_cam[0] = cam[0];
    s_cam[1] = cam[1];
    s_cam[2] = cam[2];
    s_cam[3] = 1.f / (float)Rv0;
    s_step[0] = (uint32_t)(step % plane0);
    s_step[1] = step_p % Rv0;
    s_step[2] = step_p / Rv0;
  }
  __syncthreads();
  const volatile float* v_cam = s_cam;
  const volatile uint32_t* v_step = s_step;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  uint32_t* xs = s_x[warp];
  float* ys = reinterpret_cast<float*>(xs);
  const uint32_t Rv = R + 1, plane = Rv * Rv;

  // tiles and warps are counted in 32 bits (the launch function checks)
  const int n_tiles = (int)((n_vert + TILE - 1) / TILE);
  const int n_warps = gridDim.x * WARPS;
  int tile = blockIdx.x * WARPS + warp;
  // The tile's first vertex as (cascade m0, plane i0, offset r0 in the
  // plane), advanced by the warps' stride with carries: no division per
  // tile.
  const long long v_first = (long long)tile * TILE;
  uint32_t r0 = (uint32_t)(v_first % plane);
  const uint32_t gp0 = (uint32_t)(v_first / plane) + (uint32_t)p0;  // a plane of the bake
  uint32_t i0 = gp0 % Rv, m0 = gp0 / Rv;

  // The ring of this warp's kept vertices: raw row, (m << 16 | i, j << 16 | k)
  // and vertex id of up to 64 of them.  A batch is the 32 rows from `head`
  // (0 or 32); tiles append behind it.
  uint4* ring_raw = s_ring_raw[warp];
  uint2* ring_pos = s_ring_pos[warp];
  long long* ring_v = s_ring_v[warp];
  int head = 0, count = 0;

  for (;;) {
    const bool have_tile = tile < n_tiles;
    if (have_tile) {
      if (r0 >= plane) {
        r0 -= plane;
        ++i0;
      }
      while (i0 >= Rv) {
        i0 -= Rv;
        ++m0;
      }
      const long long v = (long long)tile * TILE + lane;
      const bool valid = v < n_vert;
      const uint4* src = reinterpret_cast<const uint4*>(rows + (valid ? v : n_vert - 1) * NF);
      const uint4 qa = __ldg(src), qb = __ldg(src + 1);
      const bool culled = !valid || (int16_t)(qa.x & 0xFFFFu) == -32768;
      if (valid && culled) out[v] = make_uint2(0u, 0u);
      const unsigned kept = __ballot_sync(0xFFFFFFFFu, !culled);
      if (kept != 0u) {
        // this lane's vertex (m, i, j, k): carries from the tile's first vertex
        uint32_t jk = r0 + lane, i = i0, m = m0;
        while (jk >= plane) {
          jk -= plane;
          ++i;
        }
        while (i >= Rv) {
          i -= Rv;
          ++m;
        }
        // j = jk / Rv through the reciprocal, off by at most one below 2^24
        uint32_t j = plane < (1u << 24) ? (uint32_t)((float)jk * v_cam[3]) : jk / Rv;
        int k = (int)(jk - j * Rv);
        if (k < 0) {
          k += (int)Rv;
          --j;
        } else if (k >= (int)Rv) {
          k -= (int)Rv;
          ++j;
        }
        if (!culled) {
          const int slot = (head + count + __popc(kept & ((1u << lane) - 1u))) & 63;
          ring_raw[2 * slot] = qa;
          ring_raw[2 * slot + 1] = qb;
          ring_pos[slot] = make_uint2((m << 16) | i, (j << 16) | (uint32_t)k);
          ring_v[slot] = v;
        }
        count += __popc(kept);
      }
      tile += n_warps;
      r0 += v_step[0];
      i0 += v_step[1];
      m0 += v_step[2];
      if (count < 32) continue;
    } else if (count == 0) {
      break;
    }

    // -- shade a batch: lane l takes kept vertex l of the ring (the last
    // batch may be short: its idle lanes shade the first row again)
    __syncwarp();
    const bool has = lane < count;
    const int row = head + (has ? lane : 0);
    const uint4 qa = ring_raw[2 * row], qb = ring_raw[2 * row + 1];
    const uint2 pos = ring_pos[row];
    const uint32_t m = pos.x >> 16, i = pos.x & 0xFFFFu, j = pos.y >> 16, k = pos.y & 0xFFFFu;
    count -= count < 32 ? count : 32;
    head ^= 32;

    const uint32_t words[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    const float* sc = s_scale + m * NF;
    float raw[NF];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      raw[2 * w] = (float)(int16_t)(words[w] & 0xFFFFu) * sc[2 * w];
      raw[2 * w + 1] = (float)(int16_t)(words[w] >> 16) * sc[2 * w + 1];
    }

    // vertex position, then the unit direction from the camera
    const float side = (float)(1u << m);
    const float lo = 0.5f - 0.5f * side;
    const float Rf = (float)R;
    const float dx = ((float)i / Rf * side + lo) - v_cam[0];
    const float dy = ((float)j / Rf * side + lo) - v_cam[1];
    const float dz = ((float)k / Rf * side + lo) - v_cam[2];
    const float n = fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-6f);
    // the reference warps the direction to [0,1]^3 and back (tcnn's SH input)
    const float X = ((dx / n + 1.f) * 0.5f) * 2.f - 1.f;
    const float Y = ((dy / n + 1.f) * 0.5f) * 2.f - 1.f;
    const float Z = ((dz / n + 1.f) * 0.5f) * 2.f - 1.f;
    const float xy = X * Y, xz = X * Z, yz = Y * Z;
    const float x2 = X * X, y2 = Y * Y, z2 = Z * Z;
    float sh[16];
    sh[0] = 0.28209479177387814f;
    sh[1] = -0.48860251190291987f * Y;
    sh[2] = 0.48860251190291987f * Z;
    sh[3] = -0.48860251190291987f * X;
    sh[4] = 1.0925484305920792f * xy;
    sh[5] = -1.0925484305920792f * yz;
    sh[6] = 0.94617469575755997f * z2 - 0.31539156525251999f;
    sh[7] = -1.0925484305920792f * xz;
    sh[8] = 0.54627421529603959f * (x2 - y2);
    sh[9] = 0.59004358992664352f * Y * (-3.f * x2 + y2);
    sh[10] = 2.8906114426405538f * xy * Z;
    sh[11] = 0.45704579946446572f * Y * (1.f - 5.f * z2);
    sh[12] = 0.3731763325901154f * Z * (5.f * z2 - 3.f);
    sh[13] = 0.45704579946446572f * X * (1.f - 5.f * z2);
    sh[14] = 1.4453057213202769f * Z * (x2 - y2);
    sh[15] = 0.59004358992664352f * X * (-x2 + 3.f * y2);

    // X row = bf16([SH16; raw16]) into the warp's tile
    __syncwarp();  // the previous tile's output reads are done
    uint4* xrow = reinterpret_cast<uint4*>(xs + lane * XPITCH);
    xrow[0] = make_uint4(pack_bf16(sh[0], sh[1]), pack_bf16(sh[2], sh[3]),
                         pack_bf16(sh[4], sh[5]), pack_bf16(sh[6], sh[7]));
    xrow[1] = make_uint4(pack_bf16(sh[8], sh[9]), pack_bf16(sh[10], sh[11]),
                         pack_bf16(sh[12], sh[13]), pack_bf16(sh[14], sh[15]));
    xrow[2] = make_uint4(pack_bf16(raw[0], raw[1]), pack_bf16(raw[2], raw[3]),
                         pack_bf16(raw[4], raw[5]), pack_bf16(raw[6], raw[7]));
    xrow[3] = make_uint4(pack_bf16(raw[8], raw[9]), pack_bf16(raw[10], raw[11]),
                         pack_bf16(raw[12], raw[13]), pack_bf16(raw[14], raw[15]));
    __syncwarp();

    // A fragments of X: tile mt, k16 tile kt.  Lane l addresses row l%16 of
    // the m16 tile, columns 8*(l/16).. of the k16 tile.
    uint32_t xa[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
        ldmatrix_x4(xa[mt][kt],
                    xs + (mt * 16 + (lane & 15)) * XPITCH + kt * 8 + (lane >> 4) * 4);

    uint32_t h1[2][4][4];
    hidden_layer<2>(xa, s_w, lane, [&](int nh, const uint32_t (&frag)[2][2][4]) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4) h1[mt][2 * nh + t][r4] = frag[mt][t][r4];
    });
    // layer 3 (one n8 tile) takes the k16 fragments of h2 as they are made
    float oc[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) oc[mt][r4] = 0.f;
    const uint32_t* w3 = s_w + W1_WORDS + W2_WORDS;
    hidden_layer<4>(h1, s_w + W1_WORDS, lane, [&](int nh, const uint32_t (&frag)[2][2][4]) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const uint2 b = *reinterpret_cast<const uint2*>(w3 + ((2 * nh + t) * 32 + lane) * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_16816(oc[mt], frag[mt][t], b.x, b.y);
      }
    });

    // (r, g) sit in lanes tig == 0, (b, pad) in tig == 1, rows g and g + 8
    // of each m16 tile: hand them to the owners through the shared tile
    __syncwarp();  // every lane has its X fragments
    if (tig < 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        *reinterpret_cast<float2*>(ys + (mt * 16 + g) * 4 + 2 * tig) =
            make_float2(oc[mt][0], oc[mt][1]);
        *reinterpret_cast<float2*>(ys + (mt * 16 + g + 8) * 4 + 2 * tig) =
            make_float2(oc[mt][2], oc[mt][3]);
      }
    }
    __syncwarp();
    const float4 rgb = *reinterpret_cast<const float4*>(ys + lane * 4);
    if (has) {
      // sigma from the ring row again (it stands until the next tile
      // appends), so that nothing but `row` is held across the MLP
      const float sigma = activation(
          (float)(int16_t)(ring_raw[2 * row].x & 0xFFFFu) * s_scale[(ring_pos[row].x >> 16) * NF],
          dact, 15.f);
      uint2 o;
      o.x = pack_bf16(activation(rgb.x, ract, 10.f) * sigma,
                      activation(rgb.y, ract, 10.f) * sigma);
      o.y = pack_bf16(activation(rgb.z, ract, 10.f) * sigma, sigma);
      out[ring_v[row]] = o;
    }
    // the next tile may append into this batch's half of the ring
    __syncwarp();
  }
}


// ---------------------------------------------------------------------------
// The general path: any ReLU colour MLP [SH16; raw16] (32) -> W -> ... -> W
// -> 3 with 0 or more hidden layers of one width W (the JAX kernel's "ReLU
// MLP, any depth", shade_pallas.py:176-183) whose padded width is at most
// 256 and whose weights leave room for the stage ring.  The 32-64-64-3 fox
// network keeps the tuned kernel above; the wrapper sends every other shape
// here, and the shapes this kernel cannot hold to shade_wide_kernel below.
// It replaces the general path's first kernel (shade_wide_kernel now: the
// tuned kernel's walk with the MLP layer by layer through per-warp shared
// tiles, one block of 8 warps an SM at width 128, mma.sync, A fragments
// reloaded from shared memory for every 32 outputs; 17 % of its bound at
// 32-128-128-3).
//
// Bound: the tuned kernel's bytes (1.31 GB on the fox's bake, 0.391 ms),
// or the MLP's 2 * (32 W + (H - 1) W^2 + 3 W) flops a kept vertex at the
// bf16 tensor peak (H hidden layers; 41,728 at 32-128-128-3, 1.11 TFLOP on
// the fox's kept vertices, 1.127 ms): bytes bound the narrow networks,
// operations the wide ones.
//
// Design (warp-specialised, sm_90a).
// - One persistent block an SM.  On entry one thread copies the packed
//   weights into shared memory with one cp.async.bulk onto an mbarrier
//   (43 KB at 32-128-128-3, 108.5 KB at 32-128x4-3).
// - Producer warps walk 32-vertex tiles with a stride, the tuned kernel's
//   walk and (m, i, j, k) carries.  Each warp streams its tiles through a
//   private ring of GEN_RAW_DEPTH 1 KB slots filled by cp.async.bulk (many
//   rows in flight without registers), writes zeros for the culled
//   vertices and compacts the kept ones into a 64-row ring, as the tuned
//   kernel does.  A batch of 32 kept vertices, one a lane, gets the
//   direction, SH16, the dequantised fields and the density (the plain
//   version's f32 operation order, -fmad=false; i / R from a table of the
//   same divisions) and takes 32 consecutive slots of the block's stream
//   of 64-row stages (one shared atomicAdd): a lane writes its bf16 X row,
//   vertex id and density there, the warp adds its rows to the stage's
//   count, and the warp that completes a stage arrives on its `full`
//   mbarrier.  A slot is reused once the consumer has released its earlier
//   round: a count, not an mbarrier phase, since producers claim stages
//   more than one round ahead of the consumers.
// - The stage slots are a multiple of the consumer warpgroups, so each slot
//   has one consumer, which waits for its rounds in order: a `full` parity
//   then names one round (with 8 slots and 3 consumers a consumer could
//   wait on a slot's second round before its first was complete, and
//   mbarrier.try_wait.parity passes at once on a phase not yet begun).
// - Consumer warpgroups take the stages in turn: wait on `full`, read the X
//   fragments with ldmatrix and the epilogue's id and density, release the
//   stage, then run every layer on wgmma.mma_async m64nWk16 with A from
//   registers and B (the weights) from shared memory through descriptors:
//   K-major core matrices without swizzle (ops/shade.py::
//   pack_shade_weights(layout="wgmma")).  A hidden layer's f32
//   accumulators, relu'd and rounded to bf16 (cvt.rn.relu.bf16x2), have the
//   register layout of the next layer's A operand: hidden activations never
//   touch shared memory.  The output layer is one n8 tile (3 outputs, 5
//   zero columns).  Every output sums its k16 steps in ascending order from
//   a zeroed accumulator, as the tuned kernel's mma.sync chain, and the two
//   instructions sum a step alike (shade_mma_probe_kernel): on the fox's
//   network the two kernels give the same bits.  Widths pad to 64, 128 or
//   256 (zero weights: the same function); at 256 a layer runs as two
//   chains of 128 outputs.
// - A net without hidden layers (32 -> 3) has no consumers: the hand-over
//   of a stage costs more than its one layer, so 20 producer warps shade
//   their own batches (gen_shade_batch: mma.sync on fragment-order
//   weights, the same sums).
// - Epilogue, run while the next stage's first layer is on the tensor
//   cores: the activations (the logistic's reciprocal correctly rounded,
//   as the division), premultiplied, 8 bytes at the kept vertex's id; the
//   padding rows of the last, short stage carry the id -1.
// - The stream ends when every producer is done: producer warp 0 pads the
//   last stage, publishes the count of stages and releases each consumer
//   warpgroup with a `full` arrival past the end.
// - Registers (setmaxnreg): the producers at 96 or less, the consumers the
//   rest (88 at width 64 with three consumer warpgroups, 104 with two, 160
//   at 128, 240 at 256, where ptxas spills a few).  Width 64 has two
//   instances: three consumer warpgroups for one or two hidden layers, two
//   for three or more, whose longer chains spill in the first (measured:
//   PERF.md section 6).
// Every wait gives up with a trap after 2^26 polls, so that a fault in the
// hand-over surfaces as a launch error, not a hung card.
//
// Where it stands (PERF.md section 6 has the times): faster than that
// earlier kernel on every shape, 1.1-3.7x; 32-128x2-3 at ~35 % of its
// operations bound.  Clock counters of its phases (tools/probe_shade.py)
// show both roles waiting on each other at the stage hand-over (the
// producers' walk and hand-over alone take ~1.3 ms on the fox's bake) and
// a consumer warpgroup's layers running one dependent wgmma group after
// another.

// GEN_PROFILE counts clock cycles by phase in block 0 (g_prof, read by
// shade_prof); GEN_NO_MLP has the consumers skip the MLP (wrong output: it
// times the producers and the hand-over alone).  Neither is in the library
// the port loads: sienerf_torch/tools/probe_shade.py builds them for the
// breakdown of where the kernel's time goes (PERF.md sections 5 and 6).
#ifdef GEN_PROFILE
__device__ unsigned long long g_prof[16];
#define PROF_ON (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 128 * NCONS))
#define PROF_NOW clock64()
#define PROF_ADD(i, t0) \
  if (PROF_ON) atomicAdd(&g_prof[i], (unsigned long long)(clock64() - (t0)))
#define PROF_COUNT(i) \
  if (PROF_ON) atomicAdd(&g_prof[i], 1ull)
#else
#define PROF_NOW 0
#define PROF_ADD(i, t0) (void)(t0)
#define PROF_COUNT(i)
#endif
#ifdef GEN_NO_MLP
constexpr bool GEN_SKIP_MLP = true;
#else
constexpr bool GEN_SKIP_MLP = false;
#endif

constexpr int GEN_STAGE_ROWS = 64;
constexpr int GEN_XPITCH = 80;                                // bytes a row of X
constexpr int GEN_STAGE_X = GEN_STAGE_ROWS * GEN_XPITCH;      // 5,120
constexpr int GEN_STAGE_BYTES = GEN_STAGE_X + GEN_STAGE_ROWS * (8 + 4);  // + ids, densities
constexpr int GEN_MAX_STAGES = 8;
constexpr int GEN_CHAIN = 128;                                // outputs a wgmma chain
constexpr int GEN_PROD_REGS = 96;                             // a producer's registers
constexpr int GEN_RAW_DEPTH = 4;                              // 1 KB tiles in flight a warp
constexpr int GEN_TILE_BYTES = TILE * NF * 2;
constexpr int GEN_MAX_PRODUCERS = 24;
constexpr int GEN_FRAC_MAX = 1024;
constexpr int GEN_RING_BYTES = 64 * (32 + 8 + 8);             // a producer's kept rows
// the weights' wgmma descriptors: 8 x 16-byte core matrices, the two K
// halves of a k16 step LBO bytes apart, successive 8-output groups SBO
constexpr uint32_t GEN_LBO = 128, GEN_SBO = 256;

// Bytes of the stage stream; producers that shade their own batches
// (no consumers) keep their X tiles there instead
__host__ __device__ constexpr int gen_stage_region(int stages, int direct_producers) {
  return stages * GEN_STAGE_BYTES > direct_producers * TILE * XPITCH * 4
             ? stages * GEN_STAGE_BYTES
             : direct_producers * TILE * XPITCH * 4;
}

struct GenCtl {
  unsigned long long wbar;
  unsigned long long full[GEN_MAX_STAGES];
  unsigned long long raw[GEN_MAX_PRODUCERS][GEN_RAW_DEPTH];
  int ticket, n_stages;
  int written[GEN_MAX_STAGES];   // rows a stage has received, in all its rounds
  int released[GEN_MAX_STAGES];  // consumer warps done with a stage, in all its rounds
  float scale[MAX_CASCADES * NF];
  float cam[4];
  uint32_t step[3];
  float frac[GEN_FRAC_MAX];  // i / R for i <= R, when R < GEN_FRAC_MAX
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_arrive(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 26)) __trap();
  }
}

// global -> shared, `bytes` (a multiple of 16) onto `bar`'s transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(GEN_LBO >> 4) << 16) |
         ((uint64_t)(GEN_SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>  // until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 8, f32) += A(64 x 16, bf16, registers) * B(16 x 8, bf16, shared
// memory through `desc`, K-major)
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D(64 x 64, f32) += A(64 x 16, bf16, registers) * B(16 x 64, bf16, shared
// memory through `desc`, K-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16, bf16, registers) * B(16 x 128, bf16, shared
// memory through `desc`, K-major)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n8(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_n64(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  wgmma_n128(d, a, desc);
}

// The general kernel's activations: activation() with the logistic's
// 1 / (1 + e) as the correctly rounded reciprocal, the same value as the
// division, without the division's slow path
__device__ __forceinline__ float gen_activation(float x, int act, float clamp) {
  if (act == ACT_LOGISTIC) return __frcp_rn(1.f + expf(-x));
  return activation(x, act, clamp);
}

// Issue one hidden layer of the warpgroup's 64 rows, acc = ain @ Wl, as
// W / NC chains of NC outputs, each its own commit group.  `lw` is the
// layer's packed weights (KTIN k16 steps of W / 8 core-matrix pairs).
template <int W, int KTIN>
__device__ __forceinline__ void gen_issue(float (&acc)[W / 2], const uint32_t (&ain)[KTIN][4],
                                          uint32_t lw) {
  constexpr int NC = W > GEN_CHAIN ? GEN_CHAIN : W;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < W / NC; ++c) {
#pragma unroll
    for (int kt = 0; kt < KTIN; ++kt)
      wgmma<NC>(*reinterpret_cast<float(*)[NC / 2]>(acc + c * (NC / 2)), ain[kt],
                wgmma_desc(lw + (kt * (W / 8) + c * (NC / 8)) * 256));
    wgmma_commit();
  }
}

// Finish it: aout = bf16(relu(acc)), each chain converted as soon as it is
// done while the later ones run.  The accumulators of n8 tiles (2j, 2j + 1)
// are k16 tile j of the next layer's A operand.
template <int W>
__device__ __forceinline__ void gen_finish(float (&acc)[W / 2], uint32_t (&aout)[W / 16][4]) {
  constexpr int NC = W > GEN_CHAIN ? GEN_CHAIN : W;
  constexpr int CHAINS = W / NC;
  static_assert(CHAINS <= 2, "widths up to 2 chains");
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    if (c + 1 < CHAINS)
      wgmma_wait<1>();  // the last chain may still run
    else
      wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int j = c * (NC / 16); j < (c + 1) * (NC / 16); ++j) {
      aout[j][0] = pack_relu_bf16(acc[8 * j], acc[8 * j + 1]);
      aout[j][1] = pack_relu_bf16(acc[8 * j + 2], acc[8 * j + 3]);
      aout[j][2] = pack_relu_bf16(acc[8 * j + 4], acc[8 * j + 5]);
      aout[j][3] = pack_relu_bf16(acc[8 * j + 6], acc[8 * j + 7]);
    }
  }
}

// Issue the output layer (one n8 tile) from KT k16 tiles of input at `lw`
template <int KT>
__device__ __forceinline__ void gen_issue_output(float (&oc)[4], const uint32_t (&a)[KT][4],
                                                 uint32_t lw) {
#pragma unroll
  for (int i = 0; i < 4; ++i) oc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) wgmma<8>(oc, a[kt], wgmma_desc(lw + kt * 256));
  wgmma_commit();
}

// Registers a thread: at launch (what __launch_bounds__ leaves) and after
// setmaxnreg for the producers and the consumers.
template <int W, int NCONS, int P>
struct GenShape {
  static constexpr int THREADS = 128 * NCONS + 32 * P;
  static constexpr int LAUNCH_REGS = (65536 / THREADS) / 8 * 8;
  static_assert(P % 4 == 0 && P <= GEN_MAX_PRODUCERS, "producers: whole warpgroups");
  // the instance without hidden layers needs few consumer registers and
  // gives the rest to its producers; the others keep the producers at
  // GEN_PROD_REGS and give the rest to the consumers
  static constexpr int CONS_OUT_ONLY = 64;
  static constexpr int PROD_REGS =
      W == 32 ? ((LAUNCH_REGS * THREADS - CONS_OUT_ONLY * 128 * NCONS) / (32 * P)) / 8 * 8
      : (GEN_PROD_REGS < LAUNCH_REGS - 8 ? GEN_PROD_REGS : LAUNCH_REGS - 8);
  static constexpr int CONS_FREE =
      NCONS == 0 ? 0 : ((LAUNCH_REGS * THREADS - PROD_REGS * 32 * P) / (128 * NCONS)) / 8 * 8;
  static constexpr int CONS_REGS = CONS_FREE > 240 ? 240 : CONS_FREE;
};

template <int REGS, int LAUNCH>
__device__ __forceinline__ void set_registers() {
  if constexpr (REGS > LAUNCH)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(REGS));
  else if constexpr (REGS < LAUNCH)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(REGS));
}

// A consumer warpgroup: the stages q = wg, wg + NCONS, ...  A slot holds
// the stages q = s (mod n_stage_slots), and n_stage_slots is a multiple of
// NCONS (gen_plan), so every slot has one consumer, which waits on its
// rounds in order: the parity of `full` then names the round it waits for.
template <int W, int NCONS>
__device__ __forceinline__ void gen_consumer(GenCtl& ctl, const uint8_t* weights,
                                             const uint8_t* stages, int n_stage_slots,
                                             int n_hidden, uint2* __restrict__ out, int ract) {
  static_assert(W > 32, "a net without hidden layers has no consumers");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const uint32_t wbase = smem_u32(weights);
  mbar_wait(&ctl.wbar, 0);
  const volatile int* v_nstages = &ctl.n_stages;
  // the previous stage's output layer, vertex id and density, stored by
  // `epilogue` once the next stage's MLP is under way: the rgb activation,
  // premultiplied, 8 bytes at the vertex.  (r, g) of rows g and g + 8 sit
  // in lane t = 0, (b, pad) in t = 1.
  float pend_oc[4] = {0.f, 0.f, 0.f, 0.f};
  long long pend_vid = -1;
  float pend_sigma = 0.f;
  auto epilogue = [&]() {
    const float p0 = __shfl_xor_sync(0xFFFFFFFFu, pend_oc[0], 1);
    const float p2 = __shfl_xor_sync(0xFFFFFFFFu, pend_oc[2], 1);
    const float p3 = __shfl_xor_sync(0xFFFFFFFFu, pend_oc[3], 1);
    if (t < 2 && pend_vid >= 0) {
      const float sigma = pend_sigma;  // the density, activated by the producer
      const float r = t ? p2 : pend_oc[0], gr = t ? p3 : pend_oc[1], b = t ? pend_oc[2] : p0;
      uint2 o;
      o.x = pack_bf16(gen_activation(r, ract, 10.f) * sigma,
                      gen_activation(gr, ract, 10.f) * sigma);
      o.y = pack_bf16(gen_activation(b, ract, 10.f) * sigma, sigma);
      out[pend_vid] = o;
    }
  };
  for (int q = wg;; q += NCONS) {
    const int s = q % n_stage_slots;
    const long long prof_q = PROF_NOW;
    mbar_wait(&ctl.full[s], (uint32_t)(q / n_stage_slots) & 1u);
    PROF_ADD(0, prof_q);
    const long long prof_l = PROF_NOW;
    if (q >= *v_nstages) break;
    const uint8_t* st = stages + s * GEN_STAGE_BYTES;
    uint32_t xa[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
      ldmatrix_x4(xa[kt], reinterpret_cast<const uint32_t*>(
                              st + (warp * 16 + (lane & 15)) * GEN_XPITCH + kt * 32 +
                              (lane >> 4) * 16));
    // the row this lane stores: (g, t = 0) takes row g, (g, t = 1) row g + 8
    const int row = warp * 16 + (lane >> 2) + 8 * (t & 1);
    long long vid = -1;
    float sigma = 0.f;
    if (t < 2) {
      vid = reinterpret_cast<const long long*>(st + GEN_STAGE_X)[row];
      sigma = reinterpret_cast<const float*>(st + GEN_STAGE_X + GEN_STAGE_ROWS * 8)[row];
    }
    __syncwarp();
    if (lane == 0) {  // the stage is read: release it
      __threadfence_block();
      atomicAdd(&ctl.released[s], 1);
    }

    PROF_ADD(1, prof_l);
    const long long prof_m = PROF_NOW;

    // the stage's MLP; the previous stage's epilogue runs while its first
    // layer is on the tensor cores
    float oc[4] = {0.f, 0.f, 0.f, 0.f};
    if (GEN_SKIP_MLP) {
      epilogue();
    } else {
      float acc[W / 2];
      uint32_t a[W / 16][4];
      gen_issue<W, 2>(acc, xa, wbase);
      epilogue();
      gen_finish<W>(acc, a);
      uint32_t lw = wbase + 32 * W * 2;
      for (int l = 1; l < n_hidden; ++l) {
        gen_issue<W, W / 16>(acc, a, lw);
        gen_finish<W>(acc, a);
        lw += W * W * 2;
      }
      gen_issue_output<W / 16>(oc, a, lw);
    }
    if (!GEN_SKIP_MLP) {
      wgmma_wait<0>();
      fence_operands(oc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) pend_oc[i] = oc[i];
    pend_vid = vid;
    pend_sigma = sigma;
    PROF_ADD(2, prof_m);
    PROF_COUNT(4);
  }
  epilogue();
}

// The warp's rows of one stage are in: add them to the stage's count; the
// warp that completes the stage's 64 rows hands it to its consumer
__device__ __forceinline__ void gen_complete(GenCtl& ctl, int seq, int rows, int n_stage_slots) {
  const int s = seq % n_stage_slots;
  const int old = atomicAdd(&ctl.written[s], rows);
  if (((old + rows) & (GEN_STAGE_ROWS - 1)) == 0) {
    __threadfence_block();
    mbar_arrive(&ctl.full[s]);
  }
}

// Wait until stage `seq`'s slot is free: its consumer has released every
// earlier round of the slot (a count, not a phase parity: producers may
// claim stages more than a round ahead of the consumers)
__device__ __forceinline__ void gen_wait_free(GenCtl& ctl, int seq, int n_stage_slots) {
  const volatile int* released = &ctl.released[seq % n_stage_slots];
  const int need = 4 * (seq / n_stage_slots);
  for (uint32_t tries = 0; *released < need; ++tries)
    if (tries > (1u << 26)) __trap();
  __threadfence_block();
}

// A batch of 32 kept vertices through a net without hidden layers, by the
// producer warp itself (a hand-over to a consumer costs more than this one
// layer): lane l's X row into the warp's tile, ldmatrix, two m16 tiles x
// two k16 steps of mma.sync against the output layer in fragment order
// (the tuned kernel's, pack_shade_weights(layout="fragment"); its sums
// are wgmma's bit for bit, shade_mma_probe_kernel), and the owner lane's
// epilogue through the same tile.
__device__ __forceinline__ void gen_shade_batch(const uint32_t (&xw)[16], float sigma,
                                                long long v, bool has, uint32_t* xs,
                                                const uint8_t* weights, uint2* __restrict__ out,
                                                int ract) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  uint4* xrow = reinterpret_cast<uint4*>(xs + lane * XPITCH);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    xrow[q] = make_uint4(xw[4 * q], xw[4 * q + 1], xw[4 * q + 2], xw[4 * q + 3]);
  __syncwarp();
  float oc[2][4] = {};
  const uint32_t* w = reinterpret_cast<const uint32_t*>(weights);
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const uint2 b = *reinterpret_cast<const uint2*>(w + (kt * 32 + lane) * 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * XPITCH + kt * 8 + (lane >> 4) * 4);
      mma_16816(oc[mt], a, b.x, b.y);
    }
  }
  // (r, g) sit in lanes tig == 0, (b, pad) in tig == 1, rows g and g + 8
  // of each m16 tile: to the owners through the tile
  __syncwarp();
  float* ys = reinterpret_cast<float*>(xs);
  if (tig < 2) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      *reinterpret_cast<float2*>(ys + (mt * 16 + g) * 4 + 2 * tig) = make_float2(oc[mt][0], oc[mt][1]);
      *reinterpret_cast<float2*>(ys + (mt * 16 + g + 8) * 4 + 2 * tig) =
          make_float2(oc[mt][2], oc[mt][3]);
    }
  }
  __syncwarp();
  const float4 rgb = *reinterpret_cast<const float4*>(ys + lane * 4);
  if (has) {
    uint2 o;
    o.x = pack_bf16(gen_activation(rgb.x, ract, 10.f) * sigma,
                    gen_activation(rgb.y, ract, 10.f) * sigma);
    o.y = pack_bf16(gen_activation(rgb.z, ract, 10.f) * sigma, sigma);
    out[v] = o;
  }
  __syncwarp();  // the tile takes the next batch
}

template <int NCONS, int P>
__device__ __forceinline__ void gen_producer(GenCtl& ctl, const uint8_t* weights, uint8_t* stages,
                                             uint8_t* raw_all, uint8_t* ring_all,
                                             int n_stage_slots, const int16_t* __restrict__ rows,
                                             uint2* __restrict__ out, int R, long long n_vert,
                                             int p0,
                                             int dact, int ract, int stall_ns) {
  // without consumers (the net without hidden layers) a producer warp
  // shades its batches itself, through its own X tile
  constexpr bool DIRECT = NCONS == 0;
  const int p = (threadIdx.x - 128 * NCONS) >> 5, lane = threadIdx.x & 31;
  const long long prof_start = PROF_NOW;
  uint32_t* xtile = reinterpret_cast<uint32_t*>(stages) + p * TILE * XPITCH;
  if (DIRECT) mbar_wait(&ctl.wbar, 0);
  uint8_t* raw = raw_all + p * GEN_RAW_DEPTH * GEN_TILE_BYTES;
  unsigned long long* rbar = ctl.raw[p];
  // the warp's ring of kept vertices: raw row, (m << 16 | i, j << 16 | k),
  // vertex id of up to 64; a batch is the 32 from `head` (0 or 32)
  uint4* ring_raw = reinterpret_cast<uint4*>(ring_all + p * GEN_RING_BYTES);
  uint2* ring_pos = reinterpret_cast<uint2*>(ring_raw + 2 * 64);
  long long* ring_v = reinterpret_cast<long long*>(ring_pos + 64);
  const volatile float* v_cam = ctl.cam;
  const volatile uint32_t* v_step = ctl.step;
  const uint32_t Rv = R + 1, plane = Rv * Rv;
  const int n_tiles = (int)((n_vert + TILE - 1) / TILE);
  const int stride = gridDim.x * P;
  int tile = blockIdx.x * P + p;
  auto issue = [&](int tt, int slot) {
    const long long left = n_vert - (long long)tt * TILE;
    const uint32_t bytes = (uint32_t)((left < TILE ? left : TILE) * NF * 2);
    mbar_expect_arrive(&rbar[slot], bytes);
    bulk_load(raw + slot * GEN_TILE_BYTES, rows + (long long)tt * TILE * NF, bytes, &rbar[slot]);
  };
  if (lane == 0)
    for (int d = 0; d < GEN_RAW_DEPTH; ++d)
      if (tile + d * stride < n_tiles) issue(tile + d * stride, d);
  const long long v_first = (long long)tile * TILE;
  uint32_t r0 = (uint32_t)(v_first % plane);
  const uint32_t gp0 = (uint32_t)(v_first / plane) + (uint32_t)p0;  // a plane of the bake
  uint32_t i0 = gp0 % Rv, m0 = gp0 / Rv;
  int head = 0, count = 0;

  for (int n = 0;; ++n) {
    if (tile < n_tiles) {
      if (r0 >= plane) {
        r0 -= plane;
        ++i0;
      }
      while (i0 >= Rv) {
        i0 -= Rv;
        ++m0;
      }
      const int slot = n % GEN_RAW_DEPTH;
      const long long prof_r = PROF_NOW;
      mbar_wait(&rbar[slot], (uint32_t)(n / GEN_RAW_DEPTH) & 1u);
      PROF_ADD(8, prof_r);
      PROF_COUNT(14);
      const long long v = (long long)tile * TILE + lane;
      const bool valid = v < n_vert;
      const uint4* src = reinterpret_cast<const uint4*>(raw + slot * GEN_TILE_BYTES + lane * 32);
      const uint4 qa = src[0], qb = src[1];
      const bool culled = !valid || (int16_t)(qa.x & 0xFFFFu) == -32768;
      __syncwarp();  // every lane holds its row: the slot takes a later tile
      if (lane == 0 && tile + GEN_RAW_DEPTH * stride < n_tiles) {
        fence_proxy_async();
        issue(tile + GEN_RAW_DEPTH * stride, slot);
      }
      if (valid && culled) out[v] = make_uint2(0u, 0u);
      const unsigned kept = __ballot_sync(0xFFFFFFFFu, !culled);
      if (kept != 0u) {
        // this lane's vertex (m, i, j, k): carries from the tile's first vertex
        uint32_t jk = r0 + lane, i = i0, m = m0;
        while (jk >= plane) {
          jk -= plane;
          ++i;
        }
        while (i >= Rv) {
          i -= Rv;
          ++m;
        }
        uint32_t j = plane < (1u << 24) ? (uint32_t)((float)jk * v_cam[3]) : jk / Rv;
        int k = (int)(jk - j * Rv);
        if (k < 0) {
          k += (int)Rv;
          --j;
        } else if (k >= (int)Rv) {
          k -= (int)Rv;
          ++j;
        }
        if (!culled) {
          const int at = (head + count + __popc(kept & ((1u << lane) - 1u))) & 63;
          ring_raw[2 * at] = qa;
          ring_raw[2 * at + 1] = qb;
          ring_pos[at] = make_uint2((m << 16) | i, (j << 16) | (uint32_t)k);
          ring_v[at] = v;
        }
        count += __popc(kept);
      }
      tile += stride;
      r0 += v_step[0];
      i0 += v_step[1];
      m0 += v_step[2];
      if (count < 32) continue;
    } else if (count == 0) {
      break;
    }

    // -- a batch: lane l takes kept vertex l of the ring (the last batch may
    // be short: its idle lanes compute the first row again and store nothing)
    long long prof_t = PROF_NOW;
    __syncwarp();
    const int nb = count < 32 ? count : 32;
    const bool has = lane < nb;
    const int row = head + (has ? lane : 0);
    const uint4 qa = ring_raw[2 * row], qb = ring_raw[2 * row + 1];
    const uint2 pos = ring_pos[row];
    const long long v = ring_v[row];
    const uint32_t m = pos.x >> 16, i = pos.x & 0xFFFFu, j = pos.y >> 16, k = pos.y & 0xFFFFu;
    count -= nb;
    head ^= 32;
    int base = 0;  // the batch's first slot; read after the vertices are done
    if (!DIRECT && lane == 0) base = atomicAdd(&ctl.ticket, nb);

    uint32_t xw[16];  // the X row: bf16 pairs of [SH16; raw16]
    const uint32_t words[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    const float* sc = ctl.scale + m * NF;
#pragma unroll
    for (int w = 0; w < 8; ++w)
      xw[8 + w] = pack_bf16((float)(int16_t)(words[w] & 0xFFFFu) * sc[2 * w],
                            (float)(int16_t)(words[w] >> 16) * sc[2 * w + 1]);
    const float sigma = activation((float)(int16_t)(qa.x & 0xFFFFu) * sc[0], dact, 15.f);
    const float side = (float)(1u << m);
    const float lo = 0.5f - 0.5f * side;
    const float Rf = (float)R;
    const bool table = R < GEN_FRAC_MAX;  // the lattice fractions i / R, as divided
    const float dx = ((table ? ctl.frac[i] : (float)i / Rf) * side + lo) - v_cam[0];
    const float dy = ((table ? ctl.frac[j] : (float)j / Rf) * side + lo) - v_cam[1];
    const float dz = ((table ? ctl.frac[k] : (float)k / Rf) * side + lo) - v_cam[2];
    const float nrm = fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-6f);
    const float X = ((dx / nrm + 1.f) * 0.5f) * 2.f - 1.f;
    const float Y = ((dy / nrm + 1.f) * 0.5f) * 2.f - 1.f;
    const float Z = ((dz / nrm + 1.f) * 0.5f) * 2.f - 1.f;
    const float xy = X * Y, xz = X * Z, yz = Y * Z;
    const float x2 = X * X, y2 = Y * Y, z2 = Z * Z;
    xw[0] = pack_bf16(0.28209479177387814f, -0.48860251190291987f * Y);
    xw[1] = pack_bf16(0.48860251190291987f * Z, -0.48860251190291987f * X);
    xw[2] = pack_bf16(1.0925484305920792f * xy, -1.0925484305920792f * yz);
    xw[3] = pack_bf16(0.94617469575755997f * z2 - 0.31539156525251999f,
                      -1.0925484305920792f * xz);
    xw[4] = pack_bf16(0.54627421529603959f * (x2 - y2),
                      0.59004358992664352f * Y * (-3.f * x2 + y2));
    xw[5] = pack_bf16(2.8906114426405538f * xy * Z, 0.45704579946446572f * Y * (1.f - 5.f * z2));
    xw[6] = pack_bf16(0.3731763325901154f * Z * (5.f * z2 - 3.f),
                      0.45704579946446572f * X * (1.f - 5.f * z2));
    xw[7] = pack_bf16(1.4453057213202769f * Z * (x2 - y2),
                      0.59004358992664352f * X * (-x2 + 3.f * y2));

    if constexpr (DIRECT) {
      gen_shade_batch(xw, sigma, v, has, xtile, weights, out, ract);
      PROF_ADD(12, prof_t);
      PROF_COUNT(13);
      __syncwarp();  // the next tile may append into this batch's half of the ring
      continue;
    }

    // into the batch's slots of the stage stream (one or two stages)
    base = __shfl_sync(0xFFFFFFFFu, base, 0);
    const int seq0 = base >> 6, seq1 = (base + nb - 1) >> 6;
    // the checks' hook: producer warp 0 writes its claimed rows late, so
    // that stages fill out of order (0 in every launch of the port)
    if (stall_ns > 0 && p == 0) __nanosleep((unsigned)stall_ns);
    if (lane == 0) {
      PROF_ADD(10, prof_t);
      const long long prof_w = PROF_NOW;
      gen_wait_free(ctl, seq0, n_stage_slots);
      PROF_ADD(11, prof_w);
      prof_t = PROF_NOW;
      if (seq1 != seq0) gen_wait_free(ctl, seq1, n_stage_slots);
    }
    __syncwarp();
    if (has) {
      const int slot_t = base + lane;
      uint8_t* st = stages + ((slot_t >> 6) % n_stage_slots) * GEN_STAGE_BYTES;
      const int srow = slot_t & (GEN_STAGE_ROWS - 1);
      uint4* xrow = reinterpret_cast<uint4*>(st + srow * GEN_XPITCH);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xrow[q] = make_uint4(xw[4 * q], xw[4 * q + 1], xw[4 * q + 2], xw[4 * q + 3]);
      reinterpret_cast<long long*>(st + GEN_STAGE_X)[srow] = v;
      reinterpret_cast<float*>(st + GEN_STAGE_X + GEN_STAGE_ROWS * 8)[srow] = sigma;
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();  // the warp's rows before its count
      const int n0 = seq0 == seq1 ? nb : GEN_STAGE_ROWS - (base & (GEN_STAGE_ROWS - 1));
      gen_complete(ctl, seq0, n0, n_stage_slots);
      if (seq1 != seq0) gen_complete(ctl, seq1, nb - n0, n_stage_slots);
    }
    PROF_ADD(12, prof_t);
    PROF_COUNT(13);
    __syncwarp();  // the next tile may append into this batch's half of the ring
  }

  // every producer is done: warp 0 pads the last stage and ends the stream
  PROF_ADD(15, prof_start);
  if (DIRECT) return;
  asm volatile("bar.sync 1, %0;" ::"r"(32 * P) : "memory");
  if (p != 0) return;
  const int t_end = *reinterpret_cast<volatile int*>(&ctl.ticket);
  const int rem = t_end & (GEN_STAGE_ROWS - 1);
  const int n_st = (t_end + GEN_STAGE_ROWS - 1) / GEN_STAGE_ROWS;
  if (rem != 0) {
    const int seq = t_end >> 6;
    if (lane == 0) gen_wait_free(ctl, seq, n_stage_slots);
    __syncwarp();
    uint8_t* st = stages + (seq % n_stage_slots) * GEN_STAGE_BYTES;
    for (int r = rem + lane; r < GEN_STAGE_ROWS; r += 32) {
      uint4* xrow = reinterpret_cast<uint4*>(st + r * GEN_XPITCH);
      xrow[0] = xrow[1] = xrow[2] = xrow[3] = make_uint4(0u, 0u, 0u, 0u);
      reinterpret_cast<long long*>(st + GEN_STAGE_X)[r] = -1;
      reinterpret_cast<float*>(st + GEN_STAGE_X + GEN_STAGE_ROWS * 8)[r] = 0.f;
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      gen_complete(ctl, seq, GEN_STAGE_ROWS - rem, n_stage_slots);
    }
  }
  if (lane == 0) {
    *reinterpret_cast<volatile int*>(&ctl.n_stages) = n_st;
    __threadfence_block();
    for (int c = 0; c < NCONS; ++c) {
      const int q = n_st + ((c - n_st % NCONS) + NCONS) % NCONS;  // consumer c's next stage
      gen_wait_free(ctl, q, n_stage_slots);
      mbar_arrive(&ctl.full[q % n_stage_slots]);
    }
  }
}

template <int W, int NCONS, int P>
__global__ void __launch_bounds__(GenShape<W, NCONS, P>::THREADS, 1) shade_general_kernel(
    const int16_t* __restrict__ rows, const float* __restrict__ scale,
    const float* __restrict__ cam, const uint16_t* __restrict__ wpacked, int w_bytes,
    int n_hidden, int n_stage_slots, uint2* __restrict__ out, int R, int K, long long n_vert,
    int p0,
    int dact, int ract, int stall_ns) {
  using Shape = GenShape<W, NCONS, P>;
  __shared__ GenCtl ctl;
  extern __shared__ __align__(128) uint8_t g_dyn[];
  const int w_pad = (w_bytes + 127) & ~127;
  uint8_t* stages = g_dyn + w_pad;
  uint8_t* raw = stages + gen_stage_region(n_stage_slots, NCONS == 0 ? P : 0);
  uint8_t* ring = raw + P * GEN_RAW_DEPTH * GEN_TILE_BYTES;
  if (threadIdx.x == 0) {
    mbar_init(&ctl.wbar, 1);
    for (int s = 0; s < n_stage_slots; ++s) {
      mbar_init(&ctl.full[s], 1);
      ctl.written[s] = ctl.released[s] = 0;
    }
    for (int p = 0; p < P; ++p)
      for (int d = 0; d < GEN_RAW_DEPTH; ++d) mbar_init(&ctl.raw[p][d], 1);
    ctl.ticket = 0;
    ctl.n_stages = 0x7FFFFFFF;
    const uint32_t Rv0 = R + 1, plane0 = Rv0 * Rv0;
    const long long step = (long long)gridDim.x * P * TILE;
    const uint32_t step_p = (uint32_t)(step / plane0);
    ctl.cam[0] = cam[0];
    ctl.cam[1] = cam[1];
    ctl.cam[2] = cam[2];
    ctl.cam[3] = 1.f / (float)Rv0;
    ctl.step[0] = (uint32_t)(step % plane0);
    ctl.step[1] = step_p % Rv0;
    ctl.step[2] = step_p / Rv0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_arrive(&ctl.wbar, (uint32_t)w_bytes);
    bulk_load(g_dyn, wpacked, (uint32_t)w_bytes, &ctl.wbar);
  }
  for (int t = threadIdx.x; t < K * NF; t += blockDim.x) ctl.scale[t] = scale[t];
  if (R < GEN_FRAC_MAX)
    for (int t = threadIdx.x; t <= R; t += blockDim.x) ctl.frac[t] = (float)t / (float)R;
  __syncthreads();
  if (threadIdx.x >= 128 * NCONS) {
    set_registers<Shape::PROD_REGS, Shape::LAUNCH_REGS>();
    gen_producer<NCONS, P>(ctl, g_dyn, stages, raw, ring, n_stage_slots, rows, out, R, n_vert, p0,
                           dact, ract, stall_ns);
  } else if constexpr (NCONS > 0) {
    set_registers<Shape::CONS_REGS, Shape::LAUNCH_REGS>();
    gen_consumer<W, NCONS>(ctl, g_dyn, stages, n_stage_slots, n_hidden, out, ract);
  }
}

// ---------------------------------------------------------------------------
// The wide path: the colour MLPs the general kernel above cannot hold,
// hidden widths above 256 (wgmma's widest product, and more accumulators
// than a warpgroup's registers) or weights that leave its shared memory no
// room for the stage ring (e.g. 32-128x6-3).  No net of configs/nerf/ comes
// here.  This is the general path's first kernel, kept as it was:
// the tuned kernel's walk, ring of kept rows, direction, SH16 and owner's
// epilogue, line for line; a layer's outputs 32 at a time (two pairs of n8
// tiles of mma.sync) over a runtime loop of k16 input tiles, each hidden
// layer's relu + bf16 output through a per-warp shared tile (row pitch W +
// 8 bf16: ldmatrix and the 32-bit stores free of bank conflicts) that the
// next layer reads with ldmatrix, two tiles a warp alternating.  Weights in
// fragment order (pack_shade_weights(layout="fragment"), width padded to
// 16) in dynamic shared memory; the launch picks the warps a block (8, 4,
// 2 or 1) that put the most warps on an SM.  Every output is a chain of
// mma over its k16 tiles in ascending order, so it gives the general
// kernel's sums.  It takes any width whose weights and one warp's tiles
// fit an SM's shared memory (32-512-3, 32-128x6-3), at 17 % of its
// bound at 32-128-128-3 (PERF.md section 6): the general kernel's time
// beside this one's is the floor the general kernel was held to.
constexpr int WIDE_MAX_WARPS = 8;
constexpr int WIDE_RING_BYTES = 64 * 32 + 64 * 8 + 64 * 8;  // raw rows, pos, vertex ids

__global__ void __launch_bounds__(32 * WIDE_MAX_WARPS, 1) shade_wide_kernel(
    const int16_t* __restrict__ rows, const float* __restrict__ scale,
    const float* __restrict__ cam, const uint32_t* __restrict__ wpacked, int w_words,
    int n_hidden, int width, uint2* __restrict__ out, int R, int K, long long n_vert, int p0,
    int dact, int ract) {
  extern __shared__ __align__(16) uint32_t g_smem[];
  const int warps = blockDim.x >> 5;
  // words a row of an activation tile, which also holds the 32-wide X
  const int pitch = ((width > 32 ? width : 32) + 8) / 2;
  const int tile_words = TILE * pitch;
  uint32_t* s_w = g_smem;
  // per warp: the ring, then two activation tiles
  const int warp_words = WIDE_RING_BYTES / 4 + 2 * tile_words;
  __shared__ __align__(16) float s_scale[MAX_CASCADES * NF];
  for (int t = threadIdx.x; t < w_words / 4; t += blockDim.x)
    reinterpret_cast<uint4*>(s_w)[t] = __ldg(reinterpret_cast<const uint4*>(wpacked) + t);
  for (int t = threadIdx.x; t < K * NF; t += blockDim.x) s_scale[t] = scale[t];
  __shared__ float s_cam[4];
  __shared__ uint32_t s_step[3];
  if (threadIdx.x == 0) {
    const uint32_t Rv0 = R + 1, plane0 = Rv0 * Rv0;
    const long long step = (long long)gridDim.x * warps * TILE;
    const uint32_t step_p = (uint32_t)(step / plane0);
    s_cam[0] = cam[0];
    s_cam[1] = cam[1];
    s_cam[2] = cam[2];
    s_cam[3] = 1.f / (float)Rv0;
    s_step[0] = (uint32_t)(step % plane0);
    s_step[1] = step_p % Rv0;
    s_step[2] = step_p / Rv0;
  }
  __syncthreads();
  const volatile float* v_cam = s_cam;
  const volatile uint32_t* v_step = s_step;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  uint32_t* wbase = g_smem + w_words + warp * warp_words;
  uint4* ring_raw = reinterpret_cast<uint4*>(wbase);
  uint2* ring_pos = reinterpret_cast<uint2*>(wbase + 64 * 8);
  long long* ring_v = reinterpret_cast<long long*>(wbase + 64 * 8 + 64 * 2);
  uint32_t* const tile0 = wbase + WIDE_RING_BYTES / 4;  // tile c at tile0 + c * tile_words
  const uint32_t Rv = R + 1, plane = Rv * Rv;

  const int n_tiles = (int)((n_vert + TILE - 1) / TILE);
  const int n_warps = gridDim.x * warps;
  int tile = blockIdx.x * warps + warp;
  const long long v_first = (long long)tile * TILE;
  uint32_t r0 = (uint32_t)(v_first % plane);
  const uint32_t gp0 = (uint32_t)(v_first / plane) + (uint32_t)p0;  // a plane of the bake
  uint32_t i0 = gp0 % Rv, m0 = gp0 / Rv;
  int head = 0, count = 0;
  const int n_pairs = width / 16;  // pairs of n8 output tiles of a hidden layer

  for (;;) {
    const bool have_tile = tile < n_tiles;
    if (have_tile) {
      if (r0 >= plane) {
        r0 -= plane;
        ++i0;
      }
      while (i0 >= Rv) {
        i0 -= Rv;
        ++m0;
      }
      const long long v = (long long)tile * TILE + lane;
      const bool valid = v < n_vert;
      const uint4* src = reinterpret_cast<const uint4*>(rows + (valid ? v : n_vert - 1) * NF);
      const uint4 qa = __ldg(src), qb = __ldg(src + 1);
      const bool culled = !valid || (int16_t)(qa.x & 0xFFFFu) == -32768;
      if (valid && culled) out[v] = make_uint2(0u, 0u);
      const unsigned kept = __ballot_sync(0xFFFFFFFFu, !culled);
      if (kept != 0u) {
        uint32_t jk = r0 + lane, i = i0, m = m0;
        while (jk >= plane) {
          jk -= plane;
          ++i;
        }
        while (i >= Rv) {
          i -= Rv;
          ++m;
        }
        uint32_t j = plane < (1u << 24) ? (uint32_t)((float)jk * v_cam[3]) : jk / Rv;
        int k = (int)(jk - j * Rv);
        if (k < 0) {
          k += (int)Rv;
          --j;
        } else if (k >= (int)Rv) {
          k -= (int)Rv;
          ++j;
        }
        if (!culled) {
          const int slot = (head + count + __popc(kept & ((1u << lane) - 1u))) & 63;
          ring_raw[2 * slot] = qa;
          ring_raw[2 * slot + 1] = qb;
          ring_pos[slot] = make_uint2((m << 16) | i, (j << 16) | (uint32_t)k);
          ring_v[slot] = v;
        }
        count += __popc(kept);
      }
      tile += n_warps;
      r0 += v_step[0];
      i0 += v_step[1];
      m0 += v_step[2];
      if (count < 32) continue;
    } else if (count == 0) {
      break;
    }

    __syncwarp();
    const bool has = lane < count;
    const int row = head + (has ? lane : 0);
    const uint4 qa = ring_raw[2 * row], qb = ring_raw[2 * row + 1];
    const uint2 pos = ring_pos[row];
    const uint32_t m = pos.x >> 16, i = pos.x & 0xFFFFu, j = pos.y >> 16, k = pos.y & 0xFFFFu;
    count -= count < 32 ? count : 32;
    head ^= 32;

    const uint32_t words[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    const float* sc = s_scale + m * NF;
    float raw[NF];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      raw[2 * w] = (float)(int16_t)(words[w] & 0xFFFFu) * sc[2 * w];
      raw[2 * w + 1] = (float)(int16_t)(words[w] >> 16) * sc[2 * w + 1];
    }
    const float side = (float)(1u << m);
    const float lo = 0.5f - 0.5f * side;
    const float Rf = (float)R;
    const float dx = ((float)i / Rf * side + lo) - v_cam[0];
    const float dy = ((float)j / Rf * side + lo) - v_cam[1];
    const float dz = ((float)k / Rf * side + lo) - v_cam[2];
    const float n = fmaxf(sqrtf(dx * dx + dy * dy + dz * dz), 1e-6f);
    const float X = ((dx / n + 1.f) * 0.5f) * 2.f - 1.f;
    const float Y = ((dy / n + 1.f) * 0.5f) * 2.f - 1.f;
    const float Z = ((dz / n + 1.f) * 0.5f) * 2.f - 1.f;
    const float xy = X * Y, xz = X * Z, yz = Y * Z;
    const float x2 = X * X, y2 = Y * Y, z2 = Z * Z;
    float sh[16];
    sh[0] = 0.28209479177387814f;
    sh[1] = -0.48860251190291987f * Y;
    sh[2] = 0.48860251190291987f * Z;
    sh[3] = -0.48860251190291987f * X;
    sh[4] = 1.0925484305920792f * xy;
    sh[5] = -1.0925484305920792f * yz;
    sh[6] = 0.94617469575755997f * z2 - 0.31539156525251999f;
    sh[7] = -1.0925484305920792f * xz;
    sh[8] = 0.54627421529603959f * (x2 - y2);
    sh[9] = 0.59004358992664352f * Y * (-3.f * x2 + y2);
    sh[10] = 2.8906114426405538f * xy * Z;
    sh[11] = 0.45704579946446572f * Y * (1.f - 5.f * z2);
    sh[12] = 0.3731763325901154f * Z * (5.f * z2 - 3.f);
    sh[13] = 0.45704579946446572f * X * (1.f - 5.f * z2);
    sh[14] = 1.4453057213202769f * Z * (x2 - y2);
    sh[15] = 0.59004358992664352f * X * (-x2 + 3.f * y2);

    // X row = bf16([SH16; raw16]) into tile 0
    __syncwarp();  // the previous batch's reads of both tiles are done
    uint4* xrow = reinterpret_cast<uint4*>(tile0 + lane * pitch);
    xrow[0] = make_uint4(pack_bf16(sh[0], sh[1]), pack_bf16(sh[2], sh[3]),
                         pack_bf16(sh[4], sh[5]), pack_bf16(sh[6], sh[7]));
    xrow[1] = make_uint4(pack_bf16(sh[8], sh[9]), pack_bf16(sh[10], sh[11]),
                         pack_bf16(sh[12], sh[13]), pack_bf16(sh[14], sh[15]));
    xrow[2] = make_uint4(pack_bf16(raw[0], raw[1]), pack_bf16(raw[2], raw[3]),
                         pack_bf16(raw[4], raw[5]), pack_bf16(raw[6], raw[7]));
    xrow[3] = make_uint4(pack_bf16(raw[8], raw[9]), pack_bf16(raw[10], raw[11]),
                         pack_bf16(raw[12], raw[13]), pack_bf16(raw[14], raw[15]));
    __syncwarp();

    // hidden layers: tile (l & 1) -> tile (l + 1) & 1
    const uint32_t* wl = s_w;
    int k_tiles = 2;  // k16 tiles of the layer's input
    int cur = 0;
    for (int l = 0; l < n_hidden; ++l) {
      const uint32_t* hin = tile0 + cur * tile_words;
      uint32_t* hout = tile0 + (cur ^ 1) * tile_words;
      for (int p0 = 0; p0 < n_pairs; p0 += 2) {
        float acc[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
        for (int kt = 0; kt < k_tiles; ++kt) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldmatrix_x4(a[mt], hin + (mt * 16 + (lane & 15)) * pitch + kt * 8 + (lane >> 4) * 4);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (p0 + q < n_pairs) {
              const uint4 b = *reinterpret_cast<const uint4*>(
                  wl + ((kt * n_pairs + p0 + q) * 32 + lane) * 4);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_16816(acc[mt][2 * q], a[mt], b.x, b.y);
                mma_16816(acc[mt][2 * q + 1], a[mt], b.z, b.w);
              }
            }
          }
        }
        // relu + bf16 into the output tile: n8 tile nt of pair p0 + nt / 2
        // holds columns 8 (2 p0 + nt) .. + 7, lane (g, tig) two of them
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (p0 + nt / 2 < n_pairs) {
            const int col = (2 * p0 + nt) * 4 + tig;  // in words
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              hout[(mt * 16 + g) * pitch + col] = pack_relu_bf16(acc[mt][nt][0], acc[mt][nt][1]);
              hout[(mt * 16 + g + 8) * pitch + col] =
                  pack_relu_bf16(acc[mt][nt][2], acc[mt][nt][3]);
            }
          }
        }
      }
      __syncwarp();
      wl += k_tiles * n_pairs * 32 * 4;
      k_tiles = n_pairs;  // a pair of n8 tiles is one k16 tile of the next layer
      cur ^= 1;
    }
    // the output layer: one n8 tile (3 outputs and 5 zero columns)
    float oc[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) oc[mt][r4] = 0.f;
    for (int kt = 0; kt < k_tiles; ++kt) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], tile0 + cur * tile_words + (mt * 16 + (lane & 15)) * pitch + kt * 8 + (lane >> 4) * 4);
      const uint2 b = *reinterpret_cast<const uint2*>(wl + (kt * 32 + lane) * 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_16816(oc[mt], a[mt], b.x, b.y);
    }

    // (r, g) sit in lanes tig == 0, (b, pad) in tig == 1: to the owners
    // through the tile the output layer did not read
    float* ys = reinterpret_cast<float*>(tile0 + (cur ^ 1) * tile_words);
    if (tig < 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        *reinterpret_cast<float2*>(ys + (mt * 16 + g) * 4 + 2 * tig) =
            make_float2(oc[mt][0], oc[mt][1]);
        *reinterpret_cast<float2*>(ys + (mt * 16 + g + 8) * 4 + 2 * tig) =
            make_float2(oc[mt][2], oc[mt][3]);
      }
    }
    __syncwarp();
    const float4 rgb = *reinterpret_cast<const float4*>(ys + lane * 4);
    if (has) {
      const float sigma = activation(
          (float)(int16_t)(ring_raw[2 * row].x & 0xFFFFu) * s_scale[(ring_pos[row].x >> 16) * NF],
          dact, 15.f);
      uint2 o;
      o.x = pack_bf16(activation(rgb.x, ract, 10.f) * sigma,
                      activation(rgb.y, ract, 10.f) * sigma);
      o.y = pack_bf16(activation(rgb.z, ract, 10.f) * sigma, sigma);
      out[ring_v[row]] = o;
    }
    __syncwarp();
  }
}

// One k16 chain of a 64 x 64 x 64 product through both instructions, for
// the checks: A (64 x 64) and B (64 x 64, k x n) bf16 row-major; d_sync =
// A B by mma.sync.m16n8k16 (the tuned kernel's), d_wgmma by wgmma m64n64k16
// with A from registers and B through a descriptor (the general path's),
// each output's four k16 steps in ascending order from zero.
__global__ void __launch_bounds__(128, 1) shade_mma_probe_kernel(
    const uint16_t* __restrict__ a, const uint16_t* __restrict__ b, float* __restrict__ d_sync,
    float* __restrict__ d_wgmma) {
  __shared__ __align__(128) uint16_t sb[64 * 64];
  for (int e = threadIdx.x; e < 64 * 64; e += 128) {
    const int k = e / 64, n = e % 64;
    sb[(((k / 16) * 8 + n / 8) * 2 + (k % 16) / 8) * 64 + (n % 8) * 8 + k % 8] = b[e];
  }
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto pair = [](uint16_t lo, uint16_t hi) { return (uint32_t)lo | ((uint32_t)hi << 16); };
  uint32_t af[4][4];
  const uint16_t* ar = a + (warp * 16 + g) * 64;
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const int c = kt * 16 + 2 * t;
    af[kt][0] = pair(ar[c], ar[c + 1]);
    af[kt][1] = pair(ar[8 * 64 + c], ar[8 * 64 + c + 1]);
    af[kt][2] = pair(ar[c + 8], ar[c + 9]);
    af[kt][3] = pair(ar[8 * 64 + c + 8], ar[8 * 64 + c + 9]);
  }
  float ds[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) ds[nt][r] = 0.f;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const int k = kt * 16 + 2 * t, n = nt * 8 + g;
      mma_16816(ds[nt], af[kt], pair(b[k * 64 + n], b[(k + 1) * 64 + n]),
                pair(b[(k + 8) * 64 + n], b[(k + 9) * 64 + n]));
    }
  }
  float dw[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dw[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) wgmma<64>(dw, af[kt], wgmma_desc(smem_u32(sb) + kt * 8 * 256));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(dw);
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (r0 + 8 * h) * 64 + nt * 8 + 2 * t;
      d_sync[o] = ds[nt][2 * h];
      d_sync[o + 1] = ds[nt][2 * h + 1];
      d_wgmma[o] = dw[4 * nt + 2 * h];
      d_wgmma[o + 1] = dw[4 * nt + 2 * h + 1];
    }
}

}  // namespace

extern "C" int shade_block_threads() { return BLOCK; }

// Blocks of shade_kernel that fit one SM (registers and shared memory).
extern "C" int shade_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, shade_kernel, BLOCK, 0) != cudaSuccess)
    return 0;
  return n;
}

// The vertices a launch shades: vertex planes [plane0, plane0 + n_planes) of
// the K*(R+1) planes of the bake, each (R+1)^2 rows of 32 bytes (a plane
// starts 32-byte aligned).  Returns the planes' first row and their vertex
// count, or a null pointer when the range is not in the bake.
static const int16_t* plane_range(const void* rows, int resolution, int n_cascades,
                                  int plane0, int n_planes, long long* n_vert) {
  const long long Rv = resolution + 1;
  if (plane0 < 0 || n_planes < 1 || (long long)plane0 + n_planes > n_cascades * Rv)
    return nullptr;
  *n_vert = (long long)n_planes * Rv * Rv;
  return (const int16_t*)rows + (long long)plane0 * Rv * Rv * NF;
}

// rows (K*(R+1)^3, 16) int16, scale (K, 16) f32, cam (3,) f32, wpacked the
// 13,312-byte fragment-order weights, out n_planes*(R+1)^2 vertices x 4 bf16:
// planes [plane0, plane0 + n_planes) of the bake.
extern "C" int shade_volume_launch(const void* rows, const void* scale,
                                   const void* cam, const void* wpacked, void* out,
                                   int resolution, int n_cascades, int plane0, int n_planes,
                                   int density_act, int rgb_act, int n_sms,
                                   void* stream) {
  if (n_cascades > MAX_CASCADES || resolution > 65534) return (int)cudaErrorInvalidValue;
  long long n_vert = 0;
  const int16_t* first = plane_range(rows, resolution, n_cascades, plane0, n_planes, &n_vert);
  if (first == nullptr) return (int)cudaErrorInvalidValue;
  static const int resident = shade_blocks_per_sm();  // asked once
  const int per_sm = resident < 1 ? 1 : resident;
  if ((n_vert + TILE - 1) / TILE > 0x7FFFFFFFLL - 65536) return (int)cudaErrorInvalidValue;
  const long long want = (n_vert + BLOCK - 1) / BLOCK;
  const long long have = (long long)n_sms * per_sm;
  const int grid = (int)(want < have ? want : have);
  shade_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      first, (const float*)scale, (const float*)cam,
      (const uint32_t*)wpacked, (uint2*)out, resolution, n_cascades, n_vert, plane0,
      density_act, rgb_act);
  return (int)cudaGetLastError();
}

// ---- the general path's launch -------------------------------------------

// An instance of the general kernel: padded width, consumer warpgroups,
// producer warps.
struct GenInstance {
  const void* fn;
  int threads, launch_regs, producers, direct_producers, consumers;
};

template <int W, int NCONS, int P>
static GenInstance gen_instance() {
  using Shape = GenShape<W, NCONS, P>;
  return {(const void*)shade_general_kernel<W, NCONS, P>, Shape::THREADS, Shape::LAUNCH_REGS, P,
          NCONS == 0 ? P : 0, NCONS};
}

// The instance for a padded width (32, 64, 128 or 256) and a count of
// hidden layers; fn null for another width.  Consumer warpgroups and
// producer warps as measured on the card (PERF.md section 6).
static GenInstance gen_pick(int width, int n_hidden) {
  if (width == 32) return gen_instance<32, 0, 20>();
  if (width == 64) return n_hidden < 3 ? gen_instance<64, 3, 12>() : gen_instance<64, 2, 12>();
  if (width == 128) return gen_instance<128, 2, 8>();
  if (width == 256) return gen_instance<256, 1, 8>();
  return {nullptr, 0, 0, 0, 0, 0};
}

// Dynamic shared memory for `stages` stages.
static int gen_smem_bytes(int w_bytes, int stages, int producers, int direct_producers) {
  return ((w_bytes + 127) & ~127) + gen_stage_region(stages, direct_producers) +
         producers * (GEN_RAW_DEPTH * GEN_TILE_BYTES + GEN_RING_BYTES);
}

// The stages and the dynamic shared memory of a launch: the most that fit,
// up to GEN_MAX_STAGES, a multiple of the consumer warpgroups (so that each
// slot has one consumer, gen_consumer) and at least 2; 0 stages where the
// weights leave no room, or the instance lacks the registers its setmaxnreg
// split assumes.
static int gen_plan(const GenInstance& in, int w_bytes, int* smem) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, in.fn) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  // setmaxnreg splits what the launch gives: ptxas must have taken it all
  if (in.direct_producers == 0 && attr.numRegs < in.launch_regs) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int step = in.consumers > 1 ? in.consumers : 1;
  for (int stages = GEN_MAX_STAGES / step * step; stages >= 2; stages -= step) {
    const int bytes = gen_smem_bytes(w_bytes, stages, in.producers, in.direct_producers);
    if (bytes + (int)attr.sharedSizeBytes <= optin) {
      *smem = bytes;
      return stages;
    }
  }
  return 0;
}

// Warps a block, dynamic shared memory and blocks an SM of the general
// path for `w_words` 32-bit words of weights packed at padded width
// `width` with `n_hidden` hidden layers; 0 warps if no launch fits.
extern "C" int shade_general_config(int w_words, int width, int n_hidden, int* out_smem,
                                    int* out_blocks) {
  const GenInstance in = gen_pick(width, n_hidden);
  int smem = 0;
  if (in.fn == nullptr || gen_plan(in, w_words * 4, &smem) == 0) return 0;
  if (cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, in.fn, in.threads, smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  *out_smem = smem;
  *out_blocks = blocks;
  return in.threads / 32;
}

// The general path: wpacked holds w_words 32-bit words (pack_shade_weights
// with layout "wgmma" for n_hidden hidden layers of padded width `width`:
// 64, 128 or 256; "fragment" for a net without hidden layers, width 32);
// planes as shade_volume_launch's.  stall_ns > 0 delays producer warp 0's
// writes (the checks' hook).
extern "C" int shade_general_launch(const void* rows, const void* scale, const void* cam,
                                    const void* wpacked, int w_words, int n_hidden,
                                    int width, void* out, int resolution, int n_cascades,
                                    int plane0, int n_planes, int density_act, int rgb_act,
                                    int n_sms, int stall_ns, void* stream) {
  const GenInstance in = gen_pick(width, n_hidden);
  if (in.fn == nullptr || n_cascades > MAX_CASCADES || resolution > 65534 ||
      w_words % 4 != 0 || n_hidden < 0 || ((uintptr_t)rows & 15) != 0 ||
      ((uintptr_t)wpacked & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  int stages = gen_plan(in, w_words * 4, &smem);
  if (stages == 0) return (int)cudaErrorInvalidConfiguration;
  if (cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return (int)cudaGetLastError();
  long long n_vert = 0;
  const int16_t* rows_p = plane_range(rows, resolution, n_cascades, plane0, n_planes, &n_vert);
  if (rows_p == nullptr) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (n_vert + TILE - 1) / TILE;
  if (n_tiles > 0x7FFFFFFFLL - 65536) return (int)cudaErrorInvalidValue;
  const long long want = (n_tiles + in.producers - 1) / in.producers;
  const int grid = (int)(want < n_sms ? want : n_sms);
  const float* scale_p = (const float*)scale;
  const float* cam_p = (const float*)cam;
  const uint16_t* w_p = (const uint16_t*)wpacked;
  int w_bytes = w_words * 4;
  uint2* out_p = (uint2*)out;
  void* args[] = {&rows_p, &scale_p, &cam_p, &w_p, &w_bytes, &n_hidden, &stages, &out_p,
                  &resolution, &n_cascades, &n_vert, &plane0, &density_act, &rgb_act,
                  &stall_ns};
  return (int)cudaLaunchKernel(in.fn, dim3(grid), dim3(in.threads), args, (size_t)smem,
                               (cudaStream_t)stream);
}

// ---- the wide path's launch ----------------------------------------------

// Dynamic shared memory of a wide-path block of `warps` warps.
static int wide_smem_bytes(int w_words, int width, int warps) {
  const int pitch = ((width > 32 ? width : 32) + 8) / 2;
  return w_words * 4 + warps * (WIDE_RING_BYTES + 2 * TILE * pitch * 4);
}

// The warps a block (8, 4, 2 or 1) that put the most warps on an SM, its
// dynamic shared memory and the blocks an SM; 0 warps if none fits.
extern "C" int shade_wide_config(int w_words, int width, int* out_smem,
                                    int* out_blocks) {
  int best = 0, best_total = 0;
  for (int warps = WIDE_MAX_WARPS; warps >= 1; warps /= 2) {
    const int smem = wide_smem_bytes(w_words, width, warps);
    if (cudaFuncSetAttribute(shade_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_wide_kernel,
                                                      32 * warps, smem) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (blocks * warps > best_total) {
      best_total = blocks * warps;
      best = warps;
      *out_smem = smem;
      *out_blocks = blocks;
    }
  }
  return best;
}

// The wide path: wpacked holds w_words 32-bit words (pack_shade_weights
// with layout "fragment" for n_hidden hidden layers of padded width
// `width`, a multiple of 16); planes as shade_volume_launch's.
extern "C" int shade_wide_launch(const void* rows, const void* scale, const void* cam,
                                    const void* wpacked, int w_words, int n_hidden,
                                    int width, void* out, int resolution, int n_cascades,
                                    int plane0, int n_planes, int density_act, int rgb_act,
                                    int n_sms, void* stream) {
  if (n_cascades > MAX_CASCADES || resolution > 65534 || width % 16 != 0 || width < 16 ||
      w_words % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int smem = 0, per_sm = 0;
  const int warps = shade_wide_config(w_words, width, &smem, &per_sm);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  if (cudaFuncSetAttribute(shade_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return (int)cudaGetLastError();
  long long n_vert = 0;
  const int16_t* first = plane_range(rows, resolution, n_cascades, plane0, n_planes, &n_vert);
  if (first == nullptr) return (int)cudaErrorInvalidValue;
  if ((n_vert + TILE - 1) / TILE > 0x7FFFFFFFLL - 65536) return (int)cudaErrorInvalidValue;
  const long long want = (n_vert + 32 * warps - 1) / (32 * warps);
  const long long have = (long long)n_sms * per_sm;
  const int grid = (int)(want < have ? want : have);
  shade_wide_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      first, (const float*)scale, (const float*)cam,
      (const uint32_t*)wpacked, w_words, n_hidden, width, (uint2*)out, resolution,
      n_cascades, n_vert, plane0, density_act, rgb_act);
  return (int)cudaGetLastError();
}

// The checks' probe: one 64 x 64 x 64 bf16 product through mma.sync and
// through wgmma (shade_mma_probe_kernel).
extern "C" int shade_mma_probe(const void* a, const void* b, void* d_sync, void* d_wgmma,
                               void* stream) {
  shade_mma_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)a, (const uint16_t*)b, (float*)d_sync, (float*)d_wgmma);
  return (int)cudaGetLastError();
}

#ifdef GEN_PROFILE
extern "C" int shade_prof(void* host, int reset) {
  if (reset) {
    static const unsigned long long zero[16] = {};
    return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof zero);
  }
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(unsigned long long) * 16);
}
#endif

extern "C" const char* shade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
