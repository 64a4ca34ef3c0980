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
// group of products.  The next step is to split the roles: light warps
// that prepare X tiles at high occupancy, and MLP warpgroups that consume
// them from a shared-memory ring.
//
// Other colour MLPs (0-3 hidden layers, widths 64 and 128 in configs/nerf/)
// take shade_general_kernel below: the same walk, the MLP through shared
// memory, layer by layer.
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
    uint2* __restrict__ out, int R, int K, long long n_vert, int dact, int ract) {
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
  uint32_t i0 = (uint32_t)(v_first / plane % Rv), m0 = (uint32_t)(v_first / plane / Rv);

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
// -> 3 with 0 or more hidden layers of one width W, padded to a multiple of
// 16 (the JAX kernel's "ReLU MLP, any depth", shade_pallas.py:176-183).  The
// 32-64-64-3 fox network keeps the tuned kernel above; the wrapper sends
// every other shape here.
//
// The vertex walk, the ring of kept rows, the direction, SH16 and the
// owner's epilogue are the tuned kernel's, line for line.  The MLP differs:
// a layer's outputs are computed 32 at a time (two pairs of n8 tiles, the
// tuned kernel's 8 mma chains) over a runtime loop of k16 input tiles, and
// each layer's relu + bf16 output goes to a per-warp shared tile (row pitch
// W + 8 bf16, an odd count of 16-byte units: ldmatrix and the 32-bit
// stores are free of bank conflicts) that the next layer reads with
// ldmatrix.  Two tiles a warp alternate as input and output.  Every output
// is a chain of mma over its k16 tiles in ascending order, as in the tuned
// kernel, so on the fox's shapes this path gives the tuned kernel's bits.
// The weights (fragment order, ops/shade.py::pack_shade_weights) sit in
// dynamic shared memory: 43 KB for 32-128-128-3.  The launch picks the
// warps a block (8, 4, 2 or 1) that put the most warps on an SM.
// Bound: as the tuned kernel's bytes (1.31 GB on the fox's bake); the MLP
// is 2 * (32 W + (H - 1) W^2 + 3 W) flops a kept vertex (H hidden layers;
// 41,728 at 32-128-128-3, 1.11 TFLOP on the fox's kept vertices, 1.13 ms
// at the bf16 tensor peak), so operations bound the widest network.
// Where it stands (PERF.md has the numbers): a simple kernel, about 6x its
// bound at 32-128-128-3, where the activation tiles leave room for one
// block of 8 warps an SM; every layer's A fragments are reloaded from
// shared memory for each 32 outputs.
constexpr int GMAX_WARPS = 8;
constexpr int RING_BYTES = 64 * 32 + 64 * 8 + 64 * 8;  // raw rows, pos, vertex ids

__global__ void __launch_bounds__(32 * GMAX_WARPS, 1) shade_general_kernel(
    const int16_t* __restrict__ rows, const float* __restrict__ scale,
    const float* __restrict__ cam, const uint32_t* __restrict__ wpacked, int w_words,
    int n_hidden, int width, uint2* __restrict__ out, int R, int K, long long n_vert,
    int dact, int ract) {
  extern __shared__ __align__(16) uint32_t g_smem[];
  const int warps = blockDim.x >> 5;
  // words a row of an activation tile, which also holds the 32-wide X
  const int pitch = ((width > 32 ? width : 32) + 8) / 2;
  const int tile_words = TILE * pitch;
  uint32_t* s_w = g_smem;
  // per warp: the ring, then two activation tiles
  const int warp_words = RING_BYTES / 4 + 2 * tile_words;
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
  uint32_t* const tile0 = wbase + RING_BYTES / 4;  // tile c at tile0 + c * tile_words
  const uint32_t Rv = R + 1, plane = Rv * Rv;

  const int n_tiles = (int)((n_vert + TILE - 1) / TILE);
  const int n_warps = gridDim.x * warps;
  int tile = blockIdx.x * warps + warp;
  const long long v_first = (long long)tile * TILE;
  uint32_t r0 = (uint32_t)(v_first % plane);
  uint32_t i0 = (uint32_t)(v_first / plane % Rv), m0 = (uint32_t)(v_first / plane / Rv);
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

}  // namespace

extern "C" int shade_block_threads() { return BLOCK; }

// Blocks of shade_kernel that fit one SM (registers and shared memory).
extern "C" int shade_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, shade_kernel, BLOCK, 0) != cudaSuccess)
    return 0;
  return n;
}

// rows (K*(R+1)^3, 16) int16, scale (K, 16) f32, cam (3,) f32, wpacked the
// 13,312-byte fragment-order weights, out K*(R+1)^3 vertices x 4 bf16.
extern "C" int shade_volume_launch(const void* rows, const void* scale,
                                   const void* cam, const void* wpacked, void* out,
                                   int resolution, int n_cascades,
                                   int density_act, int rgb_act, int n_sms,
                                   void* stream) {
  if (n_cascades > MAX_CASCADES || resolution > 65534) return (int)cudaErrorInvalidValue;
  const long long Rv = resolution + 1;
  const long long n_vert = (long long)n_cascades * Rv * Rv * Rv;
  static const int resident = shade_blocks_per_sm();  // asked once
  const int per_sm = resident < 1 ? 1 : resident;
  if ((n_vert + TILE - 1) / TILE > 0x7FFFFFFFLL - 65536) return (int)cudaErrorInvalidValue;
  const long long want = (n_vert + BLOCK - 1) / BLOCK;
  const long long have = (long long)n_sms * per_sm;
  const int grid = (int)(want < have ? want : have);
  shade_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int16_t*)rows, (const float*)scale, (const float*)cam,
      (const uint32_t*)wpacked, (uint2*)out, resolution, n_cascades, n_vert,
      density_act, rgb_act);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a general-path block of `warps` warps.
static int general_smem_bytes(int w_words, int width, int warps) {
  const int pitch = ((width > 32 ? width : 32) + 8) / 2;
  return w_words * 4 + warps * (RING_BYTES + 2 * TILE * pitch * 4);
}

// The warps a block (8, 4, 2 or 1) that put the most warps on an SM, its
// dynamic shared memory and the blocks an SM; 0 warps if none fits.
extern "C" int shade_general_config(int w_words, int width, int* out_smem,
                                    int* out_blocks) {
  int best = 0, best_total = 0;
  for (int warps = GMAX_WARPS; warps >= 1; warps /= 2) {
    const int smem = general_smem_bytes(w_words, width, warps);
    if (cudaFuncSetAttribute(shade_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_general_kernel,
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

// The general path: wpacked holds w_words 32-bit words (pack_shade_weights
// for n_hidden hidden layers of padded width `width`, a multiple of 16).
extern "C" int shade_general_launch(const void* rows, const void* scale, const void* cam,
                                    const void* wpacked, int w_words, int n_hidden,
                                    int width, void* out, int resolution, int n_cascades,
                                    int density_act, int rgb_act, int n_sms, void* stream) {
  if (n_cascades > MAX_CASCADES || resolution > 65534 || width % 16 != 0 || width < 16 ||
      w_words % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int smem = 0, per_sm = 0;
  const int warps = shade_general_config(w_words, width, &smem, &per_sm);
  if (warps == 0) return (int)cudaErrorInvalidConfiguration;
  if (cudaFuncSetAttribute(shade_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return (int)cudaGetLastError();
  const long long Rv = resolution + 1;
  const long long n_vert = (long long)n_cascades * Rv * Rv * Rv;
  if ((n_vert + TILE - 1) / TILE > 0x7FFFFFFFLL - 65536) return (int)cudaErrorInvalidValue;
  const long long want = (n_vert + 32 * warps - 1) / (32 * warps);
  const long long have = (long long)n_sms * per_sm;
  const int grid = (int)(want < have ? want : have);
  shade_general_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int16_t*)rows, (const float*)scale, (const float*)cam,
      (const uint32_t*)wpacked, w_words, n_hidden, width, (uint2*)out, resolution,
      n_cascades, n_vert, density_act, rgb_act);
  return (int)cudaGetLastError();
}

extern "C" const char* shade_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
