// G1 and G2: random row gathers, for Hopper (sm_90a).
//
// G1 replaces the JAX package's TPU kernel
// tools/bench_pallas_gather.py::gather_rows_pallas (its `kernel`), G2 the
// kernel of tools/bench_gather.py::bench_pallas.  Plain PyTorch versions:
// sienerf_torch/ops/gather.py::gather_rows_plain and gather_small_plain.
// Both kernels copy bits, so they are held to the plain versions with
// tolerance zero.
//
// G1: out[i, j, :] = table[idx[i]*g + j, :] for 512-byte rows (128 int32)
// of a table far larger than the 50 MB L2 (0.8 GB in the probe).  The
// Pallas kernel exists to keep W row DMAs in flight from one serial issue
// loop, with the indices staged in SMEM per block; its `block` and
// `window` are the depths of that pipeline, not part of the function.  A
// Hopper SM has thousands of threads to issue loads, so here one warp
// copies one row, each lane one 16-byte ld.global / st.global, and a warp
// takes G1_ROWS rows per step of its grid-stride loop with all their loads
// issued before the first store, which keeps G1_ROWS x 512 bytes in flight
// per warp.  Bound: bytes.  Every distinct gathered row is read once from
// HBM (a repeated random row of a 0.8 GB table rarely still sits in L2)
// and every output row written once, plus 4 bytes of index, at 3.35 TB/s.
// There is no arithmetic.
//
// G2: out[i, :] = table[idx[i], :] for narrow rows (64 or 128 bytes in the
// probe: 32 bf16 or f32) of a table the TPU holds whole in VMEM (0.5-8 MB).
// No SM's shared memory (227 KB) holds that; on this card the on-chip home
// of such a table is the 50 MB L2.  Bound: bytes, as for G1: the distinct
// rows gathered (nearly the whole small table) read once, N rows written,
// N*4 bytes of index read.  The output dominates (67-134 MB in the probe
// against a 0.5-8 MB table), so G2 is a write stream fed by L2 hits, and
// its design serves that stream:
// - a warp owns tiles of 32 consecutive output rows.  Lane l loads
//   idx[base + l] once, one coalesced 128-byte load that does not
//   allocate in L1, and the row indices reach the other lanes by
//   __shfl_sync.  The kernel is templated on UNITS = row bytes / 16 for
//   1, 2, 4, 8, 16 and 32, so rows and units are 32-bit shifts and masks
//   with no division; one warp instruction covers 32 / UNITS rows and
//   every store instruction writes 512 contiguous bytes.  Other widths
//   (not a power of two, or over 512 bytes) take one generic kernel of
//   the same structure that steps (row, unit) by carries.
// - a lane issues all its table loads for a tile (for 8 / UNITS tiles
//   when UNITS < 8; in batches of 16 at UNITS = 32) before its first
//   store: at least 8 16-byte loads in flight per lane, so the chain
//   index -> table -> store is paid once per batch, not once per unit.
// - the table is read with an L2 evict-last policy
//   (createpolicy.fractional.L2::evict_last, ld.global.nc.L2::cache_hint)
//   and the output written as streaming stores (st.global.cs), so that
//   the 67-134 MB of output passing through the L2 evicts its own lines
//   first and not the table's: a table row pushed out would be read from
//   HBM again on its next hit.  No device-wide L2 setting is changed.
// - a persistent grid, the SMs times the blocks one SM holds, strides
//   over the tiles.
// On an H100 80GB HBM3 at 700 W this reaches 71-80 % of the bound at the
// probe's four shapes, 76-80 % of the rate at which the card writes the
// same output with torch.zeros (2.90-3.11 TB/s, itself above the bound's
// time).  The evict-last policy gains 1-3 % there (and loses 2 % on 17-34
// MB tables); staging a step's rows in shared memory for one
// cp.async.bulk store per step measured 1-7 % slower than the direct
// stores, and 16 loads in flight a lane (fewer resident warps) 5-36 %
// slower (PERF.md, PR 4).
//
// Indices must lie in [0, rows); a bad index trips a device-side assert,
// as PyTorch's own CUDA gathers do.  Byte offsets are size_t: a table may
// exceed 2^31 bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3
// (sienerf_torch/ops/cuda_lib.py).

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G1_ROWS = 4;            // rows in flight per warp
constexpr int G1_BLOCKS_PER_SM = 32;  // G1's grid: it strides, so this fills the card
constexpr int G2_THREADS = 256;
constexpr int G2_WARPS = G2_THREADS / 32;
constexpr int G2_LOADS = 8;       // 16-byte table loads a lane keeps in flight, at least
constexpr int G2_MAX_LOADS = 16;  // and at most (registers)
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(256)
gather_rows512_kernel(const int4* __restrict__ table, const int* __restrict__ idx,
                      int4* __restrict__ out, long long n_rows, int g,
                      long long n_groups) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r0 = warp * G1_ROWS; r0 < n_rows; r0 += n_warps * G1_ROWS) {
    int4 v[G1_ROWS];
#pragma unroll
    for (int u = 0; u < G1_ROWS; ++u) {
      const long long r = r0 + u;
      if (r < n_rows) {
        const long long i = r / g;
        const int j = (int)(r - i * g);
        const long long src = (long long)idx[i];
        assert(src >= 0 && src < n_groups);
        v[u] = __ldg(table + ((size_t)src * g + j) * 32 + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < G1_ROWS; ++u) {
      const long long r = r0 + u;
      if (r < n_rows) out[(size_t)r * 32 + lane] = v[u];
    }
  }
}

// ---- G2 ---------------------------------------------------------------

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// a table unit: read-only path, kept in L2 ahead of other lines
__device__ __forceinline__ int4 load_table(const int4* p, uint64_t policy) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// an index: read once, not kept in L1
__device__ __forceinline__ int load_index(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__host__ __device__ constexpr int g2_tiles(int units) {
  return units < G2_LOADS ? G2_LOADS / units : 1;
}

template <int UNITS>
__global__ void __launch_bounds__(G2_THREADS)
gather_small_kernel(const int4* __restrict__ table, const int* __restrict__ idx,
                    int4* __restrict__ out, long long n_idx, unsigned t_rows) {
  static_assert(UNITS >= 1 && UNITS <= 32 && (UNITS & (UNITS - 1)) == 0,
                "UNITS: a power of two up to 32");
  constexpr int TILES = g2_tiles(UNITS);  // tiles of 32 rows a step
  constexpr int STEP = 32 * TILES;        // rows a step
  constexpr int PER_LANE = UNITS * TILES;  // units a lane copies a step
  constexpr int BATCH = PER_LANE < G2_MAX_LOADS ? PER_LANE : G2_MAX_LOADS;
  constexpr int SHIFT = UNITS == 1 ? 0 : UNITS == 2 ? 1 : UNITS == 4 ? 2
                      : UNITS == 8 ? 3 : UNITS == 16 ? 4 : 5;
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * G2_WARPS;
  const long long n_steps = (n_idx + STEP - 1) / STEP;
  const uint64_t keep = l2_evict_last();
  for (long long s = (long long)blockIdx.x * G2_WARPS + (threadIdx.x >> 5); s < n_steps;
       s += n_warps) {
    const long long base = s * STEP;
    const int valid = (int)(n_idx - base < STEP ? n_idx - base : STEP);
    int src[TILES];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      src[t] = 0;
      if (t * 32 + lane < valid) {
        src[t] = load_index(idx + base + t * 32 + lane);
        assert((unsigned)src[t] < t_rows);
      }
    }
    int4* o = out + (size_t)base * UNITS;
#pragma unroll
    for (int b = 0; b < PER_LANE; b += BATCH) {
      int4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        // unit e of the step is unit e % UNITS of the step's row e / UNITS;
        // that row sits in tile (b + u) / UNITS, whose index lane r % 32 holds
        const int e = (b + u) * 32 + lane;
        const int r = e >> SHIFT;
        const int row = __shfl_sync(FULL, src[(b + u) / UNITS], r & 31);
        if (r < valid) v[u] = load_table(table + (size_t)row * UNITS + (e & (UNITS - 1)), keep);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = (b + u) * 32 + lane;
        if ((e >> SHIFT) < valid) __stcs(o + e, v[u]);
      }
    }
  }
}

// Any row of `units` 16-byte units: one tile of 32 rows a step, the lane's
// units e = j*32 + lane of the tile walked as (row, unit) pairs, each step
// of 32 units a carry: 32 = q*units + rem.
__global__ void __launch_bounds__(G2_THREADS)
gather_small_generic_kernel(const int4* __restrict__ table, const int* __restrict__ idx,
                            int4* __restrict__ out, long long n_idx, int units,
                            unsigned t_rows) {
  const int lane = threadIdx.x & 31;
  const int q = 32 / units, rem = 32 - q * units;
  const int r0 = lane / units, k0 = lane - r0 * units;
  const long long n_warps = (long long)gridDim.x * G2_WARPS;
  const long long n_steps = (n_idx + 31) / 32;
  const uint64_t keep = l2_evict_last();
  for (long long s = (long long)blockIdx.x * G2_WARPS + (threadIdx.x >> 5); s < n_steps;
       s += n_warps) {
    const long long base = s * 32;
    const int valid = (int)(n_idx - base < 32 ? n_idx - base : 32);
    int src = 0;
    if (lane < valid) {
      src = load_index(idx + base + lane);
      assert((unsigned)src < t_rows);
    }
    int4* o = out + (size_t)base * units;
    int r = r0, k = k0;  // (row, unit) of the lane's unit j*32 + lane
    for (int j0 = 0; j0 < units; j0 += G2_LOADS) {
      int4 v[G2_LOADS];
      int lr = r, lk = k;
#pragma unroll
      for (int u = 0; u < G2_LOADS; ++u) {
        const int row = __shfl_sync(FULL, src, lr & 31);
        if (j0 + u < units && lr < valid) v[u] = load_table(table + (size_t)row * units + lk, keep);
        lr += q;
        lk += rem;
        if (lk >= units) {
          lk -= units;
          ++lr;
        }
      }
#pragma unroll
      for (int u = 0; u < G2_LOADS; ++u) {
        if (j0 + u < units && r < valid) __stcs(o + (j0 + u) * 32 + lane, v[u]);
        r += q;
        k += rem;
        if (k >= units) {
          k -= units;
          ++r;
        }
      }
    }
  }
}

int blocks_for(long long work_items, int max_blocks) {
  long long b = (work_items + 255) / 256;
  if (b < 1) b = 1;
  return (int)(b < max_blocks ? b : max_blocks);
}

// blocks of G2_THREADS that one SM holds, asked once per kernel
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* cached) {
  if (*cached > 0) return cudaSuccess;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, G2_THREADS, 0);
  if (err != cudaSuccess) return err;
  *cached = n > 0 ? n : 1;
  return cudaSuccess;
}

template <int UNITS>
int launch_small(const int4* table, const int* idx, int4* out, long long n_idx,
                 unsigned t_rows, int sms, cudaStream_t stream) {
  static int per_sm = 0;
  const cudaError_t err = resident_blocks(gather_small_kernel<UNITS>, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long steps = (n_idx + 32 * g2_tiles(UNITS) - 1) / (32 * g2_tiles(UNITS));
  const long long want = (steps + G2_WARPS - 1) / G2_WARPS;
  const long long most = (long long)sms * per_sm;
  gather_small_kernel<UNITS><<<(int)(want < most ? want : most), G2_THREADS, 0, stream>>>(
      table, idx, out, n_idx, t_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// table (t_rows, 128) int32, idx (n_idx,) int32 in [0, t_rows / g),
// out (n_idx, g, 128) int32; sms: the device's SM count
extern "C" int gather_rows512_launch(const void* table, const void* idx, void* out,
                                     long long n_idx, int g, long long t_rows,
                                     int sms, void* stream) {
  const long long n_rows = n_idx * g;
  if (n_rows == 0) return 0;
  // one warp per G1_ROWS rows: 32 threads each
  const int grid = blocks_for((n_rows + G1_ROWS - 1) / G1_ROWS * 32, sms * G1_BLOCKS_PER_SM);
  gather_rows512_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)table, (const int*)idx, (int4*)out, n_rows, g, t_rows / g);
  return (int)cudaGetLastError();
}

// table (t_rows, units * 16 bytes), idx (n_idx,) int32 in [0, t_rows),
// out (n_idx, units * 16 bytes); sms: the device's SM count
extern "C" int gather_small_launch(const void* table, const void* idx, void* out,
                                   long long n_idx, int units, long long t_rows,
                                   int sms, void* stream) {
  if (n_idx == 0) return 0;
  const int4* tab = (const int4*)table;
  const int* ix = (const int*)idx;
  int4* o = (int4*)out;
  // an int32 index never reaches row 2^31
  const unsigned rows = (unsigned)(t_rows < 0x80000000LL ? t_rows : 0x80000000LL);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (units) {
    case 1: return launch_small<1>(tab, ix, o, n_idx, rows, sms, st);
    case 2: return launch_small<2>(tab, ix, o, n_idx, rows, sms, st);
    case 4: return launch_small<4>(tab, ix, o, n_idx, rows, sms, st);
    case 8: return launch_small<8>(tab, ix, o, n_idx, rows, sms, st);
    case 16: return launch_small<16>(tab, ix, o, n_idx, rows, sms, st);
    case 32: return launch_small<32>(tab, ix, o, n_idx, rows, sms, st);
    default: break;
  }
  static int per_sm = 0;
  const cudaError_t err = resident_blocks(gather_small_generic_kernel, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long want = ((n_idx + 31) / 32 + G2_WARPS - 1) / G2_WARPS;
  const long long most = (long long)sms * per_sm;
  gather_small_generic_kernel<<<(int)(want < most ? want : most), G2_THREADS, 0, st>>>(
      tab, ix, o, n_idx, units, rows);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
