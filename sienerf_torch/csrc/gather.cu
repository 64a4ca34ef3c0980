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
// probe) of a table the TPU holds whole in VMEM (0.5-8 MB).  No SM's
// shared memory (227 KB) holds that; on this card the on-chip home of such
// a table is the L2.  The output is walked as a flat array of 16-byte
// units: unit e belongs to row e / units, so the `units` lanes of a row sit
// side by side, reads of one row coalesce into one or two sectors through
// the read-only path (__ldg), and the writes of a warp are one contiguous
// 512 bytes.  Each thread takes G2_UNITS units per step, loads first.
// Bound: bytes, as for G1: the distinct rows gathered (here nearly the
// whole small table) read once, N rows written, N*4 of index.  Repeated
// rows are served by L2, so N rows in + N rows out, which the probe
// prints beside the bound, is traffic through L2 and no lower bound.
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

constexpr int G1_ROWS = 4;   // rows in flight per warp
constexpr int G2_UNITS = 4;  // 16-byte units in flight per thread

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

__global__ void __launch_bounds__(256)
gather_small_kernel(const int4* __restrict__ table, const int* __restrict__ idx,
                    int4* __restrict__ out, long long n_units, int units,
                    long long t_rows) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_threads = (long long)gridDim.x * blockDim.x;
  // unit u of a step sits n_threads after unit u-1, so a warp's 32 lanes
  // always cover 32 consecutive units
  for (long long e0 = tid; e0 < n_units; e0 += n_threads * G2_UNITS) {
    int4 v[G2_UNITS];
#pragma unroll
    for (int u = 0; u < G2_UNITS; ++u) {
      const long long e = e0 + u * n_threads;
      if (e < n_units) {
        const long long row = e / units;
        const int k = (int)(e - row * units);
        const long long src = (long long)idx[row];
        assert(src >= 0 && src < t_rows);
        v[u] = __ldg(table + (size_t)src * units + k);
      }
    }
#pragma unroll
    for (int u = 0; u < G2_UNITS; ++u) {
      const long long e = e0 + u * n_threads;
      if (e < n_units) out[e] = v[u];
    }
  }
}

int blocks_for(long long work_items, int max_blocks) {
  long long b = (work_items + 255) / 256;
  if (b < 1) b = 1;
  return (int)(b < max_blocks ? b : max_blocks);
}

}  // namespace

// table (t_rows, 128) int32, idx (n_idx,) int32 in [0, t_rows / g),
// out (n_idx, g, 128) int32
extern "C" int gather_rows512_launch(const void* table, const void* idx, void* out,
                                     long long n_idx, int g, long long t_rows,
                                     int max_blocks, void* stream) {
  const long long n_rows = n_idx * g;
  if (n_rows == 0) return 0;
  // one warp per G1_ROWS rows: 32 threads each
  const int grid = blocks_for((n_rows + G1_ROWS - 1) / G1_ROWS * 32, max_blocks);
  gather_rows512_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)table, (const int*)idx, (int4*)out, n_rows, g, t_rows / g);
  return (int)cudaGetLastError();
}

// table (t_rows, units * 16 bytes), idx (n_idx,) int32 in [0, t_rows),
// out (n_idx, units * 16 bytes)
extern "C" int gather_small_launch(const void* table, const void* idx, void* out,
                                   long long n_idx, int units, long long t_rows,
                                   int max_blocks, void* stream) {
  const long long n_units = n_idx * units;
  if (n_units == 0) return 0;
  const int grid = blocks_for((n_units + G2_UNITS - 1) / G2_UNITS, max_blocks);
  gather_small_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)table, (const int*)idx, (int4*)out, n_units, units, t_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
