// The grid-overhead probe: a block that does almost nothing but store its
// tile, one CUDA kernel for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel of tools/probe_grid_overhead.py (the
// kernel body at :45-54, launched by the `run()` that `make(lanes, n_tx,
// label)` builds, `pl.pallas_call` at :62). Plain version: probe_grid_plain
// in ops/probe_grid.py.
//
// What it computes, for every cell (view i, row t, column u) of a
// (n_views, n_rows, n_tx) grid: the lane coordinates fy = (2 (l / 32) + 1) /
// 160 and fx = (2 (l % 32) + 1) / 160 of lanes l = 0 .. lanes-1; an
// (8, lanes) int32 scratch whose row 0 is 0x7F000000 and row 1 is 0 (rows
// 2-7 are never read, as in the TPU kernel); and one (8, lanes) f32 tile,
// rows (fx, fy, fx fy, fx + fy, fx, fx, fx, fx) plus the f32 sum of
// scratch rows 0 and 1, stored to out[i, t, u]. The sum is lanes x
// 2130706432 (127 x 2^24): every partial sum is k x 127 x 2^24 with k x 127
// below 2^24, so it is exact in f32 in any order, and the kernel equals the
// plain version bit for bit.
//
// What bounds it on the H100: the stores, (n_views n_rows n_tx) x 8 x lanes
// x 4 bytes (206,438,400 B at 252 x 5 x 5 x 1024 and at 252 x 5 x 1 x 5120:
// 0.0616 ms at 3.35 TB/s); the few operations a lane are nothing beside
// them. What it measures on this card is the fixed cost of a block: the two
// shapes store the same bytes in 6300 blocks of 1024 lanes or in 1260 of
// 5120, so their difference over 5040 blocks is what one block costs
// beyond its stores. That is the input the K2/K4 region redesign needs (how
// small a region may get before the blocks' own cost shows).
//
// What the design does about it: one block a cell, dim3(n_tx, n_rows,
// n_views), 1024 threads; thread x takes lanes x, x + 1024, ..., so a warp
// stores 32 neighbouring floats of a row at once. The scratch lives in
// dynamic shared memory as the TPU kernel's VMEM scratch did: 32 KB at 1024
// lanes (two blocks an SM), 160 KB at 5120 (one block an SM, above the
// 48 KB default, so the launch raises the limit first). Rows 0-1 are summed
// with a warp shuffle, then across the 32 warps through shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREAD = 1024;

__global__ void __launch_bounds__(NTHREAD) probe_kernel(float* __restrict__ out, int lanes) {
  extern __shared__ int scratch[];  // (8, lanes)
  __shared__ float warp_sums[NTHREAD / 32];

  for (int l = threadIdx.x; l < lanes; l += NTHREAD) {
    scratch[l] = 0x7F000000;
    scratch[lanes + l] = 0;
  }
  __syncthreads();

  float part = 0.0f;
  for (int l = threadIdx.x; l < lanes; l += NTHREAD) {
    part += (float)scratch[l];
    part += (float)scratch[lanes + l];
  }
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < NTHREAD / 32; ++w) total += warp_sums[w];

  const long long cell =
      ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* tile = out + cell * 8LL * lanes;
  for (int l = threadIdx.x; l < lanes; l += NTHREAD) {
    const float fy = (2.0f * (float)(l / 32) + 1.0f) / 160.0f;
    const float fx = (2.0f * (float)(l % 32) + 1.0f) / 160.0f;
    tile[0LL * lanes + l] = fx + total;
    tile[1LL * lanes + l] = fy + total;
    tile[2LL * lanes + l] = __fmul_rn(fx, fy) + total;  // no fma: round the product first
    tile[3LL * lanes + l] = (fx + fy) + total;
    tile[4LL * lanes + l] = fx + total;
    tile[5LL * lanes + l] = fx + total;
    tile[6LL * lanes + l] = fx + total;
    tile[7LL * lanes + l] = fx + total;
  }
}

}  // namespace

// out: (n_views, n_rows, n_tx, 8, lanes) f32. Returns cudaGetLastError()
// after the launch (0 when it was taken).
extern "C" int fp_probe_grid(void* out, int n_views, int n_rows, int n_tx, int lanes,
                             void* stream) {
  static int shared_limit = 0;  // the largest limit set so far
  const int shared = 8 * lanes * (int)sizeof(int);
  if (shared > shared_limit) {
    cudaError_t err = cudaFuncSetAttribute(probe_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    shared_limit = shared;
  }
  probe_kernel<<<dim3(n_tx, n_rows, n_views), NTHREAD, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), lanes);
  return (int)cudaGetLastError();
}
