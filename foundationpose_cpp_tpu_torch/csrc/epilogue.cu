// The epilogue of a convolution, one CUDA kernel for Hopper (sm_90a).
//
// Replaces no Pallas kernel: XLA fuses the bias and the ReLU into the JAX
// package's convolutions (foundationpose_cpp_tpu/models/networks.py). On the
// card PyTorch runs a cuDNN convolution without its bias, then adds the bias
// (add_ of a (1, C, 1, 1) view, a kernel that cannot vectorise over a
// channels-last output), and the nets' residual adds and ReLUs are kernels of
// their own, each reading and writing the whole output. Plain version:
// conv_epilogue_plain in ops/epilogue.py, that sequence of PyTorch calls.
//
// What it computes, per element of y, the NHWC memory of an (N, C, H, W)
// channels-last bf16 tensor, at channel c:
//   t = bf16(f32(y) + f32(bias[c]))      the bias, as y.add_(bias)
//   t = bf16(f32(residual) + f32(t))     with a residual, as residual + y
//   t = isnan(t) ? t : fmaxf(t, 0)       the ReLU, as torch.relu
// and writes t over y.
//
// Exactness: PyTorch computes each bf16 sum in f32 and rounds it with the
// round-to-nearest conversion (cvt.rn on sm_80 and up); its ReLU is a clamp
// that returns a NaN as it is and otherwise ::max, i.e. fmaxf, in f32. Each
// step here is the same intrinsic at the same point, so the output equals
// the plain version on the card bit for bit, NaN and -0.0 included.
//
// What bounds it on the H100: bytes. y is read and written once, the
// residual read once, the bias (at most 1 KB) stays in cache: 4 bytes an
// element, 6 with a residual. A Register's 18 launches (9 a net) move
// 8.05 GB: 2.40 ms at 3.35 TB/s. The ~10 operations an element are far under
// the CUDA cores' rate.
//
// What the design does about it: one thread a 16-byte vector of 8 channels
// of one pixel, neighbouring threads on neighbouring vectors (a warp moves
// 512 contiguous bytes a load), in a grid-stride loop over enough blocks to
// fill every SM; the bias vector is v mod (C / 8), read through the
// read-only path, its index stepped along with v so the loop divides only
// once. No shared memory, no scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREAD = 256;
constexpr int VEC = 8;  // bf16 values in 16 bytes

template <bool RESIDUAL>
__global__ void __launch_bounds__(NTHREAD)
    epilogue_kernel(__nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ residual, unsigned int nvec,
                    unsigned int cvec) {
  const unsigned int stride = gridDim.x * NTHREAD;
  const unsigned int cstep = stride % cvec;
  unsigned int v = blockIdx.x * NTHREAD + threadIdx.x;
  unsigned int c = v % cvec;
  for (; v < nvec; v += stride) {
    uint4 yv = reinterpret_cast<const uint4*>(y)[v];
    const uint4 bv = __ldg(reinterpret_cast<const uint4*>(bias) + c);
    uint4 rv;
    if (RESIDUAL) rv = reinterpret_cast<const uint4*>(residual)[v];
    __nv_bfloat16* ye = reinterpret_cast<__nv_bfloat16*>(&yv);
    const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(&bv);
    const __nv_bfloat16* re = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      __nv_bfloat16 t =
          __float2bfloat16_rn(__fadd_rn(__bfloat162float(ye[k]), __bfloat162float(be[k])));
      if (RESIDUAL) {
        t = __float2bfloat16_rn(__fadd_rn(__bfloat162float(re[k]), __bfloat162float(t)));
      }
      const float f = __bfloat162float(t);
      if (!isnan(f)) t = __float2bfloat16_rn(fmaxf(f, 0.0f));
      ye[k] = t;
    }
    reinterpret_cast<uint4*>(y)[v] = yv;
    c += cstep;
    if (c >= cvec) c -= cvec;
  }
}

}  // namespace

// y: nvec 16-byte vectors of bf16 values, the NHWC memory of a
// channels-last (N, C, H, W) tensor, written in place; bias (C,) and
// residual (y's layout, or null) in bf16; cvec = C / 8; every pointer
// 16-byte aligned; blocks > 0. Returns cudaGetLastError() after the launch
// (0 when it was taken).
extern "C" int fp_conv_epilogue(void* y, const void* bias, const void* residual,
                                unsigned int nvec, unsigned int cvec, unsigned int blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* yt = static_cast<__nv_bfloat16*>(y);
  const auto* bt = static_cast<const __nv_bfloat16*>(bias);
  const auto* rt = static_cast<const __nv_bfloat16*>(residual);
  if (residual != nullptr) {
    epilogue_kernel<true><<<blocks, NTHREAD, 0, s>>>(yt, bt, rt, nvec, cvec);
  } else {
    epilogue_kernel<false><<<blocks, NTHREAD, 0, s>>>(yt, bt, rt, nvec, cvec);
  }
  return (int)cudaGetLastError();
}
