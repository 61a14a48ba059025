// Multi-head attention for Hopper (sm_90a): one kernel body per dtype, two
// layouts (the packed qkv projection and head-split q, k, v).
//
// Replaces: the Pallas TPU kernels `_kernel_packed` (launched by
// `mha_packed_qkv`) and `_kernel` (launched by `mha_whole_head`) in
// foundationpose_cpp_tpu/ops/attention_pallas.py.
// Plain versions: mha_packed_qkv_plain and mha_whole_head_plain in
// ops/attention.py.
//
// What it computes, per (batch b, head h): softmax((q * scale) k^T) v. Where
// head h's rows live is given by element strides (batch, head, token) shared
// by q, k and v, and by the output's own strides:
//   packed (B, T, 3D): q, k, v at column offsets 0, D, 2D of the projection,
//     strides (T*3D, hd, 3D); output (B, T, D), strides (T*D, hd, D);
//   head-split (B, H, T, hd): strides (H*T*hd, T*hd, hd) for all four.
// Numerics follow the Pallas kernels: q is scaled in f32 and cast to k's
// dtype; logits accumulate in f32; the softmax is exact over the whole row
// (max-subtract, expf, multiply by 1/sum); P is cast to v's dtype; P.v
// accumulates in f32 and the output is in q's dtype. So in bf16 q and P are
// rounded to bf16, and in f32 nothing is rounded between the steps.
//
// What bounds it on the H100: at the main path's packed shape (B=252, T=400,
// D=512, 4 heads of 128) the function reads 310 MB and writes 103 MB, about
// 0.12 ms at 3.35 TB/s, and does 82.6 GFLOP, about 0.08 ms at 989 TFLOP/s of
// bf16 tensor-core rate: memory-bound. The head-split narrow net of the
// dataset path (B=252, 4 heads of 16, T=16) is a few MB: a launch's cost.
//
// What the design does about it: the (T, T) logits never leave shared
// memory, so device memory sees only q, k, v and the output. One block of 8
// warps takes 32 query rows of one (b, h) and keeps their f32 logits for all
// T <= 1024 keys in shared memory; it streams the head's keys in chunks of
// 64 through shared memory to compute the logits, runs the softmax in
// shared memory, then streams the values the same way and accumulates P.v.
// bf16 uses tensor-core MMAs (wmma 16x16x16) with f32 accumulators; f32 runs
// on the CUDA cores (no tensor cores, so no TF32 rounding). Keys are
// streamed once per query block, so k and v are re-read ceil(T/32) times,
// mostly from L2. Tensor-core pipelines (wgmma, TMA) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int QB = 32;        // query rows per block
constexpr int KC = 64;        // keys per staged chunk
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
// Shared-memory rows are padded so that the 8 rows an MMA fragment load
// reads at once fall in distinct banks: a bf16 row of HD or t_pad elements
// is a multiple of 32 bytes, which would put rows in the same banks.
constexpr int PAD_BF16 = 8;
constexpr int PAD_F32 = 4;

// Where one (b, h) lives: element strides (batch, head, token) shared by q,
// k and v, and the output's own.
struct Layout {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sb, sh, st;
  long long ob, oh, ot;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy token rows [r0, r0 + n_rows) of one head (HD elements of type E from
// src + token * st) into dst[n_rows][HD + pad], with zeros for rows at or
// past T. 16-byte vector copies: HD, st and pad are multiples of 16 bytes'
// worth of E and src is 16-byte aligned (the wrapper checks).
template <typename E, int HD, int PAD>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int r0, int n_rows, int T,
                                           long long st) {
  constexpr int VEC = 16 / sizeof(E);
  constexpr int PER_ROW = HD / VEC;
  for (int i = threadIdx.x; i < n_rows * PER_ROW; i += NTHREAD) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + PAD) + c) = v;
  }
}

// Exact softmax over the T real keys of each of the block's rows of S (f32,
// row stride lds); padded keys get probability 0. Writes P through put(r, j, p).
template <typename Put>
__device__ __forceinline__ void softmax_rows(float* S, int lds, int T, int t_pad, Put put) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < QB; r += NWARP) {
    float* row = S + r * lds;
    float m = -INFINITY;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.0f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    const float inv = 1.0f / s;
    __syncwarp();
    for (int j = lane; j < t_pad; j += 32) put(r, j, j < T ? row[j] * inv : 0.0f);
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREAD)
mha_bf16_kernel(Layout L, int T, float scale, int t_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = HD + PAD_BF16;  // row stride of Qs and KV
  const int lds = t_pad + PAD_F32;     // row stride of S
  const int ldp = t_pad + PAD_BF16;    // row stride of P
  float* S = reinterpret_cast<float*>(smem);                                 // [QB][lds]
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(S + QB * lds);         // [QB][ldp]
  __nv_bfloat16* Qs = P + QB * ldp;                                          // [QB][LDH]
  __nv_bfloat16* KV = Qs + QB * LDH;                                         // [KC][LDH]

  const int q0 = blockIdx.x * QB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * L.sb + (long long)h * L.sh;
  const auto* q = static_cast<const __nv_bfloat16*>(L.q) + in_off;
  const auto* k = static_cast<const __nv_bfloat16*>(L.k) + in_off;
  const auto* v = static_cast<const __nv_bfloat16*>(L.v) + in_off;
  auto* o = static_cast<__nv_bfloat16*>(L.o) + (long long)b * L.ob + (long long)h * L.oh;
  const int warp = threadIdx.x / 32;

  // q tile: scaled in f32 and rounded back to bf16, as the Pallas kernels do
  for (int i = threadIdx.x; i < QB * HD; i += NTHREAD) {
    const int r = i / HD;
    const int c = i % HD;
    float x = 0.0f;
    if (q0 + r < T) x = __bfloat162float(q[(size_t)(q0 + r) * L.st + c]) * scale;
    Qs[r * LDH + c] = __float2bfloat16(x);
  }

  // phase 1: S = Qs . K^T for all keys, one 16x16 tile of each 32x64 chunk
  // per warp
  const int n_chunks = t_pad / KC;
  for (int kc = 0; kc < n_chunks; ++kc) {
    __syncthreads();  // Qs ready / previous chunk consumed
    stage_rows<__nv_bfloat16, HD, PAD_BF16>(KV, k, kc * KC, KC, T, L.st);
    __syncthreads();
    const int tm = warp / 4;  // 2 row tiles
    const int tn = warp % 4;  // 4 key tiles
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, Qs + tm * 16 * LDH + kk, LDH);
      // K^T as a col-major (HD x KC) matrix is K row-major: element (k, n)
      // at KV[n * LDH + k]
      wmma::load_matrix_sync(fb, KV + tn * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(S + tm * 16 * lds + kc * KC + tn * 16, acc, lds,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // phase 2: P = softmax(S) rounded to bf16
  softmax_rows(S, lds, T, t_pad,
               [&](int r, int j, float p) { P[r * ldp + j] = __float2bfloat16(p); });

  // phase 3: O = P . V, f32 accumulators held in fragments across chunks
  constexpr int NT_N = HD / 16;
  constexpr int NT = (QB / 16) * NT_N;
  constexpr int PER = (NT + NWARP - 1) / NWARP;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) wmma::fill_fragment(acc_o[i], 0.0f);
  for (int kc = 0; kc < n_chunks; ++kc) {
    __syncthreads();  // P written / previous chunk consumed
    stage_rows<__nv_bfloat16, HD, PAD_BF16>(KV, v, kc * KC, KC, T, L.st);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = warp + i * NWARP;
      if (t < NT) {
        const int tm = t / NT_N;
        const int tn = t % NT_N;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, P + tm * 16 * ldp + kc * KC + kk, ldp);
          wmma::load_matrix_sync(fb, KV + kk * LDH + tn * 16, LDH);
          wmma::mma_sync(acc_o[i], fa, fb, acc_o[i]);
        }
      }
    }
  }
  __syncthreads();

  // epilogue: stage the f32 tile at the start of shared memory (every phase
  // is done; QB x (HD + PAD_F32) floats fit in the allocation, whose k/v
  // chunk alone is KC x (HD + PAD_BF16) bf16), round to bf16, write the
  // head's rows
  constexpr int LDO = HD + PAD_F32;
  float* Os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int t = warp + i * NWARP;
    if (t < NT) {
      const int tm = t / NT_N;
      const int tn = t % NT_N;
      wmma::store_matrix_sync(Os + tm * 16 * LDO + tn * 16, acc_o[i], LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QB * HD; i += NTHREAD) {
    const int r = i / HD;
    const int c = i % HD;
    if (q0 + r < T) o[(size_t)(q0 + r) * L.ot + c] = __float2bfloat16(Os[r * LDO + c]);
  }
}

// The same computation in f32 on the CUDA cores: products and sums in f32,
// P kept in f32 (in place of S).
template <int HD>
__global__ void __launch_bounds__(NTHREAD)
mha_f32_kernel(Layout L, int T, float scale, int t_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = HD + PAD_F32;  // row stride of Qs and KV
  const int lds = t_pad + PAD_F32;    // row stride of S (and P)
  float* S = reinterpret_cast<float*>(smem);  // [QB][lds]
  float* Qs = S + QB * lds;                   // [QB][LDH]
  float* KV = Qs + QB * LDH;                  // [KC][LDH]

  const int q0 = blockIdx.x * QB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long in_off = (long long)b * L.sb + (long long)h * L.sh;
  const float* q = static_cast<const float*>(L.q) + in_off;
  const float* k = static_cast<const float*>(L.k) + in_off;
  const float* v = static_cast<const float*>(L.v) + in_off;
  float* o = static_cast<float*>(L.o) + (long long)b * L.ob + (long long)h * L.oh;

  for (int i = threadIdx.x; i < QB * HD; i += NTHREAD) {
    const int r = i / HD;
    const int c = i % HD;
    Qs[r * LDH + c] = q0 + r < T ? q[(size_t)(q0 + r) * L.st + c] * scale : 0.0f;
  }

  // phase 1: thread (r, sub) computes the logits of row r against keys
  // sub, sub + 8, ..., sub + 56 of each chunk
  const int r1 = threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  const int n_chunks = t_pad / KC;
  for (int kc = 0; kc < n_chunks; ++kc) {
    __syncthreads();  // Qs ready / previous chunk consumed
    stage_rows<float, HD, PAD_F32>(KV, k, kc * KC, KC, T, L.st);
    __syncthreads();
    const float4* qrow = reinterpret_cast<const float4*>(Qs + r1 * LDH);
#pragma unroll 2
    for (int m = 0; m < KC / 8; ++m) {
      const int j = sub + 8 * m;
      const float4* krow = reinterpret_cast<const float4*>(KV + j * LDH);
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < HD / 4; ++d) {
        const float4 a = qrow[d];
        const float4 c = krow[d];
        acc += a.x * c.x;
        acc += a.y * c.y;
        acc += a.z * c.z;
        acc += a.w * c.w;
      }
      S[r1 * lds + kc * KC + j] = acc;
    }
  }
  __syncthreads();

  // phase 2: P = softmax(S), kept in f32 in place
  softmax_rows(S, lds, T, t_pad, [&](int r, int j, float p) { S[r * lds + j] = p; });

  // phase 3: O = P . V; thread i owns outputs i, i + 256, ... of the
  // block's QB x HD tile
  constexpr int PER = (QB * HD + NTHREAD - 1) / NTHREAD;
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
  for (int kc = 0; kc < n_chunks; ++kc) {
    __syncthreads();  // P written / previous chunk consumed
    stage_rows<float, HD, PAD_F32>(KV, v, kc * KC, KC, T, L.st);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * NTHREAD;
      if (idx < QB * HD) {
        const int r = idx / HD;
        const int c = idx % HD;
        const float* prow = S + r * lds + kc * KC;
        float a = acc[i];
        for (int j = 0; j < KC; ++j) a += prow[j] * KV[j * LDH + c];
        acc[i] = a;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = threadIdx.x + i * NTHREAD;
    if (idx < QB * HD) {
      const int r = idx / HD;
      const int c = idx % HD;
      if (q0 + r < T) o[(size_t)(q0 + r) * L.ot + c] = acc[i];
    }
  }
}

template <int HD>
cudaError_t launch_hd(const Layout& L, int B, int H, int T, float scale, bool f32,
                      cudaStream_t stream) {
  const int t_pad = (T + KC - 1) / KC * KC;
  dim3 grid((T + QB - 1) / QB, H, B);
  size_t smem;
  const void* fn;
  if (f32) {
    smem = ((size_t)QB * (t_pad + PAD_F32) + (size_t)(QB + KC) * (HD + PAD_F32)) * sizeof(float);
    fn = reinterpret_cast<const void*>(mha_f32_kernel<HD>);
  } else {
    smem = (size_t)QB * (t_pad + PAD_F32) * sizeof(float) +
           (size_t)QB * (t_pad + PAD_BF16) * sizeof(__nv_bfloat16) +
           (size_t)(QB + KC) * (HD + PAD_BF16) * sizeof(__nv_bfloat16);
    fn = reinterpret_cast<const void*>(mha_bf16_kernel<HD>);
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (f32) {
    mha_f32_kernel<HD><<<grid, NTHREAD, smem, stream>>>(L, T, scale, t_pad);
  } else {
    mha_bf16_kernel<HD><<<grid, NTHREAD, smem, stream>>>(L, T, scale, t_pad);
  }
  return cudaGetLastError();
}

cudaError_t launch(const Layout& L, int B, int H, int T, int hd, float scale, bool f32,
                   cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<16>(L, B, H, T, scale, f32, stream);
    case 32: return launch_hd<32>(L, B, H, T, scale, f32, stream);
    case 48: return launch_hd<48>(L, B, H, T, scale, f32, stream);
    case 64: return launch_hd<64>(L, B, H, T, scale, f32, stream);
    case 80: return launch_hd<80>(L, B, H, T, scale, f32, stream);
    case 96: return launch_hd<96>(L, B, H, T, scale, f32, stream);
    case 112: return launch_hd<112>(L, B, H, T, scale, f32, stream);
    case 128: return launch_hd<128>(L, B, H, T, scale, f32, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (B, T, 3H*hd) packed projection -> (B, T, H*hd); f32 != 0 for float32
// tensors, else bf16.
extern "C" int fp_mha_packed_qkv(const void* qkv, void* out, int B, int T, int H, int hd,
                                 float scale, int f32, void* stream) {
  const long long D = (long long)H * hd;
  const size_t esize = f32 ? sizeof(float) : sizeof(__nv_bfloat16);
  const char* base = static_cast<const char*>(qkv);
  Layout L{base, base + D * esize, base + 2 * D * esize, out,
           T * 3 * D, hd, 3 * D, T * D, hd, D};
  return (int)launch(L, B, H, T, hd, scale, f32 != 0, static_cast<cudaStream_t>(stream));
}

// Head-split (B, H, T, hd) q, k, v -> (B, H, T, hd).
extern "C" int fp_mha_whole_head(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int T, int hd, float scale, int f32, void* stream) {
  const long long sh = (long long)T * hd;
  Layout L{q, k, v, out, H * sh, sh, hd, H * sh, sh, hd};
  return (int)launch(L, B, H, T, hd, scale, f32 != 0, static_cast<cudaStream_t>(stream));
}
