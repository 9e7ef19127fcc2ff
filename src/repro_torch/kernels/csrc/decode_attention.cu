// K2: single-token decode attention over a KV cache for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel) and the T padding of its wrapper
// repro/kernels/ops.py::decode_attention.
//
// What it computes: for each sequence b and query head h, one new token's
// query q[b, h] (B, H, D) attends the cache k/v[b, 0..pos, h / G] with
// caches (B, T, KH, D), G = H / KH. pos is one scalar shared by the batch.
// Where the TPU kernel takes pos by scalar prefetch, it arrives here as a
// kernel argument: the decode loop runs on the host and keeps pos a host
// integer, so no device scalar is read back per token. NEG_INF = -1e30
// masks and a zero running sum writes 0, as in _decode_kernel.
//
// Design (simple first): one block per (kv head, batch) with one warp per
// query head of the group, so all G query heads read each K/V tile from
// shared memory and the cache is read from device memory once. The block
// loops over tiles of 4096/D keys only up to pos. Each lane scores 32/D-th
// of the tile's keys against its warp's query (K rows padded by one float
// so the 32 lanes hit 32 banks), the warp reduces max and sum with
// shuffles, and each lane accumulates D/32 output dims in f32 registers.
//
// What bounds it on an H100: the cache bytes. At the serving path's decode
// shape (qwen2-0.5b, B=16, KH=2, D=64, bf16) one call reads
// 2 * B * KH * (pos+1) * D * 2 bytes of cache = 1.57 MB at pos = 191
// (3.35 TB/s: 0.47 us) against 4 * B * H * D * (pos+1) = 11 MFLOP.
//
// What this simple design leaves on the table: at B = 16, KH = 2 it
// launches 32 blocks on 132 SMs, so most of the card idles and one SM's
// bandwidth bounds each block. Split-KV (several blocks per (b, kv head)
// over slices of T, combined by a second pass) is the fix, in a later
// change. Loads are also one element per thread rather than 16-byte
// vectors, and no second tile is in flight while one is computed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_G = 16;          // query heads per KV head (16 warps)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * MAX_G)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, T* __restrict__ o, int T_cap, int H,
              int KH, int pos, float scale) {
  constexpr int BK = 4096 / D;     // keys per tile (64 at D = 64)
  constexpr int KPL = BK / 32;     // keys scored per lane
  constexpr int DPL = D / 32;      // output dims per lane
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float qs[MAX_G][D];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kh * G + warp;

  const T* qp = q + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i) qs[warp][lane + 32 * i] = to_f32(qp[lane + 32 * i]);

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  const int n = min(pos + 1, T_cap);   // keys 0..pos
  const size_t t_stride = static_cast<size_t>(KH) * D;
  const T* kb = kc + (static_cast<size_t>(b) * T_cap * KH + kh) * D;
  const T* vb = vc + (static_cast<size_t>(b) * T_cap * KH + kh) * D;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();               // the previous tile (and qs) are ready
    for (int idx = threadIdx.x; idx < BK * D; idx += blockDim.x) {
      const int r = idx / D;
      const int c = idx % D;
      const int t = k0 + r;
      const bool in = t < n;
      ks[r][c] = in ? to_f32(kb[t * t_stride + c]) : 0.f;
      vs[r][c] = in ? to_f32(vb[t * t_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[KPL];
    float cmax = NEG_INF;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = lane + 32 * kk;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qs[warp][d] * ks[j][d];
      s[kk] = k0 + j < n ? dot * scale : NEG_INF;
      cmax = fmaxf(cmax, s[kk]);
    }
    const float m_new = fmaxf(m, warp_max(cmax));
    const float alpha = __expf(m - m_new);
    float p[KPL];
    float psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      p[kk] = __expf(s[kk] - m_new);
      psum += p[kk];
    }
    l = l * alpha + warp_sum(psum);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      for (int src = 0; src < 32; ++src) {
        const float pj = __shfl_sync(0xffffffffu, p[kk], src);
        const int j = src + 32 * kk;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] += pj * vs[j][lane + 32 * i];
      }
    }
    m = m_new;
  }

  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* op = o + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i) store(op + lane + 32 * i, acc[i] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o,
                   int B, int T_cap, int H, int KH, int pos, float scale,
                   cudaStream_t stream) {
  const dim3 grid(KH, B);
  decode_kernel<T, D><<<grid, 32 * (H / KH), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<T*>(o), T_cap, H, KH, pos, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int repro_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, void* o, int B,
    int T_cap, int H, int KH, int D, int dtype, int pos, float scale,
    void* stream) {
  if (B <= 0 || T_cap <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAX_G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared by both kernels' wrappers to name a failed launch.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
