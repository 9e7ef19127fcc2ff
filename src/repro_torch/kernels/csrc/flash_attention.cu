// K1: flash-attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd / _flash_kernel) together with the GQA repeat and
// block padding its wrapper repro/kernels/ops.py::flash_attention does.
//
// What it computes: out = softmax(mask(softcap(scale * q k^T))) v with an
// online softmax, per (batch, query head). q is (B, S, H, D); k and v are
// (B, T, KH, D) with KH | H. Query row s and key t sit at positions s and t
// (both from 0), as in the TPU kernel. Masks: causal (t <= s), sliding
// window (t > s - window when window > 0), logit softcap (softcap > 0).
// Masked scores are NEG_INF = -1e30 and a row whose running sum is 0 writes
// 0, exactly as _flash_kernel does.
//
// Design (simple first):
// - one block per (q-tile of BQ = 64 rows, head, batch), 256 threads: four
//   neighbouring threads own one query row, each holding D/4 of its q and
//   output dims in registers (dims interleaved, so the four read four
//   consecutive shared-memory banks);
// - an in-block loop over KV tiles of 4096/D keys staged in shared memory
//   as f32; the causal / window block skip that _flash_kernel does with
//   pl.when becomes the loop bounds [kv_lo, kv_hi);
// - the KV head is indexed as h / (H / KH) instead of materialising the
//   repeat, so any group size works (qwen2's g = 7 included);
// - the ragged S and T edges are masked by their true lengths (no padding);
// - scores, running max / sum and the accumulator stay f32 in registers,
//   updated once per chunk of 16 keys.
//
// What bounds it on an H100: at the serving path's prefill shape (qwen2-0.5b,
// B=16, S=T=128, H=14, KH=2, D=64, bf16, causal) the function must move
// q + k + v + out = 8.4 MB (3.35 TB/s: 2.5 us) and do 4*B*H*D*sum(valid keys)
// = 0.47 GFLOP (989 TFLOP/s bf16: 0.48 us), so it is memory-bound.
//
// What this simple design leaves on the table: it multiplies on the f32
// CUDA cores (67 TFLOP/s) instead of the tensor cores (mma.sync / wgmma),
// loads one element per thread instead of 16-byte vectors or TMA, keeps no
// second tile in flight while computing, and re-reads K/V once per q-tile
// (every 64 query rows) from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;             // query rows per block
constexpr int TPR = 4;             // threads per query row
constexpr int CHUNK = 16;          // keys per online-softmax update
constexpr int THREADS = BQ * TPR;  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int T_len, int H, int KH, float scale, int causal,
                 int window, float softcap) {
  constexpr int BK = 4096 / D;     // keys per tile: 32 KB of f32 K and V
  constexpr int DPT = D / TPR;     // dims per thread
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int part = tid % TPR;      // this thread's dims: part + TPR * i
  const int qpos = q0 + tid / TPR;

  float qr[DPT];
  float acc[DPT];
  const T* qp = q + ((static_cast<size_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = qpos < S ? to_f32(qp[part + TPR * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  // keys any row of this tile can see
  int kv_hi = T_len;
  if (causal) kv_hi = min(kv_hi, q0 + BQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  const size_t t_stride = static_cast<size_t>(KH) * D;
  const T* kb = k + (static_cast<size_t>(b) * T_len * KH + kh) * D;
  const T* vb = v + (static_cast<size_t>(b) * T_len * KH + kh) * D;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();               // the previous tile is consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D;
      const int c = idx % D;
      const int t = k0 + r;
      const bool in = t < kv_hi;
      ks[r][c] = in ? to_f32(kb[t * t_stride + c]) : 0.f;
      vs[r][c] = in ? to_f32(vb[t * t_stride + c]) : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK && k0 + j0 < kv_hi; j0 += CHUNK) {
      float s[CHUNK];
      float cmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const int j = j0 + jj;
        const int t = k0 + j;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) dot += qr[i] * ks[j][part + TPR * i];
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        bool ok = t < kv_hi;
        if (causal) ok = ok && t <= qpos;
        if (window > 0) ok = ok && t > qpos - window;
        s[jj] = ok ? sc : NEG_INF;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        const float p = __expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] += p * vs[j0 + jj][part + TPR * i];
      }
      m = m_new;
    }
  }

  if (qpos < S) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    T* op = o + ((static_cast<size_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(op + part + TPR * i, acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T_len, int H, int KH, float scale,
                   int causal, int window, float softcap, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, KH, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int T_len, int H, int KH, int D, int dtype, float scale, int causal,
    int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, softcap, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, softcap, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, softcap, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
