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
// 0, as _flash_kernel does; in the bf16 route a masked score adds nothing
// to the sum even before the row's first unmasked key, so a row with no
// unmasked key at all (a window past the last key) writes 0.
//
// Two routes, chosen by dtype alone in the C entry below:
//
// bf16 (the serving path): flash_fwd_tc, on the tensor cores.
// - one block per (q-tile of BQ = 64 rows, head, batch), 4 warps, each
//   owning 16 query rows; the KV head is h / (H / KH), so any group size
//   works (qwen2's g = 7 included) without a repeat;
// - Q is copied once with cp.async and held as mma A fragments (ldmatrix)
//   in registers for the whole KV loop;
// - K and V come in chunks of 32 keys through a ring of four shared-memory
//   slots, copied with cp.async three chunks ahead of the one in use, so
//   the work on a chunk overlaps the copies of the next; each chunk's
//   copies arrive on an mbarrier that every warp waits on by itself, so
//   the warps never wait for each other while a chunk is in use (a block
//   barrier guards only the reuse of a slot); keys at or past the loop
//   bound are zero-filled (src-size 0), so the ragged edge needs no branch;
//   rows are padded by 16 bytes so ldmatrix reads no bank twice;
// - per chunk (32 keys, so that D = 64 fits 128 registers a thread, four
//   blocks an SM, without spills): S = Q K^T on mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate); scale, softcap, the causal / window masks and the
//   online-softmax update run on the accumulator fragments in registers,
//   each element masked by its true (row, key), the tests skipped where no
//   mask reaches, and the chunk (or a 16-key half of it past the warp's
//   last row) skipped where the masks cover this warp's 16 rows whole; row
//   max and sum are reduced over the four lanes of a quad; the exponent is
//   one FFMA and one ex2 (scale folded into log2 units);
// - P is rounded to bf16 (the reference's p.astype(v.dtype)) and reused in
//   registers as the A fragment of O += P V, V's fragments from
//   ldmatrix.trans; the causal / window block skip that _flash_kernel does
//   with pl.when is the loop bounds [kv_lo, kv_hi);
// - the output is divided by l, rounded to bf16, staged through the
//   warp's own rows of the Q tile and stored 16 bytes a lane.
//
// f32: flash_fwd_kernel, the first version on the f32 CUDA cores: four
// threads per query row, KV tiles of 4096/D keys staged as f32 in shared
// memory, probabilities kept in f32. It is on no serving path.
//
// What bounds it on an H100: at the serving path's prefill shape (qwen2-0.5b,
// B=16, S=T=128, H=14, KH=2, D=64, bf16, causal) the function must move
// q + k + v + out = 8.4 MB (3.35 TB/s: 2.5 us) and do 4*B*H*D*sum(valid keys)
// = 0.47 GFLOP (989 TFLOP/s bf16: 0.48 us), so it is memory-bound. On the
// card the bf16 route is bound by latency instead: copies that land late
// in a one-wave grid, then each warp's chain of chunks (variants without
// the P V products or without the exponentials took as long). It re-reads
// K/V once per q-tile (every 64 query rows) from L2;
// wgmma and TMA would matter only for long prompts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tc.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;             // query rows per block
constexpr int TPR = 4;             // threads per query row
constexpr int CHUNK = 16;          // keys per online-softmax update
constexpr int THREADS = BQ * TPR;  // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------- bf16 route

namespace {
namespace tcr {

constexpr int BQ = 64;             // query rows per block, 16 per warp
constexpr int SUB = 32;            // keys per chunk: one copy, one softmax step
constexpr int SLOTS = 4;           // chunks in the shared-memory ring
constexpr int AHEAD = SLOTS - 1;   // chunks in flight past the one in use
constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

// padded row of a shared-memory tile, in elements: 16 bytes past D, so the
// eight rows an ldmatrix reads start in eight different bank quads
template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }

// Q, then the ring of K and V chunks
template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ + 2 * SLOTS * SUB) * ld<D>() *
         sizeof(__nv_bfloat16);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// at D = 64, 4 blocks an SM (at most 128 registers a thread): the serving
// shape's 448 blocks then run in one wave on 132 SMs
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 2)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             int S, int T_len, int H, int KH, float scale, int causal,
             int window, float softcap) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int LD = ld<D>();
  constexpr int KD = D / 16;       // k-steps of Q K^T
  constexpr int ND = D / 8;        // n-tiles of O
  constexpr int NS = SUB / 8;      // n-tiles of S in one chunk
  constexpr int CPR = D / 8;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;           // SLOTS K chunks
  __nv_bfloat16* vs = ks + SLOTS * SUB * LD;  // SLOTS V chunks
  // full[s]: the chunk in slot s has landed (every thread's copies of it)
  __shared__ uint64_t full[SLOTS];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  // the last q-tiles (the most keys under a causal mask) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rq = q0 + warp * 16;   // this warp's first row
  const int row0 = rq + g;         // this lane's rows: row0, row0 + 8

  // keys any row of this tile can see
  int kv_hi = T_len;
  if (causal) kv_hi = min(kv_hi, q0 + BQ);
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  const size_t q_ts = static_cast<size_t>(H) * D;
  const size_t kv_ts = static_cast<size_t>(KH) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * H + h) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * T_len * KH + kh) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * T_len * KH + kh) * D;

  if (tid == 0)
    for (int i = 0; i < SLOTS; ++i) tc::mbar_init(&full[i], THREADS);
  __syncthreads();
  for (int c = tid; c < BQ * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool in = q0 + r < S;
    tc::cp_async16(qs + r * LD + col, qb + (in ? q0 + r : q0) * q_ts + col, in);
  }
  // chunk i holds keys kv_lo + SUB i.. in ring slot i % SLOTS; keys at or
  // past kv_hi are zero-filled
  const int nchunks = kv_lo < kv_hi ? (kv_hi - kv_lo + SUB - 1) / SUB : 0;
  auto load_chunk = [&](int i) {
    const int k0 = kv_lo + i * SUB;
    __nv_bfloat16* kd = ks + (i % SLOTS) * SUB * LD;
    __nv_bfloat16* vd = vs + (i % SLOTS) * SUB * LD;
    for (int c = tid; c < SUB * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const bool in = k0 + r < kv_hi;
      const size_t off = (in ? k0 + r : k0) * kv_ts + col;
      tc::cp_async16(kd + r * LD + col, kb + off, in);
      tc::cp_async16(vd + r * LD + col, vb + off, in);
    }
    tc::cp_async_arrive(&full[i % SLOTS]);
  };
  // Q lands with chunk 0 (an arrival waits for all the thread's copies)
  for (int i = 0; i < AHEAD && i < nchunks; ++i) load_chunk(i);

  // exp(scale s - scale m) = 2^(s mul - m mul): one FFMA and one ex2 per
  // score (with a softcap, s is the capped score and mul log2(e))
  const float mul = softcap > 0.f ? LOG2E : scale * LOG2E;
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};         // this lane's part of the row sums

  for (int i = 0; i < nchunks; ++i) {
    if (i + AHEAD < nchunks) load_chunk(i + AHEAD);
    // each warp waits for chunk i (and Q) on its own: no block barrier
    tc::mbar_wait(&full[i % SLOTS], (i / SLOTS) & 1);
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD +
                                    kk * 16 + (lane >> 4) * 8);
    }
    const int kb0 = kv_lo + i * SUB;  // first key of this chunk
    const __nv_bfloat16* kt = ks + (i % SLOTS) * SUB * LD;
    const __nv_bfloat16* vt = vs + (i % SLOTS) * SUB * LD;
    // a chunk masked whole for this warp's 16 rows is skipped, as
    // _flash_kernel skips masked blocks
    const bool skip = (causal && kb0 > rq + 15) ||
                      (window > 0 && kb0 + SUB - 1 <= rq - window);
    if (!skip) {
      // S = Q K^T for this warp's 16 rows and the chunk's keys
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
      // 16-key halves of the chunk past this warp's last row (causal) are
      // masked whole: their products are skipped and their P is 0
      bool half_live[NS / 2];
#pragma unroll
      for (int np = 0; np < NS / 2; ++np)
        half_live[np] = !(causal && kb0 + 16 * np > rq + 15);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          if (!half_live[np]) continue;
          uint32_t r[4];
          tc::ldmatrix_x4(
              r, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
          tc::mma(s[2 * np], qf[kk], r[0], r[1]);
          tc::mma(s[2 * np + 1], qf[kk], r[2], r[3]);
        }
      }

      // scale, softcap and masks, element by element at its true (row,
      // key); a chunk that no mask reaches for this warp's rows skips the
      // tests
      const bool masked = kb0 + SUB > kv_hi ||
                          (causal && kb0 + SUB - 1 > rq) ||
                          (window > 0 && kb0 <= rq + 15 - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // x in units where p = 2^(x mul - m mul)
          float x = s[j][c];
          if (softcap > 0.f) x = softcap * tanhf(x * scale / softcap);
          if (masked) {
            const int row = row0 + (c >> 1) * 8;
            const int key = kb0 + j * 8 + 2 * t4 + (c & 1);
            bool ok = key < kv_hi;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && key > row - window;
            if (!ok) x = NEG_INF;
          }
          s[j][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2_approx((m[r] - m_new) * mul);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // P in f32 for the sums, rounded to bf16 as the A fragments of P V:
      // n-tiles 2kk and 2kk + 1 of S are k-step kk of P
      uint32_t pf[NS / 2][4];
      // a row that has seen no unmasked key yet takes p = 0 (m * mul - m
      // * mul is not 0 in one FFMA when m = NEG_INF)
      const float mm[2] = {m[0] == NEG_INF ? 0.f : m[0] * mul,
                           m[1] == NEG_INF ? 0.f : m[1] * mul};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float p0 = exp2_approx(fmaf(s[j][0], mul, -mm[0]));
        const float p1 = exp2_approx(fmaf(s[j][1], mul, -mm[0]));
        const float p2 = exp2_approx(fmaf(s[j][2], mul, -mm[1]));
        const float p3 = exp2_approx(fmaf(s[j][3], mul, -mm[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[j / 2][(j % 2) * 2] = tc::pack_bf16(p0, p1);
        pf[j / 2][(j % 2) * 2 + 1] = tc::pack_bf16(p2, p3);
      }

      // O += P V
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        if (!half_live[kk]) continue;
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(
              r, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     dp * 16 + (lane >> 4) * 8);
          tc::mma(acc[2 * dp], pf[kk], r[0], r[1]);
          tc::mma(acc[2 * dp + 1], pf[kk], r[2], r[3]);
        }
      }
    }
    // slot i % SLOTS takes chunk i + SLOTS, if there is one, next
    if (i + SLOTS < nchunks) __syncthreads();
  }

  // with no KV chunk the Q copy may still be in flight
  if (nchunks == 0) {
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  // stage the warp's 16 output rows in its own rows of the Q tile
  __nv_bfloat16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LD + n * 8 + 2 * t4) =
        tc::pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + n * 8 + 2 * t4) =
        tc::pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int sq = rq + r;
    if (sq < S)
      *reinterpret_cast<uint4*>(o + (static_cast<size_t>(b) * S + sq) * q_ts +
                                static_cast<size_t>(h) * D + col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T_len, int H, int KH, float scale,
                   int causal, int window, float softcap, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = tc::set_smem_once(
      reinterpret_cast<const void*>(flash_fwd_tc<D>), smem_bytes<D>(),
      smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_tc<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      T_len, H, KH, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace tcr
}  // namespace

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (tensor-core route).
// Returns a cudaError_t (0 = launched).
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
    return tcr::launch<64>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, softcap, st);
  if (dtype == 1 && D == 128)
    return tcr::launch<128>(q, k, v, o, B, S, T_len, H, KH, scale, causal, window, softcap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
