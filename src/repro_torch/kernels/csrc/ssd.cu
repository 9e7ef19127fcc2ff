// K3: Mamba2 SSD chunk scan (ngroups = 1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py (ssd_chunk_scan /
// _ssd_kernel) together with the chunk padding its wrapper
// repro/kernels/ops.py::ssd does.
//
// What it computes, for each sequence b and head h, over chunks of L tokens
// in order, with the (P, N) state S carried in f32 from chunk to chunk
// (zero before the first):
//   cs_i   = sum_{k <= i} dt_k * A                 (within the chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + exp(cs_i) S_in C_i                 (S_in: state entering it)
//   S_out  = S_in exp(cs_last) + sum_j x_j (B_j exp(cs_last - cs_j) dt_j)^T
// x is (nb, S, H, P) in f32 or bf16, dt (nb, S, H) f32 after softplus, A (H,)
// f32 negative, B and C (nb, S, N) in f32 or bf16, shared by all heads. y is
// (nb, S, H, P) in x's type; the final state (nb, H, P, N) f32. x, B and C
// are read through a token stride, so the model's slices of one conv output
// need no copy. The whole y path is f32 and y is rounded once at the store,
// as in _ssd_kernel (a bf16 score matrix cost 0.18 max-abs error there).
//
// Both routes share the algorithm: the TPU grid's sequential chunk axis
// becomes a loop inside one block per (h, b); a ragged last chunk is masked
// by its true length lc (the TPU wrapper pads with dt = 0, which means decay
// 1 and no state update: the same result); the (L, L) score matrix is never
// held whole, only the 64-row tiles at or left of the diagonal; the whole
// chunk's y is computed from the entering state before the state is
// updated; cumsum(dt A) is an f32 warp scan. Above the diagonal nothing is
// computed: exp(cs_i - cs_j) may overflow to inf there and inf * 0 is NaN,
// so entries with j > i, and rows or columns past lc, are written as 0
// without computing the exponential, and tails past lc load as zeros.
//
// Two routes, chosen by dtype alone in the C entry below:
//
// bf16 x, B and C (the serving path): ssd_tc, on the tensor cores.
// - PM / 16 warps (4 at P <= 64, 8 up to 128); each owns 16 rows p of the
//   (P, N) f32 state, held in mma accumulator fragments in registers for
//   the whole sequence (64 a lane), never in shared memory as f32;
// - per chunk, the entering state is split into bf16 hi = bf16(S) and
//   lo = bf16(S - hi) in shared memory; y over row tiles of 16 rows per warp:
//   y_i = exp(cs_i) C_i (S_hi + S_lo)^T, then for 32-column steps j at or
//   left of the diagonal G = C_i B_j^T (bf16 products, exact in f32), scaled
//   in registers by exp(cs_i - cs_j) dt_j, split into hi + lo A fragments,
//   and y_i += hi x_j + lo x_j (x_j's fragments by ldmatrix.trans); y is
//   rounded once, at the store, staged through the warp's own C rows;
// - state update: S = S exp(cs_last) + x^T (B w), with B w formed in f32 and
//   split into hi + lo in shared memory, two products into the registers;
// - C, B and x come in with 16-byte cp.async copies through their token
//   strides, B and x double-buffered over 64-column tiles; rows padded by
//   16 bytes so ldmatrix reads no bank twice.
// The split keeps the y path f32 to about 2^-16 relative: one bf16
// rounding of the scores or the state (hi alone) is 2^-8 and breaks the
// state's 1e-2 tolerance (tests/test_torch_kernel_precision.py).
//
// f32 x, B or C: ssd_kernel, the first version on the f32 CUDA cores, 256
// threads, the state in shared memory as S[n][p], each thread owning 4 x 4
// output tiles read as 16-byte vectors. It is on no serving path.
//
// What bounds it on an H100: at the mamba2-2.7b prefill shape (nb = 16,
// S = 512, H = 80, P = 64, N = 128, L = 256; x, B, C bf16) the function must
// move x + y (83.9 MB each) + the final state (41.9 MB) + dt (2.6 MB) + B and
// C (4.2 MB) = 216 MB (3.35 TB/s: 0.065 ms) and do, counting the causal half
// of each chunk's scores, 53.8 GFLOP (989 TFLOP/s bf16: 0.054 ms), so the
// bytes bound it. The bf16 route runs about 97 GFLOP of mma (the hi + lo
// products, whole 16 x 32 steps on the diagonal). Left on the table: C B^T
// is the same for all heads (ngroups = 1) and is recomputed per head, as
// the TPU kernel does; wgmma and TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;           // chunk rows (i) and columns (j) per tile
constexpr int TS = TILE + 4;       // padded row stride of ct, bt and sc
constexpr int MAX_L = 256;         // longest chunk
constexpr int MAX_P = 128;         // at P = N = 128 a block takes 187 KB of
constexpr int MAX_N = 128;         // shared memory, within the 227 KB allowed
constexpr int Y_ITEMS = (TILE / 4) * (MAX_P / 4) / THREADS;   // 4x4 y tiles a thread owns
constexpr int S_ITEMS = (MAX_N / 4) * (MAX_P / 4) / THREADS;  // 4x4 state tiles a thread owns

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// shared-memory floats the kernel needs at (P, N)
__host__ __device__ constexpr size_t smem_floats(int P, int N) {
  return static_cast<size_t>(N) * P + 2 * static_cast<size_t>(N) * TS +
         static_cast<size_t>(TILE) * P + TILE * TS + 2 * MAX_L;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const TB* __restrict__ Bm,
           const TB* __restrict__ Cm, TX* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int P, int N, int L,
           long long x_ts, long long b_ts, long long c_ts) {
  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // state S[n][p]
  float* ct = st + N * P;          // C tile, transposed: ct[n][i]
  float* bt = ct + N * TS;         // B tile: bt[n][j] (scores), bt[j][n] (update)
  float* xs = bt + N * TS;         // x tile: xs[j][p]
  float* sc = xs + TILE * P;       // score tile: sc[i][j]
  float* cs = sc + TILE * TS;      // cumsum of dt * A over the chunk
  float* dts = cs + MAX_L;         // dt over the chunk (0 past lc)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[h];
  const size_t tok0 = static_cast<size_t>(b) * S;
  const TX* xb = x + tok0 * x_ts + static_cast<size_t>(h) * P;
  const TB* bb = Bm + tok0 * b_ts;
  const TB* cb = Cm + tok0 * c_ts;
  TX* yb = y + (tok0 * H + h) * P;
  const int P4 = P / 4;
  const int y_items = (TILE / 4) * P4;
  const int s_items = (N / 4) * P4;

  for (int i = tid; i < N * P; i += THREADS) st[i] = 0.f;

  const int nc = (S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    const int lc = min(L, S - t0);   // true length of this chunk
    __syncthreads();                 // the previous chunk is done with smem

    // dt and its running sum times A, by one warp: each lane scans 8
    // consecutive steps, then the lanes' totals are scanned with shuffles
    if (tid < 32) {
      constexpr int PER = MAX_L / 32;
      float run = 0.f;
      float part[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = tid * PER + k;
        const float d = i < lc ? dt[(tok0 + t0 + i) * H + h] : 0.f;
        dts[i] = d;
        run += d * a;
        part[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, tot, o);
        if (tid >= o) tot += u;
      }
      const float base = tot - run;
#pragma unroll
      for (int k = 0; k < PER; ++k) cs[tid * PER + k] = base + part[k];
    }

    // ---- y for each row tile, from the state entering the chunk
    for (int i0 = 0; i0 < lc; i0 += TILE) {
      __syncthreads();               // cs ready; ct free
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int r = idx / N, k = idx % N;
        const int t = i0 + r;
        ct[k * TS + r] = t < lc ? to_f32(cb[(t0 + t) * c_ts + k]) : 0.f;
      }
      __syncthreads();

      // carried state: acc[i][p] = exp(cs_i) * sum_n C[i][n] S[n][p]
      float acc[Y_ITEMS][4][4];
#pragma unroll
      for (int q = 0; q < Y_ITEMS; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[q][r][cc] = 0.f;
        const int it = tid + q * THREADS;
        if (it < y_items) {
          const int iq = it / P4, pq = it % P4;
          for (int k = 0; k < N; ++k)
            fma4x4(acc[q], ld4(ct + k * TS + iq * 4), ld4(st + k * P + pq * 4));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float e = expf(cs[i0 + iq * 4 + r]);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc[q][r][cc] *= e;
          }
        }
      }

      // intra-chunk: column tiles at or left of the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        __syncthreads();             // bt, xs, sc free
        for (int idx = tid; idx < TILE * N; idx += THREADS) {
          const int r = idx / N, k = idx % N;
          const int t = j0 + r;
          bt[k * TS + r] = t < lc ? to_f32(bb[(t0 + t) * b_ts + k]) : 0.f;
        }
        for (int idx = tid; idx < TILE * P; idx += THREADS) {
          const int r = idx / P, k = idx % P;
          const int t = j0 + r;
          xs[r * P + k] = t < lc ? to_f32(xb[(t0 + t) * x_ts + k]) : 0.f;
        }
        __syncthreads();
        {
          // sc[i][j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0
          const int iq = tid / (TILE / 4), jq = tid % (TILE / 4);
          float s4[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) s4[r][cc] = 0.f;
          for (int k = 0; k < N; ++k)
            fma4x4(s4, ld4(ct + k * TS + iq * 4), ld4(bt + k * TS + jq * 4));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + iq * 4 + r;
            float v[4];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int j = j0 + jq * 4 + cc;
              v[cc] = 0.f;
              if (j <= i && i < lc)  // j <= i < lc: never past the tail
                v[cc] = s4[r][cc] * expf(cs[i] - cs[j]) * dts[j];
            }
            *reinterpret_cast<float4*>(sc + (iq * 4 + r) * TS + jq * 4) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
        __syncthreads();
        // acc[i][p] += sum_j sc[i][j] x[j][p]
#pragma unroll
        for (int q = 0; q < Y_ITEMS; ++q) {
          const int it = tid + q * THREADS;
          if (it >= y_items) continue;
          const int iq = it / P4, pq = it % P4;
          for (int j = 0; j < TILE; j += 4) {
            float4 srow[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) srow[r] = ld4(sc + (iq * 4 + r) * TS + j);
            const float4 x0 = ld4(xs + (j + 0) * P + pq * 4);
            const float4 x1 = ld4(xs + (j + 1) * P + pq * 4);
            const float4 x2 = ld4(xs + (j + 2) * P + pq * 4);
            const float4 x3 = ld4(xs + (j + 3) * P + pq * 4);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float sv[4] = {srow[r].x, srow[r].y, srow[r].z, srow[r].w};
              const float4 xv[4] = {x0, x1, x2, x3};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                acc[q][r][0] = fmaf(sv[jj], xv[jj].x, acc[q][r][0]);
                acc[q][r][1] = fmaf(sv[jj], xv[jj].y, acc[q][r][1]);
                acc[q][r][2] = fmaf(sv[jj], xv[jj].z, acc[q][r][2]);
                acc[q][r][3] = fmaf(sv[jj], xv[jj].w, acc[q][r][3]);
              }
            }
          }
        }
      }

      // one rounding, at the store
#pragma unroll
      for (int q = 0; q < Y_ITEMS; ++q) {
        const int it = tid + q * THREADS;
        if (it >= y_items) continue;
        const int iq = it / P4, pq = it % P4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + iq * 4 + r;
          if (i >= lc) continue;
          TX* yp = yb + (static_cast<size_t>(t0 + i) * H) * P + pq * 4;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) store(yp + cc, acc[q][r][cc]);
        }
      }
    }

    // ---- state update: S = S exp(cs_last) + sum_j (B_j w_j) (x) x_j,
    // w_j = exp(cs_last - cs_j) dt_j; B is held j-major here: bt[j][n]
    const float cl = cs[lc - 1];
    float sacc[S_ITEMS][4][4];
#pragma unroll
    for (int q = 0; q < S_ITEMS; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) sacc[q][r][cc] = 0.f;
    for (int j0 = 0; j0 < lc; j0 += TILE) {
      __syncthreads();               // y is done with st, bt, xs
      for (int idx = tid; idx < TILE * N; idx += THREADS) {
        const int r = idx / N, k = idx % N;
        const int t = j0 + r;
        bt[r * N + k] = t < lc ? to_f32(bb[(t0 + t) * b_ts + k]) *
                                     (expf(cl - cs[t]) * dts[t])
                               : 0.f;
      }
      for (int idx = tid; idx < TILE * P; idx += THREADS) {
        const int r = idx / P, k = idx % P;
        const int t = j0 + r;
        xs[r * P + k] = t < lc ? to_f32(xb[(t0 + t) * x_ts + k]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < S_ITEMS; ++q) {
        const int it = tid + q * THREADS;
        if (it >= s_items) continue;
        const int nq = it / P4, pq = it % P4;
        for (int j = 0; j < TILE; ++j)
          fma4x4(sacc[q], ld4(bt + j * N + nq * 4), ld4(xs + j * P + pq * 4));
      }
    }
    // each thread owns its state entries: no other thread reads st here
    const float decay = expf(cl);
    const bool last = c == nc - 1;
#pragma unroll
    for (int q = 0; q < S_ITEMS; ++q) {
      const int it = tid + q * THREADS;
      if (it >= s_items) continue;
      const int nq = it / P4, pq = it % P4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* sp = st + (nq * 4 + r) * P + pq * 4;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          sacc[q][r][cc] = fmaf(sp[cc], decay, sacc[q][r][cc]);
          sp[cc] = sacc[q][r][cc];
        }
      }
      if (last) {                    // state_out[b][h][p][n], n contiguous
        float* so = state_out + (static_cast<size_t>(b) * H + h) * P * N;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          *reinterpret_cast<float4*>(so + (pq * 4 + cc) * N + nq * 4) =
              make_float4(sacc[q][0][cc], sacc[q][1][cc], sacc[q][2][cc],
                          sacc[q][3][cc]);
      }
    }
  }
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state,
                   int nb, int S, int H, int P, int N, int L, long long x_ts,
                   long long b_ts, long long c_ts, cudaStream_t stream) {
  // set once for the largest (P, N), so a launch never changes it
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = smem_floats(P, N) * sizeof(float);
  cudaError_t err = tc::set_smem_once(
      reinterpret_cast<const void*>(ssd_kernel<TX, TB>),
      smem_floats(MAX_P, MAX_N) * sizeof(float), smem_set);
  if (err != cudaSuccess) return err;
  ssd_kernel<TX, TB><<<dim3(H, nb), THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TB*>(Bm),
      static_cast<const TB*>(Cm), static_cast<TX*>(y),
      static_cast<float*>(state), S, H, P, N, L, x_ts, b_ts, c_ts);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- bf16 route

namespace {
namespace tcr {

constexpr int JT = 64;             // columns j per B / x tile
constexpr int NM = 128;            // state width held in the tiles (N <= NM)
constexpr int LDN = NM + 8;        // padded row of the C, B, S and B.w tiles

// PM: the head width held in registers (P <= PM, zero-padded), 16 rows of
// the state and of y per warp
template <int PM>
struct Cfg {
  static constexpr int WARPS = PM / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RT = PM;                   // y rows per row tile
  static constexpr int LDP = PM + 8;              // padded row of x tiles
  static constexpr int SROWS = PM > JT ? PM : JT; // rows of the S / B.w split
  // offsets in bf16 elements: C tile, two B tiles, two x tiles, hi and lo
  static constexpr int B_OFF = RT * LDN;
  static constexpr int X_OFF = B_OFF + 2 * JT * LDN;
  static constexpr int S_OFF = X_OFF + 2 * JT * LDP;
  static constexpr int END = S_OFF + 2 * SROWS * LDN;
  // then cs and dt over the chunk, f32
  static constexpr size_t BYTES = END * sizeof(__nv_bfloat16) + 2 * MAX_L * sizeof(float);
};

// ROWS rows of CPR 16-byte chunks from the token rows r0.. of a chunk
// (src: its first token, ts: token stride); rows at or past lc and chunks at
// or past cpr_real are zero-filled
template <int ROWS, int CPR, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ldd,
                                          const __nv_bfloat16* src,
                                          long long ts, int r0, int lc,
                                          int cpr_real) {
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, k = c % CPR;
    const bool in = r0 + r < lc && k < cpr_real;
    tc::cp_async16(dst + r * ldd + k * 8,
                   src + (in ? (r0 + r) * ts + k * 8 : 0), in);
  }
}

template <int PM>
__global__ void __launch_bounds__(Cfg<PM>::THREADS)
ssd_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
       const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
       float* __restrict__ state_out, int S, int H, int P, int N, int L,
       long long x_ts, long long b_ts, long long c_ts) {
  using K = Cfg<PM>;
  constexpr int THREADS = K::THREADS;
  constexpr int RT = K::RT;
  constexpr int LDP = K::LDP;
  constexpr int NTS = NM / 8;      // n-tiles of the state (over n)
  constexpr int NTY = PM / 8;      // n-tiles of y (over p)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ct = sm;                    // C rows of the row tile
  __nv_bfloat16* bt = sm + K::B_OFF;         // two B tiles
  __nv_bfloat16* xt = sm + K::X_OFF;         // two x tiles
  __nv_bfloat16* s_hi = sm + K::S_OFF;       // S (y), then B.w (update)
  __nv_bfloat16* s_lo = s_hi + K::SROWS * LDN;
  float* cs = reinterpret_cast<float*>(sm + K::END);
  float* dts = cs + MAX_L;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float a = A[h];
  const size_t tok0 = static_cast<size_t>(b) * S;
  const __nv_bfloat16* xb = x + tok0 * x_ts + static_cast<size_t>(h) * P;
  const __nv_bfloat16* bb = Bm + tok0 * b_ts;
  const __nv_bfloat16* cb = Cm + tok0 * c_ts;
  __nv_bfloat16* yb = y + (tok0 * H + h) * P;
  const int ncp = N / 8, pcp = P / 8;        // true 16-byte chunks per row

  // the state, f32, in accumulator fragments for the whole sequence: this
  // lane holds p = 16 warp + g (+ 8), n = 8 nt + 2 t4 (+ 1)
  float st[NTS][4];
#pragma unroll
  for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[nt][c] = 0.f;
  const int sp = 16 * warp + g;

  const int nc = (S + L - 1) / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    const int lc = min(L, S - t0);   // true length of this chunk
    const __nv_bfloat16* xc = xb + t0 * x_ts;
    const __nv_bfloat16* bc = bb + t0 * b_ts;
    const __nv_bfloat16* cc = cb + t0 * c_ts;
    __syncthreads();                 // the previous chunk is done with smem

    // dt and its running sum times A, by warp 0: each lane scans 8
    // consecutive steps, then the lanes' totals are scanned with shuffles
    if (warp == 0) {
      constexpr int PER = MAX_L / 32;
      float run = 0.f;
      float part[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane * PER + k;
        const float d = i < lc ? dt[(tok0 + t0 + i) * H + h] : 0.f;
        dts[i] = d;
        run += d * a;
        part[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, tot, o);
        if (lane >= o) tot += u;
      }
      const float base = tot - run;
#pragma unroll
      for (int k = 0; k < PER; ++k) cs[lane * PER + k] = base + part[k];
    }

    // the state entering the chunk, split into bf16 hi + lo for C S^T
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt) {
      uint32_t hi, lo;
      const int n = 8 * nt + 2 * t4;
      tc::split_bf16(st[nt][0], st[nt][1], hi, lo);
      *reinterpret_cast<uint32_t*>(s_hi + sp * LDN + n) = hi;
      *reinterpret_cast<uint32_t*>(s_lo + sp * LDN + n) = lo;
      tc::split_bf16(st[nt][2], st[nt][3], hi, lo);
      *reinterpret_cast<uint32_t*>(s_hi + (sp + 8) * LDN + n) = hi;
      *reinterpret_cast<uint32_t*>(s_lo + (sp + 8) * LDN + n) = lo;
    }

    // ---- y, row tile by row tile, from the state entering the chunk
    for (int i0 = 0; i0 < lc; i0 += RT) {
      __syncthreads();               // cs and S ready; the tiles are free
      const int jend = min(i0 + RT, lc);
      load_tile<RT, NM / 8, THREADS>(ct, LDN, cc, c_ts, i0, lc, ncp);
      load_tile<JT, NM / 8, THREADS>(bt, LDN, bc, b_ts, 0, lc, ncp);
      load_tile<JT, PM / 8, THREADS>(xt, LDP, xc, x_ts, 0, lc, pcp);
      tc::cp_async_commit();

      const int rlo = i0 + 16 * warp;          // the warp's first row
      const int ia = rlo + g, ib = rlo + g + 8;  // this lane's rows
      const __nv_bfloat16* crow =
          ct + (16 * warp + (lane & 15)) * LDN + (lane >> 4) * 8;
      float ya[NTY][4];
#pragma unroll
      for (int n = 0; n < NTY; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) ya[n][k] = 0.f;

      int buf = 0;
      for (int j0 = 0; j0 < jend; j0 += JT) {
        if (j0 + JT < jend) {
          load_tile<JT, NM / 8, THREADS>(bt + (buf ^ 1) * JT * LDN, LDN, bc,
                                         b_ts, j0 + JT, lc, ncp);
          load_tile<JT, PM / 8, THREADS>(xt + (buf ^ 1) * JT * LDP, LDP, xc,
                                         x_ts, j0 + JT, lc, pcp);
        }
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
        __syncthreads();

        if (j0 == 0) {
          // carried term: y_i = exp(cs_i) C_i (S_hi + S_lo)^T
#pragma unroll
          for (int kk = 0; kk < NM / 16; ++kk) {
            uint32_t af[4];
            tc::ldmatrix_x4(af, crow + kk * 16);
#pragma unroll
            for (int pp = 0; pp < PM / 16; ++pp) {
              const int off = (pp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN +
                              kk * 16 + ((lane >> 3) & 1) * 8;
              uint32_t r[4];
              tc::ldmatrix_x4(r, s_hi + off);
              tc::mma(ya[2 * pp], af, r[0], r[1]);
              tc::mma(ya[2 * pp + 1], af, r[2], r[3]);
              tc::ldmatrix_x4(r, s_lo + off);
              tc::mma(ya[2 * pp], af, r[0], r[1]);
              tc::mma(ya[2 * pp + 1], af, r[2], r[3]);
            }
          }
          const float ea = expf(cs[ia]), eb = expf(cs[ib]);
#pragma unroll
          for (int n = 0; n < NTY; ++n) {
            ya[n][0] *= ea;
            ya[n][1] *= ea;
            ya[n][2] *= eb;
            ya[n][3] *= eb;
          }
        }

        const __nv_bfloat16* btb = bt + buf * JT * LDN;
        const __nv_bfloat16* xtb = xt + buf * JT * LDP;
        for (int js = 0; js < JT; js += 32) {
          const int jg = j0 + js;
          // all above the diagonal, or all past the chunk: nothing to add
          if (jg > rlo + 15 || jg >= lc || rlo >= lc) continue;
          // G = C_i B_j^T for 16 rows and 32 columns (exact in f32)
          float ga[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int k = 0; k < 4; ++k) ga[n][k] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NM / 16; ++kk) {
            uint32_t af[4];
            tc::ldmatrix_x4(af, crow + kk * 16);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t r[4];
              tc::ldmatrix_x4(
                  r, btb + (js + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDN +
                         kk * 16 + ((lane >> 3) & 1) * 8);
              tc::mma(ga[2 * np], af, r[0], r[1]);
              tc::mma(ga[2 * np + 1], af, r[2], r[3]);
            }
          }
          // exp(cs_i - cs_j) dt_j where j <= i < lc, 0 elsewhere (never
          // computed there: it may overflow); split into hi + lo A fragments
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int i = half ? ib : ia;
              const int j = jg + 8 * n + 2 * t4;
              float v0 = 0.f, v1 = 0.f;
              if (i < lc) {
                if (j <= i) v0 = ga[n][2 * half] * expf(cs[i] - cs[j]) * dts[j];
                if (j + 1 <= i)
                  v1 = ga[n][2 * half + 1] * expf(cs[i] - cs[j + 1]) * dts[j + 1];
              }
              tc::split_bf16(v0, v1, ah[n / 2][(n % 2) * 2 + half],
                             al[n / 2][(n % 2) * 2 + half]);
            }
          }
          // y_i += (hi + lo) x_j; x is bf16, so both products are exact
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
            for (int pp = 0; pp < PM / 16; ++pp) {
              uint32_t r[4];
              tc::ldmatrix_x4_trans(
                  r, xtb + (js + ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                         pp * 16 + (lane >> 4) * 8);
              tc::mma(ya[2 * pp], ah[ks], r[0], r[1]);
              tc::mma(ya[2 * pp + 1], ah[ks], r[2], r[3]);
              tc::mma(ya[2 * pp], al[ks], r[0], r[1]);
              tc::mma(ya[2 * pp + 1], al[ks], r[2], r[3]);
            }
          }
        }
        __syncthreads();             // this buffer is free for the next load
        buf ^= 1;
      }

      // one rounding, at the store: stage in the warp's own C rows (only
      // this warp reads them), then 16 bytes a lane
      __nv_bfloat16* ys = ct + 16 * warp * LDN;
#pragma unroll
      for (int n = 0; n < NTY; ++n) {
        *reinterpret_cast<uint32_t*>(ys + g * LDN + 8 * n + 2 * t4) =
            tc::pack_bf16(ya[n][0], ya[n][1]);
        *reinterpret_cast<uint32_t*>(ys + (g + 8) * LDN + 8 * n + 2 * t4) =
            tc::pack_bf16(ya[n][2], ya[n][3]);
      }
      __syncwarp();
      for (int e = lane; e < 16 * (PM / 8); e += 32) {
        const int r = e / (PM / 8), k = e % (PM / 8);
        const int i = rlo + r;
        if (i < lc && k < pcp)
          *reinterpret_cast<uint4*>(yb + static_cast<size_t>(t0 + i) * H * P +
                                    k * 8) =
              *reinterpret_cast<const uint4*>(ys + r * LDN + k * 8);
      }
    }

    // ---- state update: S = S exp(cs_last) + x^T (B w), w_j =
    // exp(cs_last - cs_j) dt_j, with B w split into bf16 hi + lo
    __syncthreads();                 // y is done with the tiles and S
    const float cl = cs[lc - 1];
    const float decay = expf(cl);
#pragma unroll
    for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) st[nt][k] *= decay;
    load_tile<JT, NM / 8, THREADS>(bt, LDN, bc, b_ts, 0, lc, ncp);
    load_tile<JT, PM / 8, THREADS>(xt, LDP, xc, x_ts, 0, lc, pcp);
    tc::cp_async_commit();
    int buf = 0;
    for (int j0 = 0; j0 < lc; j0 += JT) {
      if (j0 + JT < lc) {
        load_tile<JT, NM / 8, THREADS>(bt + (buf ^ 1) * JT * LDN, LDN, bc,
                                       b_ts, j0 + JT, lc, ncp);
        load_tile<JT, PM / 8, THREADS>(xt + (buf ^ 1) * JT * LDP, LDP, xc,
                                       x_ts, j0 + JT, lc, pcp);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* btb = bt + buf * JT * LDN;
      for (int e = threadIdx.x; e < JT * NM / 2; e += THREADS) {
        const int r = e / (NM / 2), n = (e % (NM / 2)) * 2;
        const int j = j0 + r;
        const float w = j < lc ? expf(cl - cs[j]) * dts[j] : 0.f;
        const __nv_bfloat162 bv =
            *reinterpret_cast<const __nv_bfloat162*>(btb + r * LDN + n);
        uint32_t hi, lo;
        tc::split_bf16(__low2float(bv) * w, __high2float(bv) * w, hi, lo);
        *reinterpret_cast<uint32_t*>(s_hi + r * LDN + n) = hi;
        *reinterpret_cast<uint32_t*>(s_lo + r * LDN + n) = lo;
      }
      __syncthreads();
      const __nv_bfloat16* xtb = xt + buf * JT * LDP;
#pragma unroll
      for (int ks = 0; ks < JT / 16; ++ks) {
        uint32_t af[4];             // x^T: rows p of this warp, columns j
        tc::ldmatrix_x4_trans(
            af, xtb + (ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * LDP +
                    16 * warp + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < NM / 16; ++np) {
          const int off = (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                          np * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          tc::ldmatrix_x4_trans(r, s_hi + off);
          tc::mma(st[2 * np], af, r[0], r[1]);
          tc::mma(st[2 * np + 1], af, r[2], r[3]);
          tc::ldmatrix_x4_trans(r, s_lo + off);
          tc::mma(st[2 * np], af, r[0], r[1]);
          tc::mma(st[2 * np + 1], af, r[2], r[3]);
        }
      }
      __syncthreads();               // B w and this buffer are free
      buf ^= 1;
    }
  }

  // state_out[b][h][p][n], f32
  float* so = state_out + (static_cast<size_t>(b) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < NTS; ++nt) {
    const int n = 8 * nt + 2 * t4;
    if (n >= N) continue;
    if (sp < P)
      *reinterpret_cast<float2*>(so + static_cast<size_t>(sp) * N + n) =
          make_float2(st[nt][0], st[nt][1]);
    if (sp + 8 < P)
      *reinterpret_cast<float2*>(so + static_cast<size_t>(sp + 8) * N + n) =
          make_float2(st[nt][2], st[nt][3]);
  }
}

template <int PM>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* state,
                   int nb, int S, int H, int P, int N, int L, long long x_ts,
                   long long b_ts, long long c_ts, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = tc::set_smem_once(
      reinterpret_cast<const void*>(ssd_tc<PM>), Cfg<PM>::BYTES, smem_set);
  if (err != cudaSuccess) return err;
  ssd_tc<PM><<<dim3(H, nb), Cfg<PM>::THREADS, Cfg<PM>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(state), S, H, P, N, L, x_ts, b_ts, c_ts);
  return cudaGetLastError();
}

}  // namespace tcr
}  // namespace

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16. x_ts, b_ts, c_ts: elements
// between consecutive tokens of x, B and C (the batch stride is S times
// that). Returns a cudaError_t (0 = launched).
extern "C" int repro_ssd_chunk_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, int nb, int S, int H, int P, int N,
    int L, long long x_ts, long long b_ts, long long c_ts, int x_dtype,
    int bc_dtype, void* stream) {
  if (nb <= 0 || S <= 0 || H <= 0 || L <= 0 || L > MAX_L || P <= 0 ||
      P > MAX_P || P % 4 || N <= 0 || N > MAX_N || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD(TX, TB) \
  launch<TX, TB>(x, dt, A, B, C, y, state, nb, S, H, P, N, L, x_ts, b_ts, c_ts, st)
  if (x_dtype == 1 && bc_dtype == 1) {
    // the tensor-core route: whole 16-byte rows, 16-byte aligned
    const bool aligned =
        P % 8 == 0 && N % 8 == 0 && x_ts % 8 == 0 && b_ts % 8 == 0 &&
        c_ts % 8 == 0 &&
        ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(B) |
          reinterpret_cast<size_t>(C) | reinterpret_cast<size_t>(y)) % 16) == 0;
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    if (P <= 64)
      return tcr::launch<64>(x, dt, A, B, C, y, state, nb, S, H, P, N, L, x_ts, b_ts, c_ts, st);
    return tcr::launch<128>(x, dt, A, B, C, y, state, nb, S, H, P, N, L, x_ts, b_ts, c_ts, st);
  }
  if (x_dtype == 0 && bc_dtype == 0) return REPRO_SSD(float, float);
  if (x_dtype == 0 && bc_dtype == 1) return REPRO_SSD(float, __nv_bfloat16);
  if (x_dtype == 1 && bc_dtype == 0) return REPRO_SSD(__nv_bfloat16, float);
#undef REPRO_SSD
  return static_cast<int>(cudaErrorInvalidValue);
}
