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
// Design (simple first):
// - the TPU grid's sequential chunk axis becomes a loop inside one block per
//   (h, b), 256 threads; the state lives in shared memory as S[n][p];
// - a ragged last chunk is masked by its true length lc (the TPU wrapper pads
//   with dt = 0, which means decay 1 and no state update: the same result);
// - the (L, L) score matrix (256 KB in f32 at L = 256, more than a block's
//   227 KB) is never held whole: rows of the chunk go in tiles of 64, and for
//   each row tile only the column tiles at or left of the diagonal are
//   computed, 64 x 64 at a time, from C and B tiles held transposed (n-major)
//   in shared memory;
// - above the diagonal nothing is computed: exp(cs_i - cs_j) may overflow to
//   inf there and inf * 0 is NaN, so those entries are set to 0, not masked
//   by a multiply; tails past lc are loaded as zeros for the same reason;
// - the whole chunk's y is computed from S_in before S is updated, so the
//   state update needs no second buffer;
// - every product runs on the f32 CUDA cores, each thread owning 4 x 4
//   output tiles and reading 16-byte vectors from shared memory.
//
// What bounds it on an H100: at the mamba2-2.7b prefill shape (nb = 16,
// S = 512, H = 80, P = 64, N = 128, L = 256; x, B, C bf16) the function must
// move x + y (83.9 MB each) + the final state (41.9 MB) + dt (2.6 MB) + B and
// C (4.2 MB) = 216 MB (3.35 TB/s: 0.065 ms) and do, counting the causal half
// of each chunk's scores, 53.8 GFLOP (989 TFLOP/s bf16: 0.054 ms), so the
// bytes bound it; on the f32 CUDA cores this kernel uses (67 TFLOP/s) the
// same work takes at least 0.80 ms.
//
// What this simple design leaves on the table: the tensor cores (mma.sync /
// wgmma with a split-precision f32 product), C B^T shared across the 80 heads
// (it is recomputed per head, as the TPU kernel does), 16-byte or TMA global
// loads with a second tile in flight, the wasted upper half of each diagonal
// tile, and occupancy (138 KB of shared memory at the path's shape: one
// block of 8 warps per SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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
  const size_t smem = smem_floats(P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_kernel<TX, TB><<<dim3(H, nb), THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TB*>(Bm),
      static_cast<const TB*>(Cm), static_cast<TX*>(y),
      static_cast<float*>(state), S, H, P, N, L, x_ts, b_ts, c_ts);
  return cudaGetLastError();
}

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
  if (x_dtype == 0 && bc_dtype == 0) return REPRO_SSD(float, float);
  if (x_dtype == 0 && bc_dtype == 1) return REPRO_SSD(float, __nv_bfloat16);
  if (x_dtype == 1 && bc_dtype == 0) return REPRO_SSD(__nv_bfloat16, float);
  if (x_dtype == 1 && bc_dtype == 1) return REPRO_SSD(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_SSD
  return static_cast<int>(cudaErrorInvalidValue);
}
