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
// integer, so no device scalar is read back per token. A row with no key
// writes 0, as in _decode_kernel.
//
// What bounds it on an H100: the cache bytes. At the serving path's decode
// shape (qwen2-0.5b, B=16, KH=2, D=64, bf16) one call reads
// 2 * B * KH * (pos+1) * D * 2 bytes of cache = 1.57 MB at pos = 191
// (3.35 TB/s: 0.47 us) against 4 * B * H * D * (pos+1) = 11 MFLOP. The
// time goes to latency: one DRAM round trip for the copies, then a short
// chain of products, so the design is about putting many SMs' copies in
// flight at once and keeping the chain short.
//
// Two routes, chosen by dtype alone in the C entry below:
//
// bf16 (the serving path): decode_split_tc, split-KV on the tensor cores.
// - the key axis is cut into `splits` slices of span = ceil(T / splits)
//   keys; one block per (split, kv head, batch). The wrapper
//   (kernels/decode_attention.py::splits_for) picks splits from T and
//   B * KH so that the grid covers the 132 SMs: at B=16, KH=2, T=192 it is
//   8 splits of 24 keys (256 blocks); at B=1, KH=2, T=8192 16 splits of
//   512 keys (32 blocks, the most one cluster holds). A block has 4 warps.
//   The grid depends on T, never on pos: a block whose slice
//   starts past pos copies nothing and leaves an empty partial
//   (m = -1e30, l = 0, acc = 0), so a later CUDA-graph capture can take pos
//   from the device without changing the launch;
// - the splits of one (kv head, batch) form one thread-block cluster along
//   x (cudaLaunchKernelEx; 16 splits use the H100's non-portable cluster
//   size). Each block of the cluster owns a share of the G * D outputs;
//   every block sends its partial (acc, m, l) of each share to the share's
//   owner by stores into the owner's shared memory (distributed shared
//   memory: a store does not wait, where a remote read would), and after
//   cluster.sync() each owner combines the partials it holds by the
//   log-sum-exp rule (m* = max m_i, l = sum l_i 2^(m_i - m*),
//   o = sum acc_i 2^(m_i - m*) / l). Partials never touch device memory and
//   there is no second launch. A block with an empty slice still sends its
//   empty partial and takes its share, so it does not return early; no
//   block writes into another before all have started (the first half of
//   a cluster barrier, arrived at on entry and waited for just before the
//   sends);
// - the G query heads of the group are the rows of one m16 tile (rows past
//   G are zero), loaded by each warp straight from device memory into its
//   mma A fragments; the slice is walked in chunks of 16 keys, warp w
//   taking chunks w, w + 4, ...: S = Q K^T on mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate), an online softmax per warp on the accumulator
//   fragments (scores in log2 units, one ex2 per score, keys at or past
//   min(pos + 1, T) masked by their true index), P rounded to bf16 before
//   O += P V as the reference's p.astype(v.dtype), l summed from the f32
//   probabilities;
// - K and V rows come by 16-byte cp.async straight into shared memory in
//   bf16, rows padded by 16 bytes so ldmatrix reads no bank twice; rows at
//   or past the slice's end are zero-filled (src-size 0). Each warp copies
//   its own chunks into its own ring of two slots, one chunk ahead of the
//   one in use, and waits for them with cp.async.wait_group and
//   __syncwarp: the warps never wait for each other inside the loop, and
//   no mbarrier is used (on the H100 both a block barrier per 64-key tile
//   and a cp.async arrival on an mbarrier with its wait cost more per
//   chunk than the chunk's copy and math). At the serving shape a warp
//   has at most one chunk, so all its copies are issued before its wait;
// - the warps' partials meet in shared memory (the ring's space, once
//   consumed) and are combined into the block's partial by the same rule
//   as they are sent;
// - -1e30 stands for minus infinity throughout, and no exponent forms
//   m * c - m * c: a warp's running max is finite after its first chunk
//   (each chunk it computes holds a valid key), so masked keys give
//   2^(-1e30 - m) = 0, and an empty partial's weight multiplies zeros.
//
// f32: decode_kernel, the first version on the f32 CUDA cores: one block
// per (kv head, batch) with one warp per query head, tiles of whole 32-key
// lane rows (up to 32 KB) staged as f32, probabilities kept in f32. It is
// on no serving path.
//
// Head dims 64, 112 (zamba2's shared attention block) and 128 are built.
// zamba2 decodes MHA (G = 1): one of the 16 rows of each m16 tile is live,
// and at B = 16 with 32 KV heads the grid of 512 blocks takes one split.
// At D = 112 the split route's shared memory is 70,912 B a block.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "tc.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_G = 16;          // query heads per KV head

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

template <int D>
__global__ void __launch_bounds__(32 * MAX_G)
decode_kernel(const float* __restrict__ q, const float* __restrict__ kc,
              const float* __restrict__ vc, float* __restrict__ o, int T_cap,
              int H, int KH, int pos, float scale) {
  // Each lane scores KPL keys of a tile and owns output dims lane + 32 i.
  // The tile is whole 32-key rows of lanes (up to 32 KB of f32 K and V):
  // at D = 112, 4096 / D = 36 keys would leave 4 of them unscored. The
  // output dims are ceil(D / 32) a lane with the last one guarded: D / 32
  // would drop 16 of D = 112's dims.
  constexpr int KPL = 4096 / D / 32;   // 2 at D = 64; 1 at D = 112, 128
  constexpr int BK = 32 * KPL;         // keys per tile
  constexpr int DPL = (D + 31) / 32;   // output dims per lane
  static_assert(KPL >= 1 && BK * D <= 4096, "a tile is whole lane rows");
  static_assert(DPL * 32 >= D && (DPL - 1) * 32 < D,
                "the lanes' dims cover D, each dim once");
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D];
  __shared__ float qs[MAX_G][D];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = kh * G + warp;

  const float* qp = q + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < D) qs[warp][lane + 32 * i] = qp[lane + 32 * i];

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = NEG_INF;
  float l = 0.f;

  const int n = min(pos + 1, T_cap);   // keys 0..pos
  const size_t t_stride = static_cast<size_t>(KH) * D;
  const float* kb = kc + (static_cast<size_t>(b) * T_cap * KH + kh) * D;
  const float* vb = vc + (static_cast<size_t>(b) * T_cap * KH + kh) * D;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();               // the previous tile (and qs) are ready
    for (int idx = threadIdx.x; idx < BK * D; idx += blockDim.x) {
      const int r = idx / D;
      const int c = idx % D;
      const int t = k0 + r;
      const bool in = t < n;
      ks[r][c] = in ? kb[t * t_stride + c] : 0.f;
      vs[r][c] = in ? vb[t * t_stride + c] : 0.f;
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
        for (int i = 0; i < DPL; ++i)
          if (lane + 32 * i < D) acc[i] += pj * vs[j][lane + 32 * i];
      }
    }
    m = m_new;
  }

  const float inv = 1.f / (l == 0.f ? 1.f : l);
  float* op = o + (static_cast<size_t>(b) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (lane + 32 * i < D) op[lane + 32 * i] = acc[i] * inv;
}

template <int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o,
                   int B, int T_cap, int H, int KH, int pos, float scale,
                   cudaStream_t stream) {
  const dim3 grid(KH, B);
  decode_kernel<D><<<grid, 32 * (H / KH), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<float*>(o), T_cap, H, KH,
      pos, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 route

namespace split {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int CK = 16;             // keys per chunk: one k-step of P V
constexpr int WARPS = 4;           // warps a block
constexpr int SLOTS = 2;           // chunks in a warp's ring: one in flight
constexpr int MAX_SPLITS = 16;     // the H100's largest (non-portable) cluster
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes: each warp's ring of K and V chunks, in which
// the warps' partials meet once all are consumed; the partials the
// cluster's blocks send to this block for its share of the outputs (acc,
// then m and l of every split).
template <int D>
struct Layout {
  static constexpr int LD = D + 8;       // padded bf16 row of K, V
  static constexpr int WLD = D + 8;      // padded f32 row of a warp partial
  static constexpr int RECV_ACC = 16 * D + 4 * MAX_SPLITS;   // floats
  static constexpr size_t chunk_bytes = 2 * CK * LD * sizeof(bf16);
  static constexpr size_t warp_bytes = WARPS * (16 * WLD + 2 * 16) *
                                       sizeof(float);
  static constexpr size_t recv_bytes =
      (RECV_ACC + 2 * MAX_SPLITS * 16) * sizeof(float);
  static constexpr size_t ring_bytes =
      WARPS * SLOTS * chunk_bytes > warp_bytes ? WARPS * SLOTS * chunk_bytes
                                               : warp_bytes;
  static constexpr size_t bytes = ring_bytes + recv_bytes;
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The two halves of a cluster barrier: this thread has started (no memory
// ordering), and wait for every thread of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(32 * WARPS)
decode_split_tc(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                const bf16* __restrict__ vc, bf16* __restrict__ o, int T_cap,
                int H, int KH, int pos, float scale, int span) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  // the combine moves four dims a thread, and the thread with dims
  // 4i..4i+3 of a row sends that row's m and l to block i of the cluster
  static_assert(D % 4 == 0 && D / 4 >= MAX_SPLITS,
                "every split receives m and l from one thread of a row");
  static_assert((D / 8) % 2 == 0, "O's n-tiles pair up for ldmatrix.x4");
  using L = Layout<D>;
  static_assert(L::LD % 8 == 0 && L::WLD % 4 == 0,
                "padded rows keep 16-byte alignment");
  constexpr int THREADS = 32 * WARPS;
  constexpr int LD = L::LD;
  constexpr int WLD = L::WLD;
  constexpr int KD = D / 16;       // k-steps of Q K^T
  constexpr int ND = D / 8;        // n-tiles of O
  constexpr int CPR = D / 8;       // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* recv_acc = reinterpret_cast<float*>(smem_raw + L::ring_bytes);
  float* recv_m = recv_acc + L::RECV_ACC;
  float* recv_l = recv_m + MAX_SPLITS * 16;

  // no block writes into another before that one has started (the wait
  // is just before the first such write, long after the copies)
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = gridDim.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  // this block's keys: [s0, end), cut at key pos, in chunks of CK; warp w
  // takes chunks w, w + WARPS, ...
  const int s0 = blockIdx.x * span;
  const int end = min(s0 + span, min(pos + 1, T_cap));
  const int nchunks = end > s0 ? (end - s0 + CK - 1) / CK : 0;
  const int mine = nchunks > warp ? (nchunks - warp + WARPS - 1) / WARPS : 0;

  const size_t kv_ts = static_cast<size_t>(KH) * D;
  const bf16* qb = q + (static_cast<size_t>(b) * H + kh * G) * D;
  const bf16* kb = kc + (static_cast<size_t>(b) * T_cap * KH + kh) * D;
  const bf16* vb = vc + (static_cast<size_t>(b) * T_cap * KH + kh) * D;

  // this warp's chunk j: keys s0 + CK (warp + WARPS j).., in its ring slot
  // j % SLOTS; keys at or past end are zero-filled
  bf16* wring = ring + warp * SLOTS * 2 * CK * LD;
  auto load_chunk = [&](int j) {
    const int k0 = s0 + CK * (warp + WARPS * j);
    bf16* kd = wring + (j % SLOTS) * 2 * CK * LD;
    bf16* vd = kd + CK * LD;
#pragma unroll
    for (int c = lane; c < CK * CPR; c += 32) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const bool in = k0 + r < end;
      const size_t off = static_cast<size_t>(in ? k0 + r : s0) * kv_ts + col;
      tc::cp_async16(kd + r * LD + col, kb + off, in);
      tc::cp_async16(vd + r * LD + col, vb + off, in);
    }
    tc::cp_async_commit();
  };
  if (mine > 0) load_chunk(0);

  const float mul = scale * LOG2E;   // scores in log2 units
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};           // this lane's part of the row sums

  // Q straight from device memory into the A fragments (rows g and g + 8
  // of the m16 tile, rows past G zero): no shared memory, no barrier
  if (mine > 0) {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(qb + g * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(qb + (g + 8) * D);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = (kk * 16 + 2 * t4) / 2;   // in pairs of bf16
      qf[kk][0] = g < G ? __ldg(q0 + c) : 0u;
      qf[kk][1] = g + 8 < G ? __ldg(q1 + c) : 0u;
      qf[kk][2] = g < G ? __ldg(q0 + c + 4) : 0u;
      qf[kk][3] = g + 8 < G ? __ldg(q1 + c + 4) : 0u;
    }
  }
  // the warps run their chunks on their own: no block barrier in the loop
  for (int j = 0; j < mine; ++j) {
    if (j + 1 < mine) {
      __syncwarp();                // the slot's last chunk is consumed
      load_chunk(j + 1);
    }
    // chunk j has landed once at most the chunk after it is in flight;
    // then every lane's copies of it are visible to the warp
    if (j + 1 < mine)
      tc::cp_async_wait<1>();
    else
      tc::cp_async_wait<0>();
    __syncwarp();
    const int kb0 = s0 + CK * (warp + WARPS * j);   // first key, < end
    const bf16* kt = wring + (j % SLOTS) * 2 * CK * LD;
    const bf16* vt = kt + CK * LD;
    // S = Q K^T for the 16 rows and the chunk's 16 keys
    float s[2][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[h2][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t r[4];
      tc::ldmatrix_x4(r, kt + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8);
      tc::mma(s[0], qf[kk], r[0], r[1]);
      tc::mma(s[1], qf[kk], r[2], r[3]);
    }
    const bool edge = kb0 + CK > end;   // the slice's last, ragged chunk
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kb0 + h2 * 8 + 2 * t4 + (c & 1);
        const float x = edge && key >= end ? NEG_INF : s[h2][c] * mul;
        s[h2][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);   // finite: key kb0 is valid
      alpha[r] = exp2_approx(m[r] - m_new);
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
    // P in f32 for the sums, rounded to bf16 as the A fragment of P V
    uint32_t pf[4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const float p0 = exp2_approx(s[h2][0] - m[0]);
      const float p1 = exp2_approx(s[h2][1] - m[0]);
      const float p2 = exp2_approx(s[h2][2] - m[1]);
      const float p3 = exp2_approx(s[h2][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[2 * h2] = tc::pack_bf16(p0, p1);
      pf[2 * h2 + 1] = tc::pack_bf16(p2, p3);
    }
    // O += P V
#pragma unroll
    for (int dp = 0; dp < ND / 2; ++dp) {
      uint32_t r[4];
      tc::ldmatrix_x4_trans(r, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                        LD + dp * 16 + (lane >> 4) * 8);
      tc::mma(acc[2 * dp], pf, r[0], r[1]);
      tc::mma(acc[2 * dp + 1], pf, r[2], r[3]);
    }
  }

  // the warps' partials, in the ring's space once every warp is done
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(ring);
  float* wm = wacc + WARPS * 16 * WLD;
  float* wl = wm + WARPS * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* wa = wacc + warp * 16 * WLD;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<float2*>(wa + g * WLD + n * 8 + 2 * t4) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(wa + (g + 8) * WLD + n * 8 + 2 * t4) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (t4 == 0) {
    wm[warp * 16 + g] = m[0];
    wm[warp * 16 + g + 8] = m[1];
    wl[warp * 16 + g] = l[0];
    wl[warp * 16 + g + 8] = l[1];
  }
  __syncthreads();

  // The block's partial: the warps' partials by the log-sum-exp rule (a
  // warp that saw no key has l = 0, acc = 0; a block that saw none sends
  // m = -1e30, l = 0, acc = 0). Output element e = r * D + d belongs to
  // block e / per of the cluster, which receives every block's partial of
  // it: the sends are stores into the owners' shared memory (distributed
  // shared memory), so no block waits on a remote read. The thread with
  // dims 4i..4i+3 of row r also sends row r's m and l to block i.
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (G * D + 4 * nsplit - 1) / (4 * nsplit) * 4;
  cluster_wait();
  for (int j = tid; j < G * D / 4; j += THREADS) {
    const int e = 4 * j, r = e / D, d = e % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * 16 + r]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2_approx(wm[w * 16 + r] - mx);
      const float4 x =
          *reinterpret_cast<const float4*>(wacc + (w * 16 + r) * WLD + d);
      a.x += x.x * wt;
      a.y += x.y * wt;
      a.z += x.z * wt;
      a.w += x.w * wt;
      ls += wl[w * 16 + r] * wt;
    }
    *reinterpret_cast<float4*>(cluster.map_shared_rank(recv_acc, e / per) +
                               rank * per + e % per) = a;
    if (d / 4 < nsplit) {
      cluster.map_shared_rank(recv_m, d / 4)[rank * 16 + r] = mx;
      cluster.map_shared_rank(recv_l, d / 4)[rank * 16 + r] = ls;
    }
  }
  cluster.sync();   // every block's partial has landed with its owners

  // this block's share of the outputs, four dims a thread, from the
  // partials in its own shared memory; no block touches another's after
  // the barrier, so each may leave when done
  for (int j = tid; j < per / 4; j += THREADS) {
    const int e = rank * per + 4 * j;
    if (e >= G * D) break;
    const int r = e / D, d = e % D;
    float mx = NEG_INF;
    for (int i = 0; i < nsplit; ++i) mx = fmaxf(mx, recv_m[i * 16 + r]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
    for (int i = 0; i < nsplit; ++i) {
      const float wt = exp2_approx(recv_m[i * 16 + r] - mx);
      const float4 x =
          *reinterpret_cast<const float4*>(recv_acc + i * per + 4 * j);
      a.x += x.x * wt;
      a.y += x.y * wt;
      a.z += x.z * wt;
      a.w += x.w * wt;
      ls += recv_l[i * 16 + r] * wt;
    }
    const float inv = 1.f / (ls == 0.f ? 1.f : ls);
    *reinterpret_cast<uint2*>(
        o + (static_cast<size_t>(b) * H + kh * G + r) * D + d) =
        make_uint2(tc::pack_bf16(a.x * inv, a.y * inv),
                   tc::pack_bf16(a.z * inv, a.w * inv));
  }
}

// The kernel's dynamic shared memory and non-portable cluster size, set
// once per device; then the launch configuration of a grid of `splits`
// blocks a cluster.
template <int D>
cudaError_t prepare(int splits, int KH, int B, cudaStream_t stream,
                    cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  using L = Layout<D>;
  if (splits < 1 || splits > MAX_SPLITS) return cudaErrorInvalidValue;
  const void* kernel = reinterpret_cast<const void*>(decode_split_tc<D>);
  static std::atomic<unsigned long long> smem_set{0}, cluster_set{0};
  cudaError_t err = tc::set_smem_once(kernel, L::bytes, smem_set);
  if (err == cudaSuccess)
    err = tc::set_attr_once(kernel,
                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1,
                            cluster_set);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(splits, KH, B);
  cfg->blockDim = dim3(32 * WARPS);
  cfg->dynamicSmemBytes = L::bytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* o,
                   int B, int T_cap, int H, int KH, int pos, float scale,
                   int splits, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare<D>(splits, KH, B, stream, attr, &cfg);
  if (err != cudaSuccess) return err;
  const int span = (T_cap + splits - 1) / splits;
  err = cudaLaunchKernelEx(
      &cfg, decode_split_tc<D>, static_cast<const bf16*>(q),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<bf16*>(o), T_cap, H, KH, pos, scale, span);
  const cudaError_t last = cudaGetLastError();   // clear it either way
  return err != cudaSuccess ? err : last;
}

// How many clusters of `splits` blocks can be resident on the card at once
// (0: a launch with that many splits cannot run).
template <int D>
cudaError_t max_clusters(int splits, int* out) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = prepare<D>(splits, 1, 1, 0, attr, &cfg);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(decode_split_tc<D>), &cfg);
}

}  // namespace split
}  // namespace

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (split-KV tensor-core
// route: `splits` blocks a cluster; the f32 route ignores it). Returns a
// cudaError_t (0 = launched).
extern "C" int repro_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, void* o, int B,
    int T_cap, int H, int KH, int D, int dtype, int pos, float scale,
    int splits, void* stream) {
  if (B <= 0 || T_cap <= 0 || KH <= 0 || H % KH != 0 || H / KH > MAX_G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<64>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos, scale, st);
  if (dtype == 0 && D == 112)
    return launch<112>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos, scale, st);
  if (dtype == 0 && D == 128)
    return launch<128>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos, scale, st);
  if (dtype == 1 && D == 64)
    return split::launch<64>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos,
                             scale, splits, st);
  if (dtype == 1 && D == 112)
    return split::launch<112>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos,
                              scale, splits, st);
  if (dtype == 1 && D == 128)
    return split::launch<128>(q, k_cache, v_cache, o, B, T_cap, H, KH, pos,
                              scale, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 route's resident clusters of `splits` blocks at head dim D
// (cudaOccupancyMaxActiveClusters) into *out. Returns a cudaError_t.
extern "C" int repro_decode_max_active_clusters(int D, int splits, int* out) {
  if (D == 64) return split::max_clusters<64>(splits, out);
  if (D == 112) return split::max_clusters<112>(splits, out);
  if (D == 128) return split::max_clusters<128>(splits, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared by both kernels' wrappers to name a failed launch.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
