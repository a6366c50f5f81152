// Flash attention for heads wider than the Hopper kernels' 128-column tiles
// (sm_90a): the forward, the ring hop's partial forward, and the dQ and dK/dV
// backward, for every head dim that is a multiple of 8 from 136 up to
// kMaxHeadDim, in bfloat16 and float32.
//
// Replaces, for those head dims, the TPU kernels of
// kubeflow_tpu/ops/flash_attention.py: _fwd_kernel (launched by _flash_fwd),
// _partial_kernel (flash_attention_partial), _bwd_dq_kernel and
// _bwd_dkv_kernel (both launched by _flash_bwd). Their block specs span all
// of d, so the TPU kernels take any head dim; flash_attention_fwd.cu and
// flash_attention_bwd.cu stop at 128 columns. The function and its rounding
// points are theirs: scores, P, dP, dS and every accumulator in f32; masked
// scores at -1e30 (their probabilities exactly 0); P rounded to V's dtype
// before P V; in the backward P = exp(S * scale - lse) from the forward's
// lse, dS = P * (dP - delta), P rounded to dO's dtype before P^T dO and dS to
// the input dtype before dS K and dS^T Q, scale on the f32 products; lse,
// delta, m and l f32 [b*h, s]; a row that no key reaches is acc = 0,
// m = -1e30, l = 0 (the partial) or a zero gradient. The causal mask is
// global: query row i sits at q_offset + i and key j at k_offset + j.
//
// Bounds on an H100 SXM (989 TFLOP/s dense bf16, 67 TFLOP/s f32 outside
// the tensor cores, 3.35 TB/s) at the timed shape [8, 1024, 16, 256] bf16,
// causal: the forward's QK^T and PV are 68.8 GFLOP (70 us at the bf16 peak)
// against 268 MB of q, k, v and o (80 us): bound by bytes. The dQ kernel
// (three products, 103.2 GFLOP) moves 403 MB (120 us, bound by bytes), the
// dK/dV kernel (four, 137.6 GFLOP, 139 us) is bound by operations. This
// kernel does not reach those bounds: it is the simple, correct path for a
// head dim no configuration of the repo's main paths uses, and it does
// every product with FMA on the CUDA cores, which at 67 TFLOP/s alone
// would take 1-2 ms for them. What bounds it is shared memory: each FMA
// reads one operand from it (PERF.md has its times: slower than the plain
// PyTorch version, which runs its products on the tensor cores).
//
// What the design does:
//  * One CTA of 128 threads (4 warps) per (b*h, 16 owned rows): query rows
//    for the forward, the partial and dQ, key rows for dK/dV. The owned
//    rows' inputs (Q; Q and dO; K and V) and their f32 accumulators (O; dQ;
//    dK and dV) stay in shared memory at full width for the whole loop.
//  * The other side streams in tiles of 32 rows (a warp's lanes: lane j
//    takes streamed row j), each read through its strides in chunks of 64
//    columns into a [32][65] f32 buffer (the pitch of 65 keeps lane j's
//    column i off the other lanes' banks), rows and columns past the edge
//    as zeros. A chunk is read once for the scores and once more for the
//    products that follow the softmax.
//  * Scores: warp w holds owned rows 4w .. 4w + 3 against the 32 streamed
//    rows, so the row max and row sum of the online softmax are warp
//    shuffles, and the softmax statistics stay in registers.
//  * Products into the accumulators: thread t takes column t % 64 of a
//    chunk for 8 of the 16 owned rows, with the chunk's 32 streamed values
//    of that column in registers and P or dS read as shared-memory
//    broadcasts.
//  * Shared memory (f32): forward 128 d + 10,624 bytes, dQ 192 d + 18,752,
//    dK/dV 256 d + 20,864. The dK/dV kernel's sets the cap: at d = 824 it
//    takes 231,808 of the 232,448 bytes a CTA may have.
//  * Two kernels for the backward and no atomics: the result is
//    deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kOwn = 16;               // owned rows a CTA
constexpr int kRowsPerWarp = kOwn / kWarps;
constexpr int kStream = 32;            // streamed rows a tile: a warp's lanes
constexpr int kChunk = 64;             // columns a streamed chunk
constexpr int kPitch = kChunk + 1;     // floats a chunk row in shared memory
constexpr int kTilePitch = kStream + 1;  // floats a P / dS row
constexpr int kColThreads = kChunk;    // threads on one chunk column set
constexpr int kRowGroups = kThreads / kColThreads;  // 2
constexpr int kRowsPerGroup = kOwn / kRowGroups;    // 8
constexpr int kMaxSmem = 232448;       // bytes a CTA may have on sm_90

constexpr int fwd_smem(int d) {
  return 4 * (2 * kOwn * d + kStream * kPitch + kOwn * kTilePitch + 3 * kOwn);
}
constexpr int dq_smem(int d) {
  return 4 * (3 * kOwn * d + 2 * kStream * kPitch + kOwn * kTilePitch);
}
constexpr int dkv_smem(int d) {
  return 4 * (4 * kOwn * d + 2 * kStream * kPitch + 2 * kOwn * kTilePitch);
}
// The widest head, a multiple of 8, whose dK/dV CTA fits (the largest of
// the three footprints).
constexpr int kMaxHeadDim = (kMaxSmem - dkv_smem(0)) / (4 * 4 * kOwn) / 8 * 8;
static_assert(kMaxHeadDim == 824, "the cap ops/flash_attention.py states");
static_assert(dkv_smem(kMaxHeadDim) <= kMaxSmem &&
                  fwd_smem(kMaxHeadDim) <= kMaxSmem &&
                  dq_smem(kMaxHeadDim) <= kMaxSmem,
              "every kernel fits at the cap");

// The tensors whose (batch, seq, head) strides a launch is given, in
// elements; the head_dim stride is 1.
enum Tensor { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // dQ: read for delta; the forward writes it (o_out)
  const void* dout;
  const float* lse;  // the backward's input
  float* delta;      // dQ writes it when compute_delta
  void* o_out;       // the forward: q's dtype; the partial: f32 acc
  float* lse_out;    // the forward
  float* m;          // the partial
  float* l;          // the partial
  void* dq;
  void* dk;
  void* dv;
  int b, s_q, s_k, h, d;
  long long st[kTensors][3];
  float scale;
  int causal, q_offset, k_offset, compute_delta, partial;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x as the nearest value of T (round to nearest even, as torch's casts).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Row `row` of head (bi, hi) of tensor `which`.
template <typename T>
__device__ __forceinline__ const T* row_of(const void* base, const Params& p,
                                           int which, int bi, int hi,
                                           int row) {
  return static_cast<const T*>(base) + bi * p.st[which][0] +
         hi * p.st[which][2] + static_cast<long long>(row) * p.st[which][1];
}

template <typename T>
__device__ __forceinline__ T* out_row_of(void* base, const Params& p,
                                         int which, int bi, int hi, int row) {
  return static_cast<T*>(base) + bi * p.st[which][0] + hi * p.st[which][2] +
         static_cast<long long>(row) * p.st[which][1];
}

// The owned rows [r0, r0 + kOwn) of one head of `which` into `dst`
// ([kOwn][d] f32), rows past `rows` as zeros.
template <typename T>
__device__ __forceinline__ void load_owned(float* dst, const void* base,
                                           const Params& p, int which, int bi,
                                           int hi, int r0, int rows) {
  for (int idx = threadIdx.x; idx < kOwn * p.d; idx += kThreads) {
    const int r = idx / p.d, i = idx % p.d;
    dst[idx] = r0 + r < rows ? load(row_of<T>(base, p, which, bi, hi,
                                              r0 + r) + i)
                             : 0.f;
  }
}

// Columns [c0, c0 + kChunk) of the streamed rows [n0, n0 + kStream) of one
// head of `which` into `dst` ([kStream][kPitch] f32), rows past `rows` and
// columns past d as zeros.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const void* base,
                                           const Params& p, int which, int bi,
                                           int hi, int n0, int rows, int c0) {
  for (int idx = threadIdx.x; idx < kStream * kChunk; idx += kThreads) {
    const int r = idx / kChunk, c = idx % kChunk;
    const bool in = n0 + r < rows && c0 + c < p.d;
    dst[r * kPitch + c] =
        in ? load(row_of<T>(base, p, which, bi, hi, n0 + r) + c0 + c) : 0.f;
  }
}

__device__ __forceinline__ int chunk_cols(const Params& p, int c0) {
  return min(kChunk, p.d - c0);
}

// Whether query `qi` sees key `kj` (both local indices).
__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return qi < p.s_q && kj < p.s_k &&
         !(p.causal && p.k_offset + kj > p.q_offset + qi);
}

// acc[r][c0 + col] += sum_j tile[r][j] * chunk[j][col] for this thread's
// column and its 8 owned rows: the product of a [kOwn][kStream] tile of P
// or dS with a chunk of the streamed rows.
__device__ __forceinline__ void accumulate(float* acc, const float* tile,
                                           const float* chunk, int d, int c0,
                                           int cols) {
  const int col = threadIdx.x % kColThreads;
  const int group = threadIdx.x / kColThreads;
  if (col >= cols) return;
  float b[kStream];
#pragma unroll
  for (int j = 0; j < kStream; ++j) b[j] = chunk[j * kPitch + col];
#pragma unroll 2
  for (int rr = 0; rr < kRowsPerGroup; ++rr) {
    const int r = group * kRowsPerGroup + rr;
    float a = acc[r * d + c0 + col];
#pragma unroll
    for (int j = 0; j < kStream; ++j) a = fmaf(tile[r * kTilePitch + j], b[j], a);
    acc[r * d + c0 + col] = a;
  }
}

// The CTA's (b*h, owned tile), heaviest causal tiles first when
// `last_first` (the forward's and dQ's last query tiles see the most keys).
struct Tile {
  int bh, bi, hi, r0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int rows,
                                        bool last_first) {
  const int tiles = (rows + kOwn - 1) / kOwn;
  const int bh = blockIdx.x / tiles, t = blockIdx.x % tiles;
  return {bh, bh / p.h, bh % p.h, (last_first ? tiles - 1 - t : t) * kOwn};
}

// ------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kOwn][d]
  float* os = qs + kOwn * p.d;               // [kOwn][d] f32 acc
  float* kv = os + kOwn * p.d;               // [kStream][kPitch]
  float* ps = kv + kStream * kPitch;         // [kOwn][kTilePitch]
  float* corr = ps + kOwn * kTilePitch;      // [kOwn]
  float* fin_m = corr + kOwn;
  float* fin_l = fin_m + kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tile t = tile_of(p, p.s_q, p.causal);

  load_owned<T>(qs, p.q, p, kQ, t.bi, t.hi, t.r0, p.s_q);
  for (int idx = threadIdx.x; idx < kOwn * p.d; idx += kThreads) os[idx] = 0.f;
  __syncthreads();

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m_run[j] = kNegBig;
    l_run[j] = 0.f;
  }
  // Keys [0, n_end) reach some row of the tile.
  const int last = min(t.r0 + kOwn, p.s_q) - 1;
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + last - p.k_offset + 1))
               : p.s_k;
  for (int n0 = 0; n0 < n_end; n0 += kStream) {
    float s[kRowsPerWarp] = {};
    for (int c0 = 0; c0 < p.d; c0 += kChunk) {
      load_chunk<T>(kv, p.k, p, kK, t.bi, t.hi, n0, p.s_k, c0);
      __syncthreads();
      const int cols = chunk_cols(p, c0);
      for (int i = 0; i < cols; ++i) {
        const float kval = kv[lane * kPitch + i];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          s[j] = fmaf(qs[r * p.d + c0 + i], kval, s[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp * kRowsPerWarp + j;
      const bool live = visible(p, t.r0 + r, n0 + lane);
      const float x = live ? s[j] * p.scale : kNegBig;
      const float m_new = fmaxf(m_run[j], warp_max(x));
      const float pr = live ? expf(x - m_new) : 0.f;
      const float c = expf(m_run[j] - m_new);
      l_run[j] = l_run[j] * c + warp_sum(pr);
      m_run[j] = m_new;
      ps[r * kTilePitch + lane] = round_to<T>(pr);
      if (lane == 0) corr[r] = c;
    }
    __syncthreads();
    for (int c0 = 0; c0 < p.d; c0 += kChunk) {
      load_chunk<T>(kv, p.v, p, kV, t.bi, t.hi, n0, p.s_k, c0);
      __syncthreads();
      const int col = threadIdx.x % kColThreads;
      const int group = threadIdx.x / kColThreads;
      if (col < chunk_cols(p, c0)) {  // the O rescale, once per tile
        for (int rr = 0; rr < kRowsPerGroup; ++rr) {
          const int r = group * kRowsPerGroup + rr;
          os[r * p.d + c0 + col] *= corr[r];
        }
      }
      accumulate(os, ps, kv, p.d, c0, chunk_cols(p, c0));
      __syncthreads();
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      fin_m[warp * kRowsPerWarp + j] = m_run[j];
      fin_l[warp * kRowsPerWarp + j] = l_run[j];
    }
  }
  __syncthreads();
  const int rows = min(kOwn, p.s_q - t.r0);
  for (int idx = threadIdx.x; idx < rows * p.d; idx += kThreads) {
    const int r = idx / p.d, i = idx % p.d;
    if (p.partial) {
      // A row no key reaches has acc 0, m -1e30 and l 0 as it stands.
      *(out_row_of<float>(p.o_out, p, kO, t.bi, t.hi, t.r0 + r) + i) =
          os[idx];
    } else {
      store(out_row_of<T>(p.o_out, p, kO, t.bi, t.hi, t.r0 + r) + i,
            os[idx] / fmaxf(fin_l[r], 1e-30f));
    }
  }
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    const long long at = static_cast<long long>(t.bh) * p.s_q + t.r0 + r;
    if (p.partial) {
      p.m[at] = fin_m[r];
      p.l[at] = fin_l[r];
    } else {
      p.lse_out[at] = fin_m[r] + logf(fmaxf(fin_l[r], 1e-30f));
    }
  }
}

// ------------------------------------------------------------- backward

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kOwn][d]
  float* dos = qs + kOwn * p.d;              // [kOwn][d]
  float* dqs = dos + kOwn * p.d;             // [kOwn][d] f32 acc
  float* kc = dqs + kOwn * p.d;              // [kStream][kPitch]
  float* vc = kc + kStream * kPitch;         // [kStream][kPitch]
  float* dss = vc + kStream * kPitch;        // [kOwn][kTilePitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tile t = tile_of(p, p.s_q, p.causal);

  load_owned<T>(qs, p.q, p, kQ, t.bi, t.hi, t.r0, p.s_q);
  load_owned<T>(dos, p.dout, p, kDO, t.bi, t.hi, t.r0, p.s_q);
  for (int idx = threadIdx.x; idx < kOwn * p.d; idx += kThreads) {
    dqs[idx] = 0.f;
  }
  __syncthreads();

  float lse[kRowsPerWarp], delta[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j, row = t.r0 + r;
    const long long at = static_cast<long long>(t.bh) * p.s_q + row;
    lse[j] = row < p.s_q ? p.lse[at] : 0.f;
    if (p.compute_delta) {
      float part = 0.f;
      if (row < p.s_q) {
        const T* o = row_of<T>(p.o, p, kO, t.bi, t.hi, row);
        for (int i = lane; i < p.d; i += 32) {
          part = fmaf(dos[r * p.d + i], load(o + i), part);
        }
      }
      delta[j] = warp_sum(part);
      if (lane == 0 && row < p.s_q) p.delta[at] = delta[j];
    } else {
      delta[j] = row < p.s_q ? p.delta[at] : 0.f;
    }
  }

  const int last = min(t.r0 + kOwn, p.s_q) - 1;
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + last - p.k_offset + 1))
               : p.s_k;
  for (int n0 = 0; n0 < n_end; n0 += kStream) {
    float s[kRowsPerWarp] = {}, dp[kRowsPerWarp] = {};
    for (int c0 = 0; c0 < p.d; c0 += kChunk) {
      load_chunk<T>(kc, p.k, p, kK, t.bi, t.hi, n0, p.s_k, c0);
      load_chunk<T>(vc, p.v, p, kV, t.bi, t.hi, n0, p.s_k, c0);
      __syncthreads();
      const int cols = chunk_cols(p, c0);
      for (int i = 0; i < cols; ++i) {
        const float kval = kc[lane * kPitch + i];
        const float vval = vc[lane * kPitch + i];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          s[j] = fmaf(qs[r * p.d + c0 + i], kval, s[j]);
          dp[j] = fmaf(dos[r * p.d + c0 + i], vval, dp[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp * kRowsPerWarp + j;
      const float pr = visible(p, t.r0 + r, n0 + lane)
                           ? expf(s[j] * p.scale - lse[j])
                           : 0.f;
      dss[r * kTilePitch + lane] = round_to<T>(pr * (dp[j] - delta[j]));
    }
    __syncthreads();
    for (int c0 = 0; c0 < p.d; c0 += kChunk) {
      load_chunk<T>(kc, p.k, p, kK, t.bi, t.hi, n0, p.s_k, c0);
      __syncthreads();
      accumulate(dqs, dss, kc, p.d, c0, chunk_cols(p, c0));
      __syncthreads();
    }
  }

  const int rows = min(kOwn, p.s_q - t.r0);
  for (int idx = threadIdx.x; idx < rows * p.d; idx += kThreads) {
    const int r = idx / p.d, i = idx % p.d;
    store(out_row_of<T>(p.dq, p, kDQ, t.bi, t.hi, t.r0 + r) + i,
          dqs[idx] * p.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  float* ks = smem;                          // [kOwn][d] owned keys
  float* vs = ks + kOwn * p.d;
  float* dks = vs + kOwn * p.d;              // f32 accs
  float* dvs = dks + kOwn * p.d;
  float* qc = dvs + kOwn * p.d;              // [kStream][kPitch]
  float* dc = qc + kStream * kPitch;         // [kStream][kPitch]
  float* ps = dc + kStream * kPitch;         // [kOwn][kTilePitch] P^T
  float* dss = ps + kOwn * kTilePitch;       // [kOwn][kTilePitch] dS^T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tile t = tile_of(p, p.s_k, false);

  load_owned<T>(ks, p.k, p, kK, t.bi, t.hi, t.r0, p.s_k);
  load_owned<T>(vs, p.v, p, kV, t.bi, t.hi, t.r0, p.s_k);
  for (int idx = threadIdx.x; idx < kOwn * p.d; idx += kThreads) {
    dks[idx] = 0.f;
    dvs[idx] = 0.f;
  }
  __syncthreads();

  const float* lse = p.lse + static_cast<long long>(t.bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(t.bh) * p.s_q;
  // Under the causal mask, the queries at or after the first key's
  // position.
  const int m_begin =
      p.causal ? min(p.s_q, max(0, p.k_offset + t.r0 - p.q_offset)) : 0;
  for (int m0 = m_begin; m0 < p.s_q; m0 += kStream) {
    float s[kRowsPerWarp] = {}, dp[kRowsPerWarp] = {};
    for (int c0 = 0; c0 < p.d; c0 += kChunk) {
      load_chunk<T>(qc, p.q, p, kQ, t.bi, t.hi, m0, p.s_q, c0);
      load_chunk<T>(dc, p.dout, p, kDO, t.bi, t.hi, m0, p.s_q, c0);
      __syncthreads();
      const int cols = chunk_cols(p, c0);
      for (int i = 0; i < cols; ++i) {
        const float qval = qc[lane * kPitch + i];
        const float dval = dc[lane * kPitch + i];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          s[j] = fmaf(ks[r * p.d + c0 + i], qval, s[j]);
          dp[j] = fmaf(vs[r * p.d + c0 + i], dval, dp[j]);
        }
      }
      __syncthreads();
    }
    const int qi = m0 + lane;
    const float lse_q = qi < p.s_q ? lse[qi] : 0.f;
    const float delta_q = qi < p.s_q ? delta[qi] : 0.f;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp * kRowsPerWarp + j;
      const float pr = visible(p, qi, t.r0 + r)
                           ? expf(s[j] * p.scale - lse_q)
                           : 0.f;
      ps[r * kTilePitch + lane] = round_to<T>(pr);
      dss[r * kTilePitch + lane] = round_to<T>(pr * (dp[j] - delta_q));
    }
    __syncthreads();
    for (int c0 = 0; c0 < p.d; c0 += kChunk) {
      load_chunk<T>(qc, p.q, p, kQ, t.bi, t.hi, m0, p.s_q, c0);
      load_chunk<T>(dc, p.dout, p, kDO, t.bi, t.hi, m0, p.s_q, c0);
      __syncthreads();
      const int cols = chunk_cols(p, c0);
      accumulate(dvs, ps, dc, p.d, c0, cols);
      accumulate(dks, dss, qc, p.d, c0, cols);
      __syncthreads();
    }
  }

  const int rows = min(kOwn, p.s_k - t.r0);
  for (int idx = threadIdx.x; idx < rows * p.d; idx += kThreads) {
    const int r = idx / p.d, i = idx % p.d;
    store(out_row_of<T>(p.dk, p, kDK, t.bi, t.hi, t.r0 + r) + i,
          dks[idx] * p.scale);
    store(out_row_of<T>(p.dv, p, kDV, t.bi, t.hi, t.r0 + r) + i, dvs[idx]);
  }
}

// ------------------------------------------------------------------ launch

int launch_kernel(void (*kernel)(Params), const Params& p, int rows,
                  int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ctas =
      static_cast<long long>(p.b) * p.h * ((rows + kOwn - 1) / kOwn);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool takes(int d, int dtype, int s_q, int s_k) {
  return d >= 8 && d <= kMaxHeadDim && d % 8 == 0 &&
         (dtype == 0 || dtype == 1) && s_q >= 1 && s_k >= 1;
}

Params make_params(int b, int s_q, int s_k, int h, int d,
                   const long long* strides, float scale, int causal,
                   int q_offset, int k_offset) {
  Params p{};
  p.b = b;
  p.s_q = s_q;
  p.s_k = s_k;
  p.h = h;
  p.d = d;
  for (int i = 0; i < kTensors; ++i) {
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[i * 3 + j];
  }
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds the (batch, seq, head)
// strides in elements of q, k, v, o, dO, dQ, dK, dV, in that order (24
// values; those of tensors a launch does not touch are ignored). Each
// returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`. The head dim d is a multiple of 8 up to
// kftpu_wide_max_head_dim().

extern "C" int kftpu_wide_max_head_dim() { return kMaxHeadDim; }

// The forward (partial = 0: o in q's dtype, lse) or the ring hop's partial
// (partial = 1, causal: o the f32 unnormalized accumulator, m and l).
extern "C" int kftpu_wide_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, float* m, float* l, int b,
                              int s, int h, int d, int dtype,
                              const long long* strides, float scale,
                              int causal, int q_offset, int k_offset,
                              int partial, void* stream) {
  if (!takes(d, dtype, s, s)) return cudaErrorInvalidValue;
  Params p = make_params(b, s, s, h, d, strides, scale, causal || partial,
                         q_offset, k_offset);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o_out = o;
  p.lse_out = lse;
  p.m = m;
  p.l = l;
  p.partial = partial;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_kernel(dtype == 1 ? &wide_fwd_kernel<__nv_bfloat16>
                                   : &wide_fwd_kernel<float>,
                       p, s, fwd_smem(d), st);
}

// dQ, and delta = rowsum(dO * O) into `delta` first when compute_delta.
extern "C" int kftpu_wide_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int b,
    int s_q, int s_k, int h, int d, int dtype, const long long* strides,
    float scale, int causal, int q_offset, int k_offset, int compute_delta,
    void* stream) {
  if (!takes(d, dtype, s_q, s_k)) return cudaErrorInvalidValue;
  Params p = make_params(b, s_q, s_k, h, d, strides, scale, causal, q_offset,
                         k_offset);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.compute_delta = compute_delta;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_kernel(dtype == 1 ? &wide_dq_kernel<__nv_bfloat16>
                                   : &wide_dq_kernel<float>,
                       p, s_q, dq_smem(d), st);
}

// dK and dV from the delta the dQ launch wrote (or the caller gave).
extern "C" int kftpu_wide_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int s_q,
    int s_k, int h, int d, int dtype, const long long* strides, float scale,
    int causal, int q_offset, int k_offset, void* stream) {
  if (!takes(d, dtype, s_q, s_k)) return cudaErrorInvalidValue;
  Params p = make_params(b, s_q, s_k, h, d, strides, scale, causal, q_offset,
                         k_offset);
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = const_cast<float*>(delta);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_kernel(dtype == 1 ? &wide_dkv_kernel<__nv_bfloat16>
                                   : &wide_dkv_kernel<float>,
                       p, s_k, dkv_smem(d), st);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
