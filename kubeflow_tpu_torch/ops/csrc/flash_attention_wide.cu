// Flash attention for heads wider than the 128-column tiles of
// flash_attention_fwd.cu and flash_attention_bwd.cu (sm_90a): the forward,
// the ring hop's partial forward, and the dQ and dK/dV backward, for every
// head dim that is a multiple of 8, in bfloat16 and float32.
//
// Replaces, for those head dims, the TPU kernels of
// kubeflow_tpu/ops/flash_attention.py: _fwd_kernel (launched by _flash_fwd),
// _partial_kernel (flash_attention_partial), _bwd_dq_kernel and
// _bwd_dkv_kernel (both launched by _flash_bwd). Their block specs span all
// of d, so the TPU kernels take any head dim. The function and its rounding
// points are theirs: scores, P, dP, dS and every accumulator in f32; masked
// scores at -1e30 (their probabilities exactly 0); P rounded to V's dtype
// before P V; in the backward P = exp(S * scale - lse) from the forward's
// lse, dS = P * (dP - delta), P rounded to dO's dtype before P^T dO and dS to
// the input dtype before dS K and dS^T Q, scale on the f32 products; lse,
// delta, m and l f32 [b*h, s]; a row that no key reaches is acc = 0,
// m = -1e30, l = 0 (the partial) or a zero gradient. The causal mask is
// global: query row i sits at q_offset + i and key j at k_offset + j.
//
// Which kernel serves which head dim (the caller's plan, which each entry
// point takes as `width` and `slices` and checks; flash_attention.py's
// _wide_plan chooses it):
//  * bf16, d <= 256: the forward and the partial run wide_fwd_bf16_kernel /
//    wide_partial_bf16_kernel, dQ wide_dq_bf16_kernel, dK/dV
//    wide_dkv_bf16_kernel, all on wgmma and TMA, at D = 192 columns
//    (d <= 192) or 256 (TMA fills the columns past d with zeros, which add
//    exactly 0 to Q K^T, dO V^T and delta; the epilogues store d columns).
//  * bf16 above 256 (the plan (0, slices)): the forward and the partial run
//    wide_fwd_bf16_sliced_kernel / wide_partial_bf16_sliced_kernel, on
//    wgmma and TMA, one CTA a 256-column slice of the output (below).
//  * f32 at any d (the plan (0, slices)): the forward and the partial run
//    flash_attention_f32.cuh's register-tiled loop on the CUDA cores, dQ
//    and dK/dV flash_attention_f32_bwd.cuh's register-tiled pair
//    (dq_f32_tiled_kernel, dkv_f32_tiled_kernel; each header has its
//    design), one CTA a 256-column slice.
//  * dQ and dK/dV of bf16 above 256: the simple kernels (wide_dq_kernel,
//    wide_dkv_kernel), FMA on the CUDA cores, with the output columns split
//    into slices of 256.
//
// Bounds on an H100 SXM (989 TFLOP/s dense bf16, 67 TFLOP/s f32 outside
// the tensor cores, 3.35 TB/s) at [8, 1024, 16, 256] bf16, causal: the
// forward's Q K^T and P V are 68.8 GFLOP (70 us at the bf16 peak) against
// 268 MB of q, k, v and o (80 us): bound by bytes. The dQ kernel (three
// products, 103.2 GFLOP, 104 us) moves 403 MB (120 us): bound by bytes;
// at the wide_heads step's [8, 1024, 8, 256] half of each, 60 us. The
// dK/dV kernel (four products, 137.6 GFLOP, 139 us) is bound by
// operations.
//
// The wgmma kernels (bf16, D = 192 or 256). Each product runs on the
// tensor cores from shared memory that TMA filled, as in the 128-column
// kernels (hopper.cuh); what changes with the width is the register
// budget: an f32 accumulator of 64 rows by 256 columns takes 128 registers
// a thread of a warpgroup.
//  * Forward and partial: one CTA of three warpgroups per (b*h, 128-row Q
//    tile): a producer (setmaxnreg 24; one thread issues the TMA loads) and
//    two consumers of 64 Q rows each (setmaxnreg 240). Q stays for the
//    whole loop (64 KB at D = 256); K and V come in 64-key tiles through 2
//    stages (2 x 64 KB): 192 KB. A consumer holds O (D / 2 floats), S of a
//    tile (32) and P as bf16 fragments (16). S = Q K^T as m64n64k16 over D
//    / 16 k-steps, both operands K-major; O += P V as m64nDk16, P from
//    registers, V MN-major. The online softmax runs in base 2 with
//    ex2.approx.ftz, as the 128-column forward. The partial is the same
//    loop with its epilogue (f32 acc, m and l).
//  * dK/dV: the two consumer warpgroups share 64 owned keys, K and V
//    resident (2 x 32 KB at D = 256); Q and dO stream in 64-row tiles with
//    their rows' lse and delta through 2 stages (2 x 64 KB). dK and dV do
//    not fit one warpgroup's registers together, so each warpgroup keeps
//    one: warpgroup A computes S^T = K Q^T, P^T = exp2(S^T' - lse') in f32,
//    hands the f32 P^T to warpgroup B through shared memory (16 KB, two
//    named barriers: ready and free) and accumulates dV += P^T dO; B
//    computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK += dS^T Q,
//    scaled on the f32 result. Shared memory 209 KB at D = 256.
//  * dQ: one CTA per (b*h, 128-row Q tile), a producer and two consumers
//    of 64 Q rows each, as the forward; Q and dO stay (2 x 64 KB at
//    D = 256). The registers fit: dQ for 64 rows x 256 columns is 128 a
//    thread, S and dP of a 64-key tile 32 each, P forms in place in S and
//    dS in place in dP, dS as bf16 fragments 16: about 192 at the peak,
//    under setmaxnreg's 240. Shared memory does not fit the plain shape:
//    two stages of K and V tiles (2 x 64 KB) beside Q and dO are 256 KB,
//    against 227 KB. So K and V stream through rings of their own, K in
//    2 stages and V in 1 (224 KB at D = 256, static_assert below): V is
//    released as soon as dP = dO V^T has landed and K after dQ += dS K,
//    so the next V's load runs under dS and dQ += dS K. 32-key tiles in
//    2 stages, or one consumer warpgroup, would fit too, but double the
//    waits a key or halve the math warps. S and dP are m64n64k16 with
//    both operands K-major, committed as two groups so that P's exp2s run
//    while dP is still on the tensor cores; dQ += dS K is m64nDk16 with
//    dS from registers and K read MN-major, as dK += dS^T Q in dK/dV.
//    delta = rowsum(dO * O): the O tile is TMA-loaded once, before the
//    loop, into the two K stages, and the consumers sum each row from
//    shared memory, four threads a row; a caller that has delta (a ring
//    hop) passes it.
//  * Launch order, as the 128-column kernels: (batch, head) pairs in groups
//    of as many heads as half the L2 holds the streamed tensors of, each
//    group's tiles from the heaviest causal tile on. No atomics: the
//    results are deterministic.
//
// The sliced bf16 forward and partial (d > 256). Bound at [8, 1024, 16,
// 320] causal by bytes: 335.5 MB of q, k, v and o (0.100 ms) against 86.9
// us of the function's products at the bf16 peak. Each 256-column slice of
// O recomputes S = Q K^T over all of d, so the slices' products are more
// than the function's: at d = 320 two slices contract S over 320 columns
// each and P V over 256 (the second slice's 192 columns past d are
// multiplied, not stored): 1.8 times one pass's 640. The design is the
// wgmma forward's (a producer and two consumer warpgroups of 64 Q rows, 64-
// key tiles, O in 128 registers, ex2.approx.ftz, P rounded to bf16 in
// registers), with the contraction over d in 64-column panels: K's panels
// through a ring of 4 stages, each panel its own commit group so that the
// next panel's wait overlaps this one's products, Q's panels resident for
// d up to 512 (176 KB at d = 320) and streamed beside K's above; the
// slice's V tile through 2 stages. The slices of one Q tile launch side by
// side, so the second reads K and V from L2. Every slice computes S, the
// max and the sum in the same order: the statistics are bitwise equal and
// slice 0 alone writes them.
//
// The simple kernels (the backward of bf16 above 256 columns):
// one CTA of 128 threads (4 warps) per (b*h, 16 owned rows, column slice):
// query rows for dQ, key rows for dK/dV.
//  * The output-column split: a CTA accumulates the slice [256 y, 256 y +
//    256) of the output's columns (dQ, dK and dV; blockIdx.y), so the f32
//    accumulators take 16 KB each whatever d. The scores (S, and dP) still
//    contract over all of d, so every slice computes the softmax statistics
//    (delta) from the same numbers in the same order: they are bitwise
//    equal, and slice 0 alone writes them.
//  * The owned rows' inputs (Q and dO; K and V) stay in shared memory
//    at full width where they fit (dK/dV: d up to about 1300), else they
//    are read 64 columns at a time beside the streamed chunk.
//  * The other side streams in tiles of 32 rows (lane j takes streamed row
//    j), read through its strides in chunks of 64 columns into a
//    [32][65] f32 buffer, rows and columns past the edge as zeros. Warp w
//    holds owned rows 4w .. 4w + 3 against the 32 streamed rows. The
//    products into the accumulators: thread t takes column t % 64 of a
//    chunk for 8 of the 16 owned rows. Every product is an f32 FMA, and
//    each reads one operand from shared memory: these kernels are right,
//    not fast (PERF.md has their times).

#include "flash_attention_f32.cuh"
#include "flash_attention_f32_bwd.cuh"
#include "hopper.cuh"

namespace {

using namespace kftpu;

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxSmem = 232448;  // bytes a CTA may have on sm_90
constexpr int kSliceCols = 256;   // output columns a sliced CTA accumulates
constexpr int kHopperMaxCols = 256;  // the widest wgmma instantiation

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
  int b, s_q, s_k, h, d;  // d: the true head dim (a tile may be wider)
  long long st[kTensors][3];
  float scale;
  int causal, q_offset, k_offset, compute_delta, partial;
  int held;    // the simple kernels: the owned rows' inputs in shared memory
  int group;   // the wgmma kernels' launch order: (batch, head) pairs a group
  int slices;  // the sliced forward: output-column slices of kSliceCols
};

// Whether the library has the kernels of a plan for head dim d and dtype
// (0 f32, 1 bf16): the wgmma kernels at `width` columns (192 or 256, bf16,
// d <= width, one slice), or (width 0) over `slices` column slices of
// kSliceCols, as many as d fills: the sliced forward (bf16 on wgmma, f32 on
// the CUDA cores) and the backward (bf16: the simple kernels; f32: the
// register-tiled pair).
bool has_plan(int d, int dtype, int width, int slices) {
  if (width == 0) {
    return slices == (d + kSliceCols - 1) / kSliceCols && slices <= 65535;
  }
  return dtype == 1 && (width == 192 || width == kHopperMaxCols) &&
         d <= width && slices == 1;
}

// ========================================================= simple kernels

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

// Floats of one owned input: held at full width, or one chunk.
__host__ __device__ constexpr int own_floats(int d, bool held) {
  return held ? kOwn * d : kOwn * kPitch;
}
// Columns of a CTA's accumulators.
__host__ __device__ constexpr int acc_cols(int d) {
  return d < kSliceCols ? d : kSliceCols;
}

constexpr int dq_smem(int d, bool held) {
  return 4 * (2 * own_floats(d, held) + kOwn * acc_cols(d) +
              2 * kStream * kPitch + kOwn * kTilePitch);
}
constexpr int dkv_smem(int d, bool held) {
  return 4 * (2 * own_floats(d, held) + 2 * kOwn * acc_cols(d) +
              2 * kStream * kPitch + 2 * kOwn * kTilePitch);
}
// Streaming the owned inputs fits at any width.
static_assert(dkv_smem(1 << 20, false) <= kMaxSmem &&
                  dq_smem(1 << 20, false) <= kMaxSmem,
              "every simple kernel fits at any head dim");

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

// Columns [c0, c0 + kChunk) of the rows [n0, n0 + R) of one head of
// `which` into `dst` ([R][kPitch] f32), rows past `rows` and columns past d
// as zeros.
template <typename T, int R>
__device__ __forceinline__ void load_chunk(float* dst, const void* base,
                                           const Params& p, int which, int bi,
                                           int hi, int n0, int rows, int c0) {
  for (int idx = threadIdx.x; idx < R * kChunk; idx += kThreads) {
    const int r = idx / kChunk, c = idx % kChunk;
    const bool in = n0 + r < rows && c0 + c < p.d;
    dst[r * kPitch + c] =
        in ? load(row_of<T>(base, p, which, bi, hi, n0 + r) + c0 + c) : 0.f;
  }
}

// An owned input's columns from c0 on, as (pointer, row pitch): from its
// full-width copy when held, else loaded into `buf` ([kOwn][kPitch]).
template <typename T>
__device__ __forceinline__ const float* owned_chunk(
    float* buf, const void* base, const Params& p, int which, int bi, int hi,
    int r0, int rows, int c0, int& pitch) {
  if (p.held) {
    pitch = p.d;
    return buf + c0;
  }
  load_chunk<T, kOwn>(buf, base, p, which, bi, hi, r0, rows, c0);
  pitch = kPitch;
  return buf;
}

__device__ __forceinline__ int chunk_cols(const Params& p, int c0) {
  return min(kChunk, p.d - c0);
}

// Whether query `qi` sees key `kj` (both local indices).
__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return qi < p.s_q && kj < p.s_k &&
         !(p.causal && p.k_offset + kj > p.q_offset + qi);
}

// acc[r][c + col] += sum_j tile[r][j] * chunk[j][col] for this thread's
// column and its 8 owned rows: the product of a [kOwn][kStream] tile of P
// or dS with a chunk of the streamed rows; acc rows are `pitch` apart.
__device__ __forceinline__ void accumulate(float* acc, const float* tile,
                                           const float* chunk, int pitch,
                                           int c, int cols) {
  const int col = threadIdx.x % kColThreads;
  const int group = threadIdx.x / kColThreads;
  if (col >= cols) return;
  float b[kStream];
#pragma unroll
  for (int j = 0; j < kStream; ++j) b[j] = chunk[j * kPitch + col];
#pragma unroll 2
  for (int rr = 0; rr < kRowsPerGroup; ++rr) {
    const int r = group * kRowsPerGroup + rr;
    float a = acc[r * pitch + c + col];
#pragma unroll
    for (int j = 0; j < kStream; ++j) a = fmaf(tile[r * kTilePitch + j], b[j], a);
    acc[r * pitch + c + col] = a;
  }
}

// The CTA's (b*h, owned tile, column slice), heaviest causal tiles first
// when `last_first` (dQ's last query tiles see the most keys).
struct Tile {
  int bh, bi, hi, r0, c_lo, c_hi;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int rows,
                                        bool last_first) {
  const int tiles = (rows + kOwn - 1) / kOwn;
  const int bh = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int c_lo = blockIdx.y * kSliceCols;
  return {bh, bh / p.h, bh % p.h, (last_first ? tiles - 1 - t : t) * kOwn,
          c_lo, min(p.d, c_lo + kSliceCols)};
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int w = acc_cols(p.d);
  const int own = own_floats(p.d, p.held);
  float* qs = smem;                          // held [kOwn][d], or a chunk
  float* dos = qs + own;
  float* dqs = dos + own;                    // [kOwn][w] f32 acc
  float* kc = dqs + kOwn * w;                // [kStream][kPitch]
  float* vc = kc + kStream * kPitch;         // [kStream][kPitch]
  float* dss = vc + kStream * kPitch;        // [kOwn][kTilePitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tile t = tile_of(p, p.s_q, p.causal);

  if (p.held) {
    load_owned<T>(qs, p.q, p, kQ, t.bi, t.hi, t.r0, p.s_q);
    load_owned<T>(dos, p.dout, p, kDO, t.bi, t.hi, t.r0, p.s_q);
  }
  for (int idx = threadIdx.x; idx < kOwn * w; idx += kThreads) {
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
        const T* dout = row_of<T>(p.dout, p, kDO, t.bi, t.hi, row);
        for (int i = lane; i < p.d; i += 32) {
          part = fmaf(load(dout + i), load(o + i), part);
        }
      }
      delta[j] = warp_sum(part);
      if (blockIdx.y == 0 && lane == 0 && row < p.s_q) p.delta[at] = delta[j];
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
      load_chunk<T, kStream>(kc, p.k, p, kK, t.bi, t.hi, n0, p.s_k, c0);
      load_chunk<T, kStream>(vc, p.v, p, kV, t.bi, t.hi, n0, p.s_k, c0);
      int pitch;
      const float* q = owned_chunk<T>(qs, p.q, p, kQ, t.bi, t.hi, t.r0,
                                      p.s_q, c0, pitch);
      const float* d_o = owned_chunk<T>(dos, p.dout, p, kDO, t.bi, t.hi,
                                        t.r0, p.s_q, c0, pitch);
      __syncthreads();
      const int cols = chunk_cols(p, c0);
      for (int i = 0; i < cols; ++i) {
        const float kval = kc[lane * kPitch + i];
        const float vval = vc[lane * kPitch + i];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          s[j] = fmaf(q[r * pitch + i], kval, s[j]);
          dp[j] = fmaf(d_o[r * pitch + i], vval, dp[j]);
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
    for (int c0 = t.c_lo; c0 < t.c_hi; c0 += kChunk) {
      load_chunk<T, kStream>(kc, p.k, p, kK, t.bi, t.hi, n0, p.s_k, c0);
      __syncthreads();
      accumulate(dqs, dss, kc, w, c0 - t.c_lo, chunk_cols(p, c0));
      __syncthreads();
    }
  }

  const int rows = min(kOwn, p.s_q - t.r0);
  const int cols = t.c_hi - t.c_lo;
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, i = idx % cols;
    store(out_row_of<T>(p.dq, p, kDQ, t.bi, t.hi, t.r0 + r) + t.c_lo + i,
          dqs[r * w + i] * p.scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wide_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int w = acc_cols(p.d);
  const int own = own_floats(p.d, p.held);
  float* ks = smem;                          // owned keys: held, or a chunk
  float* vs = ks + own;
  float* dks = vs + own;                     // [kOwn][w] f32 accs
  float* dvs = dks + kOwn * w;
  float* qc = dvs + kOwn * w;                // [kStream][kPitch]
  float* dc = qc + kStream * kPitch;         // [kStream][kPitch]
  float* ps = dc + kStream * kPitch;         // [kOwn][kTilePitch] P^T
  float* dss = ps + kOwn * kTilePitch;       // [kOwn][kTilePitch] dS^T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tile t = tile_of(p, p.s_k, false);

  if (p.held) {
    load_owned<T>(ks, p.k, p, kK, t.bi, t.hi, t.r0, p.s_k);
    load_owned<T>(vs, p.v, p, kV, t.bi, t.hi, t.r0, p.s_k);
  }
  for (int idx = threadIdx.x; idx < kOwn * w; idx += kThreads) {
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
      load_chunk<T, kStream>(qc, p.q, p, kQ, t.bi, t.hi, m0, p.s_q, c0);
      load_chunk<T, kStream>(dc, p.dout, p, kDO, t.bi, t.hi, m0, p.s_q, c0);
      int pitch;
      const float* k = owned_chunk<T>(ks, p.k, p, kK, t.bi, t.hi, t.r0,
                                      p.s_k, c0, pitch);
      const float* v = owned_chunk<T>(vs, p.v, p, kV, t.bi, t.hi, t.r0,
                                      p.s_k, c0, pitch);
      __syncthreads();
      const int cols = chunk_cols(p, c0);
      for (int i = 0; i < cols; ++i) {
        const float qval = qc[lane * kPitch + i];
        const float dval = dc[lane * kPitch + i];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const int r = warp * kRowsPerWarp + j;
          s[j] = fmaf(k[r * pitch + i], qval, s[j]);
          dp[j] = fmaf(v[r * pitch + i], dval, dp[j]);
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
    for (int c0 = t.c_lo; c0 < t.c_hi; c0 += kChunk) {
      load_chunk<T, kStream>(qc, p.q, p, kQ, t.bi, t.hi, m0, p.s_q, c0);
      load_chunk<T, kStream>(dc, p.dout, p, kDO, t.bi, t.hi, m0, p.s_q, c0);
      __syncthreads();
      const int cols = chunk_cols(p, c0);
      accumulate(dvs, ps, dc, w, c0 - t.c_lo, cols);
      accumulate(dks, dss, qc, w, c0 - t.c_lo, cols);
      __syncthreads();
    }
  }

  const int rows = min(kOwn, p.s_k - t.r0);
  const int cols = t.c_hi - t.c_lo;
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, i = idx % cols;
    store(out_row_of<T>(p.dk, p, kDK, t.bi, t.hi, t.r0 + r) + t.c_lo + i,
          dks[r * w + i] * p.scale);
    store(out_row_of<T>(p.dv, p, kDV, t.bi, t.hi, t.r0 + r) + t.c_lo + i,
          dvs[r * w + i]);
  }
}

// =========================================================== wgmma kernels

typedef __nv_bfloat16 bf16;

constexpr int kBlockM = 128;     // Q rows a forward CTA: two warpgroups
constexpr int kWgRows = 64;      // rows a consumer warpgroup takes
constexpr int kTileRows = 64;    // keys a K/V tile; owned keys and streamed
                                 // Q/dO rows of dK/dV
constexpr int kPanel128 = kBlockM * kRowBytes;   // a 128-row panel: 16 KB
constexpr int kPanel64 = kTileRows * kRowBytes;  // a 64-row panel: 8 KB
constexpr int kSbo = 8 * kRowBytes;  // 8-row groups of a swizzled panel
constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;
constexpr int kConsumerThreads = 2 * kWgThreads;
constexpr int kConsumerWarps = 8;
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// Named barriers (0 is __syncthreads) between dK/dV's two consumers.
constexpr int kPReady = 1;  // P^T of the tile is in shared memory
constexpr int kPFree = 2;   // ... and was read: the next may overwrite it

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumerThreads)
               : "memory");
}

// acc (+)= A B^T for a warpgroup's 64 rows of A and a 64-row B, both
// K-major over D columns: a k-step of 16 columns moves 32 bytes along the
// swizzled row, four of them a panel; `a_panel` / `b_panel` bytes apart.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a,
                                         int a_panel, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(acc, smem_desc(a + (kk / 4) * a_panel + off, 16, kSbo),
                 smem_desc(b + (kk / 4) * kPanel64 + off, 16, kSbo), kk > 0);
  }
}

// acc += A B: A (64 rows x 64) as register fragments, B a 64-row tile
// [64][D] read MN-major: a k-step of 16 rows is 16 x 128 bytes, the
// 64-column panels sit a panel apart (the leading byte offset).
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk) {
    const uint64_t desc = smem_desc(b + kk * 16 * kRowBytes, kPanel64, kSbo);
    if constexpr (D == 256) {
      wgmma_rs_n256(acc, a[kk], desc);
    } else {
      wgmma_rs_n192(acc, a[kk], desc);
    }
  }
}

// An m64n64 accumulator rounded to bf16 as wgmma A fragments: the
// accumulator chunks 2kk and 2kk + 1 (8 columns each) are exactly the
// m64k16 A layout of k-step kk.
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      f[kk][r] = pack_bf16(x[kk * 8 + r * 2], x[kk * 8 + r * 2 + 1]);
    }
  }
}

// The launch order: (batch, head) pairs in groups of p.group, each group's
// tiles from the heaviest (the last when `last_first`) on, the group's
// heads side by side; `idx` is the CTA's place in that order.
__device__ __forceinline__ void group_tile(const Params& p, int tiles,
                                           bool last_first, int& bh,
                                           int& tile, int idx = blockIdx.x) {
  const int bhs = p.b * p.h;
  const int per_group = p.group * tiles;
  const int g = idx / per_group, rem = idx % per_group;
  const int heads = min(p.group, bhs - g * p.group);
  bh = g * p.group + rem % heads;
  tile = last_first ? tiles - 1 - rem / heads : rem / heads;
}

// ------------------------------------------------- forward and partial

template <int D>
struct FwdCfg {
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kQBytes = kPanels * kPanel128;
  static constexpr int kKvBytes = kPanels * kPanel64;  // a K or V tile
  // Q | K0 | V0 | K1 | V1 | barriers, 1024-aligned.
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKvBytes;
  static constexpr int kBars = 1 + 3 * kStages;  // q, k full, v full, empty
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
};
static_assert(FwdCfg<256>::kSmem <= kMaxSmem, "the forward fits at D 256");

template <int D>
struct FwdSmem {
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int st) const {
    return base + FwdCfg<D>::kQBytes + 2 * st * FwdCfg<D>::kKvBytes;
  }
  __device__ uint32_t v(int st) const {
    return k(st) + FwdCfg<D>::kKvBytes;
  }
  __device__ uint32_t bar(int i) const {
    return base + FwdCfg<D>::kBarOffset + 8 * i;
  }
  __device__ uint32_t q_full() const { return bar(0); }
  __device__ uint32_t k_full(int st) const { return bar(1 + st); }
  __device__ uint32_t v_full(int st) const { return bar(1 + kStages + st); }
  __device__ uint32_t empty(int st) const {
    return bar(1 + 2 * kStages + st);
  }
};

// The producer's one thread: Q once, then every K/V tile through the ring.
template <int D>
__device__ __forceinline__ void produce_fwd(const FwdSmem<D>& sm,
                                            const CUtensorMap& qmap,
                                            const CUtensorMap& kmap,
                                            const CUtensorMap& vmap, int m0,
                                            int hi, int bi, int n_tiles) {
  constexpr int kPanels = FwdCfg<D>::kPanels;
  mbar_expect_tx(sm.q_full(), FwdCfg<D>::kQBytes);
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) {
    tma_load(sm.q() + pn * kPanel128, qmap, sm.q_full(), pn * kPanelCols,
             hi, m0, bi);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    // The stage's previous tile was released (round 0 passes at once).
    mbar_wait(sm.empty(st), ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(sm.k_full(st), FwdCfg<D>::kKvBytes);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(sm.k(st) + pn * kPanel64, kmap, sm.k_full(st),
               pn * kPanelCols, hi, j * kTileRows, bi);
    }
    mbar_expect_tx(sm.v_full(st), FwdCfg<D>::kKvBytes);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(sm.v(st) + pn * kPanel64, vmap, sm.v_full(st),
               pn * kPanelCols, hi, j * kTileRows, bi);
    }
  }
}

// One 64-key tile's online softmax for the thread's two rows (row and
// row + 8) of the m64n64 accumulator: scale to log2 units, mask with -1e30
// where needed, update the running max and sum, and leave
// P = exp2(S' - m_new) in s; corr is what the accumulator is rescaled by.
__device__ __forceinline__ void online_softmax(float (&s)[32],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&corr)[2], int n0,
                                               bool need_mask, int row,
                                               int tq, const Params& p,
                                               float scale2) {
  float mx[2] = {m_run[0], m_run[1]};
  // Row i keeps the keys before min(s, its last visible key + 1); as an
  // offset from this thread's first column n0 + 2 tq.
  int live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int end = p.causal ? min(p.s_k, p.q_offset + row + 8 * i -
                                              p.k_offset + 1)
                             : p.s_k;
    live[i] = end - (n0 + tq * 2);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j * 4 + e] * scale2;
      if (need_mask && j * 8 + (e & 1) >= live[e >> 1]) x = kNegBig;
      s[j * 4 + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the 4 threads of a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pj = ex2(s[j] - mx[(j >> 1) & 1]);
    s[j] = pj;
    rs[(j >> 1) & 1] += pj;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    corr[i] = ex2(m_run[i] - mx[i]);
    l_run[i] = l_run[i] * corr[i] + rs[i];
    m_run[i] = mx[i];
  }
}

// A consumer warpgroup's loop over the K/V tiles: warpgroup `c` (0 or 1)
// owns Q rows [m0w, m0w + 64) of the tile.
template <int D>
__device__ __forceinline__ void consume_fwd(const FwdSmem<D>& sm,
                                            const Params& p, int c, int m0w,
                                            int row, int tq, int lane,
                                            int n_tiles, float (&o)[D / 2],
                                            float (&m_run)[2],
                                            float (&l_run)[2]) {
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_addr = sm.q() + c * kWgRows * kRowBytes;
  float s[32];
  uint32_t pf[4][4];
  float corr[2];

  mbar_wait(sm.q_full(), 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const int n0 = j * kTileRows;
    const bool need_mask =
        n0 + kTileRows > p.s_k ||
        (p.causal && p.k_offset + n0 + kTileRows - 1 > p.q_offset + m0w);
    mbar_wait(sm.k_full(st), ph);
    wgmma_fence();
    issue_ss<D>(s, q_addr, kPanel128, sm.k(st));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    online_softmax(s, m_run, l_run, corr, n0, need_mask, row, tq, p, scale2);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_a(s, pf);
    mbar_wait(sm.v_full(st), ph);
    wgmma_fence();
    issue_rs<D>(o, pf, sm.v(st));
    wgmma_commit();
    wgmma_wait<0>();
    hold(o);
    hold(pf);
    if (lane == 0) mbar_arrive(sm.empty(st));  // one arrive a warp
  }
}

// The body of both kernels: kPartial selects the ring hop's epilogue.
template <int D, bool kPartial>
__device__ __forceinline__ void hopper_fwd(const CUtensorMap& qmap,
                                           const CUtensorMap& kmap,
                                           const CUtensorMap& vmap,
                                           const Params& p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const FwdSmem<D> sm{(smem_u32(smem_raw) + 1023) & ~1023u};
  const int m_blocks = (p.s_q + kBlockM - 1) / kBlockM;
  int bh, tile;
  group_tile(p, m_blocks, true, bh, tile);
  const int bi = bh / p.h, hi = bh % p.h;
  const int m0 = tile * kBlockM;
  // Keys [0, n_end) reach some row of this tile: causal, the last row's
  // global position bounds them.
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + min(m0 + kBlockM, p.s_q) -
                                       p.k_offset))
               : p.s_k;
  const int n_tiles = (n_end + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.k_full(st), 1);
      mbar_init(sm.v_full(st), 1);
      mbar_init(sm.empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      produce_fwd<D>(sm, qmap, kmap, vmap, m0, hi, bi, n_tiles);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x - wg * kWgThreads;
  const int lane = t & 31, tq = lane & 3;
  const int m0w = m0 + c * kWgRows;
  // The thread's rows of the m64 accumulators: row[0] and row[0] + 8.
  const int row[2] = {m0w + (t >> 5) * 16 + (lane >> 2),
                      m0w + (t >> 5) * 16 + (lane >> 2) + 8};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // The running max in log2 units (scores scaled by scale * log2 e).
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.f, 0.f};
  if (n_tiles > 0) {
    consume_fwd<D>(sm, p, c, m0w, row[0], tq, lane, n_tiles, o, m_run,
                   l_run);
  }

  // o[j * 4 + i * 2 + e]: row row[i], column j * 8 + tq * 2 + e.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.s_q) continue;
    const long long at = static_cast<long long>(bh) * p.s_q + row[i];
    if constexpr (kPartial) {
      // A row that saw a key has a real max: each row that sees any key of
      // the block sees key 0, which is in the first tile.
      const bool seen = m_run[i] != kNegBig;
      float* orow = out_row_of<float>(p.o_out, p, kO, bi, hi, row[i]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (j * 8 >= p.d) break;  // the tile's zero columns past d
        *reinterpret_cast<float2*>(orow + j * 8 + tq * 2) =
            seen ? make_float2(o[j * 4 + i * 2], o[j * 4 + i * 2 + 1])
                 : make_float2(0.f, 0.f);
      }
      if (tq == 0) {
        p.m[at] = seen ? m_run[i] * kLn2 : kNegBig;  // log2 -> natural
        p.l[at] = seen ? l_run[i] : 0.f;
      }
    } else {
      const float l = fmaxf(l_run[i], 1e-30f);
      bf16* orow = out_row_of<bf16>(p.o_out, p, kO, bi, hi, row[i]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (j * 8 >= p.d) break;
        *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) =
            pack_bf16(o[j * 4 + i * 2] / l, o[j * 4 + i * 2 + 1] / l);
      }
      if (tq == 0) p.lse_out[at] = m_run[i] * kLn2 + logf(l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const Params p) {
  hopper_fwd<D, false>(qmap, kmap, vmap, p);
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_partial_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const Params p) {
  hopper_fwd<D, true>(qmap, kmap, vmap, p);
}

// ------------------------------- forward and partial above 256 columns

// The bf16 forward over output-column slices (d > 256; the plan (0,
// slices)): one CTA per (b*h, 128-row Q tile, slice of kSliceCols O
// columns), the producer and two consumer warpgroups of hopper_fwd, O in
// 128 registers (D = 256). S = Q K^T contracts over all of d in 64-column
// panels: K's panels of each 64-key tile come through a ring of
// kSliceStages stages, and Q's either stay in shared memory (resident, d up
// to 512) or come through the ring beside K's (streamed). The slice's V
// tile (4 panels, those past d not loaded) comes through 2 stages.
constexpr int kSliceStages = 4;
constexpr int kSliceVTile = (kSliceCols / kPanelCols) * kPanel64;  // 32 KB

struct SlicedLayout {
  int panels;     // 64-column panels of d
  bool resident;  // Q's panels stay for the whole loop
  int q, ring, stage, v, bars, smem;  // offsets and sizes in bytes
};

__host__ __device__ constexpr SlicedLayout sliced_layout(int d) {
  SlicedLayout L{};
  L.panels = (d + kPanelCols - 1) / kPanelCols;
  // q_full, full and empty a stage, V full and empty a stage.
  constexpr int kBarBytes = 8 * (1 + 2 * kSliceStages + 4);
  const int resident = L.panels * kPanel128 + kSliceStages * kPanel64 +
                       2 * kSliceVTile + kBarBytes + 1024;
  L.resident = resident <= kMaxSmem;
  L.q = 0;
  L.ring = L.resident ? L.panels * kPanel128 : 0;
  L.stage = L.resident ? kPanel64 : kPanel128 + kPanel64;  // (Q |) K
  L.v = L.ring + kSliceStages * L.stage;
  L.bars = L.v + 2 * kSliceVTile;
  L.smem = L.bars + kBarBytes + 1024;
  return L;
}
static_assert(sliced_layout(264).resident &&
                  sliced_layout(264).smem == 181352 &&
                  sliced_layout(320).resident &&
                  sliced_layout(320).smem == 181352 &&
                  sliced_layout(512).resident &&
                  sliced_layout(512).smem == 230504 &&
                  !sliced_layout(1024).resident &&
                  sliced_layout(1024).smem == 164968 &&
                  !sliced_layout(1 << 20).resident &&
                  sliced_layout(1 << 20).smem <= kMaxSmem,
              "the sliced forward's shared memory at d 264, 320, 512 (Q "
              "resident), 1024 and any wider head (Q streamed)");

template <bool kPartial>
__device__ __forceinline__ void sliced_fwd(const CUtensorMap& qmap,
                                           const CUtensorMap& kmap,
                                           const CUtensorMap& vmap,
                                           const Params& p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const SlicedLayout L = sliced_layout(p.d);
  const uint32_t bars = base + L.bars;
  const uint32_t q_full = bars;
  const auto full = [&](int st) { return bars + 8 * (1 + st); };
  const auto empty = [&](int st) {
    return bars + 8 * (1 + kSliceStages + st);
  };
  const auto v_full = [&](int vb) {
    return bars + 8 * (1 + 2 * kSliceStages + vb);
  };
  const auto v_empty = [&](int vb) {
    return bars + 8 * (3 + 2 * kSliceStages + vb);
  };
  const int m_blocks = (p.s_q + kBlockM - 1) / kBlockM;
  const int slice = blockIdx.x % p.slices;  // slices side by side
  int bh, tile;
  group_tile(p, m_blocks, true, bh, tile, blockIdx.x / p.slices);
  const int bi = bh / p.h, hi = bh % p.h;
  const int m0 = tile * kBlockM;
  const int c_lo = slice * kSliceCols;
  const int cols = min(kSliceCols, p.d - c_lo);
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + min(m0 + kBlockM, p.s_q) -
                                       p.k_offset))
               : p.s_k;
  const int n_tiles = (n_end + kTileRows - 1) / kTileRows;
  const int np = L.panels;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kSliceStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    for (int vb = 0; vb < 2; ++vb) {
      mbar_init(v_full(vb), 1);
      mbar_init(v_empty(vb), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      if (L.resident) {
        mbar_expect_tx(q_full, np * kPanel128);
        for (int pn = 0; pn < np; ++pn) {
          tma_load(base + L.q + pn * kPanel128, qmap, q_full,
                   pn * kPanelCols, hi, m0, bi);
        }
      }
      const int vpanels =
          min(kSliceCols / kPanelCols, (cols + kPanelCols - 1) / kPanelCols);
      for (int j = 0; j < n_tiles; ++j) {
        for (int pn = 0; pn < np; ++pn) {
          const int g = j * np + pn, st = g % kSliceStages;
          // The stage's previous panels were released (round 0 passes).
          mbar_wait(empty(st), ((g / kSliceStages) & 1) ^ 1);
          const uint32_t stage = base + L.ring + st * L.stage;
          mbar_expect_tx(full(st), L.stage);
          if (!L.resident) {
            tma_load(stage, qmap, full(st), pn * kPanelCols, hi, m0, bi);
          }
          tma_load(L.resident ? stage : stage + kPanel128, kmap, full(st),
                   pn * kPanelCols, hi, j * kTileRows, bi);
        }
        const int vb = j & 1;
        mbar_wait(v_empty(vb), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(v_full(vb), vpanels * kPanel64);
        for (int pn = 0; pn < vpanels; ++pn) {
          tma_load(base + L.v + vb * kSliceVTile + pn * kPanel64, vmap,
                   v_full(vb), c_lo + pn * kPanelCols, hi, j * kTileRows, bi);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x - wg * kWgThreads;
  const int lane = t & 31, tq = lane & 3;
  const int m0w = m0 + c * kWgRows;
  const int row[2] = {m0w + (t >> 5) * 16 + (lane >> 2),
                      m0w + (t >> 5) * 16 + (lane >> 2) + 8};
  const float scale2 = p.scale * kLog2e;
  float o[kSliceCols / 2];
#pragma unroll
  for (int i = 0; i < kSliceCols / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};  // log2 units
  float l_run[2] = {0.f, 0.f};
  float s[32], corr[2];
  uint32_t pf[4][4];
  if (n_tiles > 0 && L.resident) mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kTileRows;
    // S = Q K^T, one commit group a panel; a panel's stage is released
    // once the next panel's products are issued and its own have landed.
    for (int pn = 0; pn < np; ++pn) {
      const int g = j * np + pn, st = g % kSliceStages;
      mbar_wait(full(st), (g / kSliceStages) & 1);
      const uint32_t stage = base + L.ring + st * L.stage;
      const uint32_t q_addr =
          (L.resident ? base + L.q + pn * kPanel128 : stage) +
          c * kWgRows * kRowBytes;
      const uint32_t k_addr = L.resident ? stage : stage + kPanel128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n64(s, smem_desc(q_addr + kk * 32, 16, kSbo),
                     smem_desc(k_addr + kk * 32, 16, kSbo), pn > 0 || kk > 0);
      }
      wgmma_commit();
      if (pn > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty((g - 1) % kSliceStages));
      }
    }
    wgmma_wait<0>();
    hold(s);
    if (lane == 0) mbar_arrive(empty((j * np + np - 1) % kSliceStages));
    const bool need_mask =
        n0 + kTileRows > p.s_k ||
        (p.causal && p.k_offset + n0 + kTileRows - 1 > p.q_offset + m0w);
    online_softmax(s, m_run, l_run, corr, n0, need_mask, row[0], tq, p,
                   scale2);
#pragma unroll
    for (int i = 0; i < kSliceCols / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_a(s, pf);
    const int vb = j & 1;
    mbar_wait(v_full(vb), (j >> 1) & 1);
    wgmma_fence();
    issue_rs<kSliceCols>(o, pf, base + L.v + vb * kSliceVTile);
    wgmma_commit();
    wgmma_wait<0>();
    hold(o);
    hold(pf);
    if (lane == 0) mbar_arrive(v_empty(vb));  // one arrive a warp
  }

  // o[j * 4 + i * 2 + e]: row row[i], slice column j * 8 + tq * 2 + e;
  // columns past the slice's (past d) are not stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.s_q) continue;
    const long long at = static_cast<long long>(bh) * p.s_q + row[i];
    if constexpr (kPartial) {
      // A row that saw a key has a real max: each row that sees any key of
      // the block sees key 0, which is in the first tile.
      const bool seen = m_run[i] != kNegBig;
      float* orow = out_row_of<float>(p.o_out, p, kO, bi, hi, row[i]) + c_lo;
#pragma unroll
      for (int j = 0; j < kSliceCols / 8; ++j) {
        if (j * 8 >= cols) break;
        *reinterpret_cast<float2*>(orow + j * 8 + tq * 2) =
            seen ? make_float2(o[j * 4 + i * 2], o[j * 4 + i * 2 + 1])
                 : make_float2(0.f, 0.f);
      }
      if (slice == 0 && tq == 0) {  // every slice's are equal
        p.m[at] = seen ? m_run[i] * kLn2 : kNegBig;  // log2 -> natural
        p.l[at] = seen ? l_run[i] : 0.f;
      }
    } else {
      const float l = fmaxf(l_run[i], 1e-30f);
      bf16* orow = out_row_of<bf16>(p.o_out, p, kO, bi, hi, row[i]) + c_lo;
#pragma unroll
      for (int j = 0; j < kSliceCols / 8; ++j) {
        if (j * 8 >= cols) break;
        *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) =
            pack_bf16(o[j * 4 + i * 2] / l, o[j * 4 + i * 2 + 1] / l);
      }
      if (slice == 0 && tq == 0) p.lse_out[at] = m_run[i] * kLn2 + logf(l);
    }
  }
}

__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_fwd_bf16_sliced_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const Params p) {
  sliced_fwd<false>(qmap, kmap, vmap, p);
}

__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_partial_bf16_sliced_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const Params p) {
  sliced_fwd<true>(qmap, kmap, vmap, p);
}

// ------------------------------------------------------------------- dQ

template <int D>
struct DqCfg {
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kOwnTile = kPanels * kPanel128;  // Q or dO, 128 rows
  static constexpr int kKvTile = kPanels * kPanel64;    // a K or V tile
  // Q | dO | K x kStages | V | barriers, 1024-aligned. O's 128 rows take
  // the K stages before the loop.
  static constexpr int kKOffset = 2 * kOwnTile;
  static constexpr int kVOffset = kKOffset + kStages * kKvTile;
  static constexpr int kBarOffset = kVOffset + kKvTile;
  // own full, O full, O empty; K full and empty a stage; V full, V empty.
  static constexpr int kBars = 3 + 2 * kStages + 2;
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
};
static_assert(DqCfg<256>::kSmem <= kMaxSmem, "dQ fits at D 256");
static_assert(kStages * kPanel64 == kPanel128,
              "dQ's O tile takes the K stages");

template <int D>
struct DqSmem {
  using Cfg = DqCfg<D>;
  uint32_t base;
  unsigned char* ptr;  // base, as a generic pointer (for plain loads)
  __device__ const unsigned char* at(uint32_t addr) const {
    return ptr + (addr - base);
  }
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t dout() const { return base + Cfg::kOwnTile; }
  __device__ uint32_t o() const { return base + Cfg::kKOffset; }
  __device__ uint32_t k(int st) const {
    return base + Cfg::kKOffset + st * Cfg::kKvTile;
  }
  __device__ uint32_t v() const { return base + Cfg::kVOffset; }
  __device__ uint32_t bar(int i) const {
    return base + Cfg::kBarOffset + 8 * i;
  }
  __device__ uint32_t own_full() const { return bar(0); }
  __device__ uint32_t o_full() const { return bar(1); }
  __device__ uint32_t o_empty() const { return bar(2); }
  __device__ uint32_t k_full(int st) const { return bar(3 + st); }
  __device__ uint32_t k_empty(int st) const { return bar(3 + kStages + st); }
  __device__ uint32_t v_full() const { return bar(3 + 2 * kStages); }
  __device__ uint32_t v_empty() const { return bar(4 + 2 * kStages); }
};

// The producer's one thread: Q and dO once, the O tile (for delta) into
// the K stages when `with_o`, then each key tile's K and V through their
// rings; the first K waits until the consumers have read O.
template <int D>
__device__ __forceinline__ void produce_dq(const DqSmem<D>& sm,
                                           const CUtensorMap& qmap,
                                           const CUtensorMap& kmap,
                                           const CUtensorMap& vmap,
                                           const CUtensorMap& omap,
                                           const CUtensorMap& domap, int m0,
                                           int hi, int bi, int n_tiles,
                                           bool with_o) {
  using Cfg = DqCfg<D>;
  mbar_expect_tx(sm.own_full(), 2 * Cfg::kOwnTile);
#pragma unroll
  for (int pn = 0; pn < Cfg::kPanels; ++pn) {
    tma_load(sm.q() + pn * kPanel128, qmap, sm.own_full(), pn * kPanelCols,
             hi, m0, bi);
    tma_load(sm.dout() + pn * kPanel128, domap, sm.own_full(),
             pn * kPanelCols, hi, m0, bi);
  }
  if (with_o) {
    mbar_expect_tx(sm.o_full(), Cfg::kOwnTile);
#pragma unroll
    for (int pn = 0; pn < Cfg::kPanels; ++pn) {
      tma_load(sm.o() + pn * kPanel128, omap, sm.o_full(), pn * kPanelCols,
               hi, m0, bi);
    }
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const int n0 = j * kTileRows;
    if (j == 0 && with_o) mbar_wait(sm.o_empty(), 0);
    // Each ring's previous tile in the slot was released (round 0 passes
    // at once).
    mbar_wait(sm.k_empty(st), ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(sm.k_full(st), Cfg::kKvTile);
#pragma unroll
    for (int pn = 0; pn < Cfg::kPanels; ++pn) {
      tma_load(sm.k(st) + pn * kPanel64, kmap, sm.k_full(st),
               pn * kPanelCols, hi, n0, bi);
    }
    mbar_wait(sm.v_empty(), (j & 1) ^ 1);
    mbar_expect_tx(sm.v_full(), Cfg::kKvTile);
#pragma unroll
    for (int pn = 0; pn < Cfg::kPanels; ++pn) {
      tma_load(sm.v() + pn * kPanel64, vmap, sm.v_full(), pn * kPanelCols,
               hi, n0, bi);
    }
  }
}

// A consumer warpgroup of dQ: rows row[0] and row[1] of the m64
// accumulator layout (local rows rl and rl + 8 of the 128-row tile),
// warpgroup rows from m0w on.
template <int D>
__device__ __forceinline__ void consume_dq(const DqSmem<D>& sm,
                                           const Params& p, int c, int bh,
                                           int m0w, int rl,
                                           const int (&row)[2], int tq,
                                           int lane, int n_tiles, bool with_o,
                                           float (&dq)[D / 2]) {
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_addr = sm.q() + c * kWgRows * kRowBytes;
  const uint32_t do_addr = sm.dout() + c * kWgRows * kRowBytes;
  const long long stat0 = static_cast<long long>(bh) * p.s_q;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = row[i] < p.s_q ? p.lse[stat0 + row[i]] * kLog2e : 0.f;
  }
  mbar_wait(sm.own_full(), 0);
  if (with_o) {
    // delta = rowsum(f32(dO) * f32(O)) from dO and the O tile.
    mbar_wait(sm.o_full(), 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dlt[i] = row_dot<D>(sm.at(sm.dout()), sm.at(sm.o()), rl + 8 * i, tq,
                          kPanel128);
      if (tq == 0 && row[i] < p.s_q) p.delta[stat0 + row[i]] = dlt[i];
    }
    if (lane == 0) mbar_arrive(sm.o_empty());  // one arrive a warp
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dlt[i] = row[i] < p.s_q ? p.delta[stat0 + row[i]] : 0.f;
    }
  }
  // Keys [0, n_end) reach some row of this warpgroup; row i keeps the keys
  // before end[i].
  const int last = min(m0w + kWgRows, p.s_q) - 1;
  const int n_end =
      p.causal ? min(p.s_k, p.q_offset + last - p.k_offset + 1) : p.s_k;
  int end[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    end[i] = p.causal ? min(p.s_k, p.q_offset + row[i] - p.k_offset + 1)
                      : p.s_k;
  }
  float s[32], dp[32];
  uint32_t dsf[4][4];
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t k_ph = (j / kStages) & 1, v_ph = j & 1;
    const int n0 = j * kTileRows;
    // Both tiles before the first product: a wait between two wgmma
    // groups makes ptxas serialize them (C7520).
    mbar_wait(sm.k_full(st), k_ph);
    mbar_wait(sm.v_full(), v_ph);
    if (n0 >= n_end) {  // no row of this warpgroup sees the tile
      if (lane == 0) {
        mbar_arrive(sm.v_empty());
        mbar_arrive(sm.k_empty(st));
      }
      continue;
    }
    wgmma_fence();
    issue_ss<D>(s, q_addr, kPanel128, sm.k(st));
    wgmma_commit();
    issue_ss<D>(dp, do_addr, kPanel128, sm.v());
    wgmma_commit();
    wgmma_wait<1>();
    hold(s);
    // P = exp2(S' - lse') from f32 scores, masked with -1e30 on diagonal
    // and ragged tiles, while dP is on the tensor cores:
    // s[jj * 4 + i * 2 + e] is row row[i], key n0 + jj * 8 + tq * 2 + e.
    const bool need_mask =
        n0 + kTileRows > p.s_k ||
        (p.causal && p.k_offset + n0 + kTileRows - 1 > p.q_offset + m0w);
    const int col0 = n0 + tq * 2;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, col = (x >> 2) * 8 + (x & 1);
      float v = s[x] * scale2;
      if (need_mask && col >= end[i] - col0) v = kNegBig;
      s[x] = ex2(v - lse2[i]);
    }
    wgmma_wait<0>();
    hold(dp);
    if (lane == 0) mbar_arrive(sm.v_empty());  // the next V may load
    // dS = P (dP - delta), rounded to bf16 fragments for dQ += dS K.
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      dp[x] = s[x] * (dp[x] - dlt[(x >> 1) & 1]);
    }
    pack_a(dp, dsf);
    wgmma_fence();
    issue_rs<D>(dq, dsf, sm.k(st));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dq);
    hold(dsf);
    if (lane == 0) mbar_arrive(sm.k_empty(st));
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap,
                        const __grid_constant__ CUtensorMap domap,
                        const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t addr = smem_u32(smem_raw);
  const uint32_t aligned = (addr + 1023) & ~1023u;
  const DqSmem<D> sm{aligned, smem_raw + (aligned - addr)};
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full(), 1);
    mbar_init(sm.o_full(), 1);
    mbar_init(sm.o_empty(), kConsumerWarps);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.k_full(st), 1);
      mbar_init(sm.k_empty(st), kConsumerWarps);
    }
    mbar_init(sm.v_full(), 1);
    mbar_init(sm.v_empty(), kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int bh, tile;
  group_tile(p, (p.s_q + kBlockM - 1) / kBlockM, true, bh, tile);
  const int bi = bh / p.h, hi = bh % p.h;
  const int m0 = tile * kBlockM;
  // Keys [0, n_end) reach some row of this tile: causal, the last row's
  // global position bounds them.
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + min(m0 + kBlockM, p.s_q) -
                                       p.k_offset))
               : p.s_k;
  const int n_tiles = (n_end + kTileRows - 1) / kTileRows;
  const bool with_o = p.compute_delta != 0;
  const bool loads = n_tiles > 0 || with_o;

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && loads) {
      produce_dq<D>(sm, qmap, kmap, vmap, omap, domap, m0, hi, bi, n_tiles,
                    with_o);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x - wg * kWgThreads;
  const int lane = t & 31, tq = lane & 3;
  const int rl = c * kWgRows + (t >> 5) * 16 + (lane >> 2);
  const int row[2] = {m0 + rl, m0 + rl + 8};
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (loads) {
    consume_dq<D>(sm, p, c, bh, m0 + c * kWgRows, rl, row, tq, lane, n_tiles,
                  with_o, dq);
  }
  // dq[j * 4 + i * 2 + e]: row row[i], column j * 8 + tq * 2 + e. A row
  // that no key reaches stores zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.s_q) continue;
    bf16* orow = out_row_of<bf16>(p.dq, p, kDQ, bi, hi, row[i]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j * 8 >= p.d) break;  // the tile's zero columns past d
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) = pack_bf16(
          dq[j * 4 + i * 2] * p.scale, dq[j * 4 + i * 2 + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------- dK/dV

template <int D>
struct DkvCfg {
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kTile = kPanels * kPanel64;  // K, V, Q or dO tile
  // K | V | (Q, dO) x kStages | P^T f32 | lse, delta x kStages | barriers.
  static constexpr int kStreamOffset = 2 * kTile;
  static constexpr int kPOffset = kStreamOffset + 2 * kStages * kTile;
  static constexpr int kStatsOffset = kPOffset + kWgThreads * 32 * 4;
  static constexpr int kBarOffset =
      kStatsOffset + kStages * 2 * kTileRows * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // owned full, full, empty
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
};
static_assert(DkvCfg<256>::kSmem <= kMaxSmem, "dK/dV fits at D 256");

template <int D>
struct DkvSmem {
  using Cfg = DkvCfg<D>;
  uint32_t base;
  unsigned char* ptr;  // base, as a generic pointer (for plain accesses)
  __device__ uint32_t own(int i) const { return base + i * Cfg::kTile; }
  __device__ uint32_t stream(int st, int i) const {
    return base + Cfg::kStreamOffset + (2 * st + i) * Cfg::kTile;
  }
  __device__ float* pbuf() const {  // [32][128]: element x of thread t
    return reinterpret_cast<float*>(ptr + Cfg::kPOffset);
  }
  __device__ float* stats(int st) const {  // lse, then delta: 64 floats each
    return reinterpret_cast<float*>(ptr + Cfg::kStatsOffset) +
           st * 2 * kTileRows;
  }
  __device__ uint32_t own_full() const { return base + Cfg::kBarOffset; }
  __device__ uint32_t full(int st) const {
    return base + Cfg::kBarOffset + 8 * (1 + st);
  }
  __device__ uint32_t empty(int st) const {
    return base + Cfg::kBarOffset + 8 * (1 + kStages + st);
  }
};

// 4-byte asynchronous copy global -> shared; a source size of 0 writes a
// zero (the ragged edge) without reading.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The producer's warp: K and V once (one thread, TMA), then the Q/dO tiles
// through the ring, each with its rows' lse and delta, 4 bytes a copy from
// every lane (s_q * 4 need not be a multiple of TMA's 16 bytes), rows past
// s_q as zeros.
template <int D>
__device__ __forceinline__ void produce_dkv(const DkvSmem<D>& sm,
                                            const CUtensorMap& qmap,
                                            const CUtensorMap& kmap,
                                            const CUtensorMap& vmap,
                                            const CUtensorMap& domap,
                                            const Params& p, int bh, int n0,
                                            int hi, int bi, int m_begin,
                                            int n_qtiles, int lane) {
  constexpr int kPanels = DkvCfg<D>::kPanels;
  if (lane == 0) {
    mbar_expect_tx(sm.own_full(), 2 * DkvCfg<D>::kTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(sm.own(0) + pn * kPanel64, kmap, sm.own_full(),
               pn * kPanelCols, hi, n0, bi);
      tma_load(sm.own(1) + pn * kPanel64, vmap, sm.own_full(),
               pn * kPanelCols, hi, n0, bi);
    }
  }
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;
  for (int j = 0; j < n_qtiles; ++j) {
    const int st = j % kStages;
    const int m0 = m_begin + j * kTileRows;
    mbar_wait(sm.empty(st), ((j / kStages) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(sm.full(st), 2 * DkvCfg<D>::kTile);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load(sm.stream(st, 0) + pn * kPanel64, qmap, sm.full(st),
                 pn * kPanelCols, hi, m0, bi);
        tma_load(sm.stream(st, 1) + pn * kPanel64, domap, sm.full(st),
                 pn * kPanelCols, hi, m0, bi);
      }
    }
    float* stats = sm.stats(st);
#pragma unroll
    for (int r = lane; r < kTileRows; r += 32) {
      const bool valid = m0 + r < p.s_q;
      cp_async4(stats + r, valid ? lse + m0 + r : lse, valid);
      cp_async4(stats + kTileRows + r, valid ? delta + m0 + r : delta,
                valid);
    }
    cp_async_arrive(sm.full(st));
  }
  // The lanes' last copies land before they leave.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warpgroup A: P^T from S^T = K Q^T, handed to warpgroup B, and
// dV += P^T dO. Keys key[0] and key[1] of the m64 accumulator layout.
template <int D>
__device__ __forceinline__ void consume_dv(const DkvSmem<D>& sm,
                                           const Params& p, int n0,
                                           const int (&key)[2], int t,
                                           int tq, int lane, int m_begin,
                                           int n_qtiles, float (&dv)[D / 2]) {
  const float scale2 = p.scale * kLog2e;
  float* pbuf = sm.pbuf();
  float s[32];
  uint32_t pf[4][4];
  mbar_wait(sm.own_full(), 0);
  for (int j = 0; j < n_qtiles; ++j) {
    const int st = j % kStages;
    const int m0 = m_begin + j * kTileRows;
    mbar_wait(sm.full(st), (j / kStages) & 1);
    wgmma_fence();
    issue_ss<D>(s, sm.own(0), kPanel64, sm.stream(st, 0));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    // P^T from f32 scores and each query's lse, masked with -1e30 on
    // diagonal and ragged tiles: s[jj * 4 + i * 2 + e] is key key[i],
    // query m0 + jj * 8 + tq * 2 + e.
    const bool need_mask =
        m0 + kTileRows > p.s_q ||
        (p.causal && p.q_offset + m0 < p.k_offset + n0 + kTileRows - 1);
    // Key i sees the queries of the tile in [from[i], to), as offsets
    // from this thread's first column m0 + 2 tq.
    int from[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      from[i] = (p.causal ? p.k_offset + key[i] - p.q_offset : 0) -
                (m0 + tq * 2);
    }
    const int to = p.s_q - (m0 + tq * 2);
    const float* lse_s = sm.stats(st);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(lse_s + jj * 8 + tq * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = jj * 4 + e, i = e >> 1, col = jj * 8 + (e & 1);
        float v = s[x] * scale2;
        if (need_mask && (col < from[i] || col >= to)) v = kNegBig;
        s[x] = ex2(v - ((e & 1) ? l2.y : l2.x) * kLog2e);
      }
    }
    if (j > 0) named_sync(kPFree);  // B has read the previous tile's P^T
#pragma unroll
    for (int x = 0; x < 32; ++x) pbuf[x * kWgThreads + t] = s[x];
    named_arrive(kPReady);
    pack_a(s, pf);
    wgmma_fence();
    issue_rs<D>(dv, pf, sm.stream(st, 1));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dv);
    hold(pf);
    if (lane == 0) mbar_arrive(sm.empty(st));  // one arrive a warp
  }
}

// Warpgroup B: dP^T = V dO^T, dS^T = P^T (dP^T - delta) with warpgroup A's
// f32 P^T, and dK += dS^T Q.
template <int D>
__device__ __forceinline__ void consume_dk(const DkvSmem<D>& sm, int t,
                                           int tq, int lane, int n_qtiles,
                                           float (&dk)[D / 2]) {
  const float* pbuf = sm.pbuf();
  float dp[32];
  uint32_t dsf[4][4];
  mbar_wait(sm.own_full(), 0);
  for (int j = 0; j < n_qtiles; ++j) {
    const int st = j % kStages;
    mbar_wait(sm.full(st), (j / kStages) & 1);
    wgmma_fence();
    issue_ss<D>(dp, sm.own(1), kPanel64, sm.stream(st, 1));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dp);
    const float* delta_s = sm.stats(st) + kTileRows;
    named_sync(kPReady);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_s + jj * 8 + tq * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = jj * 4 + e;
        dp[x] = pbuf[x * kWgThreads + t] * (dp[x] - ((e & 1) ? dl.y : dl.x));
      }
    }
    if (j + 1 < n_qtiles) named_arrive(kPFree);
    pack_a(dp, dsf);
    wgmma_fence();
    issue_rs<D>(dk, dsf, sm.stream(st, 0));
    wgmma_commit();
    wgmma_wait<0>();
    hold(dk);
    hold(dsf);
    if (lane == 0) mbar_arrive(sm.empty(st));  // one arrive a warp
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t addr = smem_u32(smem_raw);
  const uint32_t aligned = (addr + 1023) & ~1023u;
  const DkvSmem<D> sm{aligned, smem_raw + (aligned - addr)};
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      // A stage is full once its TMA bytes and the 32 lanes' lse/delta
      // copies have landed.
      mbar_init(sm.full(st), 1 + 32);
      mbar_init(sm.empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int bh, tile;
  group_tile(p, (p.s_k + kTileRows - 1) / kTileRows, false, bh, tile);
  const int bi = bh / p.h, hi = bh % p.h;
  const int n0 = tile * kTileRows;
  // Queries that reach this tile: under the causal mask, those at global
  // positions from the global position of its first key on.
  const int m_begin =
      p.causal ? max(0, p.k_offset + n0 - p.q_offset) / kTileRows * kTileRows
               : 0;
  const int n_qtiles =
      m_begin < p.s_q ? (p.s_q - m_begin + kTileRows - 1) / kTileRows : 0;

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32 && n_qtiles > 0) {
      produce_dkv<D>(sm, qmap, kmap, vmap, domap, p, bh, n0, hi, bi, m_begin,
                     n_qtiles, threadIdx.x);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int t = threadIdx.x - wg * kWgThreads;
  const int lane = t & 31, tq = lane & 3;
  const int key[2] = {n0 + (t >> 5) * 16 + (lane >> 2),
                      n0 + (t >> 5) * 16 + (lane >> 2) + 8};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_qtiles > 0) {
    if (wg == 1) {
      consume_dv<D>(sm, p, n0, key, t, tq, lane, m_begin, n_qtiles, acc);
    } else {
      consume_dk<D>(sm, t, tq, lane, n_qtiles, acc);
    }
  }
  // acc[j * 4 + i * 2 + e]: key key[i], column j * 8 + tq * 2 + e; dV from
  // warpgroup A, dK (scaled) from B. A key tile that no query reaches
  // stores zeros.
  const float scale = wg == 1 ? 1.f : p.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.s_k) continue;
    bf16* orow = wg == 1 ? out_row_of<bf16>(p.dv, p, kDV, bi, hi, key[i])
                         : out_row_of<bf16>(p.dk, p, kDK, bi, hi, key[i]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (j * 8 >= p.d) break;  // the tile's zero columns past d
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) = pack_bf16(
          acc[j * 4 + i * 2] * scale, acc[j * 4 + i * 2 + 1] * scale);
    }
  }
}

// ------------------------------------------------------------------ launch

// The map of tensor `which` at `s` rows and the true head dim p.d,
// `box_rows` rows a box.
int encode_tensor(CUtensorMap* map, const void* ptr, const Params& p,
                  int which, int s, int box_rows) {
  return encode(map, ptr, p.b, s, p.h, p.d, p.st[which][0], p.st[which][1],
                p.st[which][2], box_rows);
}

template <int D, bool kPartial>
int launch_fwd_bf16(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = FwdCfg<D>::kSmem;
  CUtensorMap maps[3];
  int err = encode_tensor(&maps[0], p.q, p, kQ, p.s_q, kBlockM);
  if (err == 0) err = encode_tensor(&maps[1], p.k, p, kK, p.s_k, kTileRows);
  if (err == 0) err = encode_tensor(&maps[2], p.v, p, kV, p.s_k, kTileRows);
  if (err != 0) return err;
  const void* kernel =
      kPartial ? reinterpret_cast<const void*>(&wide_partial_bf16_kernel<D>)
               : reinterpret_cast<const void*>(&wide_fwd_bf16_kernel<D>);
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  err = prepare(kernel, kSmem, l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // K and V stream through every Q tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s_k * p.d * 2, l2);
  const long long ctas = static_cast<long long>(p.b) * p.h *
                         ((p.s_q + kBlockM - 1) / kBlockM);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(ctas));
  if constexpr (kPartial) {
    wide_partial_bf16_kernel<D><<<grid, kHopperThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], grouped);
  } else {
    wide_fwd_bf16_kernel<D><<<grid, kHopperThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], grouped);
  }
  return cudaGetLastError();
}

template <bool kPartial>
int launch_fwd_sliced(const Params& p, int slices, cudaStream_t stream) {
  CUtensorMap maps[3];
  int err = encode_tensor(&maps[0], p.q, p, kQ, p.s_q, kBlockM);
  if (err == 0) err = encode_tensor(&maps[1], p.k, p, kK, p.s_k, kTileRows);
  if (err == 0) err = encode_tensor(&maps[2], p.v, p, kV, p.s_k, kTileRows);
  if (err != 0) return err;
  const void* kernel =
      kPartial ? reinterpret_cast<const void*>(&wide_partial_bf16_sliced_kernel)
               : reinterpret_cast<const void*>(&wide_fwd_bf16_sliced_kernel);
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  // The limit every head dim's layout fits under.
  err = prepare(kernel, kMaxSmem, l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // K and V stream through every Q tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s_k * p.d * 2, l2);
  grouped.slices = slices;
  const long long ctas = static_cast<long long>(p.b) * p.h *
                         ((p.s_q + kBlockM - 1) / kBlockM) * slices;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int smem = sliced_layout(p.d).smem;
  if constexpr (kPartial) {
    wide_partial_bf16_sliced_kernel<<<static_cast<unsigned>(ctas),
                                      kHopperThreads, smem, stream>>>(
        maps[0], maps[1], maps[2], grouped);
  } else {
    wide_fwd_bf16_sliced_kernel<<<static_cast<unsigned>(ctas), kHopperThreads,
                                  smem, stream>>>(maps[0], maps[1], maps[2],
                                                  grouped);
  }
  return cudaGetLastError();
}

// The f32 forward (kPartial false) or partial of flash_attention_f32.cuh
// over `slices` output-column slices: 192 columns for heads up to 192,
// else 256 a slice.
template <bool kPartial>
int launch_fwd_f32(const Params& p, int slices, cudaStream_t stream) {
  f32fwd::Params f{};
  f.q = static_cast<const float*>(p.q);
  f.k = static_cast<const float*>(p.k);
  f.v = static_cast<const float*>(p.v);
  f.o = static_cast<float*>(p.o_out);
  f.lse = p.lse_out;
  f.m = p.m;
  f.l = p.l;
  f.b = p.b, f.s = p.s_q, f.h = p.h, f.d = p.d;
  const int which[4] = {kQ, kK, kV, kO};
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) f.st[i][j] = p.st[which[i]][j];
  }
  f.scale = p.scale;
  f.causal = p.causal;
  f.q_offset = p.q_offset;
  f.k_offset = p.k_offset;
  f.slices = slices;
  return p.d <= 192 ? f32fwd::launch<192, kPartial>(f, stream)
                    : f32fwd::launch<256, kPartial>(f, stream);
}

// The f32 dQ (kDkv false) or dK/dV of flash_attention_f32_bwd.cuh over
// `slices` output-column slices: 192 columns for heads up to 192, else 256
// a slice.
template <bool kDkv>
int launch_bwd_f32(const Params& p, int slices, cudaStream_t stream) {
  f32bwd::Params f = f32bwd::params_of(p);
  f.slice_cols = kSliceCols;
  f.slices = slices;
  return p.d <= 192 ? f32bwd::launch<192, kDkv>(f, stream)
                    : f32bwd::launch<256, kDkv>(f, stream);
}

template <int D>
int launch_dq_bf16(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = DqCfg<D>::kSmem;
  CUtensorMap maps[5] = {};  // q, k, v, o, dO; o only for delta
  const struct {
    const void* ptr;
    int which, s, box_rows;
  } tensors[5] = {{p.q, kQ, p.s_q, kBlockM},
                  {p.k, kK, p.s_k, kTileRows},
                  {p.v, kV, p.s_k, kTileRows},
                  {p.o, kO, p.s_q, kBlockM},
                  {p.dout, kDO, p.s_q, kBlockM}};
  for (int i = 0; i < 5; ++i) {
    if (i == 3 && !p.compute_delta) continue;
    const int err = encode_tensor(&maps[i], tensors[i].ptr, p,
                                  tensors[i].which, tensors[i].s,
                                  tensors[i].box_rows);
    if (err != 0) return err;
  }
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  const int err = prepare(
      reinterpret_cast<const void*>(&wide_dq_bf16_kernel<D>), kSmem,
      l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // K and V stream through every Q tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s_k * p.d * 2, l2);
  const long long ctas = static_cast<long long>(p.b) * p.h *
                         ((p.s_q + kBlockM - 1) / kBlockM);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  wide_dq_bf16_kernel<D>
      <<<static_cast<unsigned>(ctas), kHopperThreads, kSmem, stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], grouped);
  return cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = DkvCfg<D>::kSmem;
  CUtensorMap maps[4];
  const struct {
    const void* ptr;
    int which, s;
  } tensors[4] = {{p.q, kQ, p.s_q},
                  {p.k, kK, p.s_k},
                  {p.v, kV, p.s_k},
                  {p.dout, kDO, p.s_q}};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_tensor(&maps[i], tensors[i].ptr, p,
                                  tensors[i].which, tensors[i].s, kTileRows);
    if (err != 0) return err;
  }
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  const int err = prepare(
      reinterpret_cast<const void*>(&wide_dkv_bf16_kernel<D>), kSmem,
      l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // Q and dO stream through every key tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s_q * p.d * 2, l2);
  const long long ctas = static_cast<long long>(p.b) * p.h *
                         ((p.s_k + kTileRows - 1) / kTileRows);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  wide_dkv_bf16_kernel<D>
      <<<static_cast<unsigned>(ctas), kHopperThreads, kSmem, stream>>>(
          maps[0], maps[1], maps[2], maps[3], grouped);
  return cudaGetLastError();
}

// A simple kernel over (b*h, owned tile) x column slices: the owned rows'
// inputs held in shared memory where `smem_of(d, true)` fits (never above
// kMaxHeldCols, which keeps the sum in an int).
constexpr int kMaxHeldCols = 4096;
static_assert(dq_smem(kMaxHeldCols, true) > kMaxSmem,
              "no held width is cut off by kMaxHeldCols");

int launch_simple(void (*kernel)(Params), Params p, int rows, int slices,
                  int (*smem_of)(int, bool), cudaStream_t stream) {
  p.held = p.d <= kMaxHeldCols && smem_of(p.d, true) <= kMaxSmem;
  const int smem = smem_of(p.d, p.held);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ctas =
      static_cast<long long>(p.b) * p.h * ((rows + kOwn - 1) / kOwn);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(static_cast<unsigned>(ctas), slices), kThreads, smem,
           stream>>>(p);
  return cudaGetLastError();
}

int smem_dq(int d, bool held) { return dq_smem(d, held); }
int smem_dkv(int d, bool held) { return dkv_smem(d, held); }

bool takes(int d, int dtype, int s_q, int s_k) {
  return d >= 8 && d % 8 == 0 && (dtype == 0 || dtype == 1) && s_q >= 1 &&
         s_k >= 1;
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
// returns a cudaError_t (0 on success), or 100000 + the CUresult of a
// failed tensor-map encode; the launch is asynchronous on `stream`. The
// head dim d is any multiple of 8. `width` and `slices` are the caller's
// plan (see has_plan); a plan the library lacks returns
// cudaErrorInvalidValue.

// The forward (partial = 0: o in q's dtype, lse) or the ring hop's partial
// (partial = 1, causal: o the f32 unnormalized accumulator, m and l).
extern "C" int kftpu_wide_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, float* m, float* l, int b,
                              int s, int h, int d, int dtype,
                              const long long* strides, float scale,
                              int causal, int q_offset, int k_offset,
                              int partial, int width, int slices,
                              void* stream) {
  if (!takes(d, dtype, s, s) || !has_plan(d, dtype, width, slices)) {
    return cudaErrorInvalidValue;
  }
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
  if (width != 0) {
    if (width == 192) {
      return partial ? launch_fwd_bf16<192, true>(p, st)
                     : launch_fwd_bf16<192, false>(p, st);
    }
    return partial ? launch_fwd_bf16<256, true>(p, st)
                   : launch_fwd_bf16<256, false>(p, st);
  }
  if (dtype == 0) {
    return partial ? launch_fwd_f32<true>(p, slices, st)
                   : launch_fwd_f32<false>(p, slices, st);
  }
  return partial ? launch_fwd_sliced<true>(p, slices, st)
                 : launch_fwd_sliced<false>(p, slices, st);
}

// dQ, and delta = rowsum(dO * O) into `delta` first when compute_delta.
extern "C" int kftpu_wide_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int b,
    int s_q, int s_k, int h, int d, int dtype, const long long* strides,
    float scale, int causal, int q_offset, int k_offset, int compute_delta,
    int width, int slices, void* stream) {
  if (!takes(d, dtype, s_q, s_k) || !has_plan(d, dtype, width, slices)) {
    return cudaErrorInvalidValue;
  }
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
  if (width != 0) {
    return width == 192 ? launch_dq_bf16<192>(p, st)
                        : launch_dq_bf16<256>(p, st);
  }
  if (dtype == 0) return launch_bwd_f32<false>(p, slices, st);
  return launch_simple(&wide_dq_kernel<__nv_bfloat16>, p, s_q, slices,
                       &smem_dq, st);
}

// dK and dV from the delta the dQ launch wrote (or the caller gave).
extern "C" int kftpu_wide_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int s_q,
    int s_k, int h, int d, int dtype, const long long* strides, float scale,
    int causal, int q_offset, int k_offset, int width, int slices,
    void* stream) {
  if (!takes(d, dtype, s_q, s_k) || !has_plan(d, dtype, width, slices)) {
    return cudaErrorInvalidValue;
  }
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
  if (width != 0) {
    return width == 192 ? launch_dkv_bf16<192>(p, st)
                        : launch_dkv_bf16<256>(p, st);
  }
  if (dtype == 0) return launch_bwd_f32<true>(p, slices, st);
  return launch_simple(&wide_dkv_kernel<__nv_bfloat16>, p, s_k, slices,
                       &smem_dkv, st);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return error_string(err);
}
