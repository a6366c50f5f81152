// Flash-attention backward in float32 on the CUDA cores (sm_90a): the dQ
// kernel and the dK/dV kernel at every head dim that is a multiple of 8.
// flash_attention_bwd.cu launches them for heads up to 128 columns,
// flash_attention_wide.cu for wider ones (over output-column slices of 256);
// each library compiles the instantiations it launches.
//
// Replaces, in float32, the TPU kernels _bwd_dq_kernel and _bwd_dkv_kernel
// (both launched by _flash_bwd) of kubeflow_tpu/ops/flash_attention.py,
// with their function and rounding points: S, P, dP, dS and every
// accumulator in f32; P = exp(S * scale - lse) from the forward's f32 lse,
// dP = dO V^T, dS = P (dP - delta), dQ = scale * dS K, dV = P^T dO,
// dK = scale * dS^T Q. The causal mask is global: query row i sits at
// q_offset + i and key j at k_offset + j (a ring hop's blocks); a key that
// a query does not see, and a row or key past the tensor, contributes
// exactly 0, so an output row that no key reaches is exactly 0. delta =
// rowsum(dO * O), a plain sum outside the TPU kernels, is fused into the
// dQ launch when compute_delta (slice 0 writes it); a ring hop passes the
// final delta in. Every product is an exact f32 FMA (no TF32: the tests and
// chip_smoke.py hold f32 at 1e-4, summation order only); P is ex2.approx.ftz
// of scores scaled by scale * log2(e) less lse * log2(e), as the forward's.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s)
// at [8, 1024, 16, d] causal: dQ's three products (S, dP, dS K) are 3 * 2 b
// h pairs d FLOP (51.6 GFLOP at d = 128, 0.770 ms) against six [b, s, h,
// d] f32 tensors and two f32 rows (403 MB, 0.120 ms); dK/dV's four (S, dP,
// P^T dO, dS^T Q) 68.8 GFLOP (1.027 ms): both bound by operations at every
// d. So the design is the forward's (flash_attention_f32.cuh): an
// SGEMM-style register-tiled loop that keeps the FMA pipe fed, with two
// contractions for the scores where the forward has one, and its output
// product reading dS (P) from shared memory.
//
// Design:
//  * One CTA per (b*h, owned tile, output-column slice): 128 or 64 owned
//    rows (query rows for dQ, keys for dK/dV), the slices of one tile side
//    by side in the launch order, (batch, head) pairs in groups of as many
//    heads as half the L2 holds the streamed tensors of, each group's
//    tiles from the heaviest causal one on (dQ: the last query tile; dK/dV:
//    the first key tile). No atomics: two launches give the same bits.
//  * Three warpgroups: a producer whose registers setmaxnreg hands to two
//    consumer warpgroups (24 and 240 a thread; the balance is a
//    static_assert). dK/dV carries two accumulators where the forward
//    carries one: at 256 columns 2 x 4 rows x 16 columns = 128 registers,
//    beside the S and dP tiles, which the forward's 168 would spill.
//  * Loads: one thread of the producer issues TMA loads of 32-column f32
//    panels (128-byte rows, 128-byte swizzle, rows and columns past the
//    tensor as zeros) through the tensors' strides: for each streamed tile
//    of 64 rows (keys for dQ, queries for dK/dV), the owned pair's and the
//    streamed pair's panels c = 0 .. d/32 (dQ: Q, dO | K, V; dK/dV: K, V |
//    Q, dO) through a ring of 2 or 3 stages, then the streamed tile's
//    panels of the slice's output columns (dQ: K; dK/dV: Q and dO) into
//    one buffer. Heads of up to 32 columns (one panel) skip that buffer:
//    the output product reads the stage, which is released after it.
//  * Register tiles, as the forward's: kTx threads share an owned row
//    (neighbouring lanes), 8 for outputs of up to 64 columns (128 owned
//    rows), 16 above (64 rows). Thread (ty, tx) holds S and dP for owned
//    rows ty + r R/4 (r < 4) and streamed rows tx + kTx e, and the
//    accumulators for the same owned rows at DV / kTx columns. Operands are
//    float4 reads along the contraction whose swizzle puts a warp's reads on
//    distinct banks.
//  * dS (dQ) and P^T then dS^T (dK/dV) go through one shared tile ([rows][72
//    or 80] f32) that a warp writes and reads only in its own rows: a
//    __syncwarp orders it. The output products read it as float4 along the
//    streamed rows and the slice's panels as float4 rows.
//  * Masks only on tiles that cross the diagonal or the ragged edge; dQ
//    skips key tiles above the diagonal, dK/dV query tiles that no key of
//    the tile reaches.
//  * Output-column slices: a CTA accumulates the columns [c_lo, c_lo +
//    slice_cols) of its outputs; S and dP contract over all of d in every
//    slice in the same order, so the slices agree bitwise and slice 0 alone
//    writes delta.

#pragma once

#include "flash_attention_f32.cuh"
#include "hopper.cuh"

// In the unnamed namespace of the source that includes it, as the forward's
// header (flash_attention_f32.cuh says why).
namespace {
namespace f32bwd {

using namespace kftpu;
using f32fwd::lds;
using f32fwd::stg;
using f32fwd::swz;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCols = kRowBytes / 4;          // f32 columns of a panel: 32
constexpr int kStream = 64;                   // streamed rows a tile
constexpr int kPanelS = kStream * kRowBytes;  // a streamed panel: 8 KB
constexpr int kSmemLimit = 232448;            // bytes a CTA may have on sm_90
constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // a producer and two consumer WGs
constexpr int kWarps = 8;                 // consumer warps
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// setmaxnreg.inc waits until the CTA's other warps gave the registers back:
// what the consumers take must fit what the SM holds beside the producer.
static_assert(kWgThreads * kProducerRegs + 2 * kWgThreads * kConsumerRegs <=
                  65536,
              "setmaxnreg's registers balance");

// The tensors whose (batch, seq, head) strides a launch is given, in the C
// interface's order.
enum Tensor { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;     // dQ, for delta
  const float* dout;
  const float* lse;   // [b*h, s_q]
  float* delta;       // [b*h, s_q]: dQ writes it when compute_delta
  float* dq;
  float* dk;
  float* dv;
  int b, s_q, s_k, h, d;  // d: the true head dim
  long long st[kTensors][3];
  float scale;
  int causal, q_offset, k_offset, compute_delta;
  int slice_cols, slices;  // output columns a slice, and slices
  int group;               // the launch order: (batch, head) pairs a group
};

// The kernels' parameters from an including library's own, whose fields
// of the same names hold the same values (pointers as void*, strides in
// the same order); the caller sets slice_cols and slices.
template <class P>
Params params_of(const P& p) {
  Params f{};
  f.q = static_cast<const float*>(p.q);
  f.k = static_cast<const float*>(p.k);
  f.v = static_cast<const float*>(p.v);
  f.o = static_cast<const float*>(p.o);
  f.dout = static_cast<const float*>(p.dout);
  f.lse = p.lse;
  f.delta = p.delta;
  f.dq = static_cast<float*>(p.dq);
  f.dk = static_cast<float*>(p.dk);
  f.dv = static_cast<float*>(p.dv);
  f.b = p.b, f.s_q = p.s_q, f.s_k = p.s_k, f.h = p.h, f.d = p.d;
  for (int i = 0; i < kTensors; ++i) {
    for (int j = 0; j < 3; ++j) f.st[i][j] = p.st[i][j];
  }
  f.scale = p.scale;
  f.causal = p.causal;
  f.q_offset = p.q_offset;
  f.k_offset = p.k_offset;
  f.compute_delta = p.compute_delta;
  return f;
}

// The instantiation for output slices of up to DV columns; kDkv: dK/dV.
template <int DV, bool kDkv>
struct Cfg {
  static constexpr int kTx = DV <= 64 ? 8 : 16;
  static constexpr int kKe = kStream / kTx;
  static constexpr int kRows = kWarps * 4 * (32 / kTx);  // owned rows
  static constexpr int kRowStep = kRows / 4;
  static constexpr int kPanelO = kRows * kRowBytes;  // an owned panel
  // A stage: the owned pair's panel, then the streamed pair's.
  static constexpr int kStage = 2 * kPanelO + 2 * kPanelS;
  // One panel holds every column: the output product reads the stage.
  static constexpr bool kHold = DV <= kCols;
  static constexpr int kOPanels = kHold ? 0 : (DV + kCols - 1) / kCols;
  static constexpr int kOBytes = (kDkv ? 2 : 1) * kOPanels * kPanelS;
  static constexpr int kCpt = DV / kTx;  // output columns a thread
  static constexpr int kVw = kCpt < 4 ? kCpt : 4;  // ... as vectors of kVw
  static constexpr int kNg = kCpt / kVw;           // ... kNg of them
  // A row group's kTx threads write kTx consecutive streamed rows of 32 /
  // kTx consecutive owned rows at once: the pitch puts them on distinct
  // banks.
  static constexpr int kPitch = kStream + (kTx == 8 ? 8 : 16);
  static constexpr int kTileBytes = kRows * kPitch * 4;
  static constexpr int kRest = kOBytes + kTileBytes + 8 * (2 * 3 + 2) + 1024;
  static constexpr int kStages = 3 * kStage + kRest <= kSmemLimit ? 3 : 2;
  // Stages | output panels | the dS (P) tile | barriers, 1024-aligned.
  static constexpr int kOOffset = kStages * kStage;
  static constexpr int kTileOffset = kOOffset + kOBytes;
  static constexpr int kBarOffset = kTileOffset + kTileBytes;
  static constexpr int kBars = 2 * kStages + 2;  // full, empty, out full, empty
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
  static_assert(DV % kTx == 0 && kCpt % kVw == 0, "an output slice");
  static_assert(kSmem <= kSmemLimit, "one CTA's shared memory");
};
static_assert(Cfg<256, true>::kStages == 2 && Cfg<256, false>::kStages == 3 &&
                  Cfg<64, true>::kStages == 3,
              "the widest instantiations fit their rings");

// The CTA's (b*h, owned tile, output slice): slices innermost, then the
// group's heads side by side, each group's tiles from the last first when
// `last_first`.
struct Tile {
  int bh, bi, hi, r0, slice, c_lo, cols;
};

template <int kRows>
__device__ __forceinline__ Tile tile_of(const Params& p, int rows,
                                        bool last_first) {
  const int tiles = (rows + kRows - 1) / kRows;
  const int slice = blockIdx.x % p.slices;
  const int idx = blockIdx.x / p.slices;
  const int per_group = p.group * tiles;
  const int g0 = idx / per_group, rem = idx % per_group;
  const int heads = min(p.group, p.b * p.h - g0 * p.group);
  const int bh = g0 * p.group + rem % heads, tt = rem / heads;
  const int c_lo = slice * p.slice_cols;
  return {bh,
          bh / p.h,
          bh % p.h,
          (last_first ? tiles - 1 - tt : tt) * kRows,
          slice,
          c_lo,
          min(p.slice_cols, p.d - c_lo)};
}

// s[r][e] += sum over the panel's first 4 * steps columns of A's row
// ty + r * kRowStep times B's row tx + kTx * e (both swizzled panels).
template <int kTx, int kKe, int kRowStep>
__device__ __forceinline__ void contract(const unsigned char* a,
                                         const unsigned char* b, int ty,
                                         int tx, int steps,
                                         float (&s)[4][kKe]) {
#pragma unroll
  for (int k4 = 0; k4 < kCols / 4; ++k4) {
    if (k4 >= steps) break;  // the panel's zero columns past d
    float x[4][4], y[kKe][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) lds<4>(a + swz(ty + r * kRowStep, 4 * k4), x[r]);
#pragma unroll
    for (int e = 0; e < kKe; ++e) lds<4>(b + swz(tx + kTx * e, 4 * k4), y[e]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int e = 0; e < kKe; ++e) s[r][e] = fmaf(x[r][i], y[e][i], s[r][e]);
      }
    }
  }
}

// acc[r][.] += sum over the 64 streamed rows j of tile[row r][j] times the
// output panels' row j at this thread's columns: tile rows are the
// thread's owned rows, `ot` the slice's panels (kPanelS bytes apart).
template <class C>
__device__ __forceinline__ void product(const float* tile,
                                        const unsigned char* ot, int ty,
                                        int tx, float (&acc)[4][C::kCpt]) {
#pragma unroll 2
  for (int j4 = 0; j4 < kStream / 4; ++j4) {
    float pr[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      lds<4>(reinterpret_cast<const unsigned char*>(
                 tile + (ty + r * C::kRowStep) * C::kPitch + 4 * j4),
             pr[r]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int row = 4 * j4 + jj;
      float w[C::kNg][C::kVw];
#pragma unroll
      for (int i = 0; i < C::kNg; ++i) {
        const int col = (i * C::kTx + tx) * C::kVw;
        lds<C::kVw>(ot + (col / kCols) * kPanelS + swz(row, col % kCols),
                    w[i]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < C::kNg; ++i) {
#pragma unroll
          for (int e = 0; e < C::kVw; ++e) {
            acc[r][i * C::kVw + e] =
                fmaf(pr[r][jj], w[i][e], acc[r][i * C::kVw + e]);
          }
        }
      }
    }
  }
}

// Row `row` of head (bi, hi) of tensor `which`.
__device__ __forceinline__ long long row_at(const Params& p, int which,
                                            int bi, int hi, int row) {
  return bi * p.st[which][0] + hi * p.st[which][2] +
         static_cast<long long>(row) * p.st[which][1];
}

// Stores the thread's 4 rows of acc * mul at the slice's columns, rows at
// or past `rows` not stored.
template <class C>
__device__ __forceinline__ void store(float* out, const Params& p, int which,
                                      const Tile& t, int ty, int tx,
                                      int rows, float mul,
                                      const float (&acc)[4][C::kCpt]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = t.r0 + ty + r * C::kRowStep;
    if (row >= rows) continue;
    float* o = out + row_at(p, which, t.bi, t.hi, row) + t.c_lo;
#pragma unroll
    for (int i = 0; i < C::kNg; ++i) {
      const int col = (i * C::kTx + tx) * C::kVw;
      if (col >= t.cols) continue;
      float x[C::kVw];
#pragma unroll
      for (int e = 0; e < C::kVw; ++e) x[e] = acc[r][i * C::kVw + e] * mul;
      stg<C::kVw>(o + col, x);
    }
  }
}

template <int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dq_f32_tiled_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const Params p) {
  using C = Cfg<DV, false>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t bars = base + C::kBarOffset;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (C::kStages + st); };
  const uint32_t o_full = bars + 8 * (2 * C::kStages);
  const uint32_t o_empty = o_full + 8;

  const Tile t = tile_of<C::kRows>(p, p.s_q, true);
  const int m0 = t.r0;
  // Keys [0, n_end) reach some row of this tile: causal, the last row's
  // global position bounds them.
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + min(m0 + C::kRows, p.s_q) -
                                       p.k_offset))
               : p.s_k;
  const int n_tiles = (n_end + kStream - 1) / kStream;
  const int nc = (p.d + kCols - 1) / kCols;  // panels of the contraction

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kWarps);
    }
    mbar_init(o_full, 1);
    mbar_init(o_empty, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // the producer: one thread issues loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int opanels = min(C::kOPanels, (t.cols + kCols - 1) / kCols);
      for (int j = 0; j < n_tiles; ++j) {
        const int n0 = j * kStream;
        for (int c = 0; c < nc; ++c) {
          const int g = j * nc + c, st = g % C::kStages;
          // The stage's previous panels were released (round 0 passes).
          mbar_wait(empty(st), ((g / C::kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), C::kStage);
          const uint32_t dst = base + st * C::kStage;
          tma_load(dst, qmap, full(st), c * kCols, t.hi, m0, t.bi);
          tma_load(dst + C::kPanelO, domap, full(st), c * kCols, t.hi, m0,
                   t.bi);
          tma_load(dst + 2 * C::kPanelO, kmap, full(st), c * kCols, t.hi, n0,
                   t.bi);
          tma_load(dst + 2 * C::kPanelO + kPanelS, vmap, full(st), c * kCols,
                   t.hi, n0, t.bi);
        }
        if constexpr (!C::kHold) {  // K's panels of the slice's columns
          mbar_wait(o_empty, (j & 1) ^ 1);
          mbar_expect_tx(o_full, opanels * kPanelS);
          for (int pn = 0; pn < opanels; ++pn) {
            tma_load(base + C::kOOffset + pn * kPanelS, kmap, o_full,
                     t.c_lo + pn * kCols, t.hi, n0, t.bi);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // Consumer thread (ty, tx): S, dP and dS for query rows ty + r R / 4 and
  // keys tx + kTx e of a tile; dQ for the same rows at its columns.
  constexpr int kTx = C::kTx, kKe = C::kKe, kRowStep = C::kRowStep;
  const int lane = threadIdx.x & 31;
  const int tx = lane % kTx,
            ty = (threadIdx.x / 32 - 4) * (32 / kTx) + lane / kTx;
  const float scale2 = p.scale * kLog2e;
  float* const tile = reinterpret_cast<float*>(sm + C::kTileOffset);
  float lse2[4], dl[4];
  int end[4];  // row r sees the keys before end[r] (local indices)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty + r * kRowStep;
    const long long at = static_cast<long long>(t.bh) * p.s_q + row;
    lse2[r] = row < p.s_q ? p.lse[at] * kLog2e : 0.f;
    end[r] = p.causal ? min(p.s_k, p.q_offset + row - p.k_offset + 1) : p.s_k;
    if (p.compute_delta) {
      // delta = rowsum(dO * O): the row's kTx threads take every kTx-th
      // 4-column group, then sum by shuffles (every slice in one order).
      float part = 0.f;
      if (row < p.s_q) {
        const float* orow = p.o + row_at(p, kO, t.bi, t.hi, row);
        const float* drow = p.dout + row_at(p, kDO, t.bi, t.hi, row);
        for (int c4 = tx; c4 < p.d / 4; c4 += kTx) {
          const float4 x = *reinterpret_cast<const float4*>(orow + 4 * c4);
          const float4 y = *reinterpret_cast<const float4*>(drow + 4 * c4);
          part = fmaf(y.x, x.x, part);
          part = fmaf(y.y, x.y, part);
          part = fmaf(y.z, x.z, part);
          part = fmaf(y.w, x.w, part);
        }
      }
#pragma unroll
      for (int off = 1; off < kTx; off <<= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      dl[r] = part;
      if (t.slice == 0 && tx == 0 && row < p.s_q) p.delta[at] = part;
    } else {
      dl[r] = row < p.s_q ? p.delta[at] : 0.f;
    }
  }

  float acc[4][C::kCpt];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < C::kCpt; ++i) acc[r][i] = 0.f;
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kStream;
    float s[4][kKe], dp[4][kKe];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < kKe; ++e) s[r][e] = dp[r][e] = 0.f;
    }
    const unsigned char* held = nullptr;  // kHold: the stage's K panel
    int held_st = 0;
    for (int c = 0; c < nc; ++c) {
      const int g = j * nc + c, st = g % C::kStages;
      mbar_wait(full(st), (g / C::kStages) & 1);
      const unsigned char* qp = sm + st * C::kStage;
      const unsigned char* kp = qp + 2 * C::kPanelO;
      const int steps = min(kCols, p.d - c * kCols) / 4;  // d % 8 == 0
      contract<kTx, kKe, kRowStep>(qp, kp, ty, tx, steps, s);
      contract<kTx, kKe, kRowStep>(qp + C::kPanelO, kp + kPanelS, ty, tx,
                                   steps, dp);
      if constexpr (C::kHold) {
        held = kp;
        held_st = st;
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));  // one arrive a warp
      }
    }

    // dS = P (dP - delta), P = 2^(S scale log2 e - lse log2 e), masked on
    // diagonal and ragged tiles.
    const bool need_mask =
        n0 + kStream > p.s_k ||
        (p.causal && p.k_offset + n0 + kStream - 1 > p.q_offset + m0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < kKe; ++e) {
        float pr = ex2(fmaf(s[r][e], scale2, -lse2[r]));
        if (need_mask && n0 + tx + kTx * e >= end[r]) pr = 0.f;
        tile[(ty + r * kRowStep) * C::kPitch + tx + kTx * e] =
            pr * (dp[r][e] - dl[r]);
      }
    }
    __syncwarp();  // dS of the warp's rows is in shared memory

    if constexpr (!C::kHold) mbar_wait(o_full, j & 1);
    product<C>(tile, C::kHold ? held : sm + C::kOOffset, ty, tx, acc);
    __syncwarp();  // the warp's reads of dS and K are done
    if (lane == 0) mbar_arrive(C::kHold ? empty(held_st) : o_empty);
  }
  store<C>(p.dq, p, kDQ, t, ty, tx, p.s_q, p.scale, acc);
}

template <int DV>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_f32_tiled_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const Params p) {
  using C = Cfg<DV, true>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t bars = base + C::kBarOffset;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (C::kStages + st); };
  const uint32_t o_full = bars + 8 * (2 * C::kStages);
  const uint32_t o_empty = o_full + 8;

  const Tile t = tile_of<C::kRows>(p, p.s_k, false);
  const int n0 = t.r0;
  // Queries from m_first on see some key of this tile (causal: the first
  // key's global position bounds them); their 64-row tiles from m_begin.
  const int m_first = p.causal ? max(0, p.k_offset + n0 - p.q_offset) : 0;
  const int m_begin =
      m_first < p.s_q ? m_first / kStream * kStream : p.s_q;
  const int m_tiles = (p.s_q - m_begin + kStream - 1) / kStream;
  const int nc = (p.d + kCols - 1) / kCols;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kWarps);
    }
    mbar_init(o_full, 1);
    mbar_init(o_empty, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {  // the producer: one thread issues loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && m_tiles > 0) {
      const int opanels = min(C::kOPanels, (t.cols + kCols - 1) / kCols);
      for (int j = 0; j < m_tiles; ++j) {
        const int m0 = m_begin + j * kStream;
        for (int c = 0; c < nc; ++c) {
          const int g = j * nc + c, st = g % C::kStages;
          mbar_wait(empty(st), ((g / C::kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), C::kStage);
          const uint32_t dst = base + st * C::kStage;
          tma_load(dst, kmap, full(st), c * kCols, t.hi, n0, t.bi);
          tma_load(dst + C::kPanelO, vmap, full(st), c * kCols, t.hi, n0,
                   t.bi);
          tma_load(dst + 2 * C::kPanelO, qmap, full(st), c * kCols, t.hi, m0,
                   t.bi);
          tma_load(dst + 2 * C::kPanelO + kPanelS, domap, full(st),
                   c * kCols, t.hi, m0, t.bi);
        }
        if constexpr (!C::kHold) {  // Q's and dO's panels of the slice
          mbar_wait(o_empty, (j & 1) ^ 1);
          mbar_expect_tx(o_full, 2 * opanels * kPanelS);
          for (int pn = 0; pn < opanels; ++pn) {
            const uint32_t dst = base + C::kOOffset + pn * kPanelS;
            tma_load(dst, qmap, o_full, t.c_lo + pn * kCols, t.hi, m0, t.bi);
            tma_load(dst + C::kOPanels * kPanelS, domap, o_full,
                     t.c_lo + pn * kCols, t.hi, m0, t.bi);
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // Consumer thread (ty, tx): S^T, dP^T, P^T and dS^T for keys ty + r R / 4
  // and queries tx + kTx e of a tile; dK and dV for the same keys at its
  // columns.
  constexpr int kTx = C::kTx, kKe = C::kKe, kRowStep = C::kRowStep;
  const int lane = threadIdx.x & 31;
  const int tx = lane % kTx,
            ty = (threadIdx.x / 32 - 4) * (32 / kTx) + lane / kTx;
  const float scale2 = p.scale * kLog2e;
  float* const tile = reinterpret_cast<float*>(sm + C::kTileOffset);
  const float* lse = p.lse + static_cast<long long>(t.bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(t.bh) * p.s_q;
  int q_lo[4];  // key r is seen by the queries from q_lo[r] on (local)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    q_lo[r] = p.causal ? p.k_offset + n0 + ty + r * kRowStep - p.q_offset : 0;
  }

  float dk[4][C::kCpt], dv[4][C::kCpt];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < C::kCpt; ++i) dk[r][i] = dv[r][i] = 0.f;
  }
  for (int j = 0; j < m_tiles; ++j) {
    const int m0 = m_begin + j * kStream;
    float lse2[kKe], dl[kKe];
#pragma unroll
    for (int e = 0; e < kKe; ++e) {
      const int q = m0 + tx + kTx * e;
      lse2[e] = q < p.s_q ? lse[q] * kLog2e : 0.f;
      dl[e] = q < p.s_q ? delta[q] : 0.f;
    }
    float s[4][kKe], dp[4][kKe];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < kKe; ++e) s[r][e] = dp[r][e] = 0.f;
    }
    const unsigned char* held = nullptr;  // kHold: the stage's Q panel
    int held_st = 0;
    for (int c = 0; c < nc; ++c) {
      const int g = j * nc + c, st = g % C::kStages;
      mbar_wait(full(st), (g / C::kStages) & 1);
      const unsigned char* kp = sm + st * C::kStage;
      const unsigned char* qp = kp + 2 * C::kPanelO;
      const int steps = min(kCols, p.d - c * kCols) / 4;
      contract<kTx, kKe, kRowStep>(kp, qp, ty, tx, steps, s);
      contract<kTx, kKe, kRowStep>(kp + C::kPanelO, qp + kPanelS, ty, tx,
                                   steps, dp);
      if constexpr (C::kHold) {
        held = qp;
        held_st = st;
      } else {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
    }

    // P^T into the tile and dS^T = P^T (dP^T - delta) in place of dP^T,
    // masked on diagonal and ragged tiles.
    const bool need_mask =
        m0 + kStream > p.s_q ||
        (p.causal && p.k_offset + n0 + C::kRows - 1 > p.q_offset + m0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < kKe; ++e) {
        const int q = m0 + tx + kTx * e;
        float pr = ex2(fmaf(s[r][e], scale2, -lse2[e]));
        if (need_mask && (q >= p.s_q || q < q_lo[r])) pr = 0.f;
        tile[(ty + r * kRowStep) * C::kPitch + tx + kTx * e] = pr;
        dp[r][e] = pr * (dp[r][e] - dl[e]);
      }
    }
    __syncwarp();  // P^T of the warp's rows is in shared memory

    if constexpr (!C::kHold) mbar_wait(o_full, j & 1);
    const unsigned char* qt = C::kHold ? held : sm + C::kOOffset;
    const unsigned char* dot =
        C::kHold ? held + kPanelS : qt + C::kOPanels * kPanelS;
    product<C>(tile, dot, ty, tx, dv);
    __syncwarp();  // the warp's reads of P^T are done
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < kKe; ++e) {
        tile[(ty + r * kRowStep) * C::kPitch + tx + kTx * e] = dp[r][e];
      }
    }
    __syncwarp();  // dS^T of the warp's rows is in shared memory
    product<C>(tile, qt, ty, tx, dk);
    __syncwarp();  // the warp's reads of dS^T, Q and dO are done
    if (lane == 0) mbar_arrive(C::kHold ? empty(held_st) : o_empty);
  }
  store<C>(p.dk, p, kDK, t, ty, tx, p.s_k, p.scale, dk);
  store<C>(p.dv, p, kDV, t, ty, tx, p.s_k, 1.f, dv);
}

// One launch of the DV instantiation of dQ (kDkv false) or dK/dV over
// p.slices output slices of p.slice_cols columns. Returns a cudaError_t, or
// kEncodeError + the CUresult of a failed encode.
template <int DV, bool kDkv>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<DV, kDkv>;
  CUtensorMap maps[4];  // q, k, v, dO
  const struct {
    const float* ptr;
    int which, s, box_rows;
  } tensors[4] = {{p.q, kQ, p.s_q, kDkv ? kStream : C::kRows},
                  {p.k, kK, p.s_k, kDkv ? C::kRows : kStream},
                  {p.v, kV, p.s_k, kDkv ? C::kRows : kStream},
                  {p.dout, kDO, p.s_q, kDkv ? kStream : C::kRows}};
  for (int i = 0; i < 4; ++i) {
    const long long* st = p.st[tensors[i].which];
    const int err = encode_f32(&maps[i], tensors[i].ptr, p.b, tensors[i].s,
                               p.h, p.d, st[0], st[1], st[2],
                               tensors[i].box_rows);
    if (err != 0) return err;
  }
  const void* kernel;
  if constexpr (kDkv) {
    kernel = reinterpret_cast<const void*>(&dkv_f32_tiled_kernel<DV>);
  } else {
    kernel = reinterpret_cast<const void*>(&dq_f32_tiled_kernel<DV>);
  }
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  const int err = prepare(kernel, C::kSmem, l2_bytes, &l2);
  if (err != 0) return err;
  // The streamed pair stream through every owned tile of a head.
  Params grouped = p;
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * (kDkv ? p.s_q : p.s_k) * p.d * 4, l2);
  const int rows = kDkv ? p.s_k : p.s_q;
  const long long ctas = static_cast<long long>(p.b) * p.h *
                         ((rows + C::kRows - 1) / C::kRows) * p.slices;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(ctas));
  if constexpr (kDkv) {
    dkv_f32_tiled_kernel<DV><<<grid, kThreads, C::kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], grouped);
  } else {
    dq_f32_tiled_kernel<DV><<<grid, kThreads, C::kSmem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], grouped);
  }
  return cudaGetLastError();
}

}  // namespace f32bwd
}  // namespace
