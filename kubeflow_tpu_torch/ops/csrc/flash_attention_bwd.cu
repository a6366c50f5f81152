// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, the two halves of the gradient of flash_attention_fwd.cu.
//
// Replaces the TPU kernels kubeflow_tpu/ops/flash_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (both launched by _flash_bwd). Same
// function: the probabilities are recomputed in f32 from f32 scores and the
// forward's saved lse, P = exp(S * scale - lse); dP = dO V^T and
// dS = P * (dP - delta) in f32; P is rounded to dO's dtype before P^T dO and
// dS to the input dtype before dS K and dS^T Q; scale multiplies the f32
// products; dQ, dK and dV are stored in the input dtype. The causal mask is
// global: query row i of this call sits at q_offset + i and key j at
// k_offset + j (the TPU's scalar-prefetched offsets, for ring hops), masked
// scores are -1e30 (not -inf), and tiles no query reaches are skipped, so a
// row or a whole output that no key reaches is exactly zero. lse and delta
// are f32 [b*h, s_q] (the TPU's (8, s) sublane-replicated layout is a
// tiling artefact and is not copied). delta = rowsum(f32(dO) * f32(O)), a
// plain jnp sum outside the TPU kernels, is fused into the dQ kernel here
// (it reads O once and writes delta for the dK/dV kernel that follows on the
// same stream); a caller that has delta (a ring hop) passes it in.
//
// Bounds on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s), causal:
//  * the training shape [8, 1024, 16, 128] bf16 (b*h = 128 heads of 524,800
//    query-key pairs; one causal product costs 2 * 128 * 524,800 * 128 =
//    17.2 GFLOP; each [b, s, h, d] tensor is 33.55 MB). dQ: 3 products (S,
//    dP, dS K) = 51.6 GFLOP -> 52 us, against q, k, v, dO, O read and dQ
//    written plus lse read and delta written: 202.4 MB -> 60 us; bound by
//    bytes at about 60 us. dK/dV: 4 products (S, dP, P^T dO, dS^T Q) = 68.8
//    GFLOP -> 70 us against 202.4 MB -> 60 us; bound by operations at about
//    70 us. A train step makes 8 launches of each.
//  * the long-context hop [1, 8192, 16, 128] at offsets (0, 0), delta
//    given: dQ 412.3 GFLOP -> 0.417 ms, dK/dV 549.8 GFLOP -> 0.556 ms,
//    against 201 MB (0.060 ms): bound by operations; one launch of each per
//    layer and step on one card.
// Both are tensor-core work. What held the mma.sync kernels that these
// replace at 15-17% of their bound was feeding the tensor cores: 16 rows a
// warp made every warp re-read the streamed tiles out of shared memory,
// the loads were issued by the threads that do the math, and dK/dV's two
// accumulators left registers for 32-row Q tiles only.
//
// What the design does (bf16, every head dim that is a multiple of 8 up to
// 128, on tiles of 64 or 128 columns as the forward's):
//  * One CTA of three warpgroups per (b*h, 128-row tile it owns): Q rows
//    for dQ, keys for dK/dV. Warpgroup 0 is the producer: it gives up its
//    registers (setmaxnreg) and one thread issues every tile load through
//    TMA. Warpgroups 1 and 2 are consumers of 64 owned rows each and take
//    240 registers a thread (ptxas gives them only if no call or trap sits
//    on their path).
//  * The owned tiles (Q and dO; K and V) load once; the other side streams
//    in 64-row tiles (K and V up to the global diagonal; Q and dO from the
//    first query that reaches the keys on) through a ring of 2 stages with
//    full and empty mbarriers. At head dim 128: 64 KB owned + 2 x 32 KB.
//  * Every product runs on wgmma with f32 accumulators in registers.
//    dQ: S = Q K^T and dP = dO V^T as m64n64k16 with both operands in
//    shared memory (K-major), then dQ += dS K as m64nDk16 with dS from
//    registers and K read MN-major through the descriptor's transpose bit.
//    dK/dV keeps keys as rows (S^T = K Q^T, dP^T = V dO^T, as
//    FlashAttention-2 does), so P^T and dS^T come out in the accumulator
//    layout, which is the A-fragment layout of dV += P^T dO and
//    dK += dS^T Q, with dO and Q read MN-major. One B tile feeds 64 rows of
//    a warpgroup; no tile is transposed in shared memory and no [s, s]
//    tile touches device or shared memory.
//  * Registers at head dim 128: dQ holds dQ (64 floats a thread), S and dP
//    (32 each); dK/dV holds dK and dV (64 each), S^T and dP^T (32 each);
//    P and dS are rounded to bf16 fragments as they are formed.
//  * The schedule within a consumer warpgroup: S and dP are committed as
//    two groups, so the exp2s of P run while dP is still on the tensor
//    cores; dK/dV then issues dV += P^T dO as soon as P^T is packed and
//    forms dS^T under it. Each of the two steps measured faster on the
//    card than waiting for both products (PERF.md); the two warpgroups
//    overlap one another as in the forward.
//  * delta (dQ): the dO tile and an O tile, TMA-loaded once into the first
//    K/V stage before the loop, give each row's rowsum in the consumers,
//    four threads a row. lse and delta for dK/dV's streamed Q rows (f32
//    rows whose pitch s_q * 4 need not be a multiple of 16 bytes, so no
//    TMA) come by 4-byte cp.async from the producer's warp, completing on
//    the stage's full barrier.
//  * Masks: only diagonal and ragged tiles, branch-free within a tile, with
//    the live range taken from the global offsets; a warpgroup skips a
//    tile that none of its rows reaches. P = exp2 on the special-function
//    unit with subnormals flushed, as in the forward.
//  * Q, K, V, O and dO are read in the model's [b, s, h, d] layout through
//    their strides (4-D tensor maps, 128-byte swizzle, rows past s as
//    zeros: the ragged edge needs no masked load); outputs are stored
//    through their strides from the accumulators.
//  * Launch order: (batch, head) pairs in groups of as many heads as half
//    the L2 holds the streamed tensors of, each group's tiles from the
//    heaviest causal tile on (dQ: the last Q tile; dK/dV: the first key
//    tile). Two kernels and no atomics, so the result is deterministic.
//  * Head dims, as in the forward: D = 64 columns for d <= 64, 128 for
//    64 < d <= 128; the tensor maps carry the true d, so every tile's
//    columns past d arrive as zeros (S, dP and delta sum zeros there; dQ,
//    dK and dV come out zero there) and the epilogues store d columns.
//  * f32: dq_f32_tiled_kernel and dkv_f32_tiled_kernel of
//    flash_attention_f32_bwd.cuh (its header has their design and bound),
//    register tiles on the CUDA cores whose FMAs keep f32 products exact
//    rather than rounding through TF32, on the narrowest output width that
//    holds d (16, 32, 64 or 128 columns).

#include "flash_attention_f32_bwd.cuh"
#include "hopper.cuh"

namespace {

using namespace kftpu;

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The tensors whose (batch, seq, head) strides a launch is given, in
// elements; the head_dim stride is 1.
enum Tensor { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // read only by the dQ kernel, and only for delta
  const void* dout;
  const float* lse;  // [b*h, s_q]
  float* delta;      // [b*h, s_q]; written by the dQ kernel if compute_delta
  void* dq;
  void* dk;
  void* dv;
  int b, s_q, s_k, h, d;  // d: the true head dim (the tiles may be wider)
  long long st[kTensors][3];
  float scale;
  int causal, q_offset, k_offset, compute_delta;
  int group;  // the bf16 kernels' launch order: (batch, head) pairs a group
};

// The first element of head (bi, hi) of output `which`.
template <typename T>
__device__ __forceinline__ T* out_head_of(void* base, const Params& p,
                                          int which, int bi, int hi) {
  return static_cast<T*>(base) + bi * p.st[which][0] + hi * p.st[which][2];
}

// ---------------------------------------------------------------- bf16 path

typedef __nv_bfloat16 bf16;

constexpr int kOwnRows = 128;    // rows a CTA owns: Q rows (dQ), keys (dK/dV)
constexpr int kWgRows = 64;      // owned rows a consumer warpgroup takes
constexpr int kStreamRows = 64;  // a streamed tile: keys (dQ), Q rows (dK/dV)
constexpr int kOwnPanel = kOwnRows * kRowBytes;        // one TMA box: 16 KB
constexpr int kStreamPanel = kStreamRows * kRowBytes;  // one TMA box: 8 KB
constexpr int kSbo = 8 * kRowBytes;  // 8-row groups of a swizzled panel
constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;
constexpr int kConsumerWarps = 8;
constexpr int kStages = 2;  // streamed tiles in flight
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct BwdCfg {
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kOwnTile = kPanels * kOwnPanel;
  static constexpr int kStreamTile = kPanels * kStreamPanel;
  // Shared memory, 1024-aligned (the 128-byte swizzle repeats every 8 rows
  // of 128 bytes): the two owned tiles (Q, dO; K, V), the stages' two
  // streamed tiles each (K, V; Q, dO), the stages' lse and delta rows
  // (dK/dV), the barriers.
  static constexpr int kStreamOffset = 2 * kOwnTile;
  static constexpr int kStatsOffset =
      kStreamOffset + 2 * kStages * kStreamTile;
  static constexpr int kBarOffset =
      kStatsOffset + kStages * 2 * kStreamRows * 4;
  static constexpr int kBars = 1 + 2 * kStages;  // owned full, full, empty
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
};
static_assert(2 * kStreamPanel == kOwnPanel,
              "dQ's O tile takes the first stage's K and V");

// The shared-memory addresses and barriers of one CTA.
template <int D>
struct BwdSmem {
  using Cfg = BwdCfg<D>;
  uint32_t base;
  unsigned char* ptr;  // base, as a generic pointer (for plain loads)
  __device__ const unsigned char* at(uint32_t addr) const {
    return ptr + (addr - base);
  }
  __device__ uint32_t own(int i) const { return base + i * Cfg::kOwnTile; }
  __device__ uint32_t stream(int st, int i) const {
    return base + Cfg::kStreamOffset + (2 * st + i) * Cfg::kStreamTile;
  }
  __device__ float* stats(int st) const {  // lse, then delta: 64 floats each
    return reinterpret_cast<float*>(ptr + Cfg::kStatsOffset) +
           st * 2 * kStreamRows;
  }
  __device__ uint32_t own_full() const { return base + Cfg::kBarOffset; }
  __device__ uint32_t full(int st) const {
    return base + Cfg::kBarOffset + 8 * (1 + st);
  }
  __device__ uint32_t empty(int st) const {
    return base + Cfg::kBarOffset + 8 * (1 + kStages + st);
  }
};

// Align the dynamic shared memory, initialise the barriers (`full_count`
// arrivals complete a stage's load) and make them visible to the CTA.
template <int D>
__device__ __forceinline__ BwdSmem<D> setup_smem(unsigned char* raw,
                                                 uint32_t full_count) {
  const uint32_t addr = smem_u32(raw);
  const uint32_t aligned = (addr + 1023) & ~1023u;
  const BwdSmem<D> sm{aligned, raw + (aligned - addr)};
  if (threadIdx.x == 0) {
    mbar_init(sm.own_full(), 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(sm.full(st), full_count);
      mbar_init(sm.empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return sm;
}

// The launch order: (batch, head) pairs in groups of p.group, each group's
// tiles from the heaviest (the last when `last_first`) on, the group's
// heads side by side. CTAs that run together share a few heads' streamed
// tiles in L2, and within a group the lightest tiles come last.
__device__ __forceinline__ void tile_of(const Params& p, int tiles,
                                        bool last_first, int& bh, int& tile) {
  const int bhs = p.b * p.h;
  const int per_group = p.group * tiles;
  const int g = blockIdx.x / per_group, rem = blockIdx.x % per_group;
  const int heads = min(p.group, bhs - g * p.group);
  bh = g * p.group + rem % heads;
  tile = last_first ? tiles - 1 - rem / heads : rem / heads;
}

// acc = A B^T for a warpgroup's 64 rows of A and a 64-row B, both K-major
// (the contraction along the row): a k-step of 16 columns moves 32 bytes
// along the swizzled row, four of them a panel.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a,
                                         int a_panel, uint32_t b,
                                         int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n64(acc, smem_desc(a + (kk / 4) * a_panel + off, 16, kSbo),
                 smem_desc(b + (kk / 4) * b_panel + off, 16, kSbo), kk > 0);
  }
}

// acc += A B: A (64 rows x 64) as register fragments, B a streamed tile
// [64 rows][D] read MN-major: a k-step of 16 rows is 16 x 128 bytes, the
// 64-column panels sit a panel apart (the leading byte offset).
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kStreamRows / 16; ++kk) {
    const uint64_t desc =
        smem_desc(b + kk * 16 * kRowBytes, kStreamPanel, kSbo);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, a[kk], desc);
    } else {
      wgmma_rs_n64(acc, a[kk], desc);
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

// 4-byte asynchronous copy global -> shared; a source size of 0 writes a
// zero (the ragged edge) without reading.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the arrival counts toward the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// ------------------------------------------------------------------- dQ

// The producer's one thread: Q and dO once; then the O tile (for delta)
// into the first stage when `with_o`; then the K/V tiles through the ring.
template <int D>
__device__ __forceinline__ void produce_dq(const BwdSmem<D>& sm,
                                           const CUtensorMap& qmap,
                                           const CUtensorMap& kmap,
                                           const CUtensorMap& vmap,
                                           const CUtensorMap& omap,
                                           const CUtensorMap& domap, int m0,
                                           int hi, int bi, int n_tiles,
                                           bool with_o) {
  constexpr int kPanels = BwdCfg<D>::kPanels;
  mbar_expect_tx(sm.own_full(), 2 * BwdCfg<D>::kOwnTile);
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) {
    tma_load(sm.own(0) + pn * kOwnPanel, qmap, sm.own_full(),
             pn * kPanelCols, hi, m0, bi);
    tma_load(sm.own(1) + pn * kOwnPanel, domap, sm.own_full(),
             pn * kPanelCols, hi, m0, bi);
  }
  const int first = with_o ? 1 : 0;
  for (int it = 0; it < first + n_tiles; ++it) {
    const int st = it % kStages;
    // The stage's previous tile was released (round 0 passes at once).
    mbar_wait(sm.empty(st), ((it / kStages) & 1) ^ 1);
    if (it < first) {  // O's 128 rows take the stage's K and V: 16 KB panels
      mbar_expect_tx(sm.full(st), BwdCfg<D>::kOwnTile);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load(sm.stream(st, 0) + pn * kOwnPanel, omap, sm.full(st),
                 pn * kPanelCols, hi, m0, bi);
      }
      continue;
    }
    const int n0 = (it - first) * kStreamRows;
    mbar_expect_tx(sm.full(st), 2 * BwdCfg<D>::kStreamTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(sm.stream(st, 0) + pn * kStreamPanel, kmap, sm.full(st),
               pn * kPanelCols, hi, n0, bi);
      tma_load(sm.stream(st, 1) + pn * kStreamPanel, vmap, sm.full(st),
               pn * kPanelCols, hi, n0, bi);
    }
  }
}

// A consumer warpgroup of the dQ kernel: rows row[0] and row[1] of the
// m64 accumulator layout (local row rl and rl + 8 of the owned tile),
// warpgroup rows from m0w on.
template <int D>
__device__ __forceinline__ void consume_dq(const BwdSmem<D>& sm,
                                           const Params& p, int c, int bh,
                                           int m0w, int rl,
                                           const int (&row)[2], int tq,
                                           int lane, int n_tiles, bool with_o,
                                           float (&dq)[D / 2]) {
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_addr = sm.own(0) + c * kWgRows * kRowBytes;
  const uint32_t do_addr = sm.own(1) + c * kWgRows * kRowBytes;
  const long long stat0 = static_cast<long long>(bh) * p.s_q;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = row[i] < p.s_q ? p.lse[stat0 + row[i]] * kLog2e : 0.f;
  }
  mbar_wait(sm.own_full(), 0);
  if (with_o) {
    // delta = rowsum(f32(dO) * f32(O)) from dO and the O tile in stage 0.
    mbar_wait(sm.full(0), 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dlt[i] = row_dot<D>(sm.at(sm.own(1)), sm.at(sm.stream(0, 0)),
                          rl + 8 * i, tq, kOwnPanel);
      if (tq == 0 && row[i] < p.s_q) p.delta[stat0 + row[i]] = dlt[i];
    }
    if (lane == 0) mbar_arrive(sm.empty(0));
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
  const int first = with_o ? 1 : 0;
  float s[32], dp[32];
  uint32_t dsf[4][4];
  for (int j = 0; j < n_tiles; ++j) {
    const int it = first + j;
    const int st = it % kStages;
    const int n0 = j * kStreamRows;
    mbar_wait(sm.full(st), (it / kStages) & 1);
    if (n0 < n_end) {
      wgmma_fence();
      issue_ss<D>(s, q_addr, kOwnPanel, sm.stream(st, 0), kStreamPanel);
      wgmma_commit();
      issue_ss<D>(dp, do_addr, kOwnPanel, sm.stream(st, 1), kStreamPanel);
      wgmma_commit();
      wgmma_wait<1>();
      hold(s);
      // dS = P (dP - delta), P = exp2(S' - lse') from f32 scores, masked
      // with -1e30 on diagonal and ragged tiles: s[jj * 4 + i * 2 + e] is
      // row row[i], key n0 + jj * 8 + tq * 2 + e.
      const bool need_mask =
          n0 + kStreamRows > p.s_k ||
          (p.causal && p.k_offset + n0 + kStreamRows - 1 > p.q_offset + m0w);
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
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        dp[x] = s[x] * (dp[x] - dlt[(x >> 1) & 1]);
      }
      pack_a(dp, dsf);
      wgmma_fence();
      issue_rs<D>(dq, dsf, sm.stream(st, 0));
      wgmma_commit();
      wgmma_wait<0>();
      hold(dq);
      hold(dsf);
    }
    if (lane == 0) mbar_arrive(sm.empty(st));  // one arrive a warp
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __grid_constant__ CUtensorMap domap,
                   const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const BwdSmem<D> sm = setup_smem<D>(smem_raw, 1);
  int bh, tile;
  tile_of(p, (p.s_q + kOwnRows - 1) / kOwnRows, true, bh, tile);
  const int bi = bh / p.h, hi = bh % p.h;
  const int m0 = tile * kOwnRows;
  // Keys [0, n_end) reach some row of this tile: causal, the last row's
  // global position bounds them.
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + min(m0 + kOwnRows, p.s_q) -
                                       p.k_offset))
               : p.s_k;
  const int n_tiles = (n_end + kStreamRows - 1) / kStreamRows;
  const bool with_o = p.compute_delta != 0;
  const bool loads = n_tiles > 0 || with_o;

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && loads) {
      produce_dq<D>(sm, qmap, kmap, vmap, omap, domap, m0, hi, bi, n_tiles,
                    with_o);
    }
  } else {
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
      consume_dq<D>(sm, p, c, bh, m0 + c * kWgRows, rl, row, tq, lane,
                    n_tiles, with_o, dq);
    }
    // dq[j * 4 + i * 2 + e]: row row[i], column j * 8 + tq * 2 + e.
    bf16* out = out_head_of<bf16>(p.dq, p, kDQ, bi, hi);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= p.s_q) continue;
      bf16* orow = out + static_cast<long long>(row[i]) * p.st[kDQ][1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (j * 8 >= p.d) break;  // the tile's zero columns past d
        *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) =
            pack_bf16(dq[j * 4 + i * 2] * p.scale,
                      dq[j * 4 + i * 2 + 1] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------- dK/dV

// The producer's warp: K and V once (one thread, TMA), then the Q/dO tiles
// through the ring, each with its rows' lse and delta, 4 bytes a copy from
// every lane (s_q * 4 need not be a multiple of TMA's 16 bytes), rows past
// s_q as zeros.
template <int D>
__device__ __forceinline__ void produce_dkv(const BwdSmem<D>& sm,
                                            const CUtensorMap& qmap,
                                            const CUtensorMap& kmap,
                                            const CUtensorMap& vmap,
                                            const CUtensorMap& domap,
                                            const Params& p, int bh, int n0,
                                            int hi, int bi, int m_begin,
                                            int n_qtiles, int lane) {
  constexpr int kPanels = BwdCfg<D>::kPanels;
  if (lane == 0) {
    mbar_expect_tx(sm.own_full(), 2 * BwdCfg<D>::kOwnTile);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(sm.own(0) + pn * kOwnPanel, kmap, sm.own_full(),
               pn * kPanelCols, hi, n0, bi);
      tma_load(sm.own(1) + pn * kOwnPanel, vmap, sm.own_full(),
               pn * kPanelCols, hi, n0, bi);
    }
  }
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;
  for (int j = 0; j < n_qtiles; ++j) {
    const int st = j % kStages;
    const int m0 = m_begin + j * kStreamRows;
    mbar_wait(sm.empty(st), ((j / kStages) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(sm.full(st), 2 * BwdCfg<D>::kStreamTile);
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
        tma_load(sm.stream(st, 0) + pn * kStreamPanel, qmap, sm.full(st),
                 pn * kPanelCols, hi, m0, bi);
        tma_load(sm.stream(st, 1) + pn * kStreamPanel, domap, sm.full(st),
                 pn * kPanelCols, hi, m0, bi);
      }
    }
    float* stats = sm.stats(st);
#pragma unroll
    for (int r = lane; r < kStreamRows; r += 32) {
      const bool valid = m0 + r < p.s_q;
      cp_async4(stats + r, valid ? lse + m0 + r : lse, valid);
      cp_async4(stats + kStreamRows + r, valid ? delta + m0 + r : delta,
                valid);
    }
    cp_async_arrive(sm.full(st));
  }
  // The lanes' last copies land before they leave.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A consumer warpgroup of the dK/dV kernel: keys key[0] and key[1] of the
// m64 accumulator layout, warpgroup keys from n0w on.
template <int D>
__device__ __forceinline__ void consume_dkv(const BwdSmem<D>& sm,
                                            const Params& p, int c, int n0w,
                                            const int (&key)[2], int tq,
                                            int lane, int m_begin,
                                            int n_qtiles, float (&dk)[D / 2],
                                            float (&dv)[D / 2]) {
  const float scale2 = p.scale * kLog2e;
  const uint32_t k_addr = sm.own(0) + c * kWgRows * kRowBytes;
  const uint32_t v_addr = sm.own(1) + c * kWgRows * kRowBytes;
  // Query rows reach the warpgroup's first key from `reach` on (global:
  // q_offset + row >= k_offset + key); its keys past s_k are not stored.
  const int reach = p.causal ? p.k_offset + n0w - p.q_offset : 0;
  const bool any_key = n0w < p.s_k;
  float s[32], dp[32];
  uint32_t pf[4][4], dsf[4][4];
  mbar_wait(sm.own_full(), 0);
  for (int j = 0; j < n_qtiles; ++j) {
    const int st = j % kStages;
    const int m0 = m_begin + j * kStreamRows;
    mbar_wait(sm.full(st), (j / kStages) & 1);
    if (any_key && min(m0 + kStreamRows, p.s_q) - 1 >= reach) {
      wgmma_fence();
      issue_ss<D>(s, k_addr, kOwnPanel, sm.stream(st, 0), kStreamPanel);
      wgmma_commit();
      issue_ss<D>(dp, v_addr, kOwnPanel, sm.stream(st, 1), kStreamPanel);
      wgmma_commit();
      wgmma_wait<1>();
      hold(s);
      // P^T from f32 scores and each query's lse, masked with -1e30 on
      // diagonal and ragged tiles; dS^T = P^T (dP^T - delta):
      // s[jj * 4 + i * 2 + e] is key key[i], query m0 + jj * 8 + tq * 2 + e.
      const bool need_mask =
          m0 + kStreamRows > p.s_q ||
          (p.causal && p.q_offset + m0 < p.k_offset + n0w + kWgRows - 1);
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
      pack_a(s, pf);
      wgmma_wait<0>();
      hold(dp);
      wgmma_fence();
      issue_rs<D>(dv, pf, sm.stream(st, 1));
      wgmma_commit();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dl = *reinterpret_cast<const float2*>(
            lse_s + kStreamRows + jj * 8 + tq * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = jj * 4 + e;
          dp[x] = s[x] * (dp[x] - ((e & 1) ? dl.y : dl.x));
        }
      }
      pack_a(dp, dsf);
      wgmma_fence();
      issue_rs<D>(dk, dsf, sm.stream(st, 0));
      wgmma_commit();
      wgmma_wait<0>();
      hold(dv);
      hold(dk);
      hold(pf);
      hold(dsf);
    }
    if (lane == 0) mbar_arrive(sm.empty(st));  // one arrive a warp
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // A stage is full once its TMA bytes and the 32 lanes' lse/delta copies
  // have landed.
  const BwdSmem<D> sm = setup_smem<D>(smem_raw, 1 + 32);
  int bh, tile;
  tile_of(p, (p.s_k + kOwnRows - 1) / kOwnRows, false, bh, tile);
  const int bi = bh / p.h, hi = bh % p.h;
  const int n0 = tile * kOwnRows;
  // Queries that reach this tile: under the causal mask, those at global
  // positions from the global position of its first key on.
  const int m_begin =
      p.causal ? max(0, p.k_offset + n0 - p.q_offset) / kStreamRows *
                     kStreamRows
               : 0;
  const int n_qtiles =
      m_begin < p.s_q ? (p.s_q - m_begin + kStreamRows - 1) / kStreamRows
                      : 0;

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32 && n_qtiles > 0) {
      produce_dkv<D>(sm, qmap, kmap, vmap, domap, p, bh, n0, hi, bi, m_begin,
                     n_qtiles, threadIdx.x);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int t = threadIdx.x - wg * kWgThreads;
    const int lane = t & 31, tq = lane & 3;
    const int n0w = n0 + c * kWgRows;
    const int key[2] = {n0w + (t >> 5) * 16 + (lane >> 2),
                        n0w + (t >> 5) * 16 + (lane >> 2) + 8};
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    if (n_qtiles > 0) {
      consume_dkv<D>(sm, p, c, n0w, key, tq, lane, m_begin, n_qtiles, dk,
                     dv);
    }
    // dk[j * 4 + i * 2 + e]: key key[i], column j * 8 + tq * 2 + e. A key
    // tile that no query reaches stores zeros.
    bf16* dk_out = out_head_of<bf16>(p.dk, p, kDK, bi, hi);
    bf16* dv_out = out_head_of<bf16>(p.dv, p, kDV, bi, hi);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= p.s_k) continue;
      bf16* dkr = dk_out + static_cast<long long>(key[i]) * p.st[kDK][1];
      bf16* dvr = dv_out + static_cast<long long>(key[i]) * p.st[kDV][1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (j * 8 >= p.d) break;  // the tile's zero columns past d
        *reinterpret_cast<uint32_t*>(dkr + j * 8 + tq * 2) =
            pack_bf16(dk[j * 4 + i * 2] * p.scale,
                      dk[j * 4 + i * 2 + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvr + j * 8 + tq * 2) =
            pack_bf16(dv[j * 4 + i * 2], dv[j * 4 + i * 2 + 1]);
      }
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

// The f32 dQ (kDkv false) or dK/dV of flash_attention_f32_bwd.cuh on the
// narrowest output width that holds d (16, 32, 64 or 128), one slice.
template <bool kDkv>
int launch_f32(const Params& p, cudaStream_t stream) {
  f32bwd::Params f = f32bwd::params_of(p);
  f.slices = 1;
  f.slice_cols = p.d <= 16 ? 16 : p.d <= 32 ? 32 : p.d <= 64 ? 64 : 128;
  switch (f.slice_cols) {
    case 16: return f32bwd::launch<16, kDkv>(f, stream);
    case 32: return f32bwd::launch<32, kDkv>(f, stream);
    case 64: return f32bwd::launch<64, kDkv>(f, stream);
    default: return f32bwd::launch<128, kDkv>(f, stream);
  }
}

template <int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  CUtensorMap maps[5] = {};  // q, k, v, o, dO; o only for delta
  const struct {
    const void* ptr;
    int which, s, box_rows;
  } tensors[5] = {{p.q, kQ, p.s_q, kOwnRows},
                  {p.k, kK, p.s_k, kStreamRows},
                  {p.v, kV, p.s_k, kStreamRows},
                  {p.o, kO, p.s_q, kOwnRows},
                  {p.dout, kDO, p.s_q, kOwnRows}};
  for (int i = 0; i < 5; ++i) {
    if (i == 3 && !p.compute_delta) continue;
    const int err = encode_tensor(&maps[i], tensors[i].ptr, p,
                                  tensors[i].which, tensors[i].s,
                                  tensors[i].box_rows);
    if (err != 0) return err;
  }
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  const int err = prepare(reinterpret_cast<const void*>(&dq_bf16_kernel<D>),
                BwdCfg<D>::kSmem, l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // K and V stream through every Q tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s_k * p.d * 2, l2);
  const dim3 grid(p.b * p.h * ((p.s_q + kOwnRows - 1) / kOwnRows));
  dq_bf16_kernel<D><<<grid, kHopperThreads, BwdCfg<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], grouped);
  return cudaGetLastError();
}

template <int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  CUtensorMap maps[4];
  const struct {
    const void* ptr;
    int which, s, box_rows;
  } tensors[4] = {{p.q, kQ, p.s_q, kStreamRows},
                  {p.k, kK, p.s_k, kOwnRows},
                  {p.v, kV, p.s_k, kOwnRows},
                  {p.dout, kDO, p.s_q, kStreamRows}};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_tensor(&maps[i], tensors[i].ptr, p,
                                  tensors[i].which, tensors[i].s,
                                  tensors[i].box_rows);
    if (err != 0) return err;
  }
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  const int err = prepare(reinterpret_cast<const void*>(&dkv_bf16_kernel<D>),
                BwdCfg<D>::kSmem, l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // Q and dO stream through every key tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s_q * p.d * 2, l2);
  const dim3 grid(p.b * p.h * ((p.s_k + kOwnRows - 1) / kOwnRows));
  dkv_bf16_kernel<D><<<grid, kHopperThreads, BwdCfg<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], grouped);
  return cudaGetLastError();
}

// The bf16 tile width for head dim d, a multiple of 8 up to 128 (64 or 128
// columns; f32 takes the same head dims); 0 for one the kernels do not
// take.
int tile_cols(int d, int dtype) {
  if (d < 8 || d > 128 || d % 8 != 0 || (dtype != 0 && dtype != 1)) return 0;
  return d <= 64 ? 64 : 128;
}

Params make_params(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int b, int s_q, int s_k, int h, int d,
                   const long long* strides, float scale, int causal,
                   int q_offset, int k_offset, int compute_delta) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
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
  p.compute_delta = compute_delta;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds the (batch, seq, head)
// strides in elements of q, k, v, o, dO, dQ, dK, dV, in that order (24
// values; those of tensors a launch does not touch are ignored). Each
// returns a cudaError_t (0 on success), or 100000 + the CUresult of a
// failed tensor-map encode; the launch itself is asynchronous on `stream`.

// dQ, and delta = rowsum(dO * O) into `delta` first when compute_delta.
extern "C" int kftpu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int b,
    int s_q, int s_k, int h, int d, int dtype, const long long* strides,
    float scale, int causal, int q_offset, int k_offset, int compute_delta,
    void* stream) {
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                               nullptr, b, s_q, s_k, h, d, strides, scale,
                               causal, q_offset, k_offset, compute_delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = tile_cols(d, dtype);
  if (cols == 0 || s_q < 1 || s_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch_f32<false>(p, st);
  return cols == 128 ? launch_dq<128>(p, st) : launch_dq<64>(p, st);
}

// dK and dV from the delta the dQ launch wrote (or the caller gave).
extern "C" int kftpu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int s_q,
    int s_k, int h, int d, int dtype, const long long* strides, float scale,
    int causal, int q_offset, int k_offset, void* stream) {
  const Params p = make_params(
      q, k, v, nullptr, dout, lse, const_cast<float*>(delta), nullptr, dk, dv,
      b, s_q, s_k, h, d, strides, scale, causal, q_offset, k_offset, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = tile_cols(d, dtype);
  if (cols == 0 || s_q < 1 || s_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch_f32<true>(p, st);
  return cols == 128 ? launch_dkv<128>(p, st) : launch_dkv<64>(p, st);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return error_string(err);
}
