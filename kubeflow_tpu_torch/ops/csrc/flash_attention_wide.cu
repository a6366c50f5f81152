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
//    wide_fwd_bf16_sliced_kernel / wide_partial_bf16_sliced_kernel, dQ
//    wide_dq_bf16_sliced_kernel and dK/dV wide_dkv_bf16_sliced_kernel, on
//    wgmma and TMA, one CTA a 256-column slice of the output (below). The
//    plan (0, 1) also runs them at d <= 256 (how the sliced dQ is timed
//    beside the wgmma one).
//  * f32 at any d (the plan (0, slices)): the forward and the partial run
//    flash_attention_f32.cuh's register-tiled loop on the CUDA cores, dQ
//    and dK/dV flash_attention_f32_bwd.cuh's register-tiled pair
//    (dq_f32_tiled_kernel, dkv_f32_tiled_kernel; each header has its
//    design), one CTA a 256-column slice.
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
// The sliced bf16 backward (d > 256). Bound at [8, 1024, 16, 320] causal:
// dQ by bytes (q, k, v, o, dO read, dq written: 0.151 ms), dK/dV by
// operations (four products, 172 GFLOP: 0.174 ms). Each slice repeats the
// contraction over d: at d = 320 two slices contract S and dP over 320
// columns each and accumulate 256, so dQ's products are 1.87 and dK/dV's
// 1.8 times one pass's. The design is the wgmma pair's with the
// contraction over d in 64-column panels, as the sliced forward's: the
// score products panel by panel, each its own commit group, every other
// panel through a ring released as its products land; the slice's own
// panels that the output product reads again stay in a kept tile of 4
// panels that a producer thread of its own refills once both warpgroups
// are done with it (no head-of-line wait behind the ring). dQ keeps Q and
// dO resident up to d = 320 (160 KB) and streams them above; dK/dV keeps
// K and V resident up to d = 384 and streams them above. Every slice
// computes S, P, dP and delta from the same numbers in the same order:
// the slices' statistics are bitwise equal, and slice 0 alone writes
// delta. No atomics: the results repeat bitwise.

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
  int group;   // the wgmma kernels' launch order: (batch, head) pairs a group
  int slices;  // the sliced kernels: output-column slices of kSliceCols
};

// Whether the library has the kernels of a plan for head dim d and dtype
// (0 f32, 1 bf16): the wgmma kernels at `width` columns (192 or 256, bf16,
// d <= width, one slice), or (width 0) over `slices` column slices of
// kSliceCols, as many as d fills: the sliced kernels (bf16 on wgmma, f32
// on the CUDA cores' register tiles).
bool has_plan(int d, int dtype, int width, int slices) {
  if (width == 0) {
    return slices == (d + kSliceCols - 1) / kSliceCols && slices <= 65535;
  }
  return dtype == 1 && (width == 192 || width == kHopperMaxCols) &&
         d <= width && slices == 1;
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
// setmaxnreg.inc waits until the CTA's other warps gave the registers back:
// what the consumers take must fit what the SM holds beside the producer.
static_assert(kWgThreads * kProducerRegs + kConsumerThreads * kConsumerRegs <=
                  65536,
              "setmaxnreg's registers balance");
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

// acc (+)= A B^T over one 64-column panel of two K-major operands (a
// warpgroup's 64 rows of A, a 64-row B): 4 k-steps of 32 bytes along the
// swizzled row; `first` zeroes acc.
__device__ __forceinline__ void issue_panel(float (&acc)[32], uint32_t a,
                                            uint32_t b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss_n64(acc, smem_desc(a + kk * 32, 16, kSbo),
                 smem_desc(b + kk * 32, 16, kSbo), !first || kk > 0);
  }
}

// acc = A B^T for a warpgroup's 64 rows of A and a 64-row B, both K-major
// over D columns, panel by panel; A's panels `a_panel` bytes apart.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a,
                                         int a_panel, uint32_t b) {
#pragma unroll
  for (int pn = 0; pn < D / kPanelCols; ++pn) {
    issue_panel(acc, a + pn * a_panel, b + pn * kPanel64, pn == 0);
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
// A 64-row tile of a slice's columns: 4 panels, 32 KB.
constexpr int kSliceTile = (kSliceCols / kPanelCols) * kPanel64;

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
                       2 * kSliceTile + kBarBytes + 1024;
  L.resident = resident <= kMaxSmem;
  L.q = 0;
  L.ring = L.resident ? L.panels * kPanel128 : 0;
  L.stage = L.resident ? kPanel64 : kPanel128 + kPanel64;  // (Q |) K
  L.v = L.ring + kSliceStages * L.stage;
  L.bars = L.v + 2 * kSliceTile;
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
          tma_load(base + L.v + vb * kSliceTile + pn * kPanel64, vmap,
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
      issue_panel(s, q_addr, k_addr, pn == 0);
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
    issue_rs<kSliceCols>(o, pf, base + L.v + vb * kSliceTile);
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

// ------------------------------- dQ and dK/dV above 256 columns

// The bf16 backward over output-column slices (the plan (0, slices)): one
// CTA per (b*h, owned tile, slice of kSliceCols output columns), slices
// side by side, the producer and two consumer warpgroups of the wgmma
// kernels, the slice's accumulator in 128 registers (m64n256). The scores
// S and dP (dK/dV: S^T and dP^T) contract over all of d in 64-column
// panels, each panel its own commit group, in the same order in every
// slice; the panels of the slice's own columns that the output product
// reads again (dQ: K's; dK/dV: Q's and dO's) go to a kept tile of 4
// panels, which one producer thread refills once both warpgroups are done
// with it, and every other panel passes through a ring of stages, released
// as soon as its products have landed.

// A sliced CTA's slice: its first column, its columns (those past d are
// computed, not stored), and its kept panels [kp0, kp0 + nk) of d.
struct Slice {
  int index, c_lo, cols, kp0, nk;
  __device__ bool kept(int pn) const { return pn >= kp0 && pn < kp0 + nk; }
};

__device__ __forceinline__ Slice slice_of(const Params& p, int panels) {
  Slice s;
  s.index = blockIdx.x % p.slices;
  s.c_lo = s.index * kSliceCols;
  s.cols = min(kSliceCols, p.d - s.c_lo);
  s.kp0 = s.c_lo / kPanelCols;
  s.nk = min(kSliceCols / kPanelCols, panels - s.kp0);
  return s;
}

// One panel's products into acc, a commit group of its own (`first` zeroes
// acc); then the stage of the panel before it (`held`, -1 for none: a kept
// panel, or none yet) is released once its products have landed, so that
// the next panel's wait overlaps this one's products. The wait is
// unconditional (with one group pending it returns at once): a wgmma wait
// under a branch made ptxas serialize every wgmma of the kernel (C7515).
__device__ __forceinline__ void panel_step(float (&acc)[32], uint32_t a,
                                           uint32_t b, bool first, int st,
                                           int& held, int lane,
                                           uint32_t empty_bars) {
  wgmma_fence();
  issue_panel(acc, a, b, first);
  wgmma_commit();
  wgmma_wait<1>();
  if (held >= 0 && lane == 0) mbar_arrive(empty_bars + 8 * held);
  held = st;
}

__device__ __forceinline__ void panels_done(int held, int lane,
                                            uint32_t empty_bars) {
  wgmma_wait<0>();
  if (held >= 0 && lane == 0) mbar_arrive(empty_bars + 8 * held);
}

// This thread's share of sum over d of f32(a) * f32(b) for one row: the
// 16-byte chunks tq, tq + 4, ...; the 4 threads of the row add theirs.
__device__ __forceinline__ float row_dot_part(const bf16* a, const bf16* b,
                                              int d, int tq) {
  float sum = 0.f;
#pragma unroll 4
  for (int c = tq * 8; c < d; c += 32) {
    sum = dot8(*reinterpret_cast<const uint4*>(a + c),
               *reinterpret_cast<const uint4*>(b + c), sum);
  }
  return sum;
}

// dQ's shared memory: Q and dO (128 rows, all of d) resident where they
// fit beside the kept K tile and a ring of 4 stages of one 64-row panel
// (d up to 320), else streamed through a ring of 8 stages, each a 128-row
// panel of Q or dO and a 64-row panel of K or V.
struct DqSlicedLayout {
  int panels, stages;
  bool resident;
  int dout, kept, ring, stage, kv, bars, smem;  // offsets and sizes in bytes
};

// own full; full and empty a stage; kept full and empty.
constexpr int kDqBarBytes = 8 * (3 + 2 * 8);

__host__ __device__ constexpr DqSlicedLayout dq_sliced_layout(int d) {
  DqSlicedLayout L{};
  L.panels = (d + kPanelCols - 1) / kPanelCols;
  L.resident = 2 * L.panels * kPanel128 + kSliceTile + 4 * kPanel64 +
                   kDqBarBytes + 1024 <=
               kMaxSmem;
  L.stages = L.resident ? 4 : 8;
  L.dout = L.resident ? L.panels * kPanel128 : 0;
  L.kept = L.resident ? 2 * L.panels * kPanel128 : 0;
  L.ring = L.kept + kSliceTile;
  L.stage = L.resident ? kPanel64 : kPanel128 + kPanel64;
  L.kv = L.resident ? 0 : kPanel128;  // the K or V panel in a stage
  L.bars = L.ring + L.stages * L.stage;
  L.smem = L.bars + kDqBarBytes + 1024;
  return L;
}
static_assert(dq_sliced_layout(256).resident &&
                  dq_sliced_layout(256).smem == 197784 &&
                  dq_sliced_layout(264).resident &&
                  dq_sliced_layout(264).smem == 230552 &&
                  dq_sliced_layout(320).resident &&
                  dq_sliced_layout(320).smem == 230552 &&
                  !dq_sliced_layout(512).resident &&
                  dq_sliced_layout(512).smem == 230552 &&
                  !dq_sliced_layout(1024).resident &&
                  dq_sliced_layout(1024).smem == 230552 &&
                  !dq_sliced_layout(1 << 20).resident &&
                  dq_sliced_layout(1 << 20).smem <= kMaxSmem,
              "the sliced dQ's shared memory at d 256, 264 and 320 (Q and "
              "dO resident), 512, 1024 and any wider head (streamed)");

// dQ over 256-column slices: a consumer warpgroup owns 64 Q rows; per
// 64-key tile dP = dO V^T, then S = Q K^T, panel by panel (the panels of
// the slice's K columns from the kept tile), P = exp2(S' - lse') and
// dS = P (dP - delta) in registers, dQ_slice += dS K_slice (m64n256k16,
// dS from registers, the kept K tile read MN-major). delta = rowsum(dO *
// O) over all of d, each thread reading its rows' 16-byte chunks from
// device memory (the same sum in every slice; slice 0 writes it).
__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_dq_bf16_sliced_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const DqSlicedLayout L = dq_sliced_layout(p.d);
  const int np = L.panels, stages = L.stages;
  const uint32_t own_full = base + L.bars;
  const uint32_t full_bars = own_full + 8;
  const uint32_t empty_bars = full_bars + 8 * stages;
  const uint32_t kept_full = empty_bars + 8 * stages;
  const uint32_t kept_empty = kept_full + 8;
  const uint32_t kept = base + L.kept;
  const Slice sl = slice_of(p, np);
  int bh, tile;
  group_tile(p, (p.s_q + kBlockM - 1) / kBlockM, true, bh, tile,
             blockIdx.x / p.slices);
  const int bi = bh / p.h, hi = bh % p.h;
  const int m0 = tile * kBlockM;
  // Keys [0, n_end) reach some row of this tile.
  const int n_end =
      p.causal ? max(0, min(p.s_k, p.q_offset + min(m0 + kBlockM, p.s_q) -
                                       p.k_offset))
               : p.s_k;
  const int n_tiles = (n_end + kTileRows - 1) / kTileRows;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(full_bars + 8 * st, 1);
      mbar_init(empty_bars + 8 * st, kConsumerWarps);
    }
    mbar_init(kept_full, 1);
    mbar_init(kept_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (n_tiles > 0 && threadIdx.x == 0) {
      // The ring: Q and dO once when resident, then each key tile's dP
      // panels (dO's when streamed, V's) and S panels (Q's when streamed,
      // K's outside the kept tile).
      if (L.resident) {
        mbar_expect_tx(own_full, 2 * np * kPanel128);
        for (int pn = 0; pn < np; ++pn) {
          tma_load(base + pn * kPanel128, qmap, own_full, pn * kPanelCols,
                   hi, m0, bi);
          tma_load(base + L.dout + pn * kPanel128, domap, own_full,
                   pn * kPanelCols, hi, m0, bi);
        }
      }
      int g = 0;
      for (int j = 0; j < n_tiles; ++j) {
        for (int x = 0; x < 2 * np; ++x) {
          const bool is_s = x >= np;
          const int pn = is_s ? x - np : x;
          const bool kept_k = is_s && sl.kept(pn);
          if (L.resident && kept_k) continue;
          const int st = g % stages;
          // The stage's previous panel was released (round 0 passes).
          mbar_wait(empty_bars + 8 * st, ((g / stages) & 1) ^ 1);
          const uint32_t at = base + L.ring + st * L.stage;
          const uint32_t bar = full_bars + 8 * st;
          mbar_expect_tx(bar, (L.resident ? 0 : kPanel128) +
                                  (kept_k ? 0 : kPanel64));
          if (is_s) {
            if (!L.resident) {
              tma_load(at, qmap, bar, pn * kPanelCols, hi, m0, bi);
            }
            if (!kept_k) {
              tma_load(at + L.kv, kmap, bar, pn * kPanelCols, hi,
                       j * kTileRows, bi);
            }
          } else {
            if (!L.resident) {
              tma_load(at, domap, bar, pn * kPanelCols, hi, m0, bi);
            }
            tma_load(at + L.kv, vmap, bar, pn * kPanelCols, hi,
                     j * kTileRows, bi);
          }
          ++g;
        }
      }
    } else if (n_tiles > 0 && threadIdx.x == 32) {
      // The kept K tile: the slice's K panels of each key tile, once both
      // consumers' dQ += dS K of the one before has landed.
      for (int j = 0; j < n_tiles; ++j) {
        mbar_wait(kept_empty, (j & 1) ^ 1);
        mbar_expect_tx(kept_full, sl.nk * kPanel64);
        for (int i = 0; i < sl.nk; ++i) {
          tma_load(kept + i * kPanel64, kmap, kept_full,
                   (sl.kp0 + i) * kPanelCols, hi, j * kTileRows, bi);
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
  // The thread's rows of the m64 accumulators: row[0] and row[0] + 8.
  const int row[2] = {m0w + (t >> 5) * 16 + (lane >> 2),
                      m0w + (t >> 5) * 16 + (lane >> 2) + 8};
  const float scale2 = p.scale * kLog2e;
  const long long stat0 = static_cast<long long>(bh) * p.s_q;
  float lse2[2], dlt[2];
  int end[2];  // row i keeps the keys before end[i]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < p.s_q;
    lse2[i] = in ? p.lse[stat0 + row[i]] * kLog2e : 0.f;
    if (p.compute_delta) {
      float part = in ? row_dot_part(row_of<bf16>(p.dout, p, kDO, bi, hi,
                                                  row[i]),
                                     row_of<bf16>(p.o, p, kO, bi, hi, row[i]),
                                     p.d, tq)
                      : 0.f;
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      dlt[i] = part;
      if (sl.index == 0 && tq == 0 && in) p.delta[stat0 + row[i]] = part;
    } else {
      dlt[i] = in ? p.delta[stat0 + row[i]] : 0.f;
    }
    end[i] = p.causal ? min(p.s_k, p.q_offset + row[i] - p.k_offset + 1)
                      : p.s_k;
  }
  float dq[kSliceCols / 2];
#pragma unroll
  for (int i = 0; i < kSliceCols / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];
  uint32_t dsf[4][4];
  const uint32_t rows_at = c * kWgRows * kRowBytes;  // in a 128-row panel
  if (n_tiles > 0 && L.resident) mbar_wait(own_full, 0);
  int g = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kTileRows;
    int held = -1;
    // dP = dO V^T.
    for (int pn = 0; pn < np; ++pn) {
      const int st = g % stages;
      mbar_wait(full_bars + 8 * st, (g / stages) & 1);
      const uint32_t at = base + L.ring + st * L.stage;
      ++g;
      const uint32_t a =
          (L.resident ? base + L.dout + pn * kPanel128 : at) + rows_at;
      panel_step(dp, a, at + L.kv, pn == 0, st, held, lane,
                 empty_bars);
    }
    // S = Q K^T.
    for (int pn = 0; pn < np; ++pn) {
      const bool kept_k = sl.kept(pn);
      if (kept_k && pn == sl.kp0) mbar_wait(kept_full, j & 1);
      int st = -1;
      uint32_t at = 0;
      if (!L.resident || !kept_k) {
        st = g % stages;
        mbar_wait(full_bars + 8 * st, (g / stages) & 1);
        at = base + L.ring + st * L.stage;
        ++g;
      }
      const uint32_t a = (L.resident ? base + pn * kPanel128 : at) + rows_at;
      const uint32_t b =
          kept_k ? kept + (pn - sl.kp0) * kPanel64 : at + L.kv;
      panel_step(s, a, b, pn == 0, st, held, lane, empty_bars);
    }
    panels_done(held, lane, empty_bars);
    hold(s);
    hold(dp);
    // P = exp2(S' - lse') from f32 scores, masked with -1e30 on diagonal
    // and ragged tiles: s[jj * 4 + i * 2 + e] is row row[i], key n0 + jj *
    // 8 + tq * 2 + e; dS = P (dP - delta), rounded to bf16 fragments.
    const bool need_mask =
        n0 + kTileRows > p.s_k ||
        (p.causal && p.k_offset + n0 + kTileRows - 1 > p.q_offset + m0w);
    const int col0 = n0 + tq * 2;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, col = (x >> 2) * 8 + (x & 1);
      float v = s[x] * scale2;
      if (need_mask && col >= end[i] - col0) v = kNegBig;
      dp[x] = ex2(v - lse2[i]) * (dp[x] - dlt[i]);
    }
    pack_a(dp, dsf);
    wgmma_fence();
    issue_rs<kSliceCols>(dq, dsf, kept);
    wgmma_commit();
    wgmma_wait<0>();
    hold(dq);
    hold(dsf);
    if (lane == 0) mbar_arrive(kept_empty);  // one arrive a warp
  }

  // dq[j * 4 + i * 2 + e]: row row[i], slice column j * 8 + tq * 2 + e. A
  // row that no key reaches stores zeros.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.s_q) continue;
    bf16* orow = out_row_of<bf16>(p.dq, p, kDQ, bi, hi, row[i]) + sl.c_lo;
#pragma unroll
    for (int j = 0; j < kSliceCols / 8; ++j) {
      if (j * 8 >= sl.cols) break;
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) = pack_bf16(
          dq[j * 4 + i * 2] * p.scale, dq[j * 4 + i * 2 + 1] * p.scale);
    }
  }
}

// dK/dV's shared memory: the owned K and V (64 rows, all of d) resident
// where they fit beside the kept Q and dO tiles, P^T, the tile's lse and
// delta and two rings of 3 stages of one 64-row panel (d up to 384), else
// streamed: each stage of the rings (4 stages) an owned panel of K or V
// and the streamed one of Q or dO.
struct DkvSlicedLayout {
  int panels, stages;
  bool resident;
  // Offsets and sizes in bytes; `own` is where a stage's Q or dO panel
  // sits (after the K or V panel when streamed).
  int kept_q, kept_do, pbuf, stats, q_ring, do_ring, stage, own, bars, smem;
};

// own full; full and empty a stage of each ring; kept Q and kept dO full
// and empty.
constexpr int kDkvBarBytes = 8 * (1 + 4 * 4 + 4);
constexpr int kPBytes = kWgThreads * 32 * 4;  // P^T, f32

__host__ __device__ constexpr DkvSlicedLayout dkv_sliced_layout(int d) {
  DkvSlicedLayout L{};
  L.panels = (d + kPanelCols - 1) / kPanelCols;
  const int fixed = 2 * kSliceTile + kPBytes + 1024 + kDkvBarBytes + 1024;
  L.resident = 2 * L.panels * kPanel64 + 2 * 3 * kPanel64 + fixed <= kMaxSmem;
  L.stages = L.resident ? 3 : 4;
  L.stage = L.resident ? kPanel64 : 2 * kPanel64;
  L.own = L.resident ? 0 : kPanel64;
  L.kept_q = L.resident ? 2 * L.panels * kPanel64 : 0;
  L.kept_do = L.kept_q + kSliceTile;
  L.pbuf = L.kept_do + kSliceTile;
  L.stats = L.pbuf + kPBytes;  // lse, then delta: 64 floats each
  L.q_ring = L.stats + 1024;
  L.do_ring = L.q_ring + L.stages * L.stage;
  L.bars = L.do_ring + L.stages * L.stage;
  L.smem = L.bars + kDkvBarBytes + 1024;
  return L;
}
static_assert(dkv_sliced_layout(256).resident &&
                  dkv_sliced_layout(256).smem == 198824 &&
                  dkv_sliced_layout(264).resident &&
                  dkv_sliced_layout(264).smem == 215208 &&
                  dkv_sliced_layout(320).resident &&
                  dkv_sliced_layout(320).smem == 215208 &&
                  dkv_sliced_layout(384).resident &&
                  dkv_sliced_layout(384).smem == 231592 &&
                  !dkv_sliced_layout(512).resident &&
                  dkv_sliced_layout(512).smem == 215208 &&
                  !dkv_sliced_layout(1024).resident &&
                  dkv_sliced_layout(1024).smem == 215208 &&
                  !dkv_sliced_layout(1 << 20).resident &&
                  dkv_sliced_layout(1 << 20).smem <= kMaxSmem,
              "the sliced dK/dV's shared memory at d 256, 264, 320 and 384 "
              "(K and V resident), 512, 1024 and any wider head (streamed)");

// What a dK/dV producer thread needs of its CTA.
struct DkvProducer {
  const Params& p;
  const DkvSlicedLayout& L;
  const Slice& sl;
  uint32_t base;
  unsigned char* ptr;  // base, as a generic pointer
  uint32_t own_full;
  int bh, bi, hi, n0, m_begin, n_qtiles;
};

// One ring of dK/dV: Q's (the owned K's panels when streamed, `own_map`)
// or dO's (V's); a stage is the owned panel (streamed) and the streamed
// one outside the kept tile (`stream_map`: Q or dO).
__device__ __forceinline__ void produce_dkv_ring(const DkvProducer& px,
                                                 const CUtensorMap& own_map,
                                                 const CUtensorMap& stream_map,
                                                 uint32_t full_bars,
                                                 int ring_offset) {
  const DkvSlicedLayout& L = px.L;
  const int stages = L.stages;
  const uint32_t empty_bars = full_bars + 8 * stages;
  const uint32_t ring = px.base + ring_offset;
  int g = 0;
  for (int j = 0; j < px.n_qtiles; ++j) {
    const int m0 = px.m_begin + j * kTileRows;
    for (int pn = 0; pn < L.panels; ++pn) {
      const bool kept = px.sl.kept(pn);
      if (L.resident && kept) continue;
      const int st = g % stages;
      mbar_wait(empty_bars + 8 * st, ((g / stages) & 1) ^ 1);
      const uint32_t at = ring + st * L.stage;
      const uint32_t bar = full_bars + 8 * st;
      mbar_expect_tx(bar, (L.resident ? 0 : kPanel64) + (kept ? 0 : kPanel64));
      if (!L.resident) {
        tma_load(at, own_map, bar, pn * kPanelCols, px.hi, px.n0, px.bi);
      }
      if (!kept) {
        tma_load(at + L.own, stream_map, bar, pn * kPanelCols, px.hi, m0,
                 px.bi);
      }
      ++g;
    }
  }
}

// A kept tile of dK/dV (Q's with the tile's lse, or dO's with its delta:
// `stats` from `stat_at` floats into the stats buffer), refilled once both
// warpgroups are done with the tile before; the statistics in 4-byte
// copies from the warp's 32 lanes (s_q * 4 need not be a multiple of TMA's
// 16 bytes), rows past s_q as zeros.
__device__ __forceinline__ void produce_dkv_kept(const DkvProducer& px,
                                                 const CUtensorMap& map,
                                                 uint32_t full,
                                                 uint32_t empty,
                                                 int kept_offset,
                                                 const float* stats,
                                                 int stat_at, int lane) {
  const uint32_t kept = px.base + kept_offset;
  const int s_q = px.p.s_q;
  const float* src = stats + static_cast<long long>(px.bh) * s_q;
  float* dst = reinterpret_cast<float*>(px.ptr + px.L.stats) + stat_at;
  for (int j = 0; j < px.n_qtiles; ++j) {
    const int m0 = px.m_begin + j * kTileRows;
    mbar_wait(empty, (j & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(full, px.sl.nk * kPanel64);
      for (int i = 0; i < px.sl.nk; ++i) {
        tma_load(kept + i * kPanel64, map, full,
                 (px.sl.kp0 + i) * kPanelCols, px.hi, m0, px.bi);
      }
    }
#pragma unroll
    for (int r = lane; r < kTileRows; r += 32) {
      const bool valid = m0 + r < s_q;
      cp_async4(dst + r, valid ? src + m0 + r : src, valid);
    }
    cp_async_arrive(full);
  }
  // The lanes' last copies land before they leave.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// What a dK/dV consumer warpgroup needs of its CTA.
struct DkvConsumer {
  const Params& p;
  const DkvSlicedLayout& L;
  const Slice& sl;
  uint32_t base;
  unsigned char* ptr;  // base, as a generic pointer
  uint32_t own_full, full_bars;  // full_bars: its ring's
  uint32_t kq_full, kq_empty, kdo_full, kdo_empty;
  int bi, hi, n0, m_begin, n_qtiles, t;
};

// Warpgroup A (kA: S^T, P^T handed to B, dV) or B (dP^T, dS^T, dK) of
// the sliced dK/dV, through the epilogue.
template <bool kA>
__device__ __forceinline__ void consume_dkv_sliced(const DkvConsumer& cx) {
  const Params& p = cx.p;
  const DkvSlicedLayout& L = cx.L;
  const Slice& sl = cx.sl;
  const int np = L.panels, stages = L.stages;
  const int t = cx.t, lane = t & 31, tq = lane & 3, n0 = cx.n0;
  // The thread's keys of the m64 accumulators: key[0] and key[0] + 8.
  const int key[2] = {n0 + (t >> 5) * 16 + (lane >> 2),
                      n0 + (t >> 5) * 16 + (lane >> 2) + 8};
  float acc[kSliceCols / 2];
#pragma unroll
  for (int i = 0; i < kSliceCols / 2; ++i) acc[i] = 0.f;
  float* pbuf = reinterpret_cast<float*>(cx.ptr + L.pbuf);  // [32][128]
  // lse, then delta: 64 floats each.
  const float* stats = reinterpret_cast<const float*>(cx.ptr + L.stats);
  const uint32_t empty_bars = cx.full_bars + 8 * stages;
  const uint32_t ring = cx.base + (kA ? L.q_ring : L.do_ring);
  // A contracts K with Q (the kept Q tile), B V with dO (the kept dO tile).
  const uint32_t own = cx.base + (kA ? 0 : np * kPanel64);
  const uint32_t kept = cx.base + (kA ? L.kept_q : L.kept_do);
  const uint32_t other = cx.base + (kA ? L.kept_do : L.kept_q);
  float s[32];
  uint32_t f[4][4];
  if (cx.n_qtiles > 0 && L.resident) mbar_wait(cx.own_full, 0);
  int g = 0;
  for (int j = 0; j < cx.n_qtiles; ++j) {
    const int m0 = cx.m_begin + j * kTileRows;
    int held = -1;
    // A: S^T = K Q^T; B: dP^T = V dO^T.
    for (int pn = 0; pn < np; ++pn) {
      const bool kept_p = sl.kept(pn);
      if (kept_p && pn == sl.kp0) {
        mbar_wait(kA ? cx.kq_full : cx.kdo_full, j & 1);
      }
      int st = -1;
      uint32_t at = 0;
      if (!L.resident || !kept_p) {
        st = g % stages;
        mbar_wait(cx.full_bars + 8 * st, (g / stages) & 1);
        at = ring + st * L.stage;
        ++g;
      }
      const uint32_t a = L.resident ? own + pn * kPanel64 : at;
      const uint32_t b =
          kept_p ? kept + (pn - sl.kp0) * kPanel64 : at + L.own;
      panel_step(s, a, b, pn == 0, st, held, lane, empty_bars);
    }
    panels_done(held, lane, empty_bars);
    hold(s);
    if constexpr (kA) {
      // P^T from f32 scores and each query's lse, masked with -1e30 on
      // diagonal and ragged tiles: s[jj * 4 + i * 2 + e] is key key[i],
      // query m0 + jj * 8 + tq * 2 + e.
      const float scale2 = p.scale * kLog2e;
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
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(stats + jj * 8 + tq * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = jj * 4 + e, i = e >> 1, col = jj * 8 + (e & 1);
          float v = s[x] * scale2;
          if (need_mask && (col < from[i] || col >= to)) v = kNegBig;
          s[x] = ex2(v - ((e & 1) ? l2.y : l2.x) * kLog2e);
        }
      }
      // Done with Q's tile and lse: every lane's reads before the warp's
      // arrive.
      __syncwarp();
      if (lane == 0) mbar_arrive(cx.kq_empty);
      if (j > 0) named_sync(kPFree);  // B has read the previous tile's P^T
#pragma unroll
      for (int x = 0; x < 32; ++x) pbuf[x * kWgThreads + t] = s[x];
      named_arrive(kPReady);
    } else {
      named_sync(kPReady);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dl = *reinterpret_cast<const float2*>(
            stats + kTileRows + jj * 8 + tq * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = jj * 4 + e;
          s[x] = pbuf[x * kWgThreads + t] * (s[x] - ((e & 1) ? dl.y : dl.x));
        }
      }
      __syncwarp();  // done with dO's tile and delta
      if (lane == 0) mbar_arrive(cx.kdo_empty);
      if (j + 1 < cx.n_qtiles) named_arrive(kPFree);
    }
    // A: dV += P^T dO_slice; B: dK += dS^T Q_slice.
    pack_a(s, f);
    mbar_wait(kA ? cx.kdo_full : cx.kq_full, j & 1);
    wgmma_fence();
    issue_rs<kSliceCols>(acc, f, other);
    wgmma_commit();
    wgmma_wait<0>();
    hold(acc);
    hold(f);
    if (lane == 0) mbar_arrive(kA ? cx.kdo_empty : cx.kq_empty);
  }

  // acc[j * 4 + i * 2 + e]: key key[i], slice column j * 8 + tq * 2 + e;
  // dV from warpgroup A, dK (scaled) from B. A key tile that no query
  // reaches stores zeros.
  const float scale = kA ? 1.f : p.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= p.s_k) continue;
    bf16* orow = (kA ? out_row_of<bf16>(p.dv, p, kDV, cx.bi, cx.hi, key[i])
                     : out_row_of<bf16>(p.dk, p, kDK, cx.bi, cx.hi, key[i])) +
                 sl.c_lo;
#pragma unroll
    for (int j = 0; j < kSliceCols / 8; ++j) {
      if (j * 8 >= sl.cols) break;
      *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) = pack_bf16(
          acc[j * 4 + i * 2] * scale, acc[j * 4 + i * 2 + 1] * scale);
    }
  }
}

// dK/dV over 256-column slices: both consumer warpgroups own the CTA's 64
// keys, as in wide_dkv_bf16_kernel. Per 64-query tile warpgroup A
// computes S^T = K Q^T panel by panel (Q's ring and the kept Q tile),
// P^T = exp2(S^T' - lse'), hands the f32 P^T to B through shared memory
// and accumulates dV_slice += P^T dO_slice (the kept dO tile); B computes
// dP^T = V dO^T (dO's ring and the kept dO tile), dS^T = P^T (dP^T -
// delta) and dK_slice += dS^T Q_slice (the kept Q tile), scaled on the
// f32 result. The producer warpgroup's four warps: Q's ring (and the owned
// K and V when resident), dO's ring, the kept Q tile with the tile's lse,
// the kept dO tile with its delta; each role is a function of its own, its
// maps fixed at the call (selecting them at run time cost spills at the
// producer's 24 registers).
__global__ void __launch_bounds__(kHopperThreads, 1)
    wide_dkv_bf16_sliced_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap domap,
                                const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t addr = smem_u32(smem_raw);
  const uint32_t base = (addr + 1023) & ~1023u;
  unsigned char* const ptr = smem_raw + (base - addr);
  const DkvSlicedLayout L = dkv_sliced_layout(p.d);
  const int np = L.panels, stages = L.stages;
  const uint32_t own_full = base + L.bars;
  // Q's ring's full and empty barriers, then dO's.
  const uint32_t ring_bars[2] = {own_full + 8, own_full + 8 + 16 * stages};
  const uint32_t kept_bars = own_full + 8 + 32 * stages;
  // kept Q full, empty, kept dO full, empty.
  const uint32_t kq_full = kept_bars, kq_empty = kept_bars + 8;
  const uint32_t kdo_full = kept_bars + 16, kdo_empty = kept_bars + 24;
  const Slice sl = slice_of(p, np);
  int bh, tile;
  group_tile(p, (p.s_k + kTileRows - 1) / kTileRows, false, bh, tile,
             blockIdx.x / p.slices);
  const int bi = bh / p.h, hi = bh % p.h;
  const int n0 = tile * kTileRows;
  // Queries that reach this tile: under the causal mask, those at global
  // positions from the global position of its first key on.
  const int m_begin =
      p.causal ? max(0, p.k_offset + n0 - p.q_offset) / kTileRows * kTileRows
               : 0;
  const int n_qtiles =
      m_begin < p.s_q ? (p.s_q - m_begin + kTileRows - 1) / kTileRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int r = 0; r < 2; ++r) {
      for (int st = 0; st < stages; ++st) {
        mbar_init(ring_bars[r] + 8 * st, 1);
        mbar_init(ring_bars[r] + 8 * (stages + st), kConsumerWarps / 2);
      }
    }
    // A kept tile is full once its TMA bytes and the 32 lanes' lse or
    // delta copies have landed; empty once both warpgroups are done.
    mbar_init(kq_full, 1 + 32);
    mbar_init(kq_empty, kConsumerWarps);
    mbar_init(kdo_full, 1 + 32);
    mbar_init(kdo_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (n_qtiles == 0) return;
    const DkvProducer px{p, L, sl, base, ptr, own_full, bh, bi, hi, n0,
                         m_begin, n_qtiles};
    if (warp == 0 && lane == 0) {
      if (L.resident) {  // the owned K and V
        mbar_expect_tx(own_full, 2 * np * kPanel64);
        for (int pn = 0; pn < np; ++pn) {
          tma_load(base + pn * kPanel64, kmap, own_full, pn * kPanelCols, hi,
                   n0, bi);
          tma_load(base + (np + pn) * kPanel64, vmap, own_full,
                   pn * kPanelCols, hi, n0, bi);
        }
      }
      produce_dkv_ring(px, kmap, qmap, ring_bars[0], L.q_ring);
    } else if (warp == 1 && lane == 0) {
      produce_dkv_ring(px, vmap, domap, ring_bars[1], L.do_ring);
    } else if (warp == 2) {
      produce_dkv_kept(px, qmap, kq_full, kq_empty, L.kept_q, p.lse, 0,
                       lane);
    } else if (warp == 3) {
      produce_dkv_kept(px, domap, kdo_full, kdo_empty, L.kept_do, p.delta,
                       kTileRows, lane);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const DkvConsumer cx{p, L, sl, base, ptr, own_full, ring_bars[wg - 1],
                       kq_full, kq_empty, kdo_full, kdo_empty, bi, hi, n0,
                       m_begin, n_qtiles, static_cast<int>(threadIdx.x) -
                                              wg * kWgThreads};
  if (wg == 1) {
    consume_dkv_sliced<true>(cx);
  } else {
    consume_dkv_sliced<false>(cx);
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

// The sliced dQ (kDkv false) or dK/dV over `slices` output-column slices.
// dQ: Q and dO in 128-row boxes, K and V in 64-row ones, K and V streamed
// through every Q tile of a head; dK/dV: every map in 64-row boxes, Q and
// dO streamed through every key tile.
template <bool kDkv>
int launch_bwd_sliced(const Params& p, int slices, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, k, v, dO
  const struct {
    const void* ptr;
    int which, s, box_rows;
  } tensors[4] = {{p.q, kQ, p.s_q, kDkv ? kTileRows : kBlockM},
                  {p.k, kK, p.s_k, kTileRows},
                  {p.v, kV, p.s_k, kTileRows},
                  {p.dout, kDO, p.s_q, kDkv ? kTileRows : kBlockM}};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_tensor(&maps[i], tensors[i].ptr, p,
                                  tensors[i].which, tensors[i].s,
                                  tensors[i].box_rows);
    if (err != 0) return err;
  }
  const void* kernel =
      kDkv ? reinterpret_cast<const void*>(&wide_dkv_bf16_sliced_kernel)
           : reinterpret_cast<const void*>(&wide_dq_bf16_sliced_kernel);
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  // The limit every head dim's layout fits under.
  const int err = prepare(kernel, kMaxSmem, l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * (kDkv ? p.s_q : p.s_k) * p.d * 2, l2);
  grouped.slices = slices;
  const int rows = kDkv ? kTileRows : kBlockM;
  const long long ctas = static_cast<long long>(p.b) * p.h *
                         (((kDkv ? p.s_k : p.s_q) + rows - 1) / rows) * slices;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if constexpr (kDkv) {
    wide_dkv_bf16_sliced_kernel<<<static_cast<unsigned>(ctas), kHopperThreads,
                                  dkv_sliced_layout(p.d).smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], grouped);
  } else {
    wide_dq_bf16_sliced_kernel<<<static_cast<unsigned>(ctas), kHopperThreads,
                                 dq_sliced_layout(p.d).smem, stream>>>(
        maps[0], maps[1], maps[2], maps[3], grouped);
  }
  return cudaGetLastError();
}

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
  return launch_bwd_sliced<false>(p, slices, st);
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
  return launch_bwd_sliced<true>(p, slices, st);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return error_string(err);
}
