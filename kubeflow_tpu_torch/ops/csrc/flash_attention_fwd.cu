// Flash-attention forward for Hopper (sm_90a): the full forward, with O and
// per-row logsumexp, and the ring hop's partial forward, with the unnormalized
// accumulator and its softmax statistics. Both run one loop.
//
// Replaces two TPU kernels of kubeflow_tpu/ops/flash_attention.py:
//  * _fwd_kernel (launched by _flash_fwd): softmax(Q K^T * scale) V with an
//    online softmax whose m, l and acc stay in f32, masked logits set to -1e30
//    (not -inf), K/V tiles above the diagonal skipped when causal, P rounded
//    to V's dtype before the PV product, l floored at 1e-30, and
//    lse = m + log(l) written as f32 [b*h, s] (the TPU's (8, s)
//    sublane-replicated lse layout is a tiling artefact and is not copied).
//  * _partial_kernel (launched by flash_attention_partial): one ring hop, the
//    causal block attention of a Q block against a K/V block at the global
//    positions q_offset + i and k_offset + j. It writes the accumulator
//    UNnormalized as f32 in the [b, s, h, d] layout and the per-row max m (in
//    the natural units of s = q.k * scale: ring.py folds exp(m - m_new)
//    outside the kernel) and sum l as f32 [b*h, s]. A row that no key of the
//    block reaches is written as acc = 0, m = -1e30, l = 0, which is also what
//    the TPU kernel writes for it at block-aligned offsets (the only ones a
//    ring makes); the fold gives such a row no weight either way.
//
// Bounds on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s):
//  * forward at the serving decode shape [8, 1024, 16, 128] bf16, causal:
//    34.4 GFLOP of causal QK^T and PV (35 us) against 134 MB of q, k, v and o
//    moved once (40 us): bound by bytes at about 40 us, though only just: at
//    that size the kernel has to run the tensor cores near their peak too.
//    8 launches a decode step and a train step.
//  * partial at the long-context hop [1, 8192, 16, 128] bf16 at offsets
//    (0, 0): 274.9 GFLOP (0.278 ms) against 168.8 MB (0.050 ms): bound by
//    operations; one launch per layer and step on one card.
// Both are tensor-core work. What held the mma.sync loop that this kernel
// replaces at 16-19% of its bound was feeding the tensor cores: 16 rows a
// warp made every warp read every K and V tile out of shared memory, so
// shared-memory bandwidth set its pace, and its cp.async loads were issued
// by the threads that do the math. What bounds this kernel on the card
// (PERF.md, measured with ops/compare_fwd.py): the softmax. A score costs
// one exp2 on the special-function unit, whose rate is about a 250th of the
// tensor cores', so at head dim 128 the exp2s alone take about half as long
// as the two products; they, the masks and the O rescale run between a
// warpgroup's QK^T and its PV and overlap only the other warpgroup's
// products. At the decode shape each CTA also pays its start (barriers,
// the first loads) and its epilogue over only 1-8 K/V tiles.
//
// What the design does (bf16, every head dim that is a multiple of 8 up to
// 128: the tiles are 64 or 128 columns wide, see "Head dims" below):
//  * One CTA of three warpgroups per (b*h, 128-row Q tile). Warpgroup 0 is
//    the producer: it gives up its registers (setmaxnreg) and one thread
//    issues every load through TMA. Warpgroups 1 and 2 are consumers of 64
//    Q rows each and take 240 registers a thread (ptxas gives them only if
//    no trap sits on their path; see mbar_wait).
//  * The launch order groups (batch, head) pairs by how many heads' K and V
//    half the L2 holds, each group's Q tiles from the heaviest causal tile
//    down: CTAs that run together share K/V in L2 (the decode shape reads
//    K and V of 8 Q tiles a head), and the lightest tiles come last.
//  * Q, K and V are read in the model's [b, s, h, d] layout through their
//    strides (the q, k, v column slices of the fused qkv product): the host
//    encodes one 4-D tensor map per tensor and launch (under 1 us for the
//    three), dims (d, h, s, b) so the strides rise in the usual layouts,
//    with a 128-byte swizzle; each TMA box is 64 columns by 128 rows (a 16
//    KB panel), and rows past s arrive as zeros, which handles the ragged
//    edge (the 32-token prefill chunk). No copy or transpose runs before
//    the kernel.
//  * K/V tiles of 128 keys flow through a ring of stages (2; 160 KB of
//    shared memory with Q at head dim 128) with full and empty mbarriers; K
//    and V have their own full barriers, so QK^T starts while V is in
//    flight.
//  * Both products run on wgmma: S = Q K^T as m64n128k16 with Q and K read
//    from shared memory (K-major descriptors), O += P V as m64nDk16 with P
//    from registers (the S accumulator layout is the A-fragment layout, so P
//    is rounded to bf16 in place) and V read MN-major through the
//    descriptor's transpose bit. One B tile feeds 64 rows of a warpgroup, a
//    quarter of the shared-memory reads per product of the mma.sync loop.
//  * Each consumer warpgroup runs a tile's QK^T, softmax and PV in turn, and
//    the two warpgroups overlap one another. Two finer schedules measured
//    slower on the card and are not kept (PERF.md): issuing the next tile's
//    QK^T with this tile's PV so the softmax runs under both (ptxas then
//    injects warpgroup arrives around the register operands), and making
//    the two warpgroups take turns at issuing their products on named
//    barriers. A third K/V stage gained nothing either.
//  * The softmax runs in registers in base 2 (one exp2 a score, on the
//    special-function unit with subnormals flushed) and masks only
//    diagonal and ragged tiles, branch-free, with the live range taken from
//    the global offsets. A hop wholly above the diagonal launches CTAs that
//    load nothing and write "nothing".
//  * Head dims. The tiles are D = 64 columns wide for d <= 64 and D = 128
//    for 64 < d <= 128. The tensor maps carry the true d, so TMA fills a
//    tile's columns past d with zeros: Q K^T sums zeros there, P V's columns
//    past d come out zero, and the epilogue stores d columns only. The
//    scale is 1/sqrt(d) of the true d (the caller's). d must be a multiple
//    of 8: a TMA stride is a multiple of 16 bytes, and the heads of a qkv
//    slice lie d elements apart. A narrow head does the wide tile's
//    tensor-core work; at d = 16 and 32 the kernel moves few bytes for it.
//  * f32 (not on the main paths): flash_attention_f32.cuh's register-tiled
//    loop on the CUDA cores (exact f32 FMAs, TMA panel loads; its header
//    has its bound and design), at 16, 32, 64 or 128 output columns.

#include <chrono>

#include "flash_attention_f32.cuh"
#include "hopper.cuh"

namespace {

using namespace kftpu;

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // the forward: q's dtype; the partial: f32 acc
  float* lse;   // the forward: [b*h, s]
  float* m;     // the partial: [b*h, s], natural units
  float* l;     // the partial: [b*h, s]
  int b, s, h, d;  // d: the true head dim (the tiles may be wider)
  long long q_sb, q_ss, q_sh;  // strides in elements; the d stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  // Global positions of query row 0 and key 0 for the causal mask (a ring
  // hop's blocks); 0 and 0 for the forward.
  int q_offset, k_offset;
  int group;  // the bf16 kernels' launch order: (batch, head) pairs a group
};

// ---------------------------------------------------------------- bf16 path

constexpr int kBlockM = 128;       // Q rows a CTA: two consumer warpgroups
constexpr int kWgRows = 64;        // Q rows a consumer warpgroup
constexpr int kBlockN = 128;       // keys a K/V tile
constexpr int kPanelBytes = kBlockN * kRowBytes;  // one TMA box: 16 KB
constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;
constexpr int kConsumerWarps = 8;
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kBlockM == kBlockN, "Q and K/V tiles share one TMA box");

template <int D>
struct HopperCfg {
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // Q, K or V
  // Shared memory: Q | K0 | V0 | K1 | V1 | ... | barriers, 1024-aligned
  // (the 128-byte swizzle repeats every 8 rows of 128 bytes).
  static constexpr int kBarOffset = (1 + 2 * kStages) * kTileBytes;
  static constexpr int kBars = 1 + 3 * kStages;  // q, k full, v full, empty
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
};

// S = Q K^T for a warpgroup's 64 rows and a 128-key tile; both operands
// K-major in 16 KB panels of 64 columns: a k-step of 16 columns moves 32
// bytes along the swizzled row, four of them a panel.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss_n128(s, smem_desc(q_addr + off, 16, 8 * kRowBytes),
                  smem_desc(k_addr + off, 16, 8 * kRowBytes), kk > 0);
  }
}

// O += P V: P as the register A operand, V [key][d] read MN-major: a k-step
// of 16 keys is 16 rows of 128 bytes, the 64-column panels of d sit a
// panel apart (the leading byte offset), 8-key groups 1 KB apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pf)[8][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t b =
        smem_desc(v_addr + kk * 16 * kRowBytes, kPanelBytes, 8 * kRowBytes);
    if constexpr (D == 128) {
      wgmma_rs_n128(o, pf[kk], b);
    } else {
      wgmma_rs_n64(o, pf[kk], b);
    }
  }
}

// One tile's online softmax for the thread's two rows (row and row + 8) of
// the m64n128 accumulator: scale to log2 units, mask with -1e30 where
// needed, update the running max and sum, and leave P = exp2(S' - m_new) in
// s. corr is the factor the accumulator must be rescaled by.
struct SoftmaxArgs {
  int n0;          // the tile's first key
  bool need_mask;  // the tile crosses the diagonal or the ragged edge
  int row;         // the thread's first row (the second is row + 8)
  int tq;          // the thread's column pair within an 8-column chunk
};

__device__ __forceinline__ void online_softmax(float (&s)[64],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&corr)[2],
                                               const SoftmaxArgs& a,
                                               const Params& p,
                                               float scale2) {
  float mx[2] = {m_run[0], m_run[1]};
  // Row i keeps the keys before min(s, its last visible key + 1); as an
  // offset from this thread's first column n0 + 2 tq.
  int live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int end = p.causal ? min(p.s, p.q_offset + a.row + 8 * i -
                                            p.k_offset + 1)
                             : p.s;
    live[i] = end - (a.n0 + a.tq * 2);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j * 4 + e] * scale2;
      if (a.need_mask && j * 8 + (e & 1) >= live[e >> 1]) x = kNegBig;
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
  for (int j = 0; j < 64; ++j) {
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

// P rounded to bf16 as wgmma A fragments: the accumulator chunks 2kk and
// 2kk + 1 (8 columns each) are exactly the m64k16 A layout of k-step kk.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&pf)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pf[kk][r] = pack_bf16(s[kk * 8 + r * 2], s[kk * 8 + r * 2 + 1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// The shared-memory addresses and barriers of one CTA.
template <int D>
struct Smem {
  uint32_t base, bars;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int st) const {
    return base + (1 + 2 * st) * HopperCfg<D>::kTileBytes;
  }
  __device__ uint32_t v(int st) const {
    return base + (2 + 2 * st) * HopperCfg<D>::kTileBytes;
  }
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int st) const { return bars + 8 * (1 + st); }
  __device__ uint32_t v_full(int st) const {
    return bars + 8 * (1 + kStages + st);
  }
  __device__ uint32_t empty(int st) const {
    return bars + 8 * (1 + 2 * kStages + st);
  }
};

// The producer's one thread: Q once, then every K/V tile through the ring.
template <int D>
__device__ __forceinline__ void produce(const Smem<D>& sm,
                                        const CUtensorMap& qmap,
                                        const CUtensorMap& kmap,
                                        const CUtensorMap& vmap, int m0,
                                        int hi, int bi, int n_tiles) {
  constexpr int kPanels = HopperCfg<D>::kPanels;
  constexpr int kBytes = HopperCfg<D>::kTileBytes;
  mbar_expect_tx(sm.q_full(), kBytes);
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) {
    tma_load(sm.q() + pn * kPanelBytes, qmap, sm.q_full(), pn * kPanelCols,
             hi, m0, bi);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    // The stage's previous tile was released (round 0 passes at once).
    mbar_wait(sm.empty(st), ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(sm.k_full(st), kBytes);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(sm.k(st) + pn * kPanelBytes, kmap, sm.k_full(st),
               pn * kPanelCols, hi, j * kBlockN, bi);
    }
    mbar_expect_tx(sm.v_full(st), kBytes);
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
      tma_load(sm.v(st) + pn * kPanelBytes, vmap, sm.v_full(st),
               pn * kPanelCols, hi, j * kBlockN, bi);
    }
  }
}

// A consumer warpgroup's loop over the K/V tiles: warpgroup `c` (0 or 1)
// owns Q rows [m0w, m0w + 64) of the tile.
template <int D>
__device__ __forceinline__ void consume(const Smem<D>& sm, const Params& p,
                                        int c, int m0w, int row, int tq,
                                        int lane, int n_tiles,
                                        float (&o)[D / 2], float (&m_run)[2],
                                        float (&l_run)[2]) {
  const float scale2 = p.scale * kLog2e;
  const uint32_t q_addr = sm.q() + c * kWgRows * kRowBytes;
  float s[64];
  uint32_t pf[8][4];
  float corr[2];

  mbar_wait(sm.q_full(), 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const int n0 = j * kBlockN;
    const SoftmaxArgs args{n0,
                           n0 + kBlockN > p.s ||
                               (p.causal && p.k_offset + n0 + kBlockN - 1 >
                                                p.q_offset + m0w),
                           row, tq};
    mbar_wait(sm.k_full(st), ph);
    wgmma_fence();
    issue_qk<D>(s, q_addr, sm.k(st));
    wgmma_commit();
    wgmma_wait<0>();
    hold(s);
    online_softmax(s, m_run, l_run, corr, args, p, scale2);
    rescale<D>(o, corr);
    pack_p(s, pf);
    mbar_wait(sm.v_full(st), ph);
    wgmma_fence();
    issue_pv<D>(o, pf, sm.v(st));
    wgmma_commit();
    wgmma_wait<0>();
    hold(o);
    hold(pf);
    if (lane == 0) mbar_arrive(sm.empty(st));  // one arrive a warp
  }
}

// The body of both bf16 kernels: kPartial selects the ring hop's epilogue.
template <int D, bool kPartial>
__device__ __forceinline__ void hopper_attention(const CUtensorMap& qmap,
                                                 const CUtensorMap& kmap,
                                                 const CUtensorMap& vmap,
                                                 const Params& p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const Smem<D> sm{(raw + 1023) & ~1023u,
                   ((raw + 1023) & ~1023u) + HopperCfg<D>::kBarOffset};

  // The launch order: (batch, head) pairs in groups of p.group, each
  // group's Q tiles from the last (heaviest when causal) down, the group's
  // heads side by side. CTAs that run together share a few heads' K and V
  // in L2, and within a group the lightest tiles come last.
  const int m_blocks = (p.s + kBlockM - 1) / kBlockM;
  const int bhs = p.b * p.h;
  const int per_group = p.group * m_blocks;
  const int g = blockIdx.x / per_group, rem = blockIdx.x % per_group;
  const int heads = min(p.group, bhs - g * p.group);
  const int bh = g * p.group + rem % heads, bi = bh / p.h, hi = bh % p.h;
  const int m0 = (m_blocks - 1 - rem / heads) * kBlockM;
  // Keys [0, n_end) reach some row of this tile: causal, the last row's
  // global position bounds them.
  const int n_end =
      p.causal ? max(0, min(p.s, p.q_offset + min(m0 + kBlockM, p.s) -
                                     p.k_offset))
               : p.s;
  const int n_tiles = (n_end + kBlockN - 1) / kBlockN;

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
      produce<D>(sm, qmap, kmap, vmap, m0, hi, bi, n_tiles);
    }
  } else {
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
      consume<D>(sm, p, c, m0w, row[0], tq, lane, n_tiles, o, m_run, l_run);
    }

    // o[j * 4 + i * 2 + e]: row row[i], column j * 8 + tq * 2 + e.
    if constexpr (kPartial) {
      float* out = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] >= p.s) continue;
        // A row that saw a key has a real max: each row that sees any key
        // of the block sees key 0, which is in the first tile.
        const bool seen = m_run[i] != kNegBig;
        float* orow = out + static_cast<long long>(row[i]) * p.o_ss;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (j * 8 >= p.d) break;  // the tile's zero columns past d
          *reinterpret_cast<float2*>(orow + j * 8 + tq * 2) =
              seen ? make_float2(o[j * 4 + i * 2], o[j * 4 + i * 2 + 1])
                   : make_float2(0.f, 0.f);
        }
        if (tq == 0) {
          const long long at = static_cast<long long>(bh) * p.s + row[i];
          p.m[at] = seen ? m_run[i] * kLn2 : kNegBig;  // log2 -> natural
          p.l[at] = seen ? l_run[i] : 0.f;
        }
      }
    } else {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb +
                           hi * p.o_sh;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] >= p.s) continue;
        const float l = fmaxf(l_run[i], 1e-30f);
        __nv_bfloat16* orow = out + static_cast<long long>(row[i]) * p.o_ss;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          if (j * 8 >= p.d) break;  // the tile's zero columns past d
          *reinterpret_cast<uint32_t*>(orow + j * 8 + tq * 2) = pack_bf16(
              o[j * 4 + i * 2] / l, o[j * 4 + i * 2 + 1] / l);
        }
        if (tq == 0) {
          p.lse[static_cast<long long>(bh) * p.s + row[i]] =
              m_run[i] * kLn2 + logf(l);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const Params p) {
  hopper_attention<D, false>(qmap, kmap, vmap, p);
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    partial_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const Params p) {
  hopper_attention<D, true>(qmap, kmap, vmap, p);
}

// The maps of q, k and v at their true head dim p.d.
int encode_qkv(CUtensorMap (&maps)[3], const Params& p) {
  int err = encode(&maps[0], p.q, p.b, p.s, p.h, p.d, p.q_sb, p.q_ss, p.q_sh,
                   kBlockN);
  if (err == 0) {
    err = encode(&maps[1], p.k, p.b, p.s, p.h, p.d, p.k_sb, p.k_ss, p.k_sh,
                 kBlockN);
  }
  if (err == 0) {
    err = encode(&maps[2], p.v, p.b, p.s, p.h, p.d, p.v_sb, p.v_ss, p.v_sh,
                 kBlockN);
  }
  return err;
}

template <int D, bool kPartial>
int launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = HopperCfg<D>::kSmem;
  CUtensorMap maps[3];
  const int enc = encode_qkv(maps, p);
  if (enc != 0) return enc;
  const void* kernel =
      kPartial ? reinterpret_cast<const void*>(&partial_bf16_kernel<D>)
               : reinterpret_cast<const void*>(&fwd_bf16_kernel<D>);
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  const int err = prepare(kernel, kSmem, l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // K and V stream through every Q tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s * p.d * 2, l2);
  const int m_blocks = (p.s + kBlockM - 1) / kBlockM;
  const dim3 grid(p.b * p.h * m_blocks);
  if constexpr (kPartial) {
    partial_bf16_kernel<D><<<grid, kHopperThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], grouped);
  } else {
    fwd_bf16_kernel<D><<<grid, kHopperThreads, kSmem, stream>>>(
        maps[0], maps[1], maps[2], grouped);
  }
  return cudaGetLastError();
}

// The f32 forward (kPartial false) or partial of flash_attention_f32.cuh
// on the narrowest output width that holds d.
template <bool kPartial>
int launch_f32(const Params& p, cudaStream_t stream) {
  f32fwd::Params f{};
  f.q = static_cast<const float*>(p.q);
  f.k = static_cast<const float*>(p.k);
  f.v = static_cast<const float*>(p.v);
  f.o = static_cast<float*>(p.o);
  f.lse = p.lse;
  f.m = p.m;
  f.l = p.l;
  f.b = p.b, f.s = p.s, f.h = p.h, f.d = p.d;
  const long long st[4][3] = {{p.q_sb, p.q_ss, p.q_sh},
                              {p.k_sb, p.k_ss, p.k_sh},
                              {p.v_sb, p.v_ss, p.v_sh},
                              {p.o_sb, p.o_ss, p.o_sh}};
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 3; ++j) f.st[i][j] = st[i][j];
  }
  f.scale = p.scale;
  f.causal = p.causal;
  f.q_offset = p.q_offset;
  f.k_offset = p.k_offset;
  f.slices = 1;
  if (p.d <= 16) return f32fwd::launch<16, kPartial>(f, stream);
  if (p.d <= 32) return f32fwd::launch<32, kPartial>(f, stream);
  return p.d <= 64 ? f32fwd::launch<64, kPartial>(f, stream)
                   : f32fwd::launch<128, kPartial>(f, stream);
}

// Head dims: a multiple of 8 up to 128 (bf16 on the narrowest tile that
// holds it, 64 or 128 columns; f32 on the narrowest output width, 16, 32,
// 64 or 128); wider heads run flash_attention_wide.cu's kernels.
template <bool kPartial>
int launch(Params p, int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 8 || d > 128 || d % 8 != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.d = d;
  if (dtype == 1) {
    return d <= 64 ? launch_bf16<64, kPartial>(p, st)
                   : launch_bf16<128, kPartial>(p, st);
  }
  return launch_f32<kPartial>(p, st);
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int h, const long long* st, float scale,
                   int causal) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.b = b;
  p.s = s;
  p.h = h;
  p.q_sb = st[0], p.q_ss = st[1], p.q_sh = st[2];
  p.k_sb = st[3], p.k_ss = st[4], p.k_sh = st[5];
  p.v_sb = st[6], p.v_ss = st[7], p.v_sh = st[8];
  p.o_sb = st[9], p.o_ss = st[10], p.o_sh = st[11];
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t (0 on success), or 100000 + the CUresult of a failed
// tensor-map encode; the launch itself is asynchronous on `stream`.
extern "C" int kftpu_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int b,
    int s, int h, int d, int dtype, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  Params p = make_params(q, k, v, o, b, s, h, st, scale, causal);
  p.lse = lse;
  return launch<false>(p, d, dtype, stream);
}

// One ring hop, causal: o is the f32 [b, s, h, d] unnormalized accumulator
// (strides in elements), m and l f32 [b*h, s]; query row i sits at global
// position q_offset + i and key j at k_offset + j.
extern "C" int kftpu_flash_attention_partial(
    const void* q, const void* k, const void* v, float* o, float* m,
    float* l, int b, int s, int h, int d, int dtype, const long long* strides,
    float scale, int q_offset, int k_offset, void* stream) {
  Params p = make_params(q, k, v, o, b, s, h, strides, scale, 1);
  p.m = m;
  p.l = l;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  return launch<true>(p, d, dtype, stream);
}

// Host nanoseconds to encode the three tensor maps of one bf16 launch,
// averaged over `iters` encodes of q, k, v as given (strides as for
// kftpu_flash_attention_partial); a negative value is a failed encode.
extern "C" double kftpu_flash_attention_encode_ns(
    const void* q, const void* k, const void* v, int b, int s, int h, int d,
    const long long* strides, int iters) {
  const long long st[12] = {strides[0], strides[1], strides[2], strides[3],
                            strides[4], strides[5], strides[6], strides[7],
                            strides[8], 0, 0, 0};
  Params p = make_params(q, k, v, nullptr, b, s, h, st, 1.f, 1);
  p.d = d;
  CUtensorMap maps[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (encode_qkv(maps, p) != 0) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return error_string(err);
}
