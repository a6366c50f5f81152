// Flash-attention forward in float32 on the CUDA cores (sm_90a): the full
// forward (O and lse) and the ring hop's partial forward (the unnormalized
// accumulator, m and l), one loop with two epilogues, at every head dim
// that is a multiple of 8. flash_attention_fwd.cu launches it for heads up
// to 128 columns, flash_attention_wide.cu for wider ones (over output-column
// slices of 256); each library compiles the instantiations it launches.
//
// Replaces, in float32, the TPU kernels _fwd_kernel (launched by _flash_fwd)
// and _partial_kernel (flash_attention_partial) of
// kubeflow_tpu/ops/flash_attention.py, with their function and rounding
// points: scores, m, l and the accumulator in f32, masked scores at -1e30,
// l floored at 1e-30, lse = m + log(l) as f32 [b*h, s]; the partial writes
// acc in [b, s, h, d], m (natural units) and l as f32 [b*h, s], and a row
// that no key of the block reaches as acc = 0, m = -1e30, l = 0. Every
// product is an exact f32 FMA (no TF32: the tests and chip_smoke.py hold
// f32 at 1e-4, summation order only). The exponentials are ex2.approx.ftz
// on scores scaled by scale * log2(e), as the bf16 kernels' (about 2 ulp).
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s):
// at [8, 1024, 16, d] causal the products QK^T and PV are 2 b h s^2 d
// FLOP (34.4 GFLOP at d = 128, 0.513 ms) against 4 b s h d * 4 bytes of q,
// k, v and o (268 MB, 0.080 ms): bound by operations at every d. So the
// design keeps the FMA pipe fed: it is an SGEMM-style register-tiled loop,
// whose FMAs wait on their operands' shared-memory reads and share the
// issue slots with them and with the softmax (PERF.md has the measured
// share of the bound).
//
// Design:
//  * One CTA per (b*h, Q tile, 256-column output slice), the slices of one
//    Q tile side by side in the launch order (they share K and V in L2),
//    the (batch, head) pairs in groups of as many heads as half the L2 holds
//    K and V of, each group's Q tiles from the heaviest causal tile on. A
//    CTA is a producer warp and 8 consumer warps: 9 warps leave 168
//    registers a thread. (A 17th warp puts 5 on one of the SM's four
//    register files and cuts that to 96, which spilled; 16 consumer warps
//    fed by a producer warpgroup whose registers setmaxnreg hands over, 112
//    each, measured no faster than 8.)
//  * Loads: one thread of the producer issues TMA loads of 32-column f32
//    panels (128-byte rows, 128-byte swizzle; rows and columns past the
//    tensor come as zeros) through the tensors' strides: the Q tile's and the
//    K tile's panels c = 0 .. d/32 in pairs through a ring of 3 stages, and
//    then the K tile's V panels of the CTA's output columns into one of two
//    V buffers. Full and empty mbarriers order them; a consumer warp
//    releases a stage once its lanes have read it. So the next panels and
//    the next V tile load while this one is multiplied.
//  * Register tiles: kTx threads share a Q row (neighbouring lanes), 8 for
//    outputs of up to 64 columns (128 Q rows a CTA), 16 above (64 rows; O
//    then takes up to 64 registers a thread). Thread (ty, tx) holds S for
//    rows ty + r R/4 (r < 4, R the CTA's rows) and keys tx + kTx e of a
//    64-key tile, and O for the same rows at DV / kTx columns. Operands are
//    float4 reads along the contraction: the swizzle puts the keys a warp
//    reads at once on distinct banks, and its 4 (2) consecutive Q rows on
//    distinct banks too. At kTx = 8: 128 FMAs a thread for 12 16-byte
//    reads, each 128 bytes a warp (one shared-memory wavefront); at 16: 64
//    FMAs for 8 reads, 12 wavefronts. 8 threads a row measured 17% faster
//    at [8, 1024, 16, 32], as fast at 128 columns, and 128-row tiles halve
//    the CTAs of a small batch: hence 16 above 64 columns.
//  * Online softmax in base 2 per row: the threads that share a row reduce
//    its maximum by shuffles; the sum l stays a per-thread partial,
//    rescaled with the row, and is reduced once in the epilogue. Masks only
//    on tiles that cross the diagonal or the ragged edge; K tiles above the
//    diagonal are never loaded.
//  * P goes through shared memory ([rows][72 or 80] f32, the pitch putting
//    a warp's writes on distinct banks): a warp writes and then reads only
//    its own rows, so __syncwarp orders it, no CTA barrier.
//  * O += P V: P read as float4 along the keys (broadcast over the row's
//    threads), V as float4 rows (a row's threads cover contiguous bytes).
//  * Output-column slices: a CTA accumulates the columns [256 y, 256 y +
//    256) of O (or acc); S contracts over all of d in every slice, in the
//    same order, so every slice's statistics are bitwise equal and slice 0
//    alone writes them.

#pragma once

#include "hopper.cuh"

// In the unnamed namespace of the source that includes it, as the sources'
// own kernels: each library keeps its own instantiations and their launch
// state (a function-local static of a template with external linkage is
// one object across every library loaded into the process, and two builds
// are loaded side by side to be compared).
namespace {
namespace f32fwd {

using namespace kftpu;

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kCols = kRowBytes / 4;     // f32 columns of a panel: 32
constexpr int kKeys = 64;                // keys a K/V tile
constexpr int kStages = 3;               // Q/K panel pairs in flight
constexpr int kPanelK = kKeys * kRowBytes;  // a 64-row panel: 8 KB
constexpr int kSliceCols = 256;          // output columns a CTA at most
constexpr int kSmemLimit = 232448;       // bytes a CTA may have on sm_90

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;    // the forward: O; the partial: acc
  float* lse;  // the forward: [b*h, s]
  float* m;    // the partial: [b*h, s], natural units
  float* l;    // the partial: [b*h, s]
  int b, s, h, d;  // d: the true head dim
  long long st[4][3];  // q, k, v, o: (batch, seq, head) strides in elements
  float scale;
  int causal;
  int q_offset, k_offset;  // global positions of query row 0 and key 0
  int slices;  // output-column slices of kSliceCols
  int group;   // the launch order: (batch, head) pairs a group
};

// The instantiation for output slices of up to DV columns. kTx threads
// share a row: each holds S for 4 rows and kKe = 64 / kTx keys, and O for
// the same 4 rows and kCpt = DV / kTx columns.
template <int DV>
struct Cfg {
  static constexpr int kTx = DV <= 64 ? 8 : 16;
  static constexpr int kKe = kKeys / kTx;
  static constexpr int kWarps = 8;                       // consumer warps
  static constexpr int kRows = kWarps * 4 * (32 / kTx);  // Q rows a CTA
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int kPanelQ = kRows * kRowBytes;
  static constexpr int kStage = kPanelQ + kPanelK;   // Q panel | K panel
  static constexpr int kVPanels = (DV + kCols - 1) / kCols;
  static constexpr int kVBytes = kVPanels * kPanelK;
  static constexpr int kCpt = DV / kTx;   // O columns a thread
  static constexpr int kVw = kCpt < 4 ? kCpt : 4;  // ... as vectors of kVw
  static constexpr int kNg = kCpt / kVw;           // ... kNg of them
  // P rows: a row group's kTx threads write kTx consecutive keys of 32 /
  // kTx consecutive rows at once; a pitch of 8 (16) banks past 64 keys
  // puts them on distinct banks.
  static constexpr int kPPitch = kKeys + (kTx == 8 ? 8 : 16);
  // Stages | V x 2 | P | barriers, 1024-aligned (the swizzle's period).
  static constexpr int kVOffset = kStages * kStage;
  static constexpr int kPOffset = kVOffset + 2 * kVBytes;
  static constexpr int kBarOffset = kPOffset + kRows * kPPitch * 4;
  static constexpr int kBars = 2 * kStages + 4;  // full, empty, V full, empty
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;
  static_assert(DV % kTx == 0 && DV <= kSliceCols, "an output slice");
  static_assert(kSmem <= kSmemLimit, "one CTA's shared memory");
};
static_assert(Cfg<64>::kSmem == 144464 && Cfg<128>::kSmem == 136272 &&
                  Cfg<256>::kSmem == 201808,
              "the widest instantiations of each layout fit");

// W floats of shared memory at p (W = 1, 2 or 4; 4W-byte aligned).
template <int W>
__device__ __forceinline__ void lds(const unsigned char* p, float* out) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
    out[0] = *reinterpret_cast<const float*>(p);
  }
}

template <int W>
__device__ __forceinline__ void stg(float* p, const float* x) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// Byte offset of float `col` of row `row` in a swizzled 32-column panel.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kRowBytes + ((((col >> 2) ^ (row & 7))) << 4) + (col & 3) * 4;
}

template <int DV, bool kPartial>
__global__ void __launch_bounds__(Cfg<DV>::kThreads, 1)
    fwd_f32_tiled_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const Params p) {
  using C = Cfg<DV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t bars = base + C::kBarOffset;
  const auto full = [&](int st) { return bars + 8 * st; };
  const auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  const auto v_full = [&](int vb) { return bars + 8 * (2 * kStages + vb); };
  const auto v_empty = [&](int vb) {
    return bars + 8 * (2 * kStages + 2 + vb);
  };

  // The launch order: slices innermost, then the group's heads side by
  // side, each group's Q tiles from the last (heaviest when causal) down.
  const int m_blocks = (p.s + C::kRows - 1) / C::kRows;
  const int slice = blockIdx.x % p.slices;
  const int idx = blockIdx.x / p.slices;
  const int bhs = p.b * p.h;
  const int per_group = p.group * m_blocks;
  const int g0 = idx / per_group, rem = idx % per_group;
  const int heads = min(p.group, bhs - g0 * p.group);
  const int bh = g0 * p.group + rem % heads, bi = bh / p.h, hi = bh % p.h;
  const int m0 = (m_blocks - 1 - rem / heads) * C::kRows;
  const int c_lo = slice * kSliceCols;
  const int cols = min(kSliceCols, p.d - c_lo);  // this slice's columns
  // Keys [0, n_end) reach some row of this tile: causal, the last row's
  // global position bounds them.
  const int n_end =
      p.causal ? max(0, min(p.s, p.q_offset + min(m0 + C::kRows, p.s) -
                                     p.k_offset))
               : p.s;
  const int n_tiles = (n_end + kKeys - 1) / kKeys;
  const int nc = (p.d + kCols - 1) / kCols;  // panels of the contraction

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), C::kWarps);
    }
    for (int vb = 0; vb < 2; ++vb) {
      mbar_init(v_full(vb), 1);
      mbar_init(v_empty(vb), C::kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {  // the producer: one thread issues every load
    if (lane == 0 && n_tiles > 0) {
      const int vpanels = min(C::kVPanels, (cols + kCols - 1) / kCols);
      for (int j = 0; j < n_tiles; ++j) {
        for (int c = 0; c < nc; ++c) {
          const int g = j * nc + c, st = g % kStages;
          // The stage's previous pair was released (round 0 passes).
          mbar_wait(empty(st), ((g / kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), C::kStage);
          const uint32_t dst = base + st * C::kStage;
          tma_load(dst, qmap, full(st), c * kCols, hi, m0, bi);
          tma_load(dst + C::kPanelQ, kmap, full(st), c * kCols, hi,
                   j * kKeys, bi);
        }
        const int vb = j & 1;
        mbar_wait(v_empty(vb), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(v_full(vb), vpanels * kPanelK);
        for (int pn = 0; pn < vpanels; ++pn) {
          tma_load(base + C::kVOffset + vb * C::kVBytes + pn * kPanelK, vmap,
                   v_full(vb), c_lo + pn * kCols, hi, j * kKeys, bi);
        }
      }
    }
    return;
  }

  // Consumer thread (ty, tx): S rows ty + r R / 4 (R = kRows) and keys
  // tx + kTx e of a tile; O the same rows and columns col(i, e) of the
  // slice. The kTx threads of a row are neighbouring lanes of one warp, and
  // a warp's rows are its own (P needs no CTA barrier).
  constexpr int kTx = C::kTx, kKe = C::kKe, kRowStep = C::kRows / 4;
  const int tx = lane % kTx, ty = (warp - 1) * (32 / kTx) + lane / kTx;
  const float scale2 = p.scale * kLog2e;
  float* const pbuf = reinterpret_cast<float*>(sm + C::kPOffset);
  float o[4][C::kCpt];
  float m_run[4], l_part[4];
  int end[4];  // row r keeps the keys before end[r] (local indices)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < C::kCpt; ++i) o[r][i] = 0.f;
    m_run[r] = kNegBig;
    l_part[r] = 0.f;
    end[r] = p.causal ? min(p.s, p.q_offset + m0 + ty + r * kRowStep -
                                     p.k_offset + 1)
                      : p.s;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kKeys;
    float s[4][kKe];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int e = 0; e < kKe; ++e) s[r][e] = 0.f;
    }
    for (int c = 0; c < nc; ++c) {
      const int g = j * nc + c, st = g % kStages;
      mbar_wait(full(st), (g / kStages) & 1);
      const unsigned char* qp = sm + st * C::kStage;
      const unsigned char* kp = qp + C::kPanelQ;
      const int steps = min(kCols, p.d - c * kCols) / 4;  // d % 8 == 0
#pragma unroll
      for (int k4 = 0; k4 < kCols / 4; ++k4) {
        if (k4 >= steps) break;  // the panel's zero columns past d
        float a[4][4], bk[kKe][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          lds<4>(qp + swz(ty + r * kRowStep, 4 * k4), a[r]);
        }
#pragma unroll
        for (int e = 0; e < kKe; ++e) {
          lds<4>(kp + swz(tx + kTx * e, 4 * k4), bk[e]);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int e = 0; e < kKe; ++e) {
              s[r][e] = fmaf(a[r][x], bk[e][x], s[r][e]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));  // one arrive a warp
    }

    // The online softmax in log2 units, masked on diagonal and ragged tiles.
    const bool need_mask =
        n0 + kKeys > p.s ||
        (p.causal && p.k_offset + n0 + kKeys - 1 > p.q_offset + m0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = kNegBig;
#pragma unroll
      for (int e = 0; e < kKe; ++e) {
        float x = s[r][e] * scale2;
        if (need_mask && n0 + tx + kTx * e >= end[r]) x = kNegBig;
        s[r][e] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTx; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[r], mx);
      const float corr = ex2(m_run[r] - m_new);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < kKe; ++e) {
        const float pr = ex2(s[r][e] - m_new);
        pbuf[(ty + r * kRowStep) * C::kPPitch + tx + kTx * e] = pr;
        sum += pr;
      }
      l_part[r] = l_part[r] * corr + sum;
#pragma unroll
      for (int i = 0; i < C::kCpt; ++i) o[r][i] *= corr;
    }
    __syncwarp();  // P of the warp's rows is in shared memory

    const int vb = j & 1;
    mbar_wait(v_full(vb), (j >> 1) & 1);
    const unsigned char* vt = sm + C::kVOffset + vb * C::kVBytes;
#pragma unroll 2
    for (int j4 = 0; j4 < kKeys / 4; ++j4) {
      float pr[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        lds<4>(reinterpret_cast<const unsigned char*>(
                   pbuf + (ty + r * kRowStep) * C::kPPitch + 4 * j4),
               pr[r]);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int key = 4 * j4 + jj;
        float vv[C::kNg][C::kVw];
#pragma unroll
        for (int i = 0; i < C::kNg; ++i) {
          const int col = (i * kTx + tx) * C::kVw;
          lds<C::kVw>(vt + (col / kCols) * kPanelK + swz(key, col % kCols),
                      vv[i]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int i = 0; i < C::kNg; ++i) {
#pragma unroll
            for (int e = 0; e < C::kVw; ++e) {
              o[r][i * C::kVw + e] =
                  fmaf(pr[r][jj], vv[i][e], o[r][i * C::kVw + e]);
            }
          }
        }
      }
    }
    __syncwarp();  // the warp's reads of P and V are done
    if (lane == 0) mbar_arrive(v_empty(vb));
  }

  // Epilogue: l summed over the row's kTx threads; rows past s and
  // columns past the slice's are not stored.
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float l = l_part[r];
#pragma unroll
    for (int off = 1; off < kTx; off <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
    }
    const int row = m0 + ty + r * kRowStep;
    if (row >= p.s) continue;
    float* orow = p.o + bi * p.st[3][0] + hi * p.st[3][2] +
                  static_cast<long long>(row) * p.st[3][1] + c_lo;
    const long long at = static_cast<long long>(bh) * p.s + row;
    if constexpr (kPartial) {
      // A row that saw a key has a real max: each row that sees any key
      // of the block sees key 0, which is in the first tile.
      const bool seen = m_run[r] != kNegBig;
#pragma unroll
      for (int i = 0; i < C::kNg; ++i) {
        const int col = (i * kTx + tx) * C::kVw;
        if (col >= cols) continue;
        float x[C::kVw];
#pragma unroll
        for (int e = 0; e < C::kVw; ++e) {
          x[e] = seen ? o[r][i * C::kVw + e] : 0.f;
        }
        stg<C::kVw>(orow + col, x);
      }
      if (slice == 0 && tx == 0) {  // every slice's are equal
        p.m[at] = seen ? m_run[r] * kLn2 : kNegBig;  // log2 -> natural
        p.l[at] = seen ? l : 0.f;
      }
    } else {
      l = fmaxf(l, 1e-30f);
#pragma unroll
      for (int i = 0; i < C::kNg; ++i) {
        const int col = (i * kTx + tx) * C::kVw;
        if (col >= cols) continue;
        float x[C::kVw];
#pragma unroll
        for (int e = 0; e < C::kVw; ++e) x[e] = o[r][i * C::kVw + e] / l;
        stg<C::kVw>(orow + col, x);
      }
      if (slice == 0 && tx == 0) p.lse[at] = m_run[r] * kLn2 + logf(l);
    }
  }
}

// One launch of the DV instantiation over p.slices output slices. Returns a
// cudaError_t, or kEncodeError + the CUresult of a failed encode.
template <int DV, bool kPartial>
int launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<DV>;
  CUtensorMap maps[3];
  const struct {
    const float* ptr;
    int which, box_rows;
  } tensors[3] = {{p.q, 0, C::kRows}, {p.k, 1, kKeys}, {p.v, 2, kKeys}};
  for (int i = 0; i < 3; ++i) {
    const long long* st = p.st[tensors[i].which];
    const int err = encode_f32(&maps[i], tensors[i].ptr, p.b, p.s, p.h, p.d,
                               st[0], st[1], st[2], tensors[i].box_rows);
    if (err != 0) return err;
  }
  const void* kernel =
      reinterpret_cast<const void*>(&fwd_f32_tiled_kernel<DV, kPartial>);
  static std::atomic<int> l2_bytes[kMaxDevices];
  int l2 = 0;
  const int err = prepare(kernel, C::kSmem, l2_bytes, &l2);
  if (err != 0) return err;
  Params grouped = p;  // K and V stream through every Q tile of a head
  grouped.group = heads_a_group(static_cast<long long>(p.b) * p.h,
                                2LL * p.s * p.d * 4, l2);
  const long long ctas = static_cast<long long>(p.b) * p.h *
                         ((p.s + C::kRows - 1) / C::kRows) * p.slices;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fwd_f32_tiled_kernel<DV, kPartial>
      <<<static_cast<unsigned>(ctas), C::kThreads, C::kSmem, stream>>>(
          maps[0], maps[1], maps[2], grouped);
  return cudaGetLastError();
}

}  // namespace f32fwd
}  // namespace
