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
//    moved once (40 us): bound by bytes at about 40 us; 8 launches a decode
//    step.
//  * partial at the long-context hop [1, 8192, 16, 128] bf16 at offsets
//    (0, 0): 4 * 16 * 33,558,528 * 128 = 274.9 GFLOP (0.278 ms) against
//    q, k, v read and the f32 acc, m and l written, 168.8 MB (0.050 ms): bound
//    by operations at about 0.28 ms; one launch per layer and step on one
//    card.
//
// What the design does about it:
//  * Q, K and V are read in the model's [b, s, h, d] layout through their
//    strides (the q, k, v column slices of the fused qkv product), so no
//    transpose or copy runs before the kernel, and the output is written in
//    the same layout; only q, k, v and the outputs touch device memory.
//  * bf16: one CTA of 4 warps per (b*h, 64-row Q tile); the K/V loop runs
//    inside the CTA (replacing the TPU's sequential "arbitrary" grid axis and
//    its VMEM scratch carry) and stops at the global diagonal, so the causal
//    half of the products is never computed and a hop wholly above the
//    diagonal launches CTAs that skip every tile. Both products run on the
//    tensor cores through mma.sync m16n8k16 with f32 accumulation; the S
//    accumulator fragments become P's A fragments in registers, so S and P
//    never leave the SM. Tiles are 64x64 (the v5e's 1024x1024 VMEM blocks do
//    not fit 227 KB of shared memory), rows padded by 8 elements so fragment
//    loads and ldmatrix are free of bank conflicts. Heavy causal tiles start
//    first. K/V tiles are double-buffered with cp.async (the next tile loads
//    while this one is multiplied); softmax runs in base 2 (one exp2 per
//    score) and masks only the diagonal and ragged tiles. There is no TMA,
//    warp specialisation or wgmma yet, so the operations-bound partial runs
//    well below the tensor cores' peak.
//  * f32 (not on the main paths): a warp per query row, FMA on the CUDA
//    cores, keeping f32 products exact rather than rounding through TF32.
//  * Ragged edges (s not a multiple of the tile, e.g. the 32-token prefill
//    chunk) are zero-filled on load and masked; those rows are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // the forward: q's dtype; the partial: f32 acc
  float* lse;   // the forward: [b*h, s]
  float* m;     // the partial: [b*h, s], natural units
  float* l;     // the partial: [b*h, s]
  int b, s, h;
  long long q_sb, q_ss, q_sh;  // strides in elements; the d stride is 1
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  // Global positions of query row 0 and key 0 for the causal mask (a ring
  // hop's blocks); 0 and 0 for the forward.
  int q_offset, k_offset;
};

// ---------------------------------------------------------------- bf16 path

constexpr int kTile = 64;  // Q rows per CTA and K/V rows per loop step

template <int D>
struct Bf16Cfg {
  static constexpr int kLd = D + 8;  // padded shared-memory row, elements
  // Q, and two stages of K and V (the next tile loads during this one).
  static constexpr int kSmem = 5 * kTile * kLd * 2;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte asynchronous copy global -> shared; a source size of 0 writes
// zeros (the ragged edge) without reading.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + kTile) of one head into shared memory,
// 16 bytes a thread, zero-filling rows at or past s.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int s) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool valid = row0 + r < s;
    const __nv_bfloat16* g =
        valid ? src + static_cast<long long>(row0 + r) * row_stride + cc * 8
              : src;
    cp_async16(dst + r * Bf16Cfg<D>::kLd + cc * 8, g, valid);
  }
}

// The body of both bf16 kernels: kPartial selects the ring hop's epilogue.
template <int D, bool kPartial>
__device__ __forceinline__ void bf16_attention(const Params& p) {
  constexpr int kLd = Bf16Cfg<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv = qs + kTile * kLd;  // stage i: K at 2i, V at 2i + 1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heavy tiles first

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) +
                           bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           bi * p.k_sb + hi * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           bi * p.v_sb + hi * p.v_sh;

  const int qo = p.q_offset, ko = p.k_offset;
  // Keys [0, n_end) reach some row of this tile: causal, the last row's
  // global position bounds them.
  const int n_end =
      p.causal ? max(0, min(p.s, qo + min(m0 + kTile, p.s) - ko)) : p.s;
  const int n_tiles = (n_end + kTile - 1) / kTile;
  load_tile<D>(qs, q, p.q_ss, m0, p.s);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D>(kv, k, p.k_ss, 0, p.s);
    load_tile<D>(kv + kTile * kLd, v, p.v_ss, 0, p.s);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first K/V tile may still fly
  __syncthreads();

  // This warp's 16 Q rows as A fragments, held for the whole K/V loop.
  const int r0 = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c0 = kk * 16 + t * 2;
    qf[kk][0] = lds32(qs + r0 * kLd + c0);
    qf[kk][1] = lds32(qs + (r0 + 8) * kLd + c0);
    qf[kk][2] = lds32(qs + r0 * kLd + c0 + 8);
    qf[kk][3] = lds32(qs + (r0 + 8) * kLd + c0 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  // Each thread owns two rows of the warp's 16: r0 and r0 + 8. The
  // running max is kept in log2 units (scores scaled by scale * log2 e),
  // so every exponential is one exp2.
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.f, 0.f};
  const int row[2] = {m0 + r0, m0 + r0 + 8};
  const float scale2 = p.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kTile;
    if (j + 1 < n_tiles) {  // prefetch the next tile into the other stage
      __nv_bfloat16* next = kv + ((j + 1) & 1) * 2 * kTile * kLd;
      load_tile<D>(next, k, p.k_ss, n0 + kTile, p.s);
      load_tile<D>(next + kTile * kLd, v, p.v_ss, n0 + kTile, p.s);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const __nv_bfloat16* ks = kv + (j & 1) * 2 * kTile * kLd;
    const __nv_bfloat16* vs = ks + kTile * kLd;

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of m16n8.
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kp = ks + (nt * 8 + g) * kLd + kk * 16 + t * 2;
        mma_bf16(sc[nt], qf[kk], lds32(kp), lds32(kp + 8));
      }
    }

    // Scale in f32, mask with -1e30 (only the diagonal and ragged tiles
    // hold masked entries), running row max.
    const bool need_mask =
        n0 + kTile > p.s || (p.causal && ko + n0 + kTile - 1 > qo + m0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale2;
        if (need_mask) {
          const int col = n0 + nt * 8 + t * 2 + (e & 1);
          if (col >= p.s || (p.causal && ko + col > qo + row[e >> 1])) {
            x = kNegBig;
          }
        }
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 threads of a row group
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }

    // P = exp2(S' - m_new) = exp(S - m): row sums from f32 P, PV from P
    // rounded to bf16.
    // The m16n8 accumulator layout of S n-tiles 2j and 2j+1 is exactly the
    // m16k16 A-fragment layout of P's k-step j.
    float rs[2] = {0.f, 0.f};
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2f(sc[nt][0] - mx[0]);
      const float p1 = exp2f(sc[nt][1] - mx[0]);
      const float p2 = exp2f(sc[nt][2] - mx[1]);
      const float p3 = exp2f(sc[nt][3] - mx[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      corr[i] = exp2f(m_run[i] - mx[i]);
      l_run[i] = l_run[i] * corr[i] + rs[i];
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    // acc += P V. ldmatrix.trans turns row-major V [key][d] into the
    // k-major B fragments for two n-tiles (16 columns of d) at once.
#pragma unroll
    for (int kstep = 0; kstep < 4; ++kstep) {
      const int key = kstep * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + key * kLd + dt * 8 + (lane >> 4) * 8);
        mma_bf16(acc[dt], pf[kstep], bv[0], bv[1]);
        mma_bf16(acc[dt + 1], pf[kstep], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }

  if constexpr (kPartial) {
    float* o = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= p.s) continue;
      // A row that saw a key has a real max: each row that sees any key of
      // the block sees key 0, which is in the first tile.
      const bool seen = m_run[i] != kNegBig;
      float* orow = o + static_cast<long long>(row[i]) * p.o_ss;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<float2*>(orow + dt * 8 + t * 2) =
            seen ? make_float2(acc[dt][i * 2], acc[dt][i * 2 + 1])
                 : make_float2(0.f, 0.f);
      }
      if (t == 0) {
        const long long at = static_cast<long long>(bh) * p.s + row[i];
        p.m[at] = seen ? m_run[i] * kLn2 : kNegBig;  // log2 -> natural units
        p.l[at] = seen ? l_run[i] : 0.f;
      }
    }
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb +
                       hi * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= p.s) continue;
      const float l = fmaxf(l_run[i], 1e-30f);
      __nv_bfloat16* orow = o + static_cast<long long>(row[i]) * p.o_ss;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + t * 2) =
            pack_bf16(acc[dt][i * 2] / l, acc[dt][i * 2 + 1] / l);
      }
      if (t == 0) {
        p.lse[static_cast<long long>(bh) * p.s + row[i]] =
            m_run[i] * kLn2 + logf(l);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_bf16_kernel(Params p) {
  bf16_attention<D, false>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads) partial_bf16_kernel(Params p) {
  bf16_attention<D, true>(p);
}

// ----------------------------------------------------------------- f32 path

constexpr int kRowsPerCta = kThreads / 32;

// The body of both f32 kernels: kPartial selects the ring hop's epilogue.
template <int D, bool kPartial>
__device__ __forceinline__ void f32_attention(const Params& p) {
  constexpr int kPer = D / 32;  // output columns per lane
  __shared__ float qs[kRowsPerCta][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  const int row = blockIdx.x * kRowsPerCta + warp;
  if (row >= p.s) return;

  const float* q = static_cast<const float*>(p.q) + bi * p.q_sb +
                   hi * p.q_sh + static_cast<long long>(row) * p.q_ss;
  const float* k = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  for (int i = lane; i < D; i += 32) qs[warp][i] = q[i];
  __syncwarp();

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  float m_run = kNegBig, l_run = 0.f;
  const int qpos = p.q_offset + row;  // this row's global position
  const int n_end =
      p.causal ? max(0, min(p.s, qpos - p.k_offset + 1)) : p.s;

  for (int n0 = 0; n0 < n_end; n0 += 32) {
    // Lane j scores key n0 + j.
    const int key = n0 + lane;
    float x = kNegBig;
    if (key < p.s && !(p.causal && p.k_offset + key > qpos)) {
      const float* kr = k + static_cast<long long>(key) * p.k_ss;
      float dot = 0.f;
#pragma unroll 8
      for (int i = 0; i < D; ++i) dot = fmaf(qs[warp][i], kr[i], dot);
      x = dot * p.scale;
    }
    float mx = x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_new = fmaxf(m_run, mx);
    const float pj = expf(x - m_new);
    float ps = pj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    }
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + ps;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
    const int count = min(32, p.s - n0);
    for (int j = 0; j < count; ++j) {
      const float pb = __shfl_sync(0xffffffffu, pj, j);
      const float* vr = v + static_cast<long long>(n0 + j) * p.v_ss;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(pb, vr[lane + 32 * i], acc[i]);
    }
  }

  float* o = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh +
             static_cast<long long>(row) * p.o_ss;
  const long long at = static_cast<long long>(bh) * p.s + row;
  if constexpr (kPartial) {
    const bool seen = n_end > 0;  // key 0 reaches this row
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[lane + 32 * i] = seen ? acc[i] : 0.f;
    if (lane == 0) {
      p.m[at] = seen ? m_run : kNegBig;
      p.l[at] = seen ? l_run : 0.f;
    }
  } else {
    const float l = fmaxf(l_run, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[lane + 32 * i] = acc[i] / l;
    if (lane == 0) p.lse[at] = m_run + logf(l);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) fwd_f32_kernel(Params p) {
  f32_attention<D, false>(p);
}

template <int D>
__global__ void __launch_bounds__(kThreads) partial_f32_kernel(Params p) {
  f32_attention<D, true>(p);
}

constexpr int kMaxDevices = 64;

template <int D, bool kPartial>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr int kSmem = Bf16Cfg<D>::kSmem;
  void (*kernel)(Params) =
      kPartial ? &partial_bf16_kernel<D> : &fwd_bf16_kernel<D>;
  // Raise the kernel's dynamic shared-memory limit once per device (the
  // attribute belongs to the device's context), not on every launch.
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) done[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((p.s + kTile - 1) / kTile, p.b * p.h);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kPartial>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) =
      kPartial ? &partial_f32_kernel<D> : &fwd_f32_kernel<D>;
  const dim3 grid((p.s + kRowsPerCta - 1) / kRowsPerCta, p.b * p.h);
  kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool kPartial>
int launch(const Params& p, int d, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128) return launch_bf16<128, kPartial>(p, st);
  if (dtype == 1 && d == 64) return launch_bf16<64, kPartial>(p, st);
  if (dtype == 0 && d == 128) return launch_f32<128, kPartial>(p, st);
  if (dtype == 0 && d == 64) return launch_f32<64, kPartial>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
// cudaError_t (0 on success); the launch itself is asynchronous on `stream`.
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

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
