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
// Bound on an H100 SXM at the training shape [8, 1024, 16, 128] bf16,
// causal (b*h = 128 heads of 524,800 query-key pairs; one causal product
// costs 2 * 128 * 524,800 * 128 = 17.2 GFLOP; each [b, s, h, d] tensor is
// 33.55 MB):
//  * dQ: 3 products (S, dP, dS K) = 51.6 GFLOP -> 52 us at 989 TFLOP/s,
//    against q, k, v, dO, O read and dQ written (6 x 33.55 MB) plus lse
//    read and delta written (1.05 MB): 202.4 MB -> 60 us at 3.35 TB/s.
//    With delta fused it is bound by bytes, at about 60 us.
//  * dK/dV: 4 products (S, dP, P^T dO, dS^T Q) = 68.8 GFLOP -> 70 us,
//    against q, k, v, dO, lse, delta read and dK, dV written: 202.4 MB ->
//    60 us. Bound by operations, at about 70 us.
// A train step makes 8 launches of each.
//
// What the design does about it:
//  * The TPU's sequential "arbitrary" grid axis and its VMEM scratch carry
//    become a loop inside the CTA. dQ: one CTA of 4 warps per (b*h, 64-row Q
//    tile), looping over 64-key K/V tiles up to the global diagonal (late Q
//    tiles, which see the most keys, start first). dK/dV: one CTA per (b*h,
//    64-key tile), looping over 32-row Q tiles from the diagonal on (early
//    key tiles start first). Two kernels and no atomics, so the result is
//    deterministic.
//  * All products run on the tensor cores through mma.sync m16n8k16 bf16
//    with f32 accumulation. Accumulator fragments of S and dP become the A
//    fragments of P and dS in registers, so no [s, s] tile touches device
//    or shared memory. dK/dV keeps keys as rows (S^T = K Q^T and
//    dP^T = V dO^T, as FlashAttention-2 does), so P^T and dS^T are A
//    fragments already and Q and dO enter P^T dO and dS^T Q as B fragments
//    through ldmatrix.trans; no tile is transposed in shared memory. Its two
//    f32 accumulators (dK, dV: 128 registers a thread at d=128) are why its
//    Q tile is 32 rows, not 64: S^T and dP^T then take 32 registers, not 64.
//  * Q, K, V and dO are read in the model's [b, s, h, d] layout through
//    their strides (q, k, v are column slices of the fused qkv product);
//    rows are padded by 8 elements in shared memory, so fragment loads and
//    ldmatrix are free of bank conflicts; the streamed tiles are double
//    buffered with cp.async, the next loading while this one is multiplied;
//    the softmax runs in base 2 with lse converted; only diagonal and ragged
//    tiles are masked. There is no TMA, warp specialisation or wgmma yet.
//  * f32 (not on the training path): a warp per query row (dQ) or key row
//    (dK/dV), FMA on the CUDA cores, keeping f32 products exact rather than
//    rounding through TF32.
//  * Ragged edges (s_q, s_k not multiples of the tiles; s_q != s_k is
//    allowed) are zero-filled on load and masked; those rows are not
//    written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegBig = -1e30f;
constexpr int kThreads = 128;
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
  int b, s_q, s_k, h;
  long long st[kTensors][3];
  float scale;
  int causal, q_offset, k_offset, compute_delta;
};

// The first element of head (bi, hi) of tensor `which`.
template <typename T>
__device__ __forceinline__ const T* head_of(const void* base, const Params& p,
                                            int which, int bi, int hi) {
  return static_cast<const T*>(base) + bi * p.st[which][0] +
         hi * p.st[which][2];
}

template <typename T>
__device__ __forceinline__ T* out_head_of(void* base, const Params& p,
                                          int which, int bi, int hi) {
  return static_cast<T*>(base) + bi * p.st[which][0] + hi * p.st[which][2];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// ---------------------------------------------------------------- bf16 path

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;   // Q rows of a dQ CTA, K rows of a dK/dV CTA
constexpr int kQTile = 32;  // Q rows per loop step of the dK/dV kernel

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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
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

// The same for one 4-byte word (lse and delta rows need no alignment).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [row0, row0 + ROWS) of one head into shared memory
// (rows padded to D + 8 elements), 16 bytes a thread, zero-filling rows at
// or past n.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool valid = row0 + r < n;
    const bf16* g =
        valid ? src + static_cast<long long>(row0 + r) * row_stride + cc * 8
              : src;
    cp_async16(dst + r * (D + 8) + cc * 8, g, valid);
  }
}

// The A fragment (m16k16, row-major) of rows r0 and r0 + 8, columns
// c0 .. c0 + 1 and c0 + 8 .. c0 + 9, of a padded shared-memory tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0) {
  a[0] = lds32(tile + r0 * LD + c0);
  a[1] = lds32(tile + (r0 + 8) * LD + c0);
  a[2] = lds32(tile + r0 * LD + c0 + 8);
  a[3] = lds32(tile + (r0 + 8) * LD + c0 + 8);
}

template <int D>
struct DqCfg {
  static constexpr int kLd = D + 8;
  // Q and dO, and two stages of K and V (the next tile loads during this).
  static constexpr int kSmem = 6 * kTile * kLd * 2;
};

template <int D>
__global__ void __launch_bounds__(kThreads) dq_bf16_kernel(Params p) {
  constexpr int kLd = DqCfg<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile * kLd;
  bf16* kv = dos + kTile * kLd;  // stage i: K at 2i, V at 2i + 1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  // Late Q tiles see the most keys: start them first.
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const bf16* q = head_of<bf16>(p.q, p, kQ, bi, hi);
  const bf16* k = head_of<bf16>(p.k, p, kK, bi, hi);
  const bf16* v = head_of<bf16>(p.v, p, kV, bi, hi);
  const bf16* dout = head_of<bf16>(p.dout, p, kDO, bi, hi);
  const long long stat0 = static_cast<long long>(bh) * p.s_q;

  // Keys this tile reaches: under the causal mask, those at global
  // positions up to the global position of its last query row.
  int n_end = p.s_k;
  if (p.causal) {
    const int last = p.q_offset + min(m0 + kTile, p.s_q) - 1;
    n_end = max(0, min(p.s_k, last - p.k_offset + 1));
  }
  const int n_tiles = (n_end + kTile - 1) / kTile;

  load_rows<D, kTile>(qs, q, p.st[kQ][1], m0, p.s_q);
  load_rows<D, kTile>(dos, dout, p.st[kDO][1], m0, p.s_q);
  if (n_tiles > 0) {
    load_rows<D, kTile>(kv, k, p.st[kK][1], 0, p.s_k);
    load_rows<D, kTile>(kv + kTile * kLd, v, p.st[kV][1], 0, p.s_k);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Each thread owns two rows of its warp's 16: r0 and r0 + 8.
  const int r0 = warp * 16 + g;
  const int row[2] = {m0 + r0, m0 + r0 + 8};
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] < p.s_q) lse2[i] = p.lse[stat0 + row[i]] * kLog2e;
  }
  if (p.compute_delta) {
    // delta = rowsum(f32(dO) * f32(O)) for the warp's 16 rows, a row at a
    // time: each lane takes D / 32 columns, then the warp sums.
    constexpr int kPer = D / 32;
    const bf16* o = head_of<bf16>(p.o, p, kO, bi, hi);
    for (int r = 0; r < 16; ++r) {
      const int rl = warp * 16 + r, gr = m0 + rl;
      float sum = 0.f;
      if (gr < p.s_q) {
        const bf16* orow = o + static_cast<long long>(gr) * p.st[kO][1];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int c = lane * kPer + i;
          sum += __bfloat162float(dos[rl * kLd + c]) *
                 __bfloat162float(orow[c]);
        }
      }
      sum = warp_sum(sum);
      if (r == g) dlt[0] = sum;
      if (r == g + 8) dlt[1] = sum;
      if (lane == 0 && gr < p.s_q) p.delta[stat0 + gr] = sum;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] < p.s_q) dlt[i] = p.delta[stat0 + row[i]];
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  const float scale2 = p.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kTile;
    if (j + 1 < n_tiles) {  // prefetch the next tile into the other stage
      bf16* next = kv + ((j + 1) & 1) * 2 * kTile * kLd;
      load_rows<D, kTile>(next, k, p.st[kK][1], n0 + kTile, p.s_k);
      load_rows<D, kTile>(next + kTile * kLd, v, p.st[kV][1], n0 + kTile,
                          p.s_k);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const bf16* ks = kv + (j & 1) * 2 * kTile * kLd;
    const bf16* vs = ks + kTile * kLd;

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys: 8 n-tiles of m16n8.
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + t * 2;
      uint32_t aq[4], ado[4];
      load_a<kLd>(aq, qs, r0, c0);
      load_a<kLd>(ado, dos, r0, c0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kp = ks + (nt * 8 + g) * kLd + c0;
        mma_bf16(sc[nt], aq, lds32(kp), lds32(kp + 8));
        const bf16* vp = vs + (nt * 8 + g) * kLd + c0;
        mma_bf16(dp[nt], ado, lds32(vp), lds32(vp + 8));
      }
    }

    // P = exp2(S' - lse') = exp(S * scale - lse) from f32 scores, masked
    // with -1e30 on diagonal and ragged tiles only; dS = P (dP - delta),
    // rounded to bf16. The m16n8 accumulator layout of n-tiles 2j and
    // 2j + 1 is exactly the m16k16 A-fragment layout of k-step j.
    const bool need_mask =
        n0 + kTile > p.s_k ||
        (p.causal && p.k_offset + n0 + kTile - 1 > p.q_offset + m0);
    uint32_t dsf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale2;
        if (need_mask) {
          const int col = n0 + nt * 8 + t * 2 + (e & 1);
          if (col >= p.s_k ||
              (p.causal && p.k_offset + col > p.q_offset + row[e >> 1])) {
            x = kNegBig;
          }
        }
        const float pr = exp2f(x - lse2[e >> 1]);
        ds[e] = pr * (dp[nt][e] - dlt[e >> 1]);
      }
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K. ldmatrix.trans turns row-major K [key][d] into the
    // k-major B fragments for two n-tiles (16 columns of d) at once.
#pragma unroll
    for (int kstep = 0; kstep < 4; ++kstep) {
      const int key = kstep * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, ks + key * kLd + dt * 8 + (lane >> 4) * 8);
        mma_bf16(acc[dt], dsf[kstep], bk[0], bk[1]);
        mma_bf16(acc[dt + 1], dsf[kstep], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }

  bf16* dq = out_head_of<bf16>(p.dq, p, kDQ, bi, hi);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.s_q) continue;
    bf16* out = dq + static_cast<long long>(row[i]) * p.st[kDQ][1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + t * 2) = pack_bf16(
          acc[dt][i * 2] * p.scale, acc[dt][i * 2 + 1] * p.scale);
    }
  }
}

template <int D>
struct DkvCfg {
  static constexpr int kLd = D + 8;
  // K and V, two stages of Q and dO, and two stages of the Q rows' lse and
  // delta (f32).
  static constexpr int kSmem =
      (2 * kTile + 4 * kQTile) * kLd * 2 + 2 * 2 * kQTile * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_bf16_kernel(Params p) {
  constexpr int kLd = DkvCfg<D>::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile * kLd;
  bf16* qd = vs + kTile * kLd;  // stage i: Q at 2i, dO at 2i + 1
  float* stats = reinterpret_cast<float*>(qd + 4 * kQTile * kLd);
  // stage i: lse at 2i, delta at 2i + 1 (kQTile floats each)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  // Early key tiles see the most queries: they come first in the grid.
  const int n0 = blockIdx.x * kTile;
  const bf16* q = head_of<bf16>(p.q, p, kQ, bi, hi);
  const bf16* k = head_of<bf16>(p.k, p, kK, bi, hi);
  const bf16* v = head_of<bf16>(p.v, p, kV, bi, hi);
  const bf16* dout = head_of<bf16>(p.dout, p, kDO, bi, hi);
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  // Queries that reach this tile: under the causal mask, those at global
  // positions from the global position of its first key on.
  int m_begin = 0;
  if (p.causal) {
    m_begin = max(0, p.k_offset + n0 - p.q_offset) / kQTile * kQTile;
  }
  const int n_qtiles =
      m_begin < p.s_q ? (p.s_q - m_begin + kQTile - 1) / kQTile : 0;

  // Rows [m0, m0 + kQTile) of Q, dO, lse and delta into stage `stage`.
  auto load_q_tile = [&](int stage, int m0) {
    bf16* dst = qd + stage * 2 * kQTile * kLd;
    load_rows<D, kQTile>(dst, q, p.st[kQ][1], m0, p.s_q);
    load_rows<D, kQTile>(dst + kQTile * kLd, dout, p.st[kDO][1], m0, p.s_q);
    const int i = threadIdx.x;
    if (i < 2 * kQTile) {
      const int r = i % kQTile;
      const float* src = i < kQTile ? lse : delta;
      const bool valid = m0 + r < p.s_q;
      cp_async4(stats + stage * 2 * kQTile + i, valid ? src + m0 + r : src,
                valid);
    }
  };

  if (n_qtiles > 0) {
    load_rows<D, kTile>(ks, k, p.st[kK][1], n0, p.s_k);
    load_rows<D, kTile>(vs, v, p.st[kV][1], n0, p.s_k);
    load_q_tile(0, m_begin);
  }
  cp_async_commit();

  // This thread's key rows in the tile: kr0 and kr0 + 8, at these global
  // positions.
  const int kr0 = warp * 16 + g;
  const int key_pos[2] = {p.k_offset + n0 + kr0, p.k_offset + n0 + kr0 + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }
  const float scale2 = p.scale * kLog2e;

  for (int j = 0; j < n_qtiles; ++j) {
    const int m0 = m_begin + j * kQTile;
    if (j + 1 < n_qtiles) load_q_tile((j + 1) & 1, m0 + kQTile);
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and K, V) have landed
    __syncthreads();
    const bf16* qs = qd + (j & 1) * 2 * kQTile * kLd;
    const bf16* dos = qs + kQTile * kLd;
    const float* lse_s = stats + (j & 1) * 2 * kQTile;
    const float* dlt_s = lse_s + kQTile;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kQTile queries.
    float st[kQTile / 8][4], dpt[kQTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kQTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kk * 16 + t * 2;
      uint32_t ak[4], av[4];
      load_a<kLd>(ak, ks, kr0, c0);
      load_a<kLd>(av, vs, kr0, c0);
#pragma unroll
      for (int nt = 0; nt < kQTile / 8; ++nt) {
        const bf16* qp = qs + (nt * 8 + g) * kLd + c0;
        mma_bf16(st[nt], ak, lds32(qp), lds32(qp + 8));
        const bf16* dp = dos + (nt * 8 + g) * kLd + c0;
        mma_bf16(dpt[nt], av, lds32(dp), lds32(dp + 8));
      }
    }

    // P^T from f32 scores and each query's lse, masked with -1e30 on
    // diagonal and ragged tiles; dS^T = P^T (dP^T - delta). Both rounded to
    // bf16 as A fragments (keys are rows, queries the contraction).
    const bool need_mask =
        m0 + kQTile > p.s_q ||
        (p.causal && p.q_offset + m0 < p.k_offset + n0 + kTile - 1);
    uint32_t pf[kQTile / 16][4], dsf[kQTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kQTile / 8; ++nt) {
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);  // query in the tile
        float x = st[nt][e] * scale2;
        if (need_mask &&
            (m0 + col >= p.s_q ||
             (p.causal && p.q_offset + m0 + col < key_pos[e >> 1]))) {
          x = kNegBig;
        }
        pr[e] = exp2f(x - lse_s[col] * kLog2e);
        ds[e] = pr[e] * (dpt[nt][e] - dlt_s[col]);
      }
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(pr[0], pr[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(pr[2], pr[3]);
      dsf[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q: ldmatrix.trans reads the row-major
    // [query][d] tiles as k-major B fragments, two n-tiles at once.
#pragma unroll
    for (int kstep = 0; kstep < kQTile / 16; ++kstep) {
      const int qr = kstep * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t bd[4], bq[4];
        ldmatrix_x4_trans(bd, dos + qr * kLd + dt * 8 + (lane >> 4) * 8);
        mma_bf16(dv[dt], pf[kstep], bd[0], bd[1]);
        mma_bf16(dv[dt + 1], pf[kstep], bd[2], bd[3]);
        ldmatrix_x4_trans(bq, qs + qr * kLd + dt * 8 + (lane >> 4) * 8);
        mma_bf16(dk[dt], dsf[kstep], bq[0], bq[1]);
        mma_bf16(dk[dt + 1], dsf[kstep], bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }

  bf16* dk_out = out_head_of<bf16>(p.dk, p, kDK, bi, hi);
  bf16* dv_out = out_head_of<bf16>(p.dv, p, kDV, bi, hi);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = n0 + kr0 + i * 8;
    if (kr >= p.s_k) continue;
    bf16* dkr = dk_out + static_cast<long long>(kr) * p.st[kDK][1];
    bf16* dvr = dv_out + static_cast<long long>(kr) * p.st[kDV][1];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dkr + dt * 8 + t * 2) = pack_bf16(
          dk[dt][i * 2] * p.scale, dk[dt][i * 2 + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + dt * 8 + t * 2) =
          pack_bf16(dv[dt][i * 2], dv[dt][i * 2 + 1]);
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kRowsPerCta = kThreads / 32;

// A warp per query row; lane j scores key n0 + j, then the warp
// accumulates dQ over the 32 keys, D / 32 columns a lane.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(Params p) {
  constexpr int kPer = D / 32;
  __shared__ float qs[kRowsPerCta][D];
  __shared__ float dos[kRowsPerCta][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  const int row = blockIdx.x * kRowsPerCta + warp;
  if (row >= p.s_q) return;

  const float* q = head_of<float>(p.q, p, kQ, bi, hi) +
                   static_cast<long long>(row) * p.st[kQ][1];
  const float* dout = head_of<float>(p.dout, p, kDO, bi, hi) +
                      static_cast<long long>(row) * p.st[kDO][1];
  const float* k = head_of<float>(p.k, p, kK, bi, hi);
  const float* v = head_of<float>(p.v, p, kV, bi, hi);
  for (int i = lane; i < D; i += 32) {
    qs[warp][i] = q[i];
    dos[warp][i] = dout[i];
  }
  __syncwarp();

  const long long srow = static_cast<long long>(bh) * p.s_q + row;
  float delta;
  if (p.compute_delta) {
    const float* o = head_of<float>(p.o, p, kO, bi, hi) +
                     static_cast<long long>(row) * p.st[kO][1];
    float part = 0.f;
    for (int i = lane; i < D; i += 32) part += dos[warp][i] * o[i];
    delta = warp_sum(part);
    if (lane == 0) p.delta[srow] = delta;
  } else {
    delta = p.delta[srow];
  }
  const float lse = p.lse[srow];

  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  const int n_end = p.causal
                        ? max(0, min(p.s_k, p.q_offset + row - p.k_offset + 1))
                        : p.s_k;
  for (int n0 = 0; n0 < n_end; n0 += 32) {
    const int key = n0 + lane;
    float ds = 0.f;
    if (key < n_end) {
      const float* kr = k + static_cast<long long>(key) * p.st[kK][1];
      const float* vr = v + static_cast<long long>(key) * p.st[kV][1];
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int i = 0; i < D; ++i) {
        s = fmaf(qs[warp][i], kr[i], s);
        dp = fmaf(dos[warp][i], vr[i], dp);
      }
      ds = expf(s * p.scale - lse) * (dp - delta);
    }
    const int count = min(32, n_end - n0);
    for (int j = 0; j < count; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
      const float* kr = k + static_cast<long long>(n0 + j) * p.st[kK][1];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        acc[i] = fmaf(dsj, kr[lane + 32 * i], acc[i]);
      }
    }
  }
  float* dq = out_head_of<float>(p.dq, p, kDQ, bi, hi) +
              static_cast<long long>(row) * p.st[kDQ][1];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dq[lane + 32 * i] = acc[i] * p.scale;
}

// A warp per key row; lane j takes query m0 + j, then the warp
// accumulates dK and dV over the 32 queries.
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_f32_kernel(Params p) {
  constexpr int kPer = D / 32;
  __shared__ float ks[kRowsPerCta][D];
  __shared__ float vs[kRowsPerCta][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, bi = bh / p.h, hi = bh % p.h;
  const int key = blockIdx.x * kRowsPerCta + warp;
  if (key >= p.s_k) return;

  const float* kr = head_of<float>(p.k, p, kK, bi, hi) +
                    static_cast<long long>(key) * p.st[kK][1];
  const float* vr = head_of<float>(p.v, p, kV, bi, hi) +
                    static_cast<long long>(key) * p.st[kV][1];
  for (int i = lane; i < D; i += 32) {
    ks[warp][i] = kr[i];
    vs[warp][i] = vr[i];
  }
  __syncwarp();
  const float* q = head_of<float>(p.q, p, kQ, bi, hi);
  const float* dout = head_of<float>(p.dout, p, kDO, bi, hi);
  const float* lse = p.lse + static_cast<long long>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<long long>(bh) * p.s_q;

  float dk[kPer], dv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk[i] = dv[i] = 0.f;
  // Under the causal mask, the queries at or after this key's position.
  const int m_begin = p.causal ? max(0, p.k_offset + key - p.q_offset) : 0;
  for (int m0 = m_begin; m0 < p.s_q; m0 += 32) {
    const int qi = m0 + lane;
    float pr = 0.f, ds = 0.f;
    if (qi < p.s_q) {
      const float* qrow = q + static_cast<long long>(qi) * p.st[kQ][1];
      const float* drow = dout + static_cast<long long>(qi) * p.st[kDO][1];
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int i = 0; i < D; ++i) {
        s = fmaf(qrow[i], ks[warp][i], s);
        dp = fmaf(drow[i], vs[warp][i], dp);
      }
      pr = expf(s * p.scale - lse[qi]);
      ds = pr * (dp - delta[qi]);
    }
    const int count = min(32, p.s_q - m0);
    for (int j = 0; j < count; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pr, j);
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
      const float* qrow = q + static_cast<long long>(m0 + j) * p.st[kQ][1];
      const float* drow = dout + static_cast<long long>(m0 + j) * p.st[kDO][1];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        dv[i] = fmaf(pj, drow[lane + 32 * i], dv[i]);
        dk[i] = fmaf(dsj, qrow[lane + 32 * i], dk[i]);
      }
    }
  }
  float* dk_out = out_head_of<float>(p.dk, p, kDK, bi, hi) +
                  static_cast<long long>(key) * p.st[kDK][1];
  float* dv_out = out_head_of<float>(p.dv, p, kDV, bi, hi) +
                  static_cast<long long>(key) * p.st[kDV][1];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    dk_out[lane + 32 * i] = dk[i] * p.scale;
    dv_out[lane + 32 * i] = dv[i];
  }
}

// ------------------------------------------------------------------ launch

constexpr int kMaxDevices = 64;

// Raise a kernel's dynamic shared-memory limit once per device (the
// attribute belongs to the device's context), not on every launch.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes,
                       std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

template <int D>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((p.s_q + kRowsPerCta - 1) / kRowsPerCta, p.b * p.h);
    dq_f32_kernel<D><<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err = allow_smem(dq_bf16_kernel<D>, DqCfg<D>::kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_q + kTile - 1) / kTile, p.b * p.h);
  dq_bf16_kernel<D><<<grid, kThreads, DqCfg<D>::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((p.s_k + kRowsPerCta - 1) / kRowsPerCta, p.b * p.h);
    dkv_f32_kernel<D><<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err =
      allow_smem(dkv_bf16_kernel<D>, DkvCfg<D>::kSmem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_k + kTile - 1) / kTile, p.b * p.h);
  dkv_bf16_kernel<D><<<grid, kThreads, DkvCfg<D>::kSmem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   void* dk, void* dv, int b, int s_q, int s_k, int h,
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
// returns a cudaError_t (0 on success); the launch itself is asynchronous
// on `stream`.

// dQ, and delta = rowsum(dO * O) into `delta` first when compute_delta.
extern "C" int kftpu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, int b,
    int s_q, int s_k, int h, int d, int dtype, const long long* strides,
    float scale, int causal, int q_offset, int k_offset, int compute_delta,
    void* stream) {
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, nullptr,
                               nullptr, b, s_q, s_k, h, strides, scale, causal,
                               q_offset, k_offset, compute_delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || s_q < 1 || s_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 128) return launch_dq<128>(p, dtype, st);
  if (d == 64) return launch_dq<64>(p, dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dK and dV from the delta the dQ launch wrote (or the caller gave).
extern "C" int kftpu_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int b, int s_q,
    int s_k, int h, int d, int dtype, const long long* strides, float scale,
    int causal, int q_offset, int k_offset, void* stream) {
  const Params p = make_params(
      q, k, v, nullptr, dout, lse, const_cast<float*>(delta), nullptr, dk, dv,
      b, s_q, s_k, h, strides, scale, causal, q_offset, k_offset, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || s_q < 1 || s_k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 128) return launch_dkv<128>(p, dtype, st);
  if (d == 64) return launch_dkv<64>(p, dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kftpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
