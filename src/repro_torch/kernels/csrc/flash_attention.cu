// Forward flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:88, body _flash_kernel :35):
//
//   out = softmax(q k^T * hd^-0.5, masked) v
//
// with a running (m, l, acc) online softmax in fp32 over key tiles, masked
// scores set to NEG_INF = -1e30 (causal: key <= query; window W: key >
// query - W; and the ragged tail key >= S), key tiles above the diagonal or
// outside the window skipped, and out = acc / max(l, 1e-30) in the input
// dtype. Positions are implicit (row = absolute position), as in prefill.
//
// Layout: q (B, S, H, hd), k and v (B, S, Hkv, hd), contiguous, H % Hkv == 0;
// query head h reads KV head h / (H / Hkv), so GQA needs no expanded copy.
// Any S (the kernel masks the ragged tail itself) and any hd that is a
// multiple of 16 up to 256 (zero-padded in shared memory to 64, 128 or 256).
//
// What bounds it on the card: operations. At the serving path's prefill
// shape (B 4, S 2,048, H 16, Hkv 8, hd 128, causal, bf16) the unmasked
// pairs need 4*B*H*hd*pairs = 6.9e10 flops, 0.069 ms at 989 TFLOP/s, while
// q, k, v and out are 1.0e8 bytes, 0.030 ms at 3.35 TB/s. The bf16 kernel
// therefore runs both products on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulate; P rounded to bf16 before P V, as the reference's
// block scan does) and keeps scores and probabilities (and, up to hd 128,
// the Q fragments) in registers: one CTA
// of 4 warps per (b*h, 64-row q tile), each warp 16 query rows; 64-key K/V
// tiles streamed through shared memory with cp.async (the next K tile loads
// during P V, the V tile during Q K^T), so nothing limits the length.
//
// What the simple design gives up: mma.sync reaches a fraction of Hopper's
// bf16 rate (wgmma with TMA and warp specialisation would be needed for
// the rest); one K and one V buffer instead of a deeper pipeline; exp2f
// rather than a polynomial; no persistent scheduling, only heavy (late,
// causal) q tiles launched first. The fp32 kernel is a plain SIMT kernel
// (one warp per query row, 8 rows per CTA, 32-key tiles in shared memory)
// for inputs the tensor cores cannot take at full precision; it is off the
// serving path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, H, Hkv, hd;
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // hd^-0.5 * log2(e): scores in log2 units for exp2f
};

// Key range [kbeg, kend) that can be unmasked for query rows [q0, q0 + n).
__device__ __forceinline__ void key_range(const Params& p, int q0, int n,
                                          int* kbeg, int* kend) {
  *kend = p.causal ? min(p.S, q0 + n) : p.S;
  *kbeg = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
}

__device__ __forceinline__ bool unmasked(const Params& p, int qi, int kj) {
  bool ok = kj < p.S;
  if (p.causal) ok = ok && kj <= qi;
  if (p.window > 0) ok = ok && kj > qi - p.window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per CTA, 16 per warp
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;  // bf16 elements (16 B) of row padding: ldmatrix
                        // rows fall in distinct banks

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows x HD of one head into shared memory (row stride HD + PAD); rows
// at or past S and columns at or past hd are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm,
                                          const __nv_bfloat16* g, int row0,
                                          int S, int64_t rstride, int hd,
                                          int tid) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = tid; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = i % VPR;
    const int s = row0 + r;
    const bool ok = s < S && c * 8 < hd;
    cp_async16(sm + r * (HD + PAD) + c * 8, ok ? g + s * rstride + c * 8 : g,
               ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_bf16(Params p) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heavy tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t qs = (int64_t)p.H * p.hd, ks = (int64_t)p.Hkv * p.hd;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(p.q) +
                           ((int64_t)b * p.S * p.H + h) * p.hd;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(p.k) +
                           ((int64_t)b * p.S * p.Hkv + hk) * p.hd;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(p.v) +
                           ((int64_t)b * p.S * p.Hkv + hk) * p.hd;
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) +
                     ((int64_t)b * p.S * p.H + h) * p.hd;

  int kbeg, kend;
  key_range(p, q0, BQ, &kbeg, &kend);
  const int kt0 = kbeg / BK, kt1 = (kend + BK - 1) / BK;

  load_tile<HD>(sQ, Q, q0, p.S, qs, p.hd, tid);
  load_tile<HD>(sK, K, kt0 * BK, p.S, ks, p.hd, tid);
  cp_async_commit();
  load_tile<HD>(sV, V, kt0 * BK, p.S, ks, p.hd, tid);
  cp_async_commit();
  cp_async_wait<1>();  // Q and the first K tile
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, one per 16 columns: held
  // in registers up to HD 128; at HD 256 re-read from shared memory for
  // each key tile, so that the 32 x 4 output accumulators fit in registers
  constexpr bool Q_REGS = HD <= 128;
  const __nv_bfloat16* sQw =
      sQ + (warp * 16 + (lane % 16)) * LD + (lane / 16) * 8;
  uint32_t qf[Q_REGS ? HD / 16 : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], sQw + kk * 16);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int qr0 = q0 + warp * 16 + g, qr1 = qr0 + 8;  // this thread's rows
  const int mi = lane / 8, r8 = lane % 8;             // ldmatrix addressing

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    // S = Q K^T: 16 x 64 per warp, as 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      if constexpr (Q_REGS) {
        qa[0] = qf[kk][0];
        qa[1] = qf[kk][1];
        qa[2] = qf[kk][2];
        qa[3] = qf[kk][3];
      } else {
        ldsm_x4(qa, sQw + kk * 16);
      }
#pragma unroll
      for (int nj = 0; nj < BK / 16; ++nj) {
        // (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7),
        // (keys 8-15, d 8-15) of this 16 x 16 block of K
        uint32_t bk[4];
        ldsm_x4(bk, sK + (nj * 16 + r8 + (mi / 2) * 8) * LD + kk * 16 +
                        (mi % 2) * 8);
        mma_bf16(s[2 * nj], qa, bk[0], bk[1]);
        mma_bf16(s[2 * nj + 1], qa, bk[2], bk[3]);
      }
    }

    // scale to log2 units and mask where a tile meets the diagonal, the
    // window's edge or the ragged tail
    const bool edge = (k0 + BK > p.S) || (p.causal && k0 + BK - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + BQ - 1 - p.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (edge && !unmasked(p, e < 2 ? qr0 : qr1,
                              k0 + nt * 8 + t4 * 2 + (e & 1)))
          x = NEG_INF;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // a row lives in the 4 threads of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }
    // P = exp2(S - m); row sums in fp32, P packed to bf16 A fragments: the
    // accumulator layout of n-tiles (2kk, 2kk+1) is the A layout of k-step kk
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      float pv[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        pv[t][0] = exp2f(s[2 * kk + t][0] - mx0);
        pv[t][1] = exp2f(s[2 * kk + t][1] - mx0);
        pv[t][2] = exp2f(s[2 * kk + t][2] - mx1);
        pv[t][3] = exp2f(s[2 * kk + t][3] - mx1);
        l0 += pv[t][0] + pv[t][1];
        l1 += pv[t][2] + pv[t][3];
      }
      pf[kk][0] = pack_bf16(pv[0][0], pv[0][1]);
      pf[kk][1] = pack_bf16(pv[0][2], pv[0][3]);
      pf[kk][2] = pack_bf16(pv[1][0], pv[1][1]);
      pf[kk][3] = pack_bf16(pv[1][2], pv[1][3]);
    }

    cp_async_wait<0>();  // V tile kt
    __syncthreads();     // and every warp is done with K tile kt
    if (kt + 1 < kt1) load_tile<HD>(sK, K, k0 + BK, p.S, ks, p.hd, tid);
    cp_async_commit();

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        // transposed (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7,
        // d 8-15), (keys 8-15, d 8-15) of this 16 x 16 block of V
        uint32_t bv[4];
        ldsm_x4_t(bv, sV + (kk * 16 + r8 + (mi % 2) * 8) * LD + dn * 16 +
                          (mi / 2) * 8);
        mma_bf16(o[2 * dn], pf[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], pf[kk], bv[2], bv[3]);
      }
    }

    cp_async_wait<0>();  // K tile kt + 1
    __syncthreads();     // and every warp is done with V tile kt
    if (kt + 1 < kt1) load_tile<HD>(sV, V, k0 + BK, p.S, ks, p.hd, tid);
    cp_async_commit();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);

  // stage the warp's 16 rows in its own rows of sQ (which no other warp
  // reads), then store 16-byte vectors
  __nv_bfloat16* sO = sQ + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = i * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(sO + g * LD + col) =
        __floats2bfloat162_rn(o[i][0] / l0, o[i][1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8) * LD + col) =
        __floats2bfloat162_rn(o[i][2] / l1, o[i][3] / l1);
  }
  __syncwarp();
  constexpr int VPR = HD / 8;
  for (int i = lane; i < 16 * VPR; i += 32) {
    const int r = i / VPR, c = i % VPR;
    const int s = q0 + warp * 16 + r;
    if (s < p.S && c * 8 < p.hd)
      *reinterpret_cast<uint4*>(O + s * qs + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT, one warp per query row
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 8;  // query rows per CTA
constexpr int F_BK = 32;   // keys per tile: one per lane

template <int HD>
__global__ void __launch_bounds__(F_ROWS * 32) flash_fwd_f32(Params p) {
  extern __shared__ float fsm[];
  float* sK = fsm;                   // F_BK x (HD + 1): lane j reads row j
  float* sV = sK + F_BK * (HD + 1);  // F_BK x HD
  float* sQ = sV + F_BK * HD;        // F_ROWS x HD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_ROWS;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t qs = (int64_t)p.H * p.hd, ks = (int64_t)p.Hkv * p.hd;
  const float* Q =
      static_cast<const float*>(p.q) + ((int64_t)b * p.S * p.H + h) * p.hd;
  const float* K = static_cast<const float*>(p.k) +
                   ((int64_t)b * p.S * p.Hkv + hk) * p.hd;
  const float* V = static_cast<const float*>(p.v) +
                   ((int64_t)b * p.S * p.Hkv + hk) * p.hd;
  float* O = static_cast<float*>(p.o) + ((int64_t)b * p.S * p.H + h) * p.hd;

  for (int i = tid; i < F_ROWS * HD; i += F_ROWS * 32) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    sQ[i] = (s < p.S && d < p.hd) ? Q[s * qs + d] : 0.f;
  }
  int kbeg, kend;
  key_range(p, q0, F_ROWS, &kbeg, &kend);
  const int qi = q0 + warp;

  float acc[HD / 32];
#pragma unroll
  for (int e = 0; e < HD / 32; ++e) acc[e] = 0.f;
  float m = NEG_INF, l = 0.f;
  for (int k0 = kbeg / F_BK * F_BK; k0 < kend; k0 += F_BK) {
    __syncthreads();  // Q staged / the previous tile consumed
    for (int i = tid; i < F_BK * HD; i += F_ROWS * 32) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool ok = s < p.S && d < p.hd;
      sK[r * (HD + 1) + d] = ok ? K[s * ks + d] : 0.f;
      sV[r * HD + d] = ok ? V[s * ks + d] : 0.f;
    }
    __syncthreads();
    float x = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d)
      x = fmaf(sQ[warp * HD + d], sK[lane * (HD + 1) + d], x);
    x *= p.scale_log2;
    if (!unmasked(p, qi, k0 + lane)) x = NEG_INF;
    float mx = fmaxf(m, x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float c = exp2f(m - mx);
    const float pj = exp2f(x - mx);
    float ps = pj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * c + ps;
    m = mx;
#pragma unroll
    for (int e = 0; e < HD / 32; ++e) acc[e] *= c;
    for (int j = 0; j < F_BK; ++j) {
      const float pb = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
      for (int e = 0; e < HD / 32; ++e)
        acc[e] = fmaf(pb, sV[j * HD + e * 32 + lane], acc[e]);
    }
  }
  l = fmaxf(l, 1e-30f);
  if (qi < p.S) {
#pragma unroll
    for (int e = 0; e < HD / 32; ++e) {
      const int d = e * 32 + lane;
      if (d < p.hd) O[qi * qs + d] = acc[e] / l;
    }
  }
}

template <int HD>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (HD + PAD) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_bf16<HD><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = (F_BK * (HD + 1) + F_BK * HD + F_ROWS * HD) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + F_ROWS - 1) / F_ROWS, p.B * p.H);
  flash_fwd_f32<HD><<<grid, F_ROWS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0: no sliding window.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int hd, int causal,
                                      int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || hd <= 0 ||
      hd % 16 || hd > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, S, H, Hkv, hd, causal, window,
                 (float)(LOG2E / sqrt((double)hd))};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int pad = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  if (dtype == 1) {
    if (pad == 64) return (int)launch_bf16<64>(p, s);
    if (pad == 128) return (int)launch_bf16<128>(p, s);
    return (int)launch_bf16<256>(p, s);
  }
  if (dtype == 0) {
    if (pad == 64) return (int)launch_f32<64>(p, s);
    if (pad == 128) return (int)launch_f32<128>(p, s);
    return (int)launch_f32<256>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
