// Fused FSGLD parameter update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fsgld_update_packed and fsgld_update_2d
// (src/repro/kernels/fsgld_update.py, function bodies _make_kernel, _drift,
// _gaussian_noise, _mix). One launch updates every leaf of every chain held
// in a chain-major (C * rows_total, 128) float32 buffer:
//
//   drift  = -prior*theta + scale*g
//            + alpha*[lam_g*(mu_g - theta) - (lam_s/f_s)*(mu_s - theta)]
//   langevin: theta' = theta + (h/2)*drift + sqrt(h*tau)*xi
//   sghmc:    r' = (1-a)*r + h*drift + sqrt(2*a*tau)*sqrt(h)*xi,
//             theta' = theta + r'
//
// with xi ~ N(0, 1) from murmur3 fmix32 + Box-Muller of
// (seed[c, leaf], seg_base[j] + (row % block_rows)*128 + col): the element's
// index within its leaf, so the noise stream is the per-leaf kernel's.
//
// What bounds it on the card: device-memory bytes. Each element does ~50
// integer and float operations but moves ~28 bytes for 'diag' (theta, g,
// mu_s, lam_s read per chain, mu_g and lam_g shared across chains and
// served mostly from L2, theta' written), far below the H100's ~20
// operations per byte at 67 TFLOP/s fp32 over 3.35 TB/s. The design
// therefore spends nothing on reuse or staging: a 1-D grid of threads, each
// moving one float4 (16-byte) vector of every stream with coalesced loads,
// the noise computed in registers (it never touches memory), the (chain,
// leaf) seed and scalar row read through the read-only cache, and the
// segment table looked up per thread (a few hundred bytes, L1-resident).
// TMA and persistent blocks are left for later work.
//
// In place: theta_out may be theta itself (and r_out r), which saves a
// buffer of the parameters' size, 8.1 GB per chain at qwen3-1.7b's width.
// So theta, r and the outputs carry no __restrict__, and theta and r are
// read through the coherent path, not the read-only cache (__ldg), in
// place or not. Each thread reads its own float4 before it writes it, and
// no other thread touches it.
//
// Built without --use_fast_math: __logf/__cosf would move the normals far
// outside the tolerance against the plain version. nvcc's default FMA
// contraction moves results by an ulp, which the tolerance allows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int VEC = 4;
constexpr int VECS_PER_ROW = LANE / VEC;
constexpr int THREADS = 256;

enum { S_H, S_SCALE, S_FS, S_PRIOR, S_ALPHA, S_TEMP, S_LAMG, S_LAMS, S_FRIC,
       SCALAR_COLS };
enum { PLAIN = 0, SCALAR = 1, DIAG = 2 };

struct Args {
  const float* theta;  // may be theta_out (in place)
  const float* r;      // may be r_out
  const float* __restrict__ g;
  const float* __restrict__ mu_g;
  const float* __restrict__ mu_s;
  const float* __restrict__ lam_g;
  const float* __restrict__ lam_s;
  const int* __restrict__ seg_leaf;
  const int* __restrict__ seg_base;
  const int* __restrict__ seeds;      // uint32 bit patterns, (C, L)
  const float* __restrict__ scalars;  // (C, L, SCALAR_COLS)
  float* theta_out;
  float* r_out;
  int64_t rows;
  int rows_total;
  int block_rows;
  int num_leaves;
};

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float gaussian_noise(uint32_t seed, uint32_t idx) {
  const uint32_t h1 = mix(idx * 2u + 1u + seed * 0x9E3779B9u);
  const uint32_t h2 = mix(idx * 2u + seed * 0x85EBCA77u);
  const float u1 = (float)(h1 >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
  const float u2 = (float)(h2 >> 8) * (1.0f / 16777216.0f);
  const float rad = sqrtf(-2.0f * logf(u1));
  return rad * cosf(6.28318530717958647692f * u2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// A stream the kernel may also write (in place): the coherent path.
__device__ __forceinline__ float4 ld4_state(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set(float4& v, int k, float x) {
  if (k == 0) v.x = x; else if (k == 1) v.y = x; else if (k == 2) v.z = x; else v.w = x;
}

template <int V, bool HMC>
__global__ void __launch_bounds__(THREADS) fsgld_update_kernel(const Args a) {
  const int64_t nvec = a.rows * VECS_PER_ROW;
  for (int64_t v = (int64_t)blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * THREADS) {
    const int64_t row = v / VECS_PER_ROW;
    const int col = (int)(v % VECS_PER_ROW) * VEC;
    const int64_t c = row / a.rows_total;
    const int rr = (int)(row - c * a.rows_total);  // row within the chain
    const int j = rr / a.block_rows;               // block within the chain
    const int leaf = __ldg(a.seg_leaf + j);
    const uint32_t idx0 = (uint32_t)__ldg(a.seg_base + j)
        + (uint32_t)(rr - j * a.block_rows) * LANE + (uint32_t)col;
    const int64_t cl = c * a.num_leaves + leaf;
    const uint32_t seed = (uint32_t)__ldg(a.seeds + cl);
    const float* sc = a.scalars + cl * SCALAR_COLS;
    const float h = __ldg(sc + S_H), scale = __ldg(sc + S_SCALE);
    const float prior = __ldg(sc + S_PRIOR), alpha = __ldg(sc + S_ALPHA);
    const float fs = __ldg(sc + S_FS), temp = __ldg(sc + S_TEMP);

    const int64_t off = row * LANE + col;            // per-chain operands
    const int64_t soff = (int64_t)rr * LANE + col;   // shared operands
    const float4 th4 = ld4_state(a.theta + off);
    const float4 g4 = ld4(a.g + off);
    float4 mg4, ms4, lg4, ls4, r4;
    if (V != PLAIN) { mg4 = ld4(a.mu_g + soff); ms4 = ld4(a.mu_s + off); }
    if (V == DIAG) { lg4 = ld4(a.lam_g + soff); ls4 = ld4(a.lam_s + off); }
    if (HMC) r4 = ld4_state(a.r + off);

    float4 out4, rout4;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float th = get(th4, k);
      float drift = -prior * th + scale * get(g4, k);
      if (V == SCALAR) {
        const float cond = __ldg(sc + S_LAMG) * (get(mg4, k) - th)
            - (__ldg(sc + S_LAMS) / fs) * (get(ms4, k) - th);
        drift = drift + alpha * cond;
      } else if (V == DIAG) {
        const float cond = get(lg4, k) * (get(mg4, k) - th)
            - (get(ls4, k) / fs) * (get(ms4, k) - th);
        drift = drift + alpha * cond;
      }
      const float xi = gaussian_noise(seed, idx0 + (uint32_t)k);
      if (!HMC) {
        const float sig = sqrtf(h * temp);
        set(out4, k, th + (h * 0.5f) * drift + sig * xi);
      } else {
        const float fr = __ldg(sc + S_FRIC);
        const float noise_sig = sqrtf(2.0f * fr * temp);
        const float rn = (1.0f - fr) * get(r4, k) + h * drift
            + (noise_sig * sqrtf(h)) * xi;
        set(out4, k, th + rn);
        set(rout4, k, rn);
      }
    }
    *reinterpret_cast<float4*>(a.theta_out + off) = out4;
    if (HMC) *reinterpret_cast<float4*>(a.r_out + off) = rout4;
  }
}

template <int V, bool HMC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t nvec = a.rows * VECS_PER_ROW;
  const int64_t blocks = (nvec + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < 0x7FFFFFFF ? blocks : 0x7FFFFFFF);
  fsgld_update_kernel<V, HMC><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fsgld_update_launch(
    int variant, int sghmc, const float* theta, const float* r, const float* g,
    const float* mu_g, const float* mu_s, const float* lam_g,
    const float* lam_s, const int* seg_leaf, const int* seg_base,
    const int* seeds, const float* scalars, float* theta_out, float* r_out,
    long long rows, int rows_total, int block_rows, int num_leaves,
    void* stream) {
  if (rows <= 0 || rows_total <= 0 || block_rows <= 0 || num_leaves <= 0)
    return (int)cudaErrorInvalidValue;
  // in place is all or nothing: theta and r both, or neither
  if (sghmc && (theta_out == theta) != (r_out == r))
    return (int)cudaErrorInvalidValue;
  const Args a{theta, r, g, mu_g, mu_s, lam_g, lam_s, seg_leaf, seg_base,
               seeds, scalars, theta_out, r_out, (int64_t)rows, rows_total,
               block_rows, num_leaves};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (variant * 2 + (sghmc ? 1 : 0)) {
    case 0: return (int)launch<PLAIN, false>(a, s);
    case 1: return (int)launch<PLAIN, true>(a, s);
    case 2: return (int)launch<SCALAR, false>(a, s);
    case 3: return (int)launch<SCALAR, true>(a, s);
    case 4: return (int)launch<DIAG, false>(a, s);
    case 5: return (int)launch<DIAG, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fsgld_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
