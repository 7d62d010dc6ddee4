// Fused FSGLD parameter update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels fsgld_update_packed
// (src/repro/kernels/fsgld_update.py:273) and fsgld_update_2d (:189),
// whose bodies are _make_kernel, _drift, _gaussian_noise and _mix. One
// launch updates every leaf of every chain held in a chain-major
// (C * rows_total, 128) float32 buffer:
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
// mu_g and lam_g are (rows_total, 128), shared by every chain.
//
// What bounds it on an H100 SXM (3.35 TB/s, 132 SMs), by shape:
// * C*P = 2^27 'diag' (8 chains of one 2^24 leaf): bytes. Per chain and
//   element theta, g, mu_s, lam_s in and theta' out (20 B), and mu_g and
//   lam_g once for all chains: 2.82 GB, 0.84 ms. mu_g and lam_g are 128 MiB
//   together, more than the 50 MB L2, so a grid that streams one chain
//   after another fetches them from device memory once per chain (3.76 GB;
//   the one-vector-per-thread kernel before this one reached 92.6% of the
//   rate for that traffic, 69.5% of the bound).
// * qwen3-1.7b 'scalar', C = 1, 2.03e9 elements in place: bytes (40.6 GB,
//   12.1 ms). Nothing is shared; the work is to keep the memory busy while
//   each element's hash and full-precision logf, sqrtf and cosf issue
//   beside it (without the normals the kernel runs 2.9% faster there).
// * Table 1 (4 chains x 1,024 elements) and the multi-leaf MLP (8 chains x
//   26,624): the launch floor (~0.8-0.95 us for an empty kernel in a CUDA
//   graph; their bytes take 0.02 and 1.25 us). Above the floor lie the
//   launch of this grid, one round trip to memory for the segment table,
//   one for the seed and scalar row, and four Box-Muller normals per
//   thread.
//
// The design (each choice held against its alternative in
// tools/update_ladder.py --experiments; PERF.md has the times):
// * A work item is a tile (blockDim.x float4 vectors of in-chain rows) and
//   a group of chains. Each thread looks its vector's segment up once (its
//   leaf and noise index), loads mu_g and lam_g once and keeps them in
//   registers, then walks the group's chains, loading theta, g, mu_s,
//   lam_s and r and storing theta' (and r') for each. Where the tiles
//   alone fill the card's resident CTAs (2^27, qwen3) one group holds
//   every chain, so the shared rows leave device memory once; where they
//   do not (Table 1, the MLP) each chain is a group of its own and the
//   groups of one tile are neighbouring items, so the shared rows come
//   from L2 and every SM that can take work gets some.
// * One CTA per item, dealt to the SMs by the hardware in order. A
//   persistent grid (the SM count times the CTAs that fit, each walking
//   every gridDim.x-th item) measured 2.8% slower at 2^27 and 6.7% at
//   qwen3 (its CTAs drift apart, so that the addresses in flight spread,
//   is the likely cause; not measured). Chain and row come from the block
//   index and shifts: a 32-bit division once per item only where
//   block_rows is no power of two or the chains form several groups, no
//   64-bit division. The in-chain vector index is 32-bit (the host
//   refuses a chain of 2^31 vectors or more), element offsets 64-bit.
// * Bytes in flight come from occupancy (40-62 registers: 4-6 CTAs of 256
//   threads per SM), not from a software pipeline: two steps kept in
//   registers raised the count to 101-110 and cost 11% at 2^27, and every
//   vector but the shared rows is used once by the thread that loads it,
//   so a TMA ring in shared memory would only add a copy and a barrier.
// * Small launches: a CTA's threads halve from 256 down to 32 while the
//   items number fewer than the SMs (Table 1: 32 CTAs of 32 threads, not
//   4 of 256). The (chain, leaf) seed and scalar row are read per chain
//   through the read-only cache, one request per warp; staging them in
//   shared memory behind a barrier measured 6-13% slower at Table 1.
// * A plain launch. Programmatic dependent launch (griddepcontrol) took
//   16% off Table 1 between updates launched back to back, but on the
//   engine's path each update follows PyTorch's copy that packs g, which
//   triggers no early launch, and there it moved nothing (Table 1 within
//   0.3%, the MLP 3% slower).
//
// In place: theta_out may be theta itself (and r_out r), which saves a
// buffer of the parameters' size, 8.1 GB per chain at qwen3-1.7b's width.
// So theta, r and the outputs carry no __restrict__, and theta and r are
// read through the coherent path, not the read-only cache (__ldg), in
// place or not. Each thread reads its own float4 before it writes it, and
// no other thread touches it.
//
// Built without --use_fast_math: __logf/__cosf would move the normals far
// outside the tolerance against the plain version. The per-element
// expressions are the one-vector-per-thread kernel's: 'plain' and 'diag'
// give its bits; 'scalar' differs in up to ~2% of elements by at most
// ~1e-6 (nvcc contracts one multiply-add of its conditioning term
// otherwise), far inside the tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int VEC = 4;
constexpr int VECS_PER_ROW = LANE / VEC;
constexpr int MAX_THREADS = 256;
constexpr int MIN_THREADS = 32;
constexpr int MAX_DEVICES = 64;

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

// How one launch cuts its work (computed on the host).
struct Plan {
  uint32_t nvec;   // float4 vectors per chain
  int groups;      // chain groups per tile
  int per_group;   // chains per group (the last may hold fewer)
  int chains;
  int br_shift;    // log2(block_rows) where it is a power of two, else -1
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

// One thread's place in the walk: an item (tile, chain group), the chain
// it is at, and the vectors loaded for it.
template <int V, bool HMC>
struct Step {
  int c, c_end;     // this chain, the end of the group
  uint32_t u;       // the vector's index within its chain
  int leaf;
  uint32_t idx0;    // noise index of the vector's first element
  float4 mg, lg;    // shared: loaded once per item
  float4 th, g, ms, ls, r;  // chain c's
};

// Opens item w: its chain group, the thread's vector, the segment lookup
// and the shared rows. False when the vector lies past the chain's end.
template <int V, bool HMC>
__device__ __forceinline__ bool open_item(const Args& a, const Plan& p,
                                          uint32_t w, Step<V, HMC>& s) {
  const uint32_t tile = p.groups == 1 ? w : w / (uint32_t)p.groups;
  s.c = (int)(w - tile * (uint32_t)p.groups) * p.per_group;
  s.c_end = min(p.chains, s.c + p.per_group);
  s.u = tile * blockDim.x + threadIdx.x;
  if (s.u >= p.nvec) return false;
  const uint32_t row = s.u / VECS_PER_ROW;
  const uint32_t j = p.br_shift >= 0 ? row >> p.br_shift
                                     : row / (uint32_t)a.block_rows;
  s.leaf = __ldg(a.seg_leaf + j);
  s.idx0 = (uint32_t)__ldg(a.seg_base + j)
      + (row - j * (uint32_t)a.block_rows) * LANE
      + (s.u % VECS_PER_ROW) * VEC;
  const size_t soff = (size_t)s.u * VEC;
  if (V != PLAIN) s.mg = ld4(a.mu_g + soff);
  if (V == DIAG) s.lg = ld4(a.lam_g + soff);
  return true;
}

template <int V, bool HMC>
__device__ __forceinline__ void load_chain(const Args& a, size_t off,
                                           Step<V, HMC>& s) {
  s.th = ld4_state(a.theta + off);
  s.g = ld4(a.g + off);
  if (V != PLAIN) s.ms = ld4(a.mu_s + off);
  if (V == DIAG) s.ls = ld4(a.lam_s + off);
  if (HMC) s.r = ld4_state(a.r + off);
}

// The update of one vector of chain s.c, written at `off`; sc is its
// (chain, leaf) scalar row.
template <int V, bool HMC>
__device__ __forceinline__ void update(const Args& a, size_t off,
                                       const float* __restrict__ sc,
                                       uint32_t seed, const Step<V, HMC>& s) {
  const float h = __ldg(sc + S_H), scale = __ldg(sc + S_SCALE);
  const float prior = __ldg(sc + S_PRIOR), alpha = __ldg(sc + S_ALPHA);
  const float fs = __ldg(sc + S_FS), temp = __ldg(sc + S_TEMP);
  float lamg = 0.f, lams = 0.f;
  if (V == SCALAR) {
    lamg = __ldg(sc + S_LAMG);
    lams = __ldg(sc + S_LAMS);
  }
  float4 out4, rout4;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float th = get(s.th, k);
    float drift = -prior * th + scale * get(s.g, k);
    if (V == SCALAR) {
      const float cond = lamg * (get(s.mg, k) - th)
          - (lams / fs) * (get(s.ms, k) - th);
      drift = drift + alpha * cond;
    } else if (V == DIAG) {
      const float cond = get(s.lg, k) * (get(s.mg, k) - th)
          - (get(s.ls, k) / fs) * (get(s.ms, k) - th);
      drift = drift + alpha * cond;
    }
    const float xi = gaussian_noise(seed, s.idx0 + (uint32_t)k);
    if (!HMC) {
      const float sig = sqrtf(h * temp);
      set(out4, k, th + (h * 0.5f) * drift + sig * xi);
    } else {
      const float fr = __ldg(sc + S_FRIC);
      const float noise_sig = sqrtf(2.0f * fr * temp);
      const float rn = (1.0f - fr) * get(s.r, k) + h * drift
          + (noise_sig * sqrtf(h)) * xi;
      set(out4, k, th + rn);
      set(rout4, k, rn);
    }
  }
  *reinterpret_cast<float4*>(a.theta_out + off) = out4;
  if (HMC) *reinterpret_cast<float4*>(a.r_out + off) = rout4;
}

template <int V, bool HMC>
__global__ void __launch_bounds__(MAX_THREADS)
fsgld_update_kernel(const Args a, const Plan p) {
  const size_t chain_elems = (size_t)p.nvec * VEC;
  Step<V, HMC> s;
  if (!open_item(a, p, blockIdx.x, s)) return;  // one CTA per item
  for (; s.c < s.c_end; ++s.c) {
    const size_t off = (size_t)s.c * chain_elems + (size_t)s.u * VEC;
    load_chain(a, off, s);
    const int cl = s.c * a.num_leaves + s.leaf;
    update(a, off, a.scalars + (size_t)cl * SCALAR_COLS,
           (uint32_t)__ldg(a.seeds + cl), s);
  }
}

int sm_count(int* out) {
  static int cached[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *out = cached[dev];
  return 0;
}

// CTAs of `threads` that fit on one SM.
template <int V, bool HMC>
int ctas_per_sm(int threads, int* out) {
  static int cached[MAX_THREADS / MIN_THREADS + 1];
  int& n = cached[threads / MIN_THREADS];
  if (n == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fsgld_update_kernel<V, HMC>, threads, 0);
    if (err != cudaSuccess) return (int)err;
    if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  }
  *out = n;
  return 0;
}

template <int V, bool HMC>
int launch(const Args& a, cudaStream_t stream) {
  const int64_t chains = a.rows / a.rows_total;
  const int64_t nvec = (int64_t)a.rows_total * VECS_PER_ROW;
  if (nvec >= (int64_t(1) << 31) || chains * a.num_leaves > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  int sms = 0, resident = 0, err = sm_count(&sms);
  if (err) return err;
  // a small launch spreads over more SMs with fewer threads per CTA
  int threads = MAX_THREADS;
  while (threads > MIN_THREADS
         && (nvec + threads - 1) / threads * chains < sms)
    threads /= 2;
  if ((err = ctas_per_sm<V, HMC>(threads, &resident))) return err;
  const int64_t tiles = (nvec + threads - 1) / threads;
  const int64_t slots = (int64_t)sms * resident;
  // one group of every chain where the tiles alone fill the resident
  // CTAs, else as many groups as it takes (up to one per chain)
  int64_t groups = (slots + tiles - 1) / tiles;
  groups = groups < chains ? groups : chains;
  Plan p;
  p.chains = (int)chains;
  p.nvec = (uint32_t)nvec;
  p.per_group = (int)((chains + groups - 1) / groups);
  p.groups = (int)((chains + p.per_group - 1) / p.per_group);
  p.br_shift = -1;
  for (int k = 0; k < 31; ++k)
    if (a.block_rows == 1 << k) p.br_shift = k;
  const int64_t items = tiles * p.groups;
  // one CTA per item: the hardware deals them to the SMs in order
  fsgld_update_kernel<V, HMC><<<(unsigned)items, threads, 0, stream>>>(a, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fsgld_update_launch(
    int variant, int sghmc, const float* theta, const float* r, const float* g,
    const float* mu_g, const float* mu_s, const float* lam_g,
    const float* lam_s, const int* seg_leaf, const int* seg_base,
    const int* seeds, const float* scalars, float* theta_out, float* r_out,
    long long rows, int rows_total, int block_rows, int num_leaves,
    void* stream) {
  if (rows <= 0 || rows_total <= 0 || block_rows <= 0 || num_leaves <= 0
      || rows % rows_total != 0)
    return (int)cudaErrorInvalidValue;
  // in place is all or nothing: theta and r both, or neither
  if (sghmc && (theta_out == theta) != (r_out == r))
    return (int)cudaErrorInvalidValue;
  const Args a{theta, r, g, mu_g, mu_s, lam_g, lam_s, seg_leaf, seg_base,
               seeds, scalars, theta_out, r_out, (int64_t)rows, rows_total,
               block_rows, num_leaves};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (variant * 2 + (sghmc ? 1 : 0)) {
    case 0: return launch<PLAIN, false>(a, s);
    case 1: return launch<PLAIN, true>(a, s);
    case 2: return launch<SCALAR, false>(a, s);
    case 3: return launch<SCALAR, true>(a, s);
    case 4: return launch<DIAG, false>(a, s);
    case 5: return launch<DIAG, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fsgld_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
