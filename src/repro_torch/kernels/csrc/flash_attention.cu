// Forward flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:88, body _flash_kernel :35):
//
//   out = softmax(q k^T * hd^-0.5, masked) v
//
// and, where the caller passes a buffer for them (the training path's
// differentiable entry), each row's log-sum-exp of its masked scaled
// scores, lse = m + log(l) in natural units, as fp32 (B, H, S): the
// residual the backward recomputes the probabilities from (the reference's
// _flash_fwd returns m and l). Serving passes none, and nothing of its
// results or launches changes.
//
// with a running (m, l, acc) online softmax in fp32 over key tiles, masked
// scores set to NEG_INF = -1e30 (causal: key <= query; window W: key >
// query - W; and the ragged tail key >= S), key tiles above the diagonal or
// outside the window skipped, and out = acc / max(l, 1e-30) in the input
// dtype. Positions are implicit (row = absolute position), as in prefill.
//
// Layout: q (B, S, H, hd), k and v (B, S, Hkv, hd), contiguous, H % Hkv == 0;
// query head h reads KV head h / (H / Hkv), so GQA needs no expanded copy.
// Any S (the ragged tail is masked) and any hd that is a multiple of 16 up
// to 256 (zero-padded in shared memory to 64, 128 or 256).
//
// What bounds it on the card: operations. At the serving path's prefill
// shape (B 4, S 2,048, H 16, Hkv 8, hd 128, causal, bf16) the unmasked
// pairs need 4*B*H*hd*pairs = 6.9e10 flops, 0.069 ms at 989 TFLOP/s, while
// q, k, v and out are 1.0e8 bytes, 0.030 ms at 3.35 TB/s. So the bf16
// kernel is built the way Hopper reaches its tensor-core rate:
//
// * Warp specialisation, persistent. A CTA of three warpgroups (384
//   threads) walks work tiles of 128 query rows of one (batch, head), one
//   CTA per SM: warpgroup 0 is the producer (one thread issues every copy;
//   setmaxnreg gives its registers away, down to 40), warpgroups 1 and 2
//   are consumers of 64 rows each (up to 232 registers). The heavy (late,
//   causal) q tiles of every head come before any light one.
// * TMA into rings. K and V tiles (BK = 128 keys for hd <= 128, 64 for hd
//   256) stream through 2 stages each, every stage with a full and an empty
//   mbarrier, across works; Q has 2 slots (1 at hd 256), so the next work's
//   Q loads during this one. The tensor maps are 4-D over (hd, heads, S,
//   B), the tensors' own layout, so the KV head of a GQA group is a
//   coordinate; boxes are 64 columns (one 128-byte swizzle panel) x 64 rows,
//   and TMA's out-of-bounds fill zeroes rows >= S and columns >= hd. Maps
//   are encoded per call on the host (cuTensorMapEncodeTiled, found through
//   cudaGetDriverEntryPoint: no -lcuda) and passed as __grid_constant__
//   parameters, so a captured CUDA graph holds its own copy.
// * wgmma for both products. S = Q K^T is m64n{BK}k16 with Q and K from
//   shared memory, both K-major as TMA wrote them; O += P V is the
//   register-A form: P is the S accumulator rounded to bf16 (as the
//   reference's block scan rounds it before P V) and repacked into the A
//   fragment, whose layout matches the accumulator's, and V is read in its
//   natural [key][hd] layout with the B-transpose bit, so nothing is
//   transposed. P V of tile i - 1 is issued behind Q K^T of tile i and runs
//   during tile i's softmax.
// * Softmax in registers: a row lives in the 4 threads of a quad of the
//   accumulator; one FFMA and one ex2 per score, the row max and sum in 4
//   independent partial chains (serial chains left the softmax bound by
//   latency, the kernel 1.6x slower on an H100; PERF.md). Only
//   tiles at the diagonal, the window's edge or the ragged tail mask per
//   element, and tiles wholly masked for the work are never loaded.
// * Epilogue: O / l in bf16 stored from the accumulator, masked at rows
//   >= S and columns >= hd, while the next work's loads proceed.
//
// The fp32 kernel is a plain SIMT kernel (one warp per query row, 8 rows
// per CTA, 32-key tiles in shared memory) for inputs the tensor cores
// cannot take at full precision; it is off the serving path.

#include <cuda.h>  // CUtensorMap and its enums; the driver is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // (B, H, S) row log-sum-exp, or null: not written
  int B, S, H, Hkv, hd;
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // hd^-0.5 * log2(e): scores in log2 units for exp2
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
// bf16: TMA, mbarriers, wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int BQ = 128;        // query rows per CTA, 64 per consumer
constexpr int WG = 128;        // threads per warpgroup
constexpr int THREADS = 3 * WG;
constexpr int PANEL = 64;      // bf16 columns in one 128-byte swizzle row
constexpr int BOX_ROWS = 64;   // rows of one TMA box
constexpr int BOX_BYTES = BOX_ROWS * 128;
constexpr int STAGES = 2;      // ring depth of K and of V
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

template <int HD>
struct Tiles {
  static constexpr int BK = HD <= 128 ? 128 : 64;  // keys per tile
  static constexpr int NP = HD / PANEL;            // panels across hd
  static constexpr int Q_BYTES = BQ * HD * 2;
  // Q slots: the next work's Q loads during this one's last tiles where
  // shared memory has room for two
  static constexpr int Q_SLOTS = HD <= 128 ? 2 : 1;
  static constexpr int KV_BYTES = BK * HD * 2;     // one stage of K or V
  static constexpr int BARS = 2 * Q_SLOTS + 4 * STAGES;  // full and empty
  // + 1 KB to align the base to the swizzle's 1,024-byte period
  static constexpr int SMEM = Q_SLOTS * Q_BYTES + 2 * STAGES * KV_BYTES +
                              8 * BARS + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box (64 columns x 64 rows of one head) into shared memory at
// `dst`; completion is counted in bytes on barrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand, in two
// words. The low word holds the start address and the leading byte offset
// (16-byte units); it passes through an empty asm so that the compiler
// derives each k-step's descriptor where it is used rather than holding
// all of them across the loop.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  uint32_t lo = ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
  asm volatile("" : "+r"(lo));
  return lo;
}

// The descriptor `offset` bytes past `lo`'s start; the high word holds the
// stride byte offset (1,024 bytes: 8 rows of 128) and layout 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t lo, uint32_t offset) {
  constexpr uint32_t hi = (1u << 30) | (1024 >> 4);
  return (static_cast<uint64_t>(hi) << 32) | (lo + (offset >> 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64 fp32) (+)= A (64 x 16, shared) * B (64 x 16, shared)^T;
// both K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32) (+)= A (64 x 16, shared) * B (128 x 16, shared)^T;
// both K-major, 128-byte swizzle
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) (+)= A (64 x 16 bf16, registers) * B (16 x 64,
// shared, N-major: the transpose bit), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 128 fp32) (+)= A (64 x 16 bf16, registers) * B (16 x 128,
// shared, N-major: the transpose bit), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 256 fp32) (+)= A (64 x 16 bf16, registers) * B (16 x 256,
// shared, N-major: the transpose bit), 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// O += P V over one tile's keys, in k16 steps of 16 rows of 128 bytes; V is
// N-major, its 64-column panels BK * 128 bytes apart (the leading offset).
template <int HD, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[HD / 2],
                                         const uint32_t (&pf)[BK / 16][4],
                                         uint32_t v) {
  const uint32_t v_lo = desc_lo(v, BK * 128);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, pf[kk], sw128_desc(v_lo, kk * 16 * 128), 1);
}

// One stage of K or V: keys k0 .. k0 + BK - 1 of KV head `head`, as NP
// panels of BK rows (BK / 64 boxes each), counted in bytes on `bar`.
template <int HD, int BK>
__device__ __forceinline__ void load_kv(const CUtensorMap* map, uint32_t dst,
                                        uint32_t bar, int head, int k0,
                                        int batch) {
  mbar_expect_tx(bar, BK * HD * 2);
  for (int pn = 0; pn < HD / PANEL; ++pn)
    for (int j = 0; j < BK / BOX_ROWS; ++j)
      tma_load(dst + pn * BK * 128 + j * BOX_BYTES, map, bar, pn * PANEL,
               head, k0 + j * BOX_ROWS, batch);
}

// S = Q K^T of one tile over hd in k16 steps, 32 bytes along a swizzled
// panel: the consumer's Q panels at `q`, the stage's K panels at `k`.
template <int HD, int BK>
__device__ __forceinline__ void qk_issue(float (&sc)[BK / 2], uint32_t q,
                                         uint32_t k) {
  const uint32_t q_lo = desc_lo(q, 16), k_lo = desc_lo(k, 16);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(sc, sw128_desc(q_lo, (kk / 4) * BOX_BYTES + (kk % 4) * 32),
             sw128_desc(k_lo, (kk / 4) * BK * 128 + (kk % 4) * 32), kk > 0);
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step on this thread's raw scores of rows qr0
// and qr1 (qc0: the consumer's first row, k0: the tile's first key): mask
// where the tile meets the diagonal, the window's edge or the ragged tail,
// take the new row max (of raw scores: the scale is positive), P =
// exp2(S * scale - m * scale) in place with one FFMA and one MUFU each,
// update m (raw) and l. c0 and
// c1 get the factors that take O to the new max. Masked scores are NEG_INF
// and, as in the reference, a row masked so far weighs every key 1 until
// a real key's weight makes those vanish.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             const Params& p, int qc0,
                                             int k0, int qr0, int qr1,
                                             int t4, float& m0, float& m1,
                                             float& l0, float& l1, float& c0,
                                             float& c1) {
  const bool edge = (k0 + BK > p.S) || (p.causal && k0 + BK - 1 > qc0) ||
                    (p.window > 0 && k0 <= qc0 + BOX_ROWS - 1 - p.window);
  if (edge) {
#pragma unroll
    for (int n8 = 0; n8 < BK / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!unmasked(p, e < 2 ? qr0 : qr1, k0 + n8 * 8 + t4 * 2 + (e & 1)))
          sc[4 * n8 + e] = NEG_INF;
  }
  // per row 4 partial maxima and sums, for parallel work
  float r0[4], r1[4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float a0 = fmaxf(sc[4 * j], sc[4 * j + 1]);
    const float a1 = fmaxf(sc[4 * j + 2], sc[4 * j + 3]);
    r0[j % 4] = j < 4 ? a0 : fmaxf(r0[j % 4], a0);
    r1[j % 4] = j < 4 ? a1 : fmaxf(r1[j % 4], a1);
  }
  // a row lives in the 4 threads of a quad
  float mx0 = fmaxf(fmaxf(m0, fmaxf(r0[0], r0[1])), fmaxf(r0[2], r0[3]));
  float mx1 = fmaxf(fmaxf(m1, fmaxf(r1[0], r1[1])), fmaxf(r1[2], r1[3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // a row with no real key yet: scale 0, so every weight is 2^0 = 1
  const float s0 = mx0 == NEG_INF ? 0.f : p.scale_log2;
  const float s1 = mx1 == NEG_INF ? 0.f : p.scale_log2;
  const float ms0 = mx0 * s0, ms1 = mx1 * s1;
  c0 = ex2(m0 * s0 - ms0);
  c1 = ex2(m1 * s1 - ms1);
  m0 = mx0;
  m1 = mx1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], s0, -ms0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], s0, -ms0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], s1, -ms1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], s1, -ms1));
    const float a0 = sc[4 * j] + sc[4 * j + 1];
    const float a1 = sc[4 * j + 2] + sc[4 * j + 3];
    r0[j % 4] = j < 4 ? a0 : r0[j % 4] + a0;
    r1[j % 4] = j < 4 ? a1 : r1[j % 4] + a1;
  }
  l0 = l0 * c0 + ((r0[0] + r0[1]) + (r0[2] + r0[3]));
  l1 = l1 * c1 + ((r1[0] + r1[1]) + (r1[2] + r1[3]));
}

// O to the new max, then P to bf16 A fragments: the accumulator layout of
// columns 16kk .. 16kk + 15 is the A layout of k-step kk.
template <int HD, int BK>
__device__ __forceinline__ void rescale_pack(float (&o)[HD / 2],
                                             uint32_t (&pf)[BK / 16][4],
                                             const float (&sc)[BK / 2],
                                             float c0, float c1) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= c0;
    o[4 * j + 1] *= c0;
    o[4 * j + 2] *= c1;
    o[4 * j + 3] *= c1;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// A work tile: 128 query rows of one (batch, head). Work w runs (batch,
// head) fastest and q tiles from the last, so every head's heavy (causal)
// tiles come before any light one; CTA c takes works c, c + gridDim.x, ...
__device__ __forceinline__ void work_tile(const Params& p, int w, int* q0,
                                          int* b, int* h) {
  const int bh = w % (p.B * p.H), n_q = (p.S + BQ - 1) / BQ;
  *q0 = (n_q - 1 - w / (p.B * p.H)) * BQ;
  *b = bh / p.H;
  *h = bh % p.H;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Params p,
                   int n_work) {
  using T = Tiles<HD>;
  constexpr int BK = T::BK, NP = T::NP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;  // swizzle period
  const uint32_t sK = sQ + T::Q_SLOTS * T::Q_BYTES;  // STAGES x [panel]
                                                     // [key][128 B]
  const uint32_t sV = sK + STAGES * T::KV_BYTES;
  const uint32_t bars = sV + STAGES * T::KV_BYTES;
  // full and empty Q per slot, then full K, empty K, full V, empty V per
  // stage
  constexpr int QS = T::Q_SLOTS;
#define FULL_Q(s) (bars + 8 * (s))
#define EMPTY_Q(s) (bars + 8 * (QS + (s)))
#define FULL_K(s) (bars + 8 * (2 * QS + (s)))
#define EMPTY_K(s) (bars + 8 * (2 * QS + STAGES + (s)))
#define FULL_V(s) (bars + 8 * (2 * QS + 2 * STAGES + (s)))
#define EMPTY_V(s) (bars + 8 * (2 * QS + 3 * STAGES + (s)))
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < QS; ++s) {
      mbar_init(FULL_Q(s), 1);
      mbar_init(EMPTY_Q(s), 2 * WG);  // every consumer thread releases
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(FULL_K(s), 1);
      mbar_init(EMPTY_K(s), 2 * WG);
      mbar_init(FULL_V(s), 1);
      mbar_init(EMPTY_V(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps Q and the ring full, work after work; n
    // counts K/V tiles across works, as the consumers do
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int n = 0, it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
        int q0, b, h, kbeg, kend;
        work_tile(p, w, &q0, &b, &h);
        const int hk = h / (p.H / p.Hkv);
        key_range(p, q0, BQ, &kbeg, &kend);
        const int kt0 = kbeg / BK, ntiles = (kend + BK - 1) / BK - kt0;
        const int qs = it % QS;
        mbar_wait(EMPTY_Q(qs), ((it / QS) & 1) ^ 1);
        mbar_expect_tx(FULL_Q(qs), 2 * NP * BOX_BYTES);
        for (int c = 0; c < 2; ++c)
          for (int pn = 0; pn < NP; ++pn)
            tma_load(sQ + qs * T::Q_BYTES + (c * NP + pn) * BOX_BYTES, &tq,
                     FULL_Q(qs), pn * PANEL, h, q0 + c * BOX_ROWS, b);
        for (int i = 0; i < ntiles; ++i, ++n) {
          const int s = n % STAGES;
          const uint32_t free_parity = ((n / STAGES) & 1) ^ 1;
          const int k0 = (kt0 + i) * BK;
          mbar_wait(EMPTY_K(s), free_parity);
          load_kv<HD, BK>(&tk, sK + s * T::KV_BYTES, FULL_K(s), hk, k0, b);
          mbar_wait(EMPTY_V(s), free_parity);
          load_kv<HD, BK>(&tv, sV + s * T::KV_BYTES, FULL_V(s), hk, k0, b);
        }
      }
    }
  } else {
    // consumer c: query rows qc0 .. qc0 + 63 of each work, warp w of it
    // rows 16w ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    int n = 0, it = 0;  // K/V tiles and works so far
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      int q0, b, h, kbeg, kend;
      work_tile(p, w, &q0, &b, &h);
      key_range(p, q0, BQ, &kbeg, &kend);
      const int kt0 = kbeg / BK, ntiles = (kend + BK - 1) / BK - kt0;
      const int qc0 = q0 + c * BOX_ROWS;
      const int qr0 = qc0 + warp * 16 + g, qr1 = qr0 + 8;  // this thread's
      const int qslot = it % QS;
      const uint32_t sQc = sQ + qslot * T::Q_BYTES + c * NP * BOX_BYTES;

      // accumulator layout (m64nN): o[4i + e] is row g + 8 (e / 2), column
      // 8i + 2 t4 + (e % 2) of this warp's 16 rows; likewise the scores
      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

      // P_i stays in `pf` until its product is waited for; S_i becomes P_i
      // in place in `sc`. Every wgmma of the loop is issued unconditionally
      // (the first and last tiles are peeled): ptxas serialises wgmmas
      // issued under run-time conditions.
      float sc[BK / 2];
      uint32_t pf[BK / 16][4];
      float c0, c1;
      mbar_wait(FULL_Q(qslot), (it / QS) & 1);
      // tile 0: S_0 alone
      int s = n % STAGES;
      mbar_wait(FULL_K(s), (n / STAGES) & 1);
      wgmma_fence();
      qk_issue<HD, BK>(sc, sQc, sK + s * T::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(EMPTY_K(s));
      softmax_tile<BK>(sc, p, qc0, kt0 * BK, qr0, qr1, t4, m0, m1, l0, l1,
                       c0, c1);
      rescale_pack<HD, BK>(o, pf, sc, c0, c1);
      // tile i: S_i, then P_{i-1} V_{i-1} behind it during S_i's softmax
      for (int i = 1; i < ntiles; ++i) {
        const int sp = s;
        s = (n + i) % STAGES;
        mbar_wait(FULL_K(s), ((n + i) / STAGES) & 1);
        mbar_wait(FULL_V(sp), ((n + i - 1) / STAGES) & 1);
        wgmma_fence();
        qk_issue<HD, BK>(sc, sQc, sK + s * T::KV_BYTES);
        wgmma_commit();
        pv_issue<HD, BK>(o, pf, sV + sp * T::KV_BYTES);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);
        mbar_arrive(EMPTY_K(s));
        softmax_tile<BK>(sc, p, qc0, (kt0 + i) * BK, qr0, qr1, t4, m0, m1,
                         l0, l1, c0, c1);
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(EMPTY_V(sp));
        rescale_pack<HD, BK>(o, pf, sc, c0, c1);
      }
      // the last P V; Q is free for the next work
      mbar_arrive(EMPTY_Q(qslot));
      mbar_wait(FULL_V(s), ((n + ntiles - 1) / STAGES) & 1);
      wgmma_fence();
      pv_issue<HD, BK>(o, pf, sV + s * T::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(EMPTY_V(s));
      n += ntiles;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      l0 = fmaxf(l0, 1e-30f);
      l1 = fmaxf(l1, 1e-30f);
      // the quad's 4 threads hold the same row statistics; one writes them
      if (p.lse != nullptr && t4 == 0) {
        float* lse = p.lse + ((int64_t)b * p.H + h) * p.S;
        if (qr0 < p.S) lse[qr0] = (m0 * p.scale_log2 + log2f(l0)) * LN2;
        if (qr1 < p.S) lse[qr1] = (m1 * p.scale_log2 + log2f(l1)) * LN2;
      }

      // O / l in bf16, each thread's two columns of its two rows straight
      // from the accumulator (the next work's Q may already be loading);
      // rows >= S and columns >= hd are not stored
      __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) +
                         ((int64_t)b * p.S * p.H + h) * p.hd;
      const int64_t qs = (int64_t)p.H * p.hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = j * 8 + t4 * 2;
        if (col < p.hd) {
          if (qr0 < p.S)
            *reinterpret_cast<__nv_bfloat162*>(O + qr0 * qs + col) =
                __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
          if (qr1 < p.S)
            *reinterpret_cast<__nv_bfloat162*>(O + qr1 * qs + col) =
                __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
        }
      }
    }
  }
#undef FULL_Q
#undef EMPTY_Q
#undef FULL_K
#undef EMPTY_K
#undef FULL_V
#undef EMPTY_V
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
  if (p.lse != nullptr && lane == 0 && qi < p.S)
    p.lse[((int64_t)b * p.H + h) * p.S + qi] = (m + log2f(l)) * LN2;
  if (qi < p.S) {
#pragma unroll
    for (int e = 0; e < HD / 32; ++e) {
      const int d = e * 32 + lane;
      if (d < p.hd) O[qi * qs + d] = acc[e] / l;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared-memory limit once per device, not on every
// launch (the attribute belongs to the device's context).
constexpr int MAX_DEVICES = 64;

cudaError_t smem_limit_once(const void* kernel, int bytes,
                            std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// cuTensorMapEncodeTiled, looked up in the driver at run time so that the
// library is not linked against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (hd, heads, S, B) of a bf16 tensor laid out (B, S, heads,
// hd): boxes of one 64-column panel x 64 rows of one head and sequence,
// 128-byte swizzle; reads at rows >= S or columns >= hd give zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int heads, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {PANEL, 1, BOX_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  constexpr int smem = Tiles<HD>::SMEM;
  cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(flash_fwd_bf16<HD>), smem, ready);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = make_map(&tq, p.q, p.B, p.S, p.H, p.hd)) != cudaSuccess ||
      (err = make_map(&tk, p.k, p.B, p.S, p.Hkv, p.hd)) != cudaSuccess ||
      (err = make_map(&tv, p.v, p.B, p.S, p.Hkv, p.hd)) != cudaSuccess)
    return err;
  // Persistent: one CTA per SM walks its share of works, so that each
  // work's loads overlap the last one's epilogue.
  const int n_work = p.B * p.H * ((p.S + BQ - 1) / BQ);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int ctas = n_work < sms ? n_work : sms;
  flash_fwd_bf16<HD><<<ctas, THREADS, smem, stream>>>(tq, tk, tv, p, n_work);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static std::atomic<bool> ready[MAX_DEVICES];
  const int smem = (F_BK * (HD + 1) + F_BK * HD + F_ROWS * HD) * 4;
  cudaError_t err = smem_limit_once(
      reinterpret_cast<const void*>(flash_fwd_f32<HD>), smem, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + F_ROWS - 1) / F_ROWS, p.B * p.H);
  flash_fwd_f32<HD><<<grid, F_ROWS * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int S, int H, int Hkv, int hd, int causal,
           int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || hd <= 0 ||
      hd % 16 || hd > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, lse, B, S, H, Hkv, hd, causal, window,
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

}  // namespace

// dtype: 0 float32, 1 bfloat16. window <= 0: no sliding window.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int hd, int causal,
                                      int window, void* stream) {
  return launch(dtype, q, k, v, o, nullptr, B, S, H, Hkv, hd, causal, window,
                stream);
}

// The same, also writing each row's log-sum-exp into lse (B, H, S) fp32.
extern "C" int flash_attention_lse_launch(int dtype, const void* q,
                                          const void* k, const void* v,
                                          void* o, float* lse, int B, int S,
                                          int H, int Hkv, int hd, int causal,
                                          int window, void* stream) {
  return launch(dtype, q, k, v, o, lse, B, S, H, Hkv, hd, causal, window,
                stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
