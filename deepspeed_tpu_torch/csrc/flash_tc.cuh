// Hopper tensor-core building blocks shared by the bf16 attention bodies:
// flash_fwd_tc.cu (B1) and splash_attn_tc.cu's forward (B8), which run the
// forward's q-tile walk below (tc::fwd::q_tile_walk: TMA loads into a ring
// of stages guarded by mbarriers, wgmma products), flash_bwd_tc.cu (B2:
// cp.async loads, ldmatrix and mma.sync products), flash_bwd_2pass_tc.cu
// (B6a, B6b: the same) and splash_attn_tc.cu's backward (B9a, B9b: the
// same), and the backward's two tile walks (tc::bwd::kv_tile_walk: B2, B6b,
// B9b; tc::bwd::q_tile_walk: B6a, B9a; below).  A walk over key (or q)
// tiles takes them from a source (tc::DenseKTiles, tc::ListTiles,
// tc::bwd::DenseQTiles), so a dense attention and a layout's listed tiles
// run the same loop.  Inline PTX only, so a source that includes this
// header needs no CUTLASS and builds in seconds.
//
// Fragment layouts (a warp's 16 x 8 tile of mma.sync m16n8k16, and each
// warp's 16 rows of a wgmma m64nNk16 tile), with g = lane / 4, t = lane % 4:
//   accumulator: c[0] (g, 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t),
//                c[3] (g + 8, 2t + 1); a wgmma tile of N columns repeats
//                this for each 8-column chunk j at c[4j .. 4j + 3]
//   A (16 x 16, two bf16 a register): a[0] (g, 2t..2t+1), a[1] (g + 8, ..),
//                a[2] (g, 2t+8..2t+9), a[3] (g + 8, 2t+8..2t+9)
//   B (16 x 8):  b[0] (k 2t..2t+1, n g), b[1] (k 2t+8..2t+9, n g)
// so the accumulators of two neighbouring 8-column chunks, rounded to
// bf16 in pairs, are the A operand of the next product (pack_a).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the A fragment of k-step kk from the accumulators of 8-column chunks
// 2kk and 2kk + 1
__device__ __forceinline__ void pack_a(uint32_t* a, const float* c, int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// mbarrier and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity ``parity``
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// a (c0, c1, c2) box of a 3-D tensor map into shared memory, completing
// on ``bar``'s transaction count; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle layout (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin accumulator registers in program order around the asynchronous
// products (the compiler sees the registers written where the wgmma is
// issued, the hardware writes them by its wait)
template <int N> __device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16], A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers, B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N> __device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);
template <> __device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) { wgmma_rs_n16(d, a, db); }
template <> __device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) { wgmma_rs_n32(d, a, db); }
template <> __device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) { wgmma_rs_n64(d, a, db); }
template <> __device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) { wgmma_rs_n128(d, a, db); }

// ---------------------------------------------------------------------------
// cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

// 16 bytes global -> shared; with ``in`` false the destination is zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] * b[16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Key-tile sources of the q-tile walks (tc::fwd::q_tile_walk and
// tc::bwd::q_tile_walk; ListTiles also feeds kv_tile_walk's q tiles): the
// number of tiles, the i-th tile's first row r0(i) and its valid rows n(i).
// A tile with fewer than 64 valid rows (where T or a layout block ends) is
// masked past them: its other rows are zeros past T or the next block's.
// ---------------------------------------------------------------------------

constexpr int kTileRows = 64;  // the rows of every tile the walks move

// a dense attention's key tiles for the q tile at q0, up to the causal bound
// of its last row (end-aligned: query row i sits at key position (sk - sq) + i)
struct DenseKTiles {
  int count, sk;
  __device__ __forceinline__ DenseKTiles(int q0, int sq, int sk_, int causal) : sk(sk_) {
    const int end = causal ? min(sk, max(0, (sk - sq) + q0 + kTileRows)) : sk;
    count = (end + kTileRows - 1) / kTileRows;
  }
  __device__ __forceinline__ int r0(int i) const { return i * kTileRows; }
  __device__ __forceinline__ int n(int i) const { return min(kTileRows, sk - r0(i)); }
};

// tiles listed in shared memory by their first rows, each a 64-row tile of
// a layout block of `block` rows (shorter where the block ends)
struct ListTiles {
  const int* rows;
  int count, block;
  __device__ __forceinline__ int r0(int i) const { return rows[i]; }
  __device__ __forceinline__ int n(int i) const { return min(kTileRows, block - rows[i] % block); }
};

}  // namespace tc

// ---------------------------------------------------------------------------
// The bf16 attention forward's walk (B1, B8): one block of 160 threads owns
// a 64-row q tile and walks the key tiles of a source.  Warp 4 is the
// producer: one lane loads the Q tile once and keeps the source's K/V tiles
// in flight through TMA into a ring of four stages (three at d 128), each
// guarded by a "full" mbarrier (transaction bytes) and an "empty" one (the
// consumers' 128 arrivals).  Warps 0-3 are one consumer warpgroup owning the
// 64 query rows: S = Q.K^T by wgmma m64n64k16 with both operands in shared
// memory; the scale, bias, mask, online softmax (base 2, on the
// special-function unit) and keep factor on the accumulator fragments in
// registers; P rounded to bf16 in registers and used as the A operand of
// O += P.V by wgmma m64n{d}k16 with V read transposed from shared memory.
// The next tile's S and this tile's P.V are issued together, and the next
// tile's softmax runs while P.V is on the tensor cores (FlashAttention-3's
// overlap within a warpgroup); nothing is in flight across an iteration, so
// the compiler keeps the products asynchronous.  Every score stays on chip;
// only tiles with fewer than 64 valid keys or that cross the causal
// diagonal are masked.  Tensor maps are 3-D (d, T, B*H), so any row can
// start a tile (a layout's listed tiles too) and rows past T arrive as
// zeros, never as the next head's rows.  The tiles are stored as TMA writes
// them with the 128-byte swizzle (64-byte at d 32, 32-byte at d 16; d 128
// as two 64-column sub-tiles), and the wgmma descriptors name the same
// swizzle.  The rounding points are flash_fwd_tc.cu's.
// ---------------------------------------------------------------------------

namespace tc {
namespace fwd {

using bf16 = __nv_bfloat16;

constexpr int kBQ = kTileRows;
constexpr int kBK = kTileRows;
constexpr int kThreads = 160;  // one consumer warpgroup and the producer warp

// the shared-memory layout of a 64-row tile of head dim D
template <int D>
struct Tile {
  static constexpr int kW = D > 64 ? 64 : D;                 // columns in a sub-tile
  static constexpr int kRowBytes = kW * 2;                    // the swizzle width
  static constexpr int kSubs = D / kW;                        // sub-tiles (2 at d 128)
  static constexpr int kSubBytes = 64 * kRowBytes;
  static constexpr int kBytes = kSubs * kSubBytes;
  static constexpr uint32_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // K/V ring depth: a stage is released after its P.V, which overlaps the
  // next tile's softmax, so three or four stages keep the loads ahead
  static constexpr int kStages = D > 64 ? 3 : 4;
  // Q, the K/V ring, and the slack that aligns them to 1024 bytes (the
  // swizzle pattern repeats every 1024 bytes); a caller may keep more
  // dynamic shared memory past kSmem
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024;

  // A or B operand stored K-major (d contiguous): the 16 columns of k-step kk
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    const int byte = kk * 32;
    return wgmma_desc(base + (byte / kRowBytes) * kSubBytes + byte % kRowBytes, 16,
                      8 * kRowBytes, kLayout);
  }
  // B operand stored MN-major (V: keys are rows, d contiguous): the 16 keys of k-step kk
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return wgmma_desc(base + kk * 16 * kRowBytes, kSubBytes, 8 * kRowBytes, kLayout);
  }
};

// The walk of one q tile, rows [q0, q0 + qn) of batch*head bh (qn < 64
// where T or a layout block ends: the tile's other rows are computed and
// not written), over the key tiles of `src`, causal end-aligned (query row
// i at key position (sk - sq) + i) or none.  out (B*H, sq, D) bf16 and lse
// (B*H, sq) f32 (may be null); qmap, kmap and vmap are make_map's maps of
// q, k and v.  A source with no tile (a layout row with no block) writes 0
// and lse +inf and loads nothing (its consumers would otherwise wait on a
// stage no load fills).  Launched with kThreads threads and (at least)
// Tile<D>::kSmem bytes of dynamic shared memory.
template <int D, bool EXT, class Src>
__device__ __forceinline__ void q_tile_walk(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                            const CUtensorMap* vmap, bf16* __restrict__ out,
                                            float* __restrict__ lse, const flash::Ext& e, int bh,
                                            int q0, int qn, int sq, int sk, int causal,
                                            float sm_scale, const Src& src) {
  using L = Tile<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], qbar;
  const int tid = threadIdx.x;
  const int n_tiles = src.count;
  if (n_tiles == 0) {
    bf16* rows = out + (static_cast<size_t>(bh) * sq + q0) * D;
    for (int i = tid; i < qn * D; i += kThreads) rows[i] = __float2bfloat16_rn(0.f);
    if (lse != nullptr)
      for (int r = tid; r < qn; r += kThreads) lse[static_cast<size_t>(bh) * sq + q0 + r] = INFINITY;
    return;
  }
  // 1024-byte alignment: the swizzle pattern repeats every 1024 bytes
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + L::kBytes;                 // kStages tiles
  uint8_t* Vs = Ks + kStages * L::kBytes;       // kStages tiles
  const int offset = sk - sq;  // end-aligned causal offset

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(&qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // ---- producer warp: one lane issues every load -------------------------
    if (tid == 128) {
      mbar_arrive_expect_tx(&qbar, L::kBytes);
      for (int sub = 0; sub < L::kSubs; ++sub)
        tma_load_3d(Qs + sub * L::kSubBytes, qmap, &qbar, sub * L::kW, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // the consumers released this stage's previous tile, t - kStages
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) + 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kBytes);
        const int k0 = src.r0(t);
        for (int sub = 0; sub < L::kSubs; ++sub) {
          tma_load_3d(Ks + s * L::kBytes + sub * L::kSubBytes, kmap, &full[s], sub * L::kW, k0,
                      bh);
          tma_load_3d(Vs + s * L::kBytes + sub * L::kSubBytes, vmap, &full[s], sub * L::kW, k0,
                      bh);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows, two a thread ---------------------
  constexpr int NO = D / 2;  // output accumulators a thread holds
  constexpr float kLog2e = 1.4426950408889634f;
  const int warp = tid >> 5, lane = tid & 31;
  const int rA = warp * 16 + (lane >> 2);  // tile rows rA and rA + 8
  const int cq = 2 * (lane & 3);           // first column of the thread's pair in a chunk
  const uint32_t sQ = smem_addr(Qs), sK = smem_addr(Ks), sV = smem_addr(Vs);
  const float scale2 = sm_scale * kLog2e;
  const float* kbias_row = EXT && e.kbias != nullptr ? e.kbias + static_cast<long long>(bh / e.H) * sk
                                                     : nullptr;
  const float* fbias_bh = EXT && e.fbias != nullptr
                              ? e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                                    static_cast<long long>(bh % e.H) * e.fb_h
                              : nullptr;

  // S = Q.K^T of the tile in stage s into sc (f32), issued and committed
  float sc[32];
  auto issue_s = [&](int s) {
    fence_regs<32>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, L::kmajor(sQ, kk), L::kmajor(sK + s * L::kBytes, kk), kk > 0);
    wgmma_commit();
  };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // the softmax state in base 2: m is the row's running max of s * log2(e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  // the key-row bias of the thread's 16 columns of a tile, loaded before
  // the tile's S is issued, so the loads' latency hides under it
  float kbc[16];
  auto load_kbias = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int gk = k0 + 8 * (c >> 1) + cq + (c & 1);
      kbc[c] = gk < sk ? kbias_row[gk] : 0.f;
    }
  };

  // key tile t's softmax on sc: scale, bias, mask, the running max and
  // sum, alpha (the factor O takes before this tile's P.V), and p (times
  // the keep factor) left in sc
  auto softmax = [&](int t) {
    const int k0 = src.r0(t), kend = k0 + src.n(t);  // the tile's valid keys end at kend
    // element i sits at row rA + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + cq + (i & 1)
    const bool edge = k0 + kBK > kend || (causal && k0 + kBK - 1 > offset + q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int row = rA + 8 * h;
      const int kk = 8 * (i >> 2) + cq + (i & 1);
      const int gk = k0 + kk;
      float x;
      if (EXT) {
        x = __fmul_rn(sc[i], sm_scale);
        if (kbias_row != nullptr) {
          x = __fadd_rn(x, kbc[2 * (i >> 2) + (i & 1)]);
        } else if (fbias_bh != nullptr) {
          const int gq = q0 + row;
          x = __fadd_rn(x, gq < sq && gk < sk ? fbias_bh[gq * e.fb_q + gk * e.fb_k] : 0.f);
        }
        x *= kLog2e;
      } else {
        x = sc[i] * scale2;
      }
      // a masked key weighs exactly 0: p = exp2(-inf - m) once the row has
      // a real key, and a row with none yet subtracts 0 (below)
      if (edge && !(gk < kend && (!causal || offset + q0 + row >= gk))) x = -INFINITY;
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float mu[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with no key yet subtracts 0, so its masked scores give 0, not NaN
      mu[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = ex2(m[h] - mu[h]);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = ex2(sc[i] - mu[h]);
      ls[h] += p;  // the softmax statistics take the full p
      float pv = p;
      if (EXT && e.dropout)
        pv = __fmul_rn(p, flash::keep_factor(e, static_cast<uint32_t>(bh), q0 + rA + 8 * h,
                                             k0 + 8 * (i >> 2) + cq + (i & 1), sk));
      sc[i] = pv;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 1);
      ls[h] += __shfl_xor_sync(0xffffffffu, ls[h], 2);
      l[h] = alpha[h] * l[h] + ls[h];
    }
  };

  // O = O * alpha + P.V of key tile t, P (rounded to bf16) the register A
  // operand; issued and committed
  uint32_t pa[4][4];
  auto issue_pv = [&](int t) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, pa[kk], L::mnmajor(sV + (t % kStages) * L::kBytes, kk));
    wgmma_commit();
  };

  // Each step issues the next tile's S and this tile's P.V, then runs the
  // next tile's softmax while P.V is on the tensor cores.  No product is
  // in flight across an iteration, so the compiler can see which group
  // each wait retires and keeps the products asynchronous.
  mbar_wait(&qbar, 0);
  mbar_wait(&full[0], 0);
  if (kbias_row != nullptr) load_kbias(src.r0(0));
  issue_s(0);
  wgmma_wait<0>();
  fence_regs<32>(sc);
  softmax(0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], sc, kk);
  for (int t = 0; t + 1 < n_tiles; ++t) {
    mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
    if (kbias_row != nullptr) load_kbias(src.r0(t + 1));
    issue_s((t + 1) % kStages);
    issue_pv(t);
    wgmma_wait<1>();  // the next S is done; P.V may still run
    fence_regs<32>(sc);
    softmax(t + 1);
    wgmma_wait<0>();  // P.V is done: its registers and its stage are free
    fence_regs<NO>(o);
    mbar_arrive(&empty[t % kStages]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], sc, kk);
  }
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs<NO>(o);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rA + 8 * h;
    if (r >= qn) continue;
    const int gq = q0 + r;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    bf16* orow = out + (static_cast<size_t>(bh) * sq + gq) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + cq) =
          pack_bf16(o[4 * j + 2 * h] / denom, o[4 * j + 2 * h + 1] / denom);
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * sq + gq] =
          l[h] == 0.f ? INFINITY : m[h] * 0.6931471805599453f + logf(fmaxf(l[h], 1e-37f));
  }
}

// ---- host side: tensor maps ------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (no -lcuda at link time)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 3-D map over a (BH, T, D) bf16 tensor, 64-row boxes of the tile's
// sub-tile width, swizzled as the wgmma descriptors read it
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int BH, int T) {
  using L = Tile<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kW), 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = L::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the three maps of a forward's q (BH, sq, D), k and v (BH, sk, D)
template <int D>
int make_maps(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm, const void* q, const void* k,
              const void* v, int BH, int sq, int sk) {
  int err = make_map<D>(qm, q, BH, sq);
  if (!err) err = make_map<D>(km, k, BH, sk);
  if (!err) err = make_map<D>(vm, v, BH, sk);
  return err;
}

}  // namespace fwd
}  // namespace tc

// ---------------------------------------------------------------------------
// The bf16 attention backward's tile code, two walks: kv_tile_walk (one
// block owns a 64-row K/V tile and walks q tiles: B2 with dq, B6b and the
// block-sparse dk/dv pass B9b without) and q_tile_walk (one block owns a
// 64-row q tile and walks key tiles: the dq passes B6a and B9a).  A walk
// takes its tiles from a source, the i-th tile's first row and its valid
// rows: a dense attention's are contiguous (DenseQTiles, in B2's walk
// order, and tc::DenseKTiles); a
// block-sparse one's are the layout's active blocks cut into 64-row tiles
// and listed in shared memory (tc::ListTiles).  A tile of a layout block of 96
// or 16 rows holds fewer than 64 valid rows: its other rows belong to the
// next block, and the walk masks them.  The rounding points are those of
// the f32 body (flash_bwd.cu), stated in flash_bwd_tc.cu.
// ---------------------------------------------------------------------------

namespace tc {
namespace bwd {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;  // four warps
constexpr int kPS = kBK + 8;   // row pitch (elements) of the staged dS^T tile

// a dense attention's q tiles for one key tile in B2's walk order, and the
// key tile's place in each q tile's dq sum (flash_common.cuh's QTileWalk)
struct DenseQTiles {
  flash::QTileWalk w;
  int count, sq;
  __device__ __forceinline__ DenseQTiles(const flash::QTileWalk& w_, int sq_)
      : w(w_), count(w_.m), sq(sq_) {}
  __device__ __forceinline__ int r0(int i) const { return w.tile(i) * kBQ; }
  __device__ __forceinline__ int n(int i) const { return min(kBQ, sq - r0(i)); }
  __device__ __forceinline__ int rank(int i) const { return w.rank(w.tile(i)); }
};

// shared memory of kv_tile_walk: K, V, two buffers of a Q and a dO tile,
// with dq the dS^T tile, then two buffers each of lse and delta
template <int D, bool DQ>
struct Smem {
  static constexpr int kP = D + 8;       // row pitch (elements) of a Q/dO/K/V tile
  static constexpr int kTile = 64 * kP;  // elements of a tile
  static constexpr int kBytes = 2 * (6 * kTile + (DQ ? kBK * kPS : 0)) + 4 * 4 * kBQ;
};

// shared memory of q_tile_walk: the Q and dO tiles, two buffers each of a K
// and a V tile, lse and delta of the q tile, two buffers of a K tile's
// key-row bias
template <int D>
struct DqSmem {
  static constexpr int kP = D + 8;       // row pitch (elements) of a tile
  static constexpr int kTile = 64 * kP;  // elements of a tile
  static constexpr int kBytes = 2 * 6 * kTile + 4 * (2 * kBQ + 2 * kBK);
};

// rows [r0, r0 + 64) of a (T, D) bf16 matrix into a tile of row pitch D + 8,
// 16 bytes a copy by the block's kThreads threads; rows past T zeroed
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int T, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < 64 * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = r0 + r < T;
    const bf16* s = src + static_cast<size_t>(in ? r0 + r : 0) * D + 8 * c;
    cp_async16(dst + r * (D + 8) + 8 * c, s, in);
  }
}

// dV's probability (p times the keep factor) and dS of one score from its S
// and dP, in f32, each step rounded as the f32 body rounds it
struct Probs {
  float pd, ds;
};
template <bool EXT>
__device__ __forceinline__ Probs probs(float s, float dp, float bias, float kf, bool has_bias,
                                       bool drop, float lse, float delta, float sm_scale) {
  float x;
  if (EXT) {
    x = __fmul_rn(s, sm_scale);
    if (has_bias) x = __fadd_rn(x, bias);
  } else {
    x = s * sm_scale;
  }
  const float p = expf(x - lse);
  float pd = p;
  if (EXT && drop) {
    pd = __fmul_rn(p, kf);
    dp = __fmul_rn(dp, kf);
  }
  return {pd, p * (dp - delta) * sm_scale};
}

// One block of four warps owns one K/V tile (rows [k0, k0 + kn) of
// batch*head bh, kn < 64 where T or a layout block ends): K and V stay in
// shared memory while the block walks the q tiles of `src`, the next q
// tile's Q, dO, lse and delta loading by cp.async while the current one
// computes (across a layout's edges too: the next listed tile).  Warp w
// owns keys 16w..16w+15:
//   S^T = K.Q^T and dP^T = V.dO^T (16 x 64 each, f32 accumulators);
//   P^T and dS^T formed on those accumulators with the bias, mask, lse,
//   delta and keep factor, then rounded to bf16 in registers;
//   dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
//   operands (the accumulator layout of two 8-column chunks is the A
//   layout of one 16-deep step), dk and dv held in registers;
//   with DQ (B2): dS^T staged to shared memory, and dQ += dS.K for q rows
//   16w..16w+15, added into the f32 buffer dq32 by vector reductions in
//   L2 in the q tile's turn (dq_turn, flash_common.cuh): the key tiles add
//   into a q tile in a fixed order (src.rank), so dq's sum is the same
//   every run.  Without DQ (B6b, B9b) dq32 and dq_turn are not read.
// With dropout (DROP, a template flag) a tile's 32 keep-bits a thread are
// formed first, into one word, in the same straight-line block as the S^T
// and dP^T products: integer work with no operand from the products, so
// it issues while the tensor cores run (Threefry, not the products, is
// the floor).  Rows of every tile are padded by 16 bytes so ldmatrix's
// eight rows fall in different banks.  A score counts where its query row
// and key lie in their tiles' valid rows (and, causal, (sk - sq) + gq >=
// gk); only tiles that cross the diagonal or hold fewer than 64 valid rows
// are masked, so any T and any layout block is served; rows past T load as
// zeros.  At the end `out(kk, c, dk_c, dk_c1, dv_c, dv_c1)` takes the f32
// sums of columns c, c + 1 of each of this thread's key rows kk < kn.
// Launched with kThreads threads and (at least) Smem<D, DQ>::kBytes of
// dynamic shared memory.
template <int D, bool EXT, bool DROP, bool DQ, class Src, class Out>
__device__ __forceinline__ void kv_tile_walk(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v,
                                             const bf16* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, const flash::Ext& e,
                                             float* __restrict__ dq32, int* __restrict__ dq_turn,
                                             int bh, int k0, int kn, int sq, int sk, int causal,
                                             float sm_scale, const Src& src, Out out) {
  using S = Smem<D, DQ>;
  constexpr int P = S::kP;
  constexpr int ND = D / 8;  // 8-column chunks of a d-wide accumulator
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + S::kTile;
  bf16* Qs = Vs + S::kTile;        // two buffers, each a Q tile then a dO tile
  bf16* dOs = Qs + S::kTile;
  bf16* dSt = Qs + 4 * S::kTile;   // with DQ: kBK x kPS, dS^T, keys as rows
  float* lse_s = reinterpret_cast<float*>(dSt + (DQ ? kBK * kPS : 0));  // two buffers of kBQ
  float* delta_s = lse_s + 2 * kBQ;                                     // two buffers of kBQ

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int kw = 16 * warp;  // this warp's keys in the tile (and q rows for dQ)
  // ldmatrix addressing: the row and column a lane points at
  const int lrA = (lane & 7) + 8 * ((lane >> 3) & 1), lcA = 8 * (lane >> 4);  // A, row-major
  const int lrB = (lane & 7) + 8 * (lane >> 4), lcB = 8 * ((lane >> 3) & 1);  // B from [n][k]
  const bf16* qb = q + static_cast<size_t>(bh) * sq * D;
  const bf16* dob = dout + static_cast<size_t>(bh) * sq * D;
  const float* lseb = lse + static_cast<size_t>(bh) * sq;
  const float* deltab = delta + static_cast<size_t>(bh) * sq;
  const int offset = sk - sq;  // end-aligned causal offset

  auto load_q_tile = [&](int i, int buf) {
    const int q0 = src.r0(i);
    load_tile<D>(Qs + 2 * buf * S::kTile, qb, q0, sq, tid);
    load_tile<D>(dOs + 2 * buf * S::kTile, dob, q0, sq, tid);
    const int r = tid & 63;
    const bool in = q0 + r < sq;
    if (tid < 64)
      cp_async4(lse_s + buf * kBQ + r, lseb + (in ? q0 + r : 0), in);
    else
      cp_async4(delta_s + buf * kBQ + r, deltab + (in ? q0 + r : 0), in);
  };

  load_tile<D>(Ks, k + static_cast<size_t>(bh) * sk * D, k0, sk, tid);
  load_tile<D>(Vs, v + static_cast<size_t>(bh) * sk * D, k0, sk, tid);
  if (src.count > 0) load_q_tile(0, 0);
  cp_async_commit();

  // the key-row bias of this thread's two keys (rows g and g + 8 of its warp's 16)
  float kbv[2] = {0.f, 0.f};
  if (EXT && e.kbias != nullptr) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gk = k0 + kw + g + 8 * hh;
      kbv[hh] = gk < sk ? e.kbias[static_cast<long long>(bh / e.H) * sk + gk] : 0.f;
    }
  }
  const float* fbias_bh = EXT && e.fbias != nullptr
                              ? e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                                    static_cast<long long>(bh % e.H) * e.fb_h
                              : nullptr;
  const bool has_bias = EXT && (e.kbias != nullptr || e.fbias != nullptr);

  float dk_acc[ND * 4], dv_acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // with DQ, the q tile turn this block holds (its dq added), passed on
  // at the next barrier: every warp's adds come before that barrier, so
  // the release store after it makes them visible before the counter moves
  int* held = nullptr;
  int held_rank = 0;
  for (int i = 0; i < src.count; ++i) {
    const int buf = i & 1;
    const int q0 = src.r0(i), qn = src.n(i);
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (DQ && tid == 0 && held != nullptr) flash::st_release(held, held_rank + 1);
    if (i + 1 < src.count) {
      load_q_tile(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* Qt = Qs + 2 * buf * S::kTile;
    const bf16* dOt = dOs + 2 * buf * S::kTile;
    const float* lse_t = lse_s + buf * kBQ;
    const float* delta_t = delta_s + buf * kBQ;

    // element i of this thread's 32 scores sits at key kw + g + 8 * ((i >>
    // 1) & 1), query 8 * (i >> 2) + t2 + (i & 1) of the tiles; the
    // keep-bits first
    uint32_t keep = 0;
    if (DROP) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int gq = q0 + 8 * (j >> 2) + t2 + (j & 1);
        const int gk = k0 + kw + g + 8 * ((j >> 1) & 1);
        keep |= static_cast<uint32_t>(flash::keep_bit(e, static_cast<uint32_t>(bh), gq, gk, sk))
                << j;
      }
    }

    // S^T = K.Q^T and dP^T = V.dO^T for this warp's 16 keys x 64 queries
    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, Ks + (kw + lrA) * P + 16 * kd + lcA);
      ldsm_x4(va, Vs + (kw + lrA) * P + 16 * kd + lcA);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        ldsm_x4(b, Qt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        mma_bf16(st + 8 * n2, ka, b);
        mma_bf16(st + 8 * n2 + 4, ka, b + 2);
        ldsm_x4(b, dOt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        mma_bf16(dpt + 8 * n2, va, b);
        mma_bf16(dpt + 8 * n2 + 4, va, b + 2);
      }
    }

    // P^T (times keep, into st) and dS^T (into dpt)
    const bool edge = qn < kBQ || kn < kBK || (causal && offset + q0 < k0 + kBK - 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hh = (j >> 1) & 1;
      const int qq = 8 * (j >> 2) + t2 + (j & 1), kk = kw + g + 8 * hh;
      const int gq = q0 + qq, gk = k0 + kk;
      const bool ok = !edge || (qq < qn && kk < kn && (!causal || offset + gq >= gk));
      float bias = 0.f;
      if (EXT) {
        if (e.kbias != nullptr)
          bias = hh ? kbv[1] : kbv[0];
        else if (fbias_bh != nullptr && gq < sq && gk < sk)
          bias = fbias_bh[gq * e.fb_q + gk * e.fb_k];
      }
      const float kf = DROP && !((keep >> j) & 1u) ? 0.f : e.inv_keep;
      // a masked score is the Pallas kernel's DEFAULT_MASK_VALUE, whose
      // exp(mask - lse) is 0 for every finite lse
      const Probs r = ok ? probs<EXT>(st[j], dpt[j], bias, kf, has_bias, DROP, lse_t[qq],
                                      delta_t[qq], sm_scale)
                         : Probs{0.f, 0.f};
      st[j] = r.pd;
      dpt[j] = r.ds;
    }

    if constexpr (DQ) {
      // dS^T rounded to bf16 into this warp's 16 rows of the dS^T tile
      // (keys as rows, queries as columns), for dQ
      bf16* Tw = dSt + kw * kPS;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<uint32_t*>(Tw + g * kPS + 8 * c + t2) =
            pack_bf16(dpt[4 * c], dpt[4 * c + 1]);
        *reinterpret_cast<uint32_t*>(Tw + (g + 8) * kPS + 8 * c + t2) =
            pack_bf16(dpt[4 * c + 2], dpt[4 * c + 3]);
      }
    }

    // dV += P^T.dO, then dK += dS^T.Q (B = dO / Q read transposed), P^T and
    // dS^T rounded to bf16 as register A operands
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t pa[4], sa[4];
      pack_a(pa, st, kq);
      pack_a(sa, dpt, kq);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4_t(b, dOt + (16 * kq + lrA) * P + 16 * n2 + lcA);
        mma_bf16(dv_acc + 8 * n2, pa, b);
        mma_bf16(dv_acc + 8 * n2 + 4, pa, b + 2);
        ldsm_x4_t(b, Qt + (16 * kq + lrA) * P + 16 * n2 + lcA);
        mma_bf16(dk_acc + 8 * n2, sa, b);
        mma_bf16(dk_acc + 8 * n2 + 4, sa, b + 2);
      }
    }

    if constexpr (DQ) {
      __syncthreads();  // dS^T is whole

      // dQ[16 rows of this warp] += dS.K, into the f32 buffer
      float dq_acc[ND * 4];
#pragma unroll
      for (int j = 0; j < ND * 4; ++j) dq_acc[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t sa[4];
        ldsm_x4_t(sa, dSt + (16 * kk + lrB) * kPS + kw + lcB);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          ldsm_x4_t(b, Ks + (16 * kk + lrA) * P + 16 * n2 + lcA);
          mma_bf16(dq_acc + 8 * n2, sa, b);
          mma_bf16(dq_acc + 8 * n2 + 4, sa, b + 2);
        }
      }
      // in this q tile's turn, add the warp's 16 rows into the f32 buffer
      // (vector reductions in L2); the turn is passed on at the next
      // barrier, which spares the hand-off a barrier of its own and lets
      // the other warps start the next tile while the release waits for the
      // adds to land
      float* dqb = dq32 + static_cast<size_t>(bh) * sq * D;
      int* turn = dq_turn + static_cast<size_t>(bh) * ((sq + kBQ - 1) / kBQ) + q0 / kBQ;
      const int rank = src.rank(i);
      flash::wait_turn(turn, rank);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (kw + g + 8 * hh < qn) {
          float* row = dqb + static_cast<size_t>(q0 + kw + g + 8 * hh) * D + t2;
#pragma unroll
          for (int n = 0; n < ND; ++n)
            atomicAdd(reinterpret_cast<float2*>(row + 8 * n),
                      make_float2(dq_acc[4 * n + 2 * hh], dq_acc[4 * n + 2 * hh + 1]));
        }
      held = turn;
      held_rank = rank;
    }
  }
  if constexpr (DQ) {
    __syncthreads();
    if (tid == 0 && held != nullptr) flash::st_release(held, held_rank + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kk = kw + g + 8 * hh;
    if (kk < kn) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
        out(kk, 8 * n + t2, dk_acc[4 * n + 2 * hh], dk_acc[4 * n + 2 * hh + 1],
            dv_acc[4 * n + 2 * hh], dv_acc[4 * n + 2 * hh + 1]);
    }
  }
}

// dk and dv of kv_tile_walk rounded to bf16 into (BH, T, D) rows k0 + kk
// of batch*head bh (B2, B6b, and a column of B9b held by one item)
template <int D>
struct StoreDkv {
  bf16 *dk, *dv;
  __device__ __forceinline__ StoreDkv(bf16* dk_, bf16* dv_, int bh, int k0, int T)
      : dk(dk_ + (static_cast<size_t>(bh) * T + k0) * D),
        dv(dv_ + (static_cast<size_t>(bh) * T + k0) * D) {}
  __device__ __forceinline__ void operator()(int kk, int c, float k_lo, float k_hi, float v_lo,
                                             float v_hi) const {
    *reinterpret_cast<uint32_t*>(dk + kk * D + c) = pack_bf16(k_lo, k_hi);
    *reinterpret_cast<uint32_t*>(dv + kk * D + c) = pack_bf16(v_lo, v_hi);
  }
};

// One block of four warps owns one q tile (rows [q0, q0 + qn) of
// batch*head bh, qn < 64 where T or a layout block ends): Q, dO, lse and
// delta stay in shared memory while the block walks the key tiles of `src`,
// the next K/V tile (and its key-row bias) loading by cp.async while the
// current one computes (across a layout's edges too: the next listed
// tile).  Warp w owns q rows 16w..16w+15:
//   S = Q.K^T and dP = dO.V^T (16 x 64 each, f32 accumulators);
//   dS = p (dp keep - delta) scale formed on them with the bias, mask,
//   lse, delta and keep-bits, rounded to bf16 in registers;
//   dQ += dS.K with dS as the register A operand and K's B fragments by
//   ldmatrix.trans, dq summed in registers (D / 2 floats a thread) in the
//   source's order and rounded to bf16 once into dq's rows q0 + qq, qq < qn:
//   no atomics, so the same bits every launch.
// Masking as kv_tile_walk's.  Launched with kThreads threads and (at
// least) DqSmem<D>::kBytes of dynamic shared memory.
template <int D, bool EXT, bool DROP, class Src>
__device__ __forceinline__ void q_tile_walk(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const bf16* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, const flash::Ext& e,
                                            bf16* __restrict__ dq, int bh, int q0, int qn, int sq,
                                            int sk, int causal, float sm_scale, const Src& src) {
  using S = DqSmem<D>;
  constexpr int P = S::kP;
  constexpr int ND = D / 8;  // 8-column chunks of a d-wide accumulator
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + S::kTile;
  bf16* Ks = dOs + S::kTile;  // two buffers, each a K tile then a V tile
  bf16* Vs = Ks + S::kTile;
  float* lse_s = reinterpret_cast<float*>(Qs + 6 * S::kTile);  // kBQ
  float* delta_s = lse_s + kBQ;                                // kBQ
  float* kb_s = delta_s + kBQ;                                 // two buffers of kBK

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int qw = 16 * warp;  // this warp's q rows in the tile
  // ldmatrix addressing: the row and column a lane points at
  const int lrA = (lane & 7) + 8 * ((lane >> 3) & 1), lcA = 8 * (lane >> 4);  // A, row-major
  const int lrB = (lane & 7) + 8 * (lane >> 4), lcB = 8 * ((lane >> 3) & 1);  // B from [n][k]
  const bf16* kb = k + static_cast<size_t>(bh) * sk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * sk * D;
  const float* kbias_b =
      EXT && e.kbias != nullptr ? e.kbias + static_cast<long long>(bh / e.H) * sk : nullptr;
  const float* fbias_bh = EXT && e.fbias != nullptr
                              ? e.fbias + static_cast<long long>(bh / e.H) * e.fb_b +
                                    static_cast<long long>(bh % e.H) * e.fb_h
                              : nullptr;
  const bool has_bias = EXT && (e.kbias != nullptr || e.fbias != nullptr);
  const int offset = sk - sq;  // end-aligned causal offset

  auto load_kv_tile = [&](int i, int buf) {
    const int k0 = src.r0(i);
    load_tile<D>(Ks + 2 * buf * S::kTile, kb, k0, sk, tid);
    load_tile<D>(Vs + 2 * buf * S::kTile, vb, k0, sk, tid);
    if (kbias_b != nullptr && tid < kBK) {
      const bool in = k0 + tid < sk;
      cp_async4(kb_s + buf * kBK + tid, kbias_b + (in ? k0 + tid : 0), in);
    }
  };

  {
    load_tile<D>(Qs, q + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
    load_tile<D>(dOs, dout + static_cast<size_t>(bh) * sq * D, q0, sq, tid);
    const int r = tid & 63;
    const bool in = q0 + r < sq;
    const size_t row = static_cast<size_t>(bh) * sq + (in ? q0 + r : 0);
    if (tid < 64)
      cp_async4(lse_s + r, lse + row, in);
    else
      cp_async4(delta_s + r, delta + row, in);
  }
  if (src.count > 0) load_kv_tile(0, 0);
  cp_async_commit();

  float dq_acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) dq_acc[i] = 0.f;

  for (int i = 0; i < src.count; ++i) {
    const int buf = i & 1;
    const int k0 = src.r0(i), kn = src.n(i);
    cp_async_wait<0>();
    __syncthreads();  // tile i has landed; every warp is done with tile i - 1
    if (i + 1 < src.count) {
      load_kv_tile(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* Kt = Ks + 2 * buf * S::kTile;
    const bf16* Vt = Vs + 2 * buf * S::kTile;
    const float* kbt = kb_s + buf * kBK;

    // element j of this thread's 32 scores sits at q row qw + g + 8 * ((j
    // >> 1) & 1), key 8 * (j >> 2) + t2 + (j & 1) of the tile.  The
    // keep-bits first: integer work with no operand from the products, in
    // one block with them, so it issues while the tensor cores run
    uint32_t keep = 0;
    if (DROP) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int gq = q0 + qw + g + 8 * ((j >> 1) & 1);
        const int gk = k0 + 8 * (j >> 2) + t2 + (j & 1);
        keep |= static_cast<uint32_t>(flash::keep_bit(e, static_cast<uint32_t>(bh), gq, gk, sk))
                << j;
      }
    }

    // S = Q.K^T and dP = dO.V^T for this warp's 16 q rows x 64 keys
    float s[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, Qs + (qw + lrA) * P + 16 * kd + lcA);
      ldsm_x4(da, dOs + (qw + lrA) * P + 16 * kd + lcA);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        ldsm_x4(b, Kt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        mma_bf16(s + 8 * n2, qa, b);
        mma_bf16(s + 8 * n2 + 4, qa, b + 2);
        ldsm_x4(b, Vt + (16 * n2 + lrB) * P + 16 * kd + lcB);
        mma_bf16(dp + 8 * n2, da, b);
        mma_bf16(dp + 8 * n2 + 4, da, b + 2);
      }
    }

    // dS (into dp)
    const bool edge = qn < kBQ || kn < kBK || (causal && offset + q0 < k0 + kBK - 1);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qq = qw + g + 8 * ((j >> 1) & 1);
      const int kk = 8 * (j >> 2) + t2 + (j & 1);
      const int gq = q0 + qq, gk = k0 + kk;
      const bool ok = !edge || (qq < qn && kk < kn && (!causal || offset + gq >= gk));
      float bias = 0.f;
      if (EXT) {
        if (kbias_b != nullptr)
          bias = kbt[kk];
        else if (fbias_bh != nullptr && gq < sq && gk < sk)
          bias = fbias_bh[gq * e.fb_q + gk * e.fb_k];
      }
      const float kf = DROP && !((keep >> j) & 1u) ? 0.f : e.inv_keep;
      // a masked score is the Pallas kernel's DEFAULT_MASK_VALUE, whose
      // exp(mask - lse) is 0 for every finite lse
      dp[j] = ok ? probs<EXT>(s[j], dp[j], bias, kf, has_bias, DROP, lse_s[qq], delta_s[qq],
                              sm_scale).ds
                 : 0.f;
    }

    // dQ += dS.K (B = K read transposed), dS rounded to bf16 as the
    // register A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      pack_a(sa, dp, kk);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldsm_x4_t(b, Kt + (16 * kk + lrA) * P + 16 * n2 + lcA);
        mma_bf16(dq_acc + 8 * n2, sa, b);
        mma_bf16(dq_acc + 8 * n2 + 4, sa, b + 2);
      }
    }
  }
  cp_async_wait<0>();

  // dq rounded to bf16 once
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qq = qw + g + 8 * hh;
    if (qq < qn) {
      bf16* row = dq + (static_cast<size_t>(bh) * sq + q0 + qq) * D + t2;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<uint32_t*>(row + 8 * n) =
            pack_bf16(dq_acc[4 * n + 2 * hh], dq_acc[4 * n + 2 * hh + 1]);
    }
  }
}

}  // namespace bwd
}  // namespace tc
