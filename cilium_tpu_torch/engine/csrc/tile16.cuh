// Shared pieces of the two tensor-core scans (K1 nfa_scan.cu, K2
// dfa_oblivious.cu): the flow tile, the mma.sync / ldmatrix wrappers
// with their fragment layouts, and the prologue's asynchronous copies
// of the bytes, lengths and tables into shared memory.
//
// Flow tile: a warp owns 16 flows, the M rows of one
// mma.sync.m16n8k16 (fp16 operands, fp32 accumulators); a CTA holds
// kWarps warps. Lane l of a warp works on rows g = l / 4 and g + 8 of
// its tile, and on the fragment columns 2q, 2q + 1 (q = l % 4) of
// every 8-column n-tile:
//
//   A (16x16, fp16): reg 0 = row g,   cols 2q, 2q+1   (low half first)
//                    reg 1 = row g+8, cols 2q, 2q+1
//                    reg 2 = row g,   cols 2q+8, 2q+9
//                    reg 3 = row g+8, cols 2q+8, 2q+9
//   C (16x8, fp32):  c0, c1 = row g, cols 2q, 2q+1; c2, c3 = row g+8
//
// so the accumulators of two neighbouring n-tiles hold, lane by lane,
// exactly the elements of one k16 A fragment. B fragments come from
// shared memory, where the tables are stored row-major [k][n] with a
// row stride of an odd number of 16-byte chunks (conflict-free
// ldmatrix); ldmatrix.trans turns those rows into the column pairs the
// B operand wants.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile16 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kFlows = 16 * kWarps;      // flows per CTA
constexpr int kChunk = 256;              // bytes per flow staged at a time
constexpr uint16_t kOne = 0x3C00u;       // fp16 1.0
constexpr int kScratchWords = 16384;     // 64 KB of raw table per round trip

// Row stride, in halves, of a table n halves wide: an odd number of
// 16-byte chunks, so the 8 rows one ldmatrix reads hit 8 different
// bank groups.
__host__ __device__ inline int row_stride(int n) {
  return (((n + 7) / 8) | 1) * 8;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Two fp16 0/1 values in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack01(bool lo, bool hi) {
  return (lo ? (uint32_t)kOne : 0u) | (hi ? (uint32_t)kOne << 16 : 0u);
}

__device__ __forceinline__ bool half_lo(uint32_t r) { return (r & 0xffffu) != 0; }
__device__ __forceinline__ bool half_hi(uint32_t r) { return (r >> 16) != 0; }

// The one-hot A fragment of k-step ks for rows whose value is v0 (row g)
// and v1 (row g+8): element (row, col) = [value == ks*16 + col]. Lane q
// holds columns 2q, 2q+1 (registers 0, 1) and 2q+8, 2q+9 (2, 3), so
// the value lands in this lane's register 0/1 of k-step ks exactly when
// (v - 2q) >> 1 == 8 ks, in register 2/3 when it is 8 ks + 4, and in
// the high half when v is odd (a negative v - 2q matches nothing).
__device__ __forceinline__ void onehot_frag(uint32_t (&a)[4], int v0, int v1,
                                            int ks, int q) {
  const int p0 = (v0 - 2 * q) >> 1, p1 = (v1 - 2 * q) >> 1;
  const uint32_t h0 = v0 & 1 ? (uint32_t)kOne << 16 : kOne;
  const uint32_t h1 = v1 & 1 ? (uint32_t)kOne << 16 : kOne;
  a[0] = p0 == 8 * ks ? h0 : 0u;
  a[1] = p1 == 8 * ks ? h1 : 0u;
  a[2] = p0 == 8 * ks + 4 ? h0 : 0u;
  a[3] = p1 == 8 * ks + 4 ? h1 : 0u;
}

// d += a . b on the tensor cores (m16n8k16, fp16 in, fp32 accumulate).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two neighbouring n-tiles: rows k0..k0+15, cols
// n0..n0+15. Lane l passes the address of row k0 + (l & 15), col
// n0 + (l >> 4) * 8; b[0], b[1] feed n-tile n0 and b[2], b[3] n0 + 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&b)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying n 4-byte words to shared memory, all in flight at once.
__device__ __forceinline__ void copy_async4(void* dst, const void* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    cp_async4(static_cast<uint32_t*>(dst) + i,
              static_cast<const uint32_t*>(src) + i);
}

// put(i0 + e / cols, e % cols, scr[e]) for the n < 2^16 words at scr:
// eight reads in flight per thread, then eight puts (the compiler cannot
// move a read of scr past a store to another shared table by itself),
// and e / cols as a multiply-high, exact for e < 2^16 and 1 < cols <= 256.
template <typename T, typename F>
__device__ __forceinline__ void put_rows(const T* scr, int i0, int n, int cols,
                                         F put) {
  constexpr int kBatch = 8;
  const uint32_t inv = 0xffffffffu / cols + 1;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      v[u] = e < n ? scr[e] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int i = cols == 1 ? e : (int)__umulhi((uint32_t)e, inv);
      if (e < n) put(i0 + i, e - i * cols, v[u]);
    }
  }
}

// Convert a [rows x cols] row-major table of 4-byte words from global
// memory: the rows pass through scr (kScratchWords words) in pieces,
// each piece one round trip with all its copies in flight (a table read
// one load at a time per thread would pay the round trip per element);
// put(i, j, word) stores the converted entry. All threads call it; it
// ends with a __syncthreads.
template <typename T, typename F>
__device__ __forceinline__ void convert_table(const T* src, int rows, int cols,
                                              T* scr, F put) {
  const int R = max(1, kScratchWords / cols);
  for (int i0 = 0; i0 < rows; i0 += R) {
    const int nr = min(R, rows - i0);
    copy_async4(scr, src + (size_t)i0 * cols, nr * cols);
    cp_commit();
    stage_wait();
    __syncthreads();
    put_rows(scr, i0, nr * cols, cols, put);
    __syncthreads();
  }
}

// Start staging bytes [t0, t0 + lt) of the CTA's flows b0 .. b0 +
// kFlows - 1 into dst[r * lt + c] (dst 16-byte aligned). When the chunk
// is the whole row, the CTA's rows are one contiguous run of global
// memory, copied with 16-byte cp.async where the source is aligned (the
// copy completes at stage_wait, after a cp_commit); otherwise, and for
// the unaligned tail, with plain loads. Rows past B are not read (their
// length is staged as 0). Call stage_wait and then __syncthreads before
// reading dst.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* data,
                                            int b0, int B, int L, int t0,
                                            int lt) {
  const int rows = min(kFlows, B - b0);
  if (lt == L) {
    const uint8_t* src = data + (size_t)b0 * L;
    const int n = rows * L;
    const int nv = ((uintptr_t)src & 15) == 0 ? n / 16 : 0;
    for (int i = threadIdx.x; i < nv; i += kThreads)
      cp_async16(dst + 16 * i, src + 16 * i);
    for (int i = 16 * nv + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
  } else {
    for (int r = threadIdx.x / 32; r < rows; r += kWarps)
      for (int c = threadIdx.x % 32; c < lt; c += 32)
        dst[r * lt + c] = data[(size_t)(b0 + r) * L + t0 + c];
  }
}

// Start copying the bank's 256-entry byteclass table and the CTA's
// lengths (0 past B) to shared memory.
__device__ __forceinline__ void stage_small(int32_t* cls, int32_t* slen,
                                            const int32_t* byteclass,
                                            const int32_t* lengths, int b0,
                                            int B) {
  copy_async4(cls, byteclass, 256);
  const int rows = min(kFlows, B - b0);
  copy_async4(slen, lengths + b0, rows);
  for (int i = rows + threadIdx.x; i < kFlows; i += kThreads) slen[i] = 0;
}

}  // namespace tile16
