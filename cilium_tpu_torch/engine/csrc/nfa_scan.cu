// K1 — bitset-NFA byte scan ("rules as lanes") on the tensor cores,
// for sm_90a.
//
// Replaces: the reference's engine/pallas_nfa.py nfa_finals_pallas
// (body _nfa_kernel), which advances the position set with two MXU
// matmuls per byte:  D' = ((Follow^T . D) > 0) * (AccCls . onehot(c)).
//
// Function: for every (bank, flow), the final set of live NFA
// positions after the flow's bytes, as [NB, B, P] float32 0/1. Byte 0
// seeds start AND acc[class]; a byte at t >= length holds the set
// unchanged; a zero-length flow ends with the empty set (the plain
// version's convention: callers replace its accept words by the
// empty-string words either way).
//
// Bound on this card: the per-byte dependency chain through the
// tensor cores. Each byte needs the previous byte's set; the tables fit
// in shared memory and at B = 8192 the bytes moved are a few MB, so a
// byte step costs its product's latency: D . Follow for 64 flows, then
// the threshold that makes the next operand.
// Design: the reference's two products, on the tensor cores. A CTA is
// one warpgroup of 4 warps and owns 64 flows, 16 per warp (the M rows
// of an mma.m16n8k16 tile). Per byte:
//   pre[64 x PP] = D . Follow      one wgmma.m64nPPk16 per 16 positions,
//                                  Follow read from shared memory;
//   am[16 x PP] = onehot(class) . AccCls^T   per warp, mma.sync, while
//                                  the wgmma runs: the reference's own
//                                  second product, in place of a
//                                  class-indexed row read;
//   D' = (pre > 0) & (am > 0), held where t >= length.
// Both tables are fp16 0/1 in shared memory, zero-padded to PP =
// 16*ceil(P/16) positions and KC = 16*ceil(K/16) classes. The fp32
// accumulators of two neighbouring n8 blocks have the lane layout of one
// k16 A fragment, so D stays in registers, as the fp16 A operand, from
// byte to byte, and the finals are written from it once, through shared
// memory, with coalesced stores. Operands are 0/1 and sums count at
// most 128 ones, exact in fp32. The prologue copies the raw tables, the
// CTA's bytes and lengths and the class table with cp.async, all in
// flight at once, and converts the tables in shared memory. The class
// comes from the 256-entry byteclass table in shared memory, read by
// the byte's value. No branch, trip count or other table address
// depends on a byte, a position set or a length.
//
// This replaces the port's first K1 kernel, a bit-word scan (one thread
// per flow, 32*NW row selects of NW = ceil(P/32) words per byte:
// 0.09613 ms per launch at the http-1000 host stack, P = 108, B = 8192,
// on an H100 80GB HBM3 at 700 W, chip_smoke.py).

#include "wgmma.cuh"

namespace {

using namespace tile16;

constexpr int kMaxPositions = 128;
constexpr int kMaxClasses = 256;

// Two fp32 counts as the fp16 pair [count > 0]: the counts are
// non-negative integers, so min(count, 1) is exactly that 0/1.
__device__ __forceinline__ uint32_t positive_pair(float lo, float hi) {
  const __half2 h = __hmin2(__floats2half2_rn(lo, hi), __float2half2_rn(1.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// [m > 0] as A fragments: register r of k-step np takes n8 block
// 2*np + r/2, row g (r even) or g+8 (r odd), of the accumulators.
template <int KS>
__device__ __forceinline__ void positive_frags(uint32_t (&out)[KS][4],
                                               const float (&m)[KS][2][4]) {
#pragma unroll
  for (int np = 0; np < KS; ++np)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[np][r] = positive_pair(m[np][r >> 1][2 * (r & 1)],
                                 m[np][r >> 1][2 * (r & 1) + 1]);
}

// [onehot(class) . AccCls^T > 0]: KC/16 k-steps x PP/8 n-tiles
template <int KS>
__device__ __forceinline__ void class_frags(uint32_t (&am)[KS][4], int c0,
                                            int c1, int KCS,
                                            uint32_t acc_lane, int LD,
                                            int q) {
  float m[KS][2][4];
#pragma unroll
  for (int np = 0; np < KS; ++np)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[np][0][e] = m[np][1][e] = 0.f;
  for (int kc = 0; kc < KCS; ++kc) {
    uint32_t oh[4];
    onehot_frag(oh, c0, c1, kc, q);
#pragma unroll
    for (int np = 0; np < KS; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, acc_lane + (kc * 16 * LD + np * 16) * 2);
      mma16816(m[np][0], oh, b[0], b[1]);
      mma16816(m[np][1], oh, b[2], b[3]);
    }
  }
  positive_frags<KS>(am, m);
}

template <int KS>  // k-steps: PP = 16 * KS padded positions
__global__ void __launch_bounds__(kThreads)
nfa_scan_kernel(const float* __restrict__ follow,       // [NB, P, P]
                const float* __restrict__ acc_cls,      // [NB, P, K]
                const int32_t* __restrict__ byteclass,  // [NB, 256]
                const float* __restrict__ start,        // [NB, P]
                const uint8_t* __restrict__ data,       // [B, L]
                const int32_t* __restrict__ lengths,    // [B]
                float* __restrict__ finals,             // [NB, B, P]
                int NB, int P, int K, int B, int L) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(16) int32_t cls[256];
  __shared__ __align__(16) int32_t slen[kFlows];
  constexpr int PP = 16 * KS;
  constexpr int SBO = PP / 8 * 128;        // n-block stride of Follow
  const int LD = row_stride(PP);
  const int KCS = (K + 15) / 16;
  uint8_t* fol = smem;                     // Follow, K-major [PP][PP]
  uint16_t* acct = reinterpret_cast<uint16_t*>(smem + PP * PP * 2);
  const int tables = PP * PP * 2 + 16 * KCS * LD * 2;  // + acc^T [16*KCS][LD]
  uint8_t* bytes = smem + align16(tables);
  float* scr = reinterpret_cast<float*>(                      // raw tables
      bytes + align16((size_t)kFlows * min(L, kChunk)));
  const int bank = blockIdx.y;
  const int b0 = blockIdx.x * kFlows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // every global read of the prologue in flight at once: the first
  // chunk's bytes, the class table, the lengths, then the tables
  if (L > 0) stage_bytes(bytes, data, b0, B, L, 0, min(kChunk, L));
  stage_small(cls, slen, byteclass + bank * 256, lengths, b0, B);
  cp_commit();
  // the fp16 tables: follow and acc_cls^T as 0/1, zero padding
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = threadIdx.x; i < tables / 16; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  const float* fb = follow + (size_t)bank * P * P;
  const float* ab = acc_cls + (size_t)bank * P * K;
  auto put_acc = [&](int p, int k, float v) {
    acct[k * LD + p] = v != 0.f ? kOne : 0;
  };
  const bool acc_fits = P * (P + K) <= kScratchWords;   // P * P always does
  copy_async4(scr, fb, P * P);
  if (acc_fits) copy_async4(scr + P * P, ab, P * K);
  cp_commit();
  stage_wait();
  __syncthreads();
  // Follow[i][j] as B[n = j][k = i]: one 16-byte core-matrix row (8 k of
  // one n) per item, so neither the reads nor the stores conflict
  for (int it = threadIdx.x; it < P * KS * 2; it += kThreads) {
    const int n = it % P, k0 = it / P * 8;
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 2 * u;
      w[u] = pack01(k < P && scr[k * P + n] != 0.f,
                    k + 1 < P && scr[(k + 1) * P + n] != 0.f);
    }
    *reinterpret_cast<uint4*>(fol + core_offset(n, k0, SBO)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (acc_fits) {
    put_rows(scr + P * P, 0, P * K, K, put_acc);
  } else {
    __syncthreads();                          // Follow's words are read
    convert_table(ab, P, K, scr, put_acc);
  }
  fence_async_shared();     // Follow is read by wgmma, past the next sync

  const int g = lane / 4, q = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's two flow rows
  // ldmatrix.x4 address of this lane: row (lane & 15), col (lane >> 4) * 8
  const uint32_t acc_lane =
      smem_u32(acct) + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
  const uint64_t fol_desc = wgmma_desc(fol, SBO);
  float f[KS][2][4] = {};          // D . Follow, this warp's 16 rows
  float (&f_flat)[PP / 2] = reinterpret_cast<float (&)[PP / 2]>(f);
  uint32_t d[KS][4];  // the set, as the A fragments of D . Follow
#pragma unroll
  for (int np = 0; np < KS; ++np)
#pragma unroll
    for (int r = 0; r < 4; ++r) d[np][r] = 0u;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int lt = min(kChunk, L - t0);
    if (t0 > 0) {
      __syncthreads();                        // the previous chunk is read
      stage_bytes(bytes, data, b0, B, L, t0, lt);
    }
    stage_wait();
    __syncthreads();
    const int len0 = slen[r0] - t0, len1 = slen[r1] - t0;
    int tb = 0;
    if (t0 == 0) {
      // byte 0: D = start & acc[c0], for flows with a byte
      uint32_t am[KS][4];
      class_frags<KS>(am, cls[bytes[r0 * lt]], cls[bytes[r1 * lt]], KCS,
                      acc_lane, LD, q);
      const float* sb = start + (size_t)bank * P;
#pragma unroll
      for (int np = 0; np < KS; ++np)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = np * 16 + (r >> 1) * 8 + 2 * q;
          const uint32_t st = pack01(p < P && sb[p] != 0.f,
                                     p + 1 < P && sb[p + 1] != 0.f);
          const bool live = (r & 1 ? len1 : len0) > 0;
          d[np][r] = live ? st & am[np][r] : 0u;
        }
      tb = 1;
    }
    for (int t = tb; t < lt; ++t) {
      const bool keep0 = t >= len0, keep1 = t >= len1;
      // D . Follow on the warpgroup's tensor cores, asynchronously;
      // meanwhile each warp takes the class product for its own rows
      fence_regs(f_flat);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<PP>(f_flat, d[ks], fol_desc + (uint64_t)(256 * ks / 16),
                     ks > 0);
      wgmma_commit();
      uint32_t am[KS][4], pre[KS][4];
      class_frags<KS>(am, cls[bytes[r0 * lt + t]], cls[bytes[r1 * lt + t]],
                      KCS, acc_lane, LD, q);
      wgmma_wait();
      fence_regs(f_flat);
      positive_frags<KS>(pre, f);
#pragma unroll
      for (int np = 0; np < KS; ++np)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          d[np][r] = (r & 1 ? keep1 : keep0) ? d[np][r] : pre[np][r] & am[np][r];
    }
  }

  // finals: from the fragments into shared memory (row g from regs 0,
  // 2; row g+8 from 1, 3), then the CTA's rows, one contiguous run of
  // [B, P], with coalesced stores
  __syncthreads();                            // tables and bytes are done
  float* outs = reinterpret_cast<float*>(smem);  // [kFlows][P]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* out = outs + (half ? r1 : r0) * P;
#pragma unroll
    for (int np = 0; np < KS; ++np) {
      const int p = np * 16 + 2 * q;
      const uint32_t lo = d[np][half], hi = d[np][2 + half];
      if (p < P) out[p] = half_lo(lo) ? 1.f : 0.f;
      if (p + 1 < P) out[p + 1] = half_hi(lo) ? 1.f : 0.f;
      if (p + 8 < P) out[p + 8] = half_lo(hi) ? 1.f : 0.f;
      if (p + 9 < P) out[p + 9] = half_hi(hi) ? 1.f : 0.f;
    }
  }
  __syncthreads();
  float* dst = finals + ((size_t)bank * B + b0) * P;
  const int n = min(kFlows, B - b0) * P;
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = outs[i];
}

template <int KS>
int launch(const void* follow, const void* acc_cls, const void* byteclass,
           const void* start, const void* data, const void* lengths,
           void* finals, int NB, int P, int K, int B, int L,
           cudaStream_t stream) {
  const int KC = 16 * ((K + 15) / 16);
  const size_t smem =
      max(align16((size_t)16 * KS * 16 * KS * 2 +
                  (size_t)KC * row_stride(16 * KS) * 2) +
              align16((size_t)kFlows * min(L, kChunk)) +
              sizeof(float) * min(P * (P + K), kScratchWords),
          (size_t)kFlows * P * sizeof(float));   // the finals' staging
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfa_scan_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + kFlows - 1) / kFlows, NB);
  nfa_scan_kernel<KS><<<grid, kThreads, smem, stream>>>(
      (const float*)follow, (const float*)acc_cls,
      (const int32_t*)byteclass, (const float*)start,
      (const uint8_t*)data, (const int32_t*)lengths, (float*)finals,
      NB, P, K, B, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ct_nfa_scan(const void* follow, const void* acc_cls,
                           const void* byteclass, const void* start,
                           const void* data, const void* lengths,
                           void* finals, int NB, int P, int K, int B, int L,
                           void* stream) {
  if (P < 1 || P > kMaxPositions || K < 1 || K > kMaxClasses || L < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || NB == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define CT_K1_CASE(ks)                                                      \
  case ks:                                                                  \
    return launch<ks>(follow, acc_cls, byteclass, start, data, lengths,     \
                      finals, NB, P, K, B, L, s);
  switch ((P + 15) / 16) {
    CT_K1_CASE(1) CT_K1_CASE(2) CT_K1_CASE(3) CT_K1_CASE(4)
    CT_K1_CASE(5) CT_K1_CASE(6) CT_K1_CASE(7) CT_K1_CASE(8)
  }
#undef CT_K1_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
