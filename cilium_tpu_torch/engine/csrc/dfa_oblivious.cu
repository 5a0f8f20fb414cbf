// K2 — data-oblivious DFA byte scan on the tensor cores, for sm_90a.
//
// Replaces: the reference's engine/pallas_dfa.py dfa_finals_pallas
// (body _scan_kernel), which steps every flow with a one-hot matmul
// (rows = trans^T . onehot(state)) and a class column select, so that
// its time depends on the table's shape only, never on the rule set
// or the payload (the RE2-style guarantee some deployments ask for).
//
// Function: final DFA state of every (bank, flow) → [NB, B] int32.
// Padding bytes (t >= length) take the identity class K, whose column
// maps every state to itself, exactly as the reference pads.
//
// Bound on this card: the per-byte dependency chain. Each byte's
// product needs the previous byte's state, and a CTA's table fits in
// shared memory, so neither bytes nor tensor-core operations are the
// limit at B = 8192: a byte step costs the latency of (mma → sum →
// select → one shuffle → compare).
// Design: the reference's own product, on the tensor cores. A warp
// owns 16 flows (the M rows of mma.m16n8k16), a CTA 64; the table is
// fp16 in shared memory, [SP = 16*ceil(S/16)] x [16*ceil((K+1)/16)]
// with the identity column K appended and zero padding (every state id
// is < 128, exact in fp16; each row of the product has one non-zero
// term, exact in fp32). Per byte: rows[16 x (K+1)] = onehot(state) .
// tab, as SP/16 independent k-step products per 16 columns, summed;
// each lane keeps the element of its two rows whose column equals the
// row's class; one shuffle fetches it from the only lane of the quad
// that holds that column, giving the next state; comparing it with the
// fragment's column indices builds the next A fragment in registers.
// Tables of up to 32 columns (K < 32, every http-1000 field) keep their
// B fragments in registers for the whole byte loop; wider ones read
// them with ldmatrix at every byte. The prologue copies the raw table,
// the CTA's bytes and lengths and the class table with cp.async, all in
// flight at once, and converts the table in shared memory. The class
// comes from the 256-entry byteclass table in shared memory, read by
// the byte's value, as the reference does outside its kernel. No
// branch, trip count or other table address depends on a byte, a state
// or a length.
//
// This replaces the port's first K2 kernel, a select sweep (one thread
// per flow, S x (K+1) selects per byte: 0.68754 ms per launch at the
// http-1000 host shape [1, 78, 13], B = 8192, on an H100 80GB HBM3 at
// 700 W, chip_smoke.py).

#include "tile16.cuh"

namespace {

using namespace tile16;

constexpr int kMaxStates = 128;
constexpr int kMaxClasses = 256;

// KS k-steps: SP = 16 * KS padded states. NGR > 0: the table is NGR
// 16-column groups, whose B fragments stay in registers for the whole
// byte loop; NGR = 0: any width, B fragments read from shared memory
// at every byte.
template <int KS, int NGR>
__global__ void __launch_bounds__(kThreads)
dfa_oblivious_kernel(const int32_t* __restrict__ trans,      // [NB, S, K]
                     const int32_t* __restrict__ byteclass,  // [NB, 256]
                     const int32_t* __restrict__ start,      // [NB]
                     const uint8_t* __restrict__ data,       // [B, L]
                     const int32_t* __restrict__ lengths,    // [B]
                     int32_t* __restrict__ finals,           // [NB, B]
                     int NB, int S, int K, int B, int L) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) int32_t cls[256];
  __shared__ __align__(16) int32_t slen[kFlows];
  const int NG = (K + 1 + 15) / 16;           // 16-column groups over K + 1
  const int LD = row_stride(16 * NG);
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);         // [16*KS][LD]
  uint8_t* bytes = smem + align16((size_t)16 * KS * LD * 2); // [kFlows][lt]
  int32_t* scr = reinterpret_cast<int32_t*>(                  // raw trans
      bytes + align16((size_t)kFlows * min(L, kChunk)));
  const int bank = blockIdx.y;
  const int b0 = blockIdx.x * kFlows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // every global read of the prologue in flight at once: the first
  // chunk's bytes, the class table, the lengths, then the table
  if (L > 0) stage_bytes(bytes, data, b0, B, L, 0, min(kChunk, L));
  stage_small(cls, slen, byteclass + bank * 256, lengths, b0, B);
  cp_commit();
  // the fp16 table: trans, the identity column K, zero padding
  {
    uint4* z = reinterpret_cast<uint4*>(tab);
    for (int i = threadIdx.x; i < 16 * KS * LD * 2 / 16; i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  convert_table(trans + (size_t)bank * S * K, S, K, scr,
                [&](int s, int k, int32_t v) {
                  tab[s * LD + k] = __half_as_ushort(__int2half_rn(v));
                  if (k == K - 1)
                    tab[s * LD + K] = __half_as_ushort(__int2half_rn(s));
                });

  const int g = lane / 4, q = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this lane's two flow rows
  int st0 = start[bank], st1 = st0;
  uint32_t a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) onehot_frag(a[ks], st0, st1, ks, q);
  const uint32_t tab_lane =
      smem_u32(tab) + ((lane & 15) * LD + (lane >> 4) * 8) * 2;
  constexpr int NB_REG = NGR > 0 ? NGR : 1;
  uint32_t breg[NB_REG][KS][4];
  if (NGR > 0) {
#pragma unroll
    for (int ng = 0; ng < NB_REG; ++ng)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4_trans(breg[ng][ks], tab_lane + (ks * 16 * LD + ng * 16) * 2);
  }

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int lt = min(kChunk, L - t0);
    if (t0 > 0) {
      __syncthreads();                        // the previous chunk is read
      stage_bytes(bytes, data, b0, B, L, t0, lt);
    }
    stage_wait();
    __syncthreads();
    const int len0 = slen[r0] - t0, len1 = slen[r1] - t0;
    // each byte looks up the next byte's classes, off the state's chain
    int nc0 = cls[bytes[r0 * lt]], nc1 = cls[bytes[r1 * lt]];
    for (int t = 0; t < lt; ++t) {
      const int c0 = t < len0 ? nc0 : K;
      const int c1 = t < len1 ? nc1 : K;
      const int tn = min(t + 1, lt - 1);
      nc0 = cls[bytes[r0 * lt + tn]];
      nc1 = cls[bytes[r1 * lt + tn]];
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int ng = 0; ng < (NGR > 0 ? NGR : NG); ++ng) {
        // one accumulator per k-step, so the KS x 2 products are
        // independent; a row has one non-zero term in all, so adding
        // the partial sums is exact
        float d[KS][2][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t b[4];
          if (NGR > 0) {
#pragma unroll
            for (int r = 0; r < 4; ++r) b[r] = breg[NGR > 0 ? ng : 0][ks][r];
          } else {
            ldsm_x4_trans(b, tab_lane + (ks * 16 * LD + ng * 16) * 2);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) d[ks][0][e] = d[ks][1][e] = 0.f;
          mma16816(d[ks][0], a[ks], b[0], b[1]);
          mma16816(d[ks][1], a[ks], b[2], b[3]);
        }
#pragma unroll
        for (int ks = 1; ks < KS; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d[0][0][e] += d[ks][0][e];
            d[0][1][e] += d[ks][1][e];
          }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = ng * 16 + j * 8 + 2 * q;
          p0 += (col == c0 ? d[0][j][0] : 0.f) + (col + 1 == c0 ? d[0][j][1] : 0.f);
          p1 += (col == c1 ? d[0][j][2] : 0.f) + (col + 1 == c1 ? d[0][j][3] : 0.f);
        }
      }
      // column c of every n-tile sits with lane (c % 8) / 2 of the quad,
      // the only lane whose sum is not 0
      p0 = __shfl_sync(0xffffffffu, p0, (lane & ~3) | ((c0 & 7) >> 1));
      p1 = __shfl_sync(0xffffffffu, p1, (lane & ~3) | ((c1 & 7) >> 1));
      st0 = __float2int_rn(p0);
      st1 = __float2int_rn(p1);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) onehot_frag(a[ks], st0, st1, ks, q);
    }
  }

  if (q == 0) {
    if (b0 + r0 < B) finals[(size_t)bank * B + b0 + r0] = st0;
    if (b0 + r1 < B) finals[(size_t)bank * B + b0 + r1] = st1;
  }
}

template <int KS, int NGR>
int launch(const void* trans, const void* byteclass, const void* start,
           const void* data, const void* lengths, void* finals, int NB,
           int S, int K, int B, int L, cudaStream_t stream) {
  const size_t smem =
      align16((size_t)16 * KS * row_stride(16 * ((K + 16) / 16)) * 2) +
      align16((size_t)kFlows * min(L, kChunk)) +
      sizeof(int32_t) * min(S * K, kScratchWords);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dfa_oblivious_kernel<KS, NGR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + kFlows - 1) / kFlows, NB);
  dfa_oblivious_kernel<KS, NGR><<<grid, kThreads, smem, stream>>>(
      (const int32_t*)trans, (const int32_t*)byteclass,
      (const int32_t*)start, (const uint8_t*)data,
      (const int32_t*)lengths, (int32_t*)finals, NB, S, K, B, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ct_dfa_oblivious(const void* trans, const void* byteclass,
                                const void* start, const void* data,
                                const void* lengths, void* finals, int NB,
                                int S, int K, int B, int L, void* stream) {
  if (S < 1 || S > kMaxStates || K < 1 || K > kMaxClasses || L < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || NB == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // tables of one or two 16-column groups (K < 32) keep B in registers
  const int ng = (K + 16) / 16;
#define CT_K2_CASE(ks)                                                     \
  case ks:                                                                 \
    return ng == 1   ? launch<ks, 1>(trans, byteclass, start, data,        \
                                     lengths, finals, NB, S, K, B, L, s)   \
           : ng == 2 ? launch<ks, 2>(trans, byteclass, start, data,        \
                                     lengths, finals, NB, S, K, B, L, s)   \
                     : launch<ks, 0>(trans, byteclass, start, data,        \
                                     lengths, finals, NB, S, K, B, L, s);
  switch ((S + 15) / 16) {
    CT_K2_CASE(1) CT_K2_CASE(2) CT_K2_CASE(3) CT_K2_CASE(4)
    CT_K2_CASE(5) CT_K2_CASE(6) CT_K2_CASE(7) CT_K2_CASE(8)
  }
#undef CT_K2_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
