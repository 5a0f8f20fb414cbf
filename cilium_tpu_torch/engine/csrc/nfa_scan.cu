// K1 — bitset-NFA byte scan ("rules as lanes"), for sm_90a.
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
// Bound: operations. All matrices are 0/1, so the matmul is a boolean
// product: with the set kept as NW = ceil(P/32) <= 4 uint32 words, one
// byte costs 32*NW row selects of NW words each. Design: one thread
// per (bank, flow); follow rows and the class-acceptance rows of the
// bank live in shared memory as bit words (a warp's threads read the
// same row, so the reads broadcast); the set lives in registers. The
// byte loop runs all L bytes and, inside, ORs over every position
// slot of the word-padded stack, selecting each follow row with a mask
// made from the position's bit: no branch and no trip count depends
// on the data, which keeps the reference kernel's input-independent
// timing (pallas_nfa.py, module notes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPositions = 128;
constexpr int kMaxClasses = 256;

template <int NW>
__global__ void __launch_bounds__(kThreads)
nfa_scan_kernel(const float* __restrict__ follow,     // [NB, P, P]
                const float* __restrict__ acc_cls,    // [NB, P, K]
                const int32_t* __restrict__ byteclass,  // [NB, 256]
                const float* __restrict__ start,      // [NB, P]
                const uint8_t* __restrict__ data,     // [B, L]
                const int32_t* __restrict__ lengths,  // [B]
                float* __restrict__ finals,           // [NB, B, P]
                int NB, int P, int K, int B, int L) {
  __shared__ uint32_t fol[kMaxPositions][NW];
  __shared__ uint32_t acc[kMaxClasses][NW];
  __shared__ uint32_t st[NW];
  __shared__ int32_t cls[256];
  const int bank = blockIdx.y;
  const float* fb = follow + (size_t)bank * P * P;
  const float* ab = acc_cls + (size_t)bank * P * K;
  const float* sb = start + (size_t)bank * P;

  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    cls[i] = byteclass[bank * 256 + i];
  // follow row i → bit words over successor positions j (rows past P
  // stay zero, so the padded slots select nothing)
  for (int e = threadIdx.x; e < kMaxPositions * NW; e += blockDim.x) {
    const int i = e / NW, w = e % NW;
    uint32_t bits = 0;
    if (i < P)
      for (int j = 0; j < 32; ++j) {
        const int p = w * 32 + j;
        if (p < P && fb[(size_t)i * P + p] != 0.f) bits |= 1u << j;
      }
    fol[i][w] = bits;
  }
  for (int e = threadIdx.x; e < K * NW; e += blockDim.x) {
    const int k = e / NW, w = e % NW;
    uint32_t bits = 0;
    for (int j = 0; j < 32; ++j) {
      const int p = w * 32 + j;
      if (p < P && ab[(size_t)p * K + k] != 0.f) bits |= 1u << j;
    }
    acc[k][w] = bits;
  }
  for (int w = threadIdx.x; w < NW; w += blockDim.x) {
    uint32_t bits = 0;
    for (int j = 0; j < 32; ++j) {
      const int p = w * 32 + j;
      if (p < P && sb[p] != 0.f) bits |= 1u << j;
    }
    st[w] = bits;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = data + (size_t)b * L;
  const int len = lengths[b];

  uint32_t d[NW];
  {
    const uint32_t live = (len > 0 && L > 0) ? 0xffffffffu : 0u;
    const int c0 = L > 0 ? cls[row[0]] : 0;
    #pragma unroll
    for (int w = 0; w < NW; ++w) d[w] = st[w] & acc[c0][w] & live;
  }
  for (int t = 1; t < L; ++t) {
    const int c = cls[row[t]];
    uint32_t nx[NW];
    #pragma unroll
    for (int w = 0; w < NW; ++w) nx[w] = 0;
    // the position word is read once into a scalar, so the partially
    // unrolled inner loop indexes no register array dynamically
    #pragma unroll
    for (int iw = 0; iw < NW; ++iw) {
      const uint32_t dw = d[iw];
      #pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const uint32_t m = 0u - ((dw >> j) & 1u);
        #pragma unroll
        for (int w = 0; w < NW; ++w) nx[w] |= fol[iw * 32 + j][w] & m;
      }
    }
    // hold: bytes at t >= length leave the set as it was (a select)
    const uint32_t keep = (t < len) ? 0u : 0xffffffffu;
    #pragma unroll
    for (int w = 0; w < NW; ++w)
      d[w] = (d[w] & keep) | (nx[w] & acc[c][w] & ~keep);
  }

  float* out = finals + ((size_t)bank * B + b) * P;
  for (int p = 0; p < P; ++p)
    out[p] = ((d[p >> 5] >> (p & 31)) & 1u) ? 1.f : 0.f;
}

template <int NW>
void launch(const void* follow, const void* acc_cls, const void* byteclass,
            const void* start, const void* data, const void* lengths,
            void* finals, int NB, int P, int K, int B, int L,
            cudaStream_t stream) {
  dim3 grid((B + kThreads - 1) / kThreads, NB);
  nfa_scan_kernel<NW><<<grid, kThreads, 0, stream>>>(
      (const float*)follow, (const float*)acc_cls,
      (const int32_t*)byteclass, (const float*)start,
      (const uint8_t*)data, (const int32_t*)lengths, (float*)finals,
      NB, P, K, B, L);
}

}  // namespace

extern "C" int ct_nfa_scan(const void* follow, const void* acc_cls,
                           const void* byteclass, const void* start,
                           const void* data, const void* lengths,
                           void* finals, int NB, int P, int K, int B, int L,
                           void* stream) {
  if (P < 1 || P > kMaxPositions || K < 1 || K > kMaxClasses)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || NB == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((P + 31) / 32) {
    case 1: launch<1>(follow, acc_cls, byteclass, start, data, lengths,
                      finals, NB, P, K, B, L, s); break;
    case 2: launch<2>(follow, acc_cls, byteclass, start, data, lengths,
                      finals, NB, P, K, B, L, s); break;
    case 3: launch<3>(follow, acc_cls, byteclass, start, data, lengths,
                      finals, NB, P, K, B, L, s); break;
    default: launch<4>(follow, acc_cls, byteclass, start, data, lengths,
                       finals, NB, P, K, B, L, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
