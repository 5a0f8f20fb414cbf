// K2 — data-oblivious DFA byte scan, for sm_90a.
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
// Bound: operations. Keeping the timing input-independent means no
// table read may be indexed by the data, so each byte sweeps all
// S x (K+1) entries: next = OR_{s,k} trans[s,k] & -([s==state] &
// [k==class]) (one entry matches, so OR equals the reference's sum).
// Design: one thread per (bank, flow); the bank's table sits in
// shared memory as bytes (S <= 128, so state ids fit in 8 bits) with
// the identity column appended; every thread of a warp reads the same
// entry at the same time, so the reads broadcast. The state lives in
// a register. The sweep order and trip counts are fixed by the shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStates = 128;

__global__ void __launch_bounds__(kThreads)
dfa_oblivious_kernel(const int32_t* __restrict__ trans,      // [NB, S, K]
                     const int32_t* __restrict__ byteclass,  // [NB, 256]
                     const int32_t* __restrict__ start,      // [NB]
                     const uint8_t* __restrict__ data,       // [B, L]
                     const int32_t* __restrict__ lengths,    // [B]
                     int32_t* __restrict__ finals,           // [NB, B]
                     int NB, int S, int K, int B, int L) {
  extern __shared__ uint8_t tab[];          // [S, K + 1]
  __shared__ int32_t cls[256];
  const int bank = blockIdx.y;
  const int KP = K + 1;
  const int32_t* tb = trans + (size_t)bank * S * K;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    cls[i] = byteclass[bank * 256 + i];
  for (int e = threadIdx.x; e < S * KP; e += blockDim.x) {
    const int s = e / KP, k = e % KP;
    tab[e] = (uint8_t)(k == K ? s : tb[s * K + k]);
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const uint8_t* row = data + (size_t)b * L;
  const int len = lengths[b];
  uint32_t state = (uint32_t)start[bank];
  for (int t = 0; t < L; ++t) {
    const int c = (t < len) ? cls[row[t]] : K;
    uint32_t nxt = 0;
    for (int s = 0; s < S; ++s) {
      const uint32_t row_sel = 0u - (uint32_t)(state == (uint32_t)s);
      const uint8_t* ts = tab + s * KP;
      for (int k = 0; k < KP; ++k) {
        const uint32_t sel = row_sel & (0u - (uint32_t)(k == c));
        nxt |= (uint32_t)ts[k] & sel;
      }
    }
    state = nxt;
  }
  finals[(size_t)bank * B + b] = (int32_t)state;
}

}  // namespace

extern "C" int ct_dfa_oblivious(const void* trans, const void* byteclass,
                                const void* start, const void* data,
                                const void* lengths, void* finals, int NB,
                                int S, int K, int B, int L, void* stream) {
  if (S < 1 || S > kMaxStates || K < 1 || K > 256)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || NB == 0) return 0;
  dim3 grid((B + kThreads - 1) / kThreads, NB);
  const size_t smem = (size_t)S * (K + 1);
  dfa_oblivious_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)trans, (const int32_t*)byteclass,
      (const int32_t*)start, (const uint8_t*)data,
      (const int32_t*)lengths, (int32_t*)finals, NB, S, K, B, L);
  return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
