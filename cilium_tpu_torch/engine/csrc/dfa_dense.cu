// KD — dense-gather DFA byte scan with accept-word reads, for sm_90a.
//
// Replaces: the reference's engine/dfa_kernel.py dfa_scan_banked (a
// lax.scan of table gathers, not a Pallas kernel). Under PyTorch a
// per-byte loop would launch L kernels per field per batch, so the
// whole scan is one launch here.
//
// Function: for every (bank, flow), run the bank's DFA over the
// flow's first `length` bytes from the bank's start state, then copy
// the accept words of the final state (and of the extra group-accept
// plane when one is given) into [B, NB, W] / [B, NB, Wg]. With no
// accept table it writes the final states [NB, B] instead. uint32
// words travel as int32 bit patterns.
//
// Bound: bytes. Each byte costs one dependent table load; the
// largest table (the http-1000 path stack) is a few MB and stays in
// the 50 MB L2, so the chain of dependent L2 loads per thread is
// what the time is made of. Design: one thread per (bank, flow), the
// state in a register, the 256-entry byte-class table in shared
// memory, the transition table read through the read-only path
// (__ldg). The trip count is min(length, L): this is the
// data-dependent arm (the oblivious arm is dfa_oblivious.cu).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
dfa_dense_kernel(const int32_t* __restrict__ trans,      // [NB, S, K]
                 const int32_t* __restrict__ byteclass,  // [NB, 256]
                 const int32_t* __restrict__ start,      // [NB]
                 const int32_t* __restrict__ accept,     // [NB, S, W] or null
                 const int32_t* __restrict__ extra,      // [NB, S, Wg] or null
                 const uint8_t* __restrict__ data,       // [B, L]
                 const int32_t* __restrict__ lengths,    // [B]
                 int32_t* __restrict__ out_words,        // [B, NB, W]
                 int32_t* __restrict__ out_extra,        // [B, NB, Wg] or null
                 int32_t* __restrict__ out_finals,       // [NB, B] or null
                 int NB, int S, int K, int W, int Wg, int B, int L) {
  __shared__ int32_t cls[256];
  const int bank = blockIdx.y;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    cls[i] = byteclass[bank * 256 + i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* tb = trans + (size_t)bank * S * K;
  const uint8_t* row = data + (size_t)b * L;
  const int n = max(0, min(lengths[b], L));
  int state = start[bank];
  for (int t = 0; t < n; ++t)
    state = __ldg(tb + state * K + cls[row[t]]);

  if (out_finals != nullptr) out_finals[(size_t)bank * B + b] = state;
  if (accept == nullptr) return;
  const int32_t* ab = accept + ((size_t)bank * S + state) * W;
  int32_t* ob = out_words + ((size_t)b * NB + bank) * W;
  for (int w = 0; w < W; ++w) ob[w] = __ldg(ab + w);
  if (extra != nullptr) {
    const int32_t* eb = extra + ((size_t)bank * S + state) * Wg;
    int32_t* oe = out_extra + ((size_t)b * NB + bank) * Wg;
    for (int w = 0; w < Wg; ++w) oe[w] = __ldg(eb + w);
  }
}

}  // namespace

extern "C" int ct_dfa_dense(const void* trans, const void* byteclass,
                            const void* start, const void* accept,
                            const void* extra, const void* data,
                            const void* lengths, void* out_words,
                            void* out_extra, void* out_finals, int NB,
                            int S, int K, int W,
                            int Wg, int B, int L, void* stream) {
  if (B == 0 || NB == 0) return 0;
  dim3 grid((B + kThreads - 1) / kThreads, NB);
  dfa_dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)trans, (const int32_t*)byteclass,
      (const int32_t*)start, (const int32_t*)accept,
      (const int32_t*)extra, (const uint8_t*)data,
      (const int32_t*)lengths, (int32_t*)out_words, (int32_t*)out_extra,
      (int32_t*)out_finals, NB, S, K, W, Wg, B, L);
  return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
