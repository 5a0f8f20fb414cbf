// KD — dense-gather DFA byte scan with accept-word reads, for sm_90a.
//
// Replaces: the reference's engine/dfa_kernel.py:180 dfa_scan_banked (a
// lax.scan of table gathers, not a Pallas kernel). Under PyTorch a
// per-byte loop would launch L kernels per field per batch, so the
// whole scan is one launch here.
//
// Function: for every (bank, flow), run the bank's DFA over the flow's
// first min(max(length, 0), L) bytes from the bank's start state, then
// copy the accept words of the final state (and of the extra
// group-accept plane when one is given) into [B, NB, W] / [B, NB, Wg].
// With no accept table it writes the final states [NB, B] instead.
// uint32 words travel as int32 bit patterns. The trip count follows the
// data: this is the data-dependent arm (the oblivious arm is
// dfa_oblivious.cu).
//
// Bound on this card. Bytes: the tables, the lengths and each flow's
// live bytes read once, the outputs written once, at 3.35 TB/s (as
// chip_smoke.py counts it): 0.7 µs at the http-1000 batch's path field,
// 15 µs at the high-cardinality capture's 262144-row path table.
// Latency: each byte is one dependent table load, so a flow costs its
// live bytes x (one shared-memory load and its index arithmetic, a few
// tens of cycles) however wide the card; at L = 1024 that floor is tens
// of µs, and only splitting a string across threads (the reference's
// longscan) moves it. Staging: every CTA copies its bank's table into
// shared memory once (95 KB at the http-1000 path stack); with 128 CTAs
// copying at once that takes about as long as the batch's scan.
//
// Design, and what each item does about those bounds:
// 1. The bank's tables live in shared memory (variant "smem"): a CTA
//    scans one bank, and stages trans[bank], and the accept planes
//    accept[bank] / extra[bank] when they fit beside it, each with one
//    cp.async.bulk completed on one mbarrier, so each byte's dependent
//    load is a shared load instead of an L1/L2 round trip, and so is
//    the final state's accept row. Each array keeps its global address
//    mod 16: its 16-byte-aligned interior goes by the bulk copy, its
//    ragged head and tail (< 16 bytes each) by plain loads. CTAs loop
//    over tiles of flows, and the grid fills the SMs once, so a large
//    batch stages the table once per CTA, not once per tile. (Clusters
//    of a bank's CTAs sharing one multicast copy of the table measured
//    no faster on the H100, at 2 CTAs, and slower at 4 and 8.)
// 2. Tables over the shared-memory budget (the compiler allows 8192
//    states x 256 classes, 8 MB) read the table from global memory
//    through the read-only path (variant "global"). The wrapper picks
//    the variant from the shapes alone (dfa_dense_cuda.plan_launch).
// 3. Byte loads off the chain: each thread reads its rows 16 bytes at a
//    time (one uint4 through the read-only path where the row start,
//    the row stride and L are 16-aligned; 4-byte or byte loads where
//    they are not), one chunk ahead of the scan, and looks up the
//    chunk's 16 byte classes (a u8 table in shared memory) before the
//    dependent loads. The next tile's lengths and first chunks are
//    fetched before the current tile is scanned.
// 4. Two flows per thread, interleaved: the scheduler has a second
//    independent chain while one waits on its load.
// 5. Epilogue: a flow's W accept words (and Wg group words) are
//    contiguous in [B, NB, W]; they move as int4 where W % 4 == 0 and
//    the rows are 16-byte aligned. The kernel takes the data's row
//    stride and the lengths' stride, so column slices (the blob
//    transport's byte fields, the packed batch's length column) are
//    read in place.
//
// This replaces the port's first KD (one thread per (bank, flow), the
// table read through __ldg one byte at a time: 0.01094 ms at the
// http-1000 batch's path field, 15x its byte bound, on an H100 80GB
// HBM3 at 700 W, chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // threads per CTA
constexpr int kChains = 2;                    // flows per thread
constexpr int kFlows = kThreads * kChains;    // flows per tile
constexpr int kChunk = 16;                    // bytes per row load step
constexpr int kTableOffset = 256 + 16;        // u8 classes, mbarrier
constexpr int kMaxSmem = 232448;              // sm_90 per-CTA limit

struct Params {
  const int32_t* trans;      // [NB, S, K]
  const int32_t* byteclass;  // [NB, 256]
  const int32_t* start;      // [NB]
  const int32_t* accept;     // [NB, S, W] or null
  const int32_t* extra;      // [NB, S, Wg] or null
  const uint8_t* data;       // [B, L], rows row_stride bytes apart
  const int32_t* lengths;    // [B], len_stride ints apart
  int32_t* out_words;        // [B, NB, W]
  int32_t* out_extra;        // [B, NB, Wg] or null
  int32_t* out_finals;       // [NB, B] or null
  long long row_stride, len_stride;
  int NB, S, K, W, Wg, B, L;
  int words_vec, extra_vec;  // 1: copy accept rows as int4
  int words_smem;            // 1: stage the accept planes too (smem)
};

// ------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// 1-D bulk copy global → this CTA's shared memory, completed on the
// mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---------------------------------------------------------- staging
// A per-bank array on its way into shared memory: it lands at the same
// address mod 16 as in global memory, so its 16-byte-aligned interior
// goes by one bulk copy and only its head and tail (< 16 bytes each) by
// plain loads.
struct Staged {
  int32_t* smem;               // the array in shared memory
  uint32_t dst;                // shared address of the bulk part
  const uint8_t* src;          // global address of the bulk part
  uint32_t bulk;               // bytes of the bulk part (16-byte multiple)
};

// Lay out `nbytes` of `g` at `region` (advanced past it by a size that
// does not depend on g's alignment, so the launch plan can size the
// shared memory from the shapes) and copy its head and tail; the bulk
// part is issued later.
__device__ __forceinline__ Staged place(uint8_t*& region, const int32_t* g,
                                        uint32_t nbytes) {
  const uint32_t shift = reinterpret_cast<uintptr_t>(g) & 15;
  Staged a;
  a.smem = reinterpret_cast<int32_t*>(region + shift);
  const uint32_t lo = min((16u - shift) & 15u, nbytes);
  a.bulk = (nbytes - lo) & ~15u;
  a.dst = smem_u32(a.smem) + lo;
  a.src = reinterpret_cast<const uint8_t*>(g) + lo;
  for (uint32_t i = threadIdx.x; i < lo / 4; i += kThreads) a.smem[i] = g[i];
  for (uint32_t i = (lo + a.bulk) / 4 + threadIdx.x; i < nbytes / 4;
       i += kThreads)
    a.smem[i] = g[i];
  region += (nbytes + 15) / 16 * 16 + 16;
  return a;
}

// ------------------------------------------------------------- rows
// A 16-byte chunk of a row, as loaded: four words (kVec 16 or 4) or 16
// bytes (kVec 1). Loads are predicated on the unit's first byte lying
// below `lim`; the loader never reads what it loads, so a chunk's
// latency is paid only where it is scanned, a chunk later. kVec
// divides L, so a unit that starts below lim <= L ends within the row.
template <int kVec>
struct Chunk {
  static constexpr int kRegs = kVec == 1 ? kChunk : kChunk / 4;
  uint32_t v[kRegs];

  __device__ __forceinline__ void load(const uint8_t* row, int off,
                                       int lim) {
    const uint8_t* p = row + off;
#pragma unroll
    for (int i = 0; i < kRegs; ++i) v[i] = 0;
    if constexpr (kVec == 16) {
      if (off < lim) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      }
    } else if constexpr (kVec == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (off + 4 * i < lim)
          v[i] = __ldg(reinterpret_cast<const unsigned int*>(p) + i);
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (off + j < lim) v[j] = __ldg(p + j);
    }
  }

  __device__ __forceinline__ uint32_t byte(int j) const {
    if constexpr (kVec == 1)
      return v[j] & 0xff;
    else
      return (v[j / 4] >> (8 * (j % 4))) & 0xff;
  }
};

// A final state's accept row (in shared or global memory) to the output.
__device__ __forceinline__ void copy_words(const int32_t* src, int32_t* dst,
                                           int n, int vec) {
  if (vec) {
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int i = 0; i < n / 4; ++i) d[i] = s[i];
  } else {
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
}

template <bool kSmem>
__device__ __forceinline__ int32_t next_state(const int32_t* tab, int idx) {
  if constexpr (kSmem)
    return tab[idx];
  else
    return __ldg(tab + idx);
}

// The flows a thread carries in one tile: thread t carries flows t and
// t + kThreads, so a warp's lengths, finals and row bases are
// consecutive. fetch() issues the lengths and the first chunk of each
// row (bounded by L, not the length, so it does not wait on the
// lengths); the tile before it, or the table's staging, covers their
// latency.
template <int kVec>
struct Tile {
  int b[kChains], len[kChains];
  const uint8_t* row[kChains];
  Chunk<kVec> first[kChains];

  __device__ __forceinline__ void fetch(const Params& p, int tile) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      b[c] = tile * kFlows + c * kThreads + threadIdx.x;
      const bool in = b[c] < p.B;
      len[c] = in ? __ldg(p.lengths + (long long)b[c] * p.len_stride) : 0;
      row[c] = p.data + (long long)b[c] * p.row_stride;
      first[c].load(row[c], 0, in ? p.L : 0);
    }
  }
};

// --------------------------------------------------------------- kernel
// grid (CTAs per bank, NB); a CTA scans tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of kFlows flows, fetching the next tile's lengths and
// first chunks before it scans the current one.
template <bool kSmem, int kVec>
__global__ void __launch_bounds__(kThreads)
dfa_dense_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* cls = smem;                                   // [256] u8
  const uint32_t bar = smem_u32(smem + 256);             // mbarrier
  const int bank = blockIdx.y;
  const size_t srows = (size_t)bank * p.S;
  const int32_t* tab = p.trans + srows * p.K;
  const int32_t* acc = p.accept == nullptr ? nullptr : p.accept + srows * p.W;
  const int32_t* ext = p.extra == nullptr ? nullptr : p.extra + srows * p.Wg;
  // the table, and the accept planes when they fit beside it
  uint32_t tx = 0;
  if constexpr (kSmem) {
    uint8_t* region = smem + kTableOffset;
    Staged st[3];
    st[0] = place(region, tab, (uint32_t)p.S * p.K * 4);
    int n = 1;
    if (p.words_smem && acc != nullptr)
      st[n++] = place(region, acc, (uint32_t)p.S * p.W * 4);
    if (p.words_smem && ext != nullptr)
      st[n++] = place(region, ext, (uint32_t)p.S * p.Wg * 4);
    tab = st[0].smem;
    if (n > 1) acc = st[1].smem;
    if (n > 2) ext = st[2].smem;
    tx = st[0].bulk + (n > 1 ? st[1].bulk : 0) + (n > 2 ? st[2].bulk : 0);
    if (threadIdx.x == 0) mbar_init(bar, 1);
    __syncthreads();                    // the barrier is set up
    if (threadIdx.x == 0 && tx > 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        if (i < n && st[i].bulk > 0)
          bulk_copy(st[i].dst, st[i].src, st[i].bulk, bar);
      mbar_expect_tx(bar, tx);
    }
  }
  for (int i = threadIdx.x; i < 256; i += kThreads)
    cls[i] = static_cast<uint8_t>(__ldg(p.byteclass + bank * 256 + i));
  const int start = __ldg(p.start + bank);
  const int K = p.K;
  const int tiles = (p.B + kFlows - 1) / kFlows;
  Tile<kVec> cur;
  cur.fetch(p, blockIdx.x);
  if (tx > 0) mbar_wait(bar, 0);
  __syncthreads();                      // heads, tails and classes

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    Tile<kVec> next;
    next.fetch(p, tile + gridDim.x);
    int n[kChains], s[kChains];
    Chunk<kVec> ch[kChains];
    int nmax = 0;
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      n[c] = min(max(cur.len[c], 0), p.L);
      s[c] = start;
      ch[c] = cur.first[c];
      nmax = max(nmax, n[c]);
    }
    for (int off = 0; off < nmax; off += kChunk) {
      Chunk<kVec> nxt[kChains];
      uint32_t cl[kChains][kChunk];
#pragma unroll
      for (int c = 0; c < kChains; ++c)
        nxt[c].load(cur.row[c], off + kChunk, n[c]);
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int j = 0; j < kChunk; ++j) cl[c][j] = cls[ch[c].byte(j)];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const int nx = next_state<kSmem>(tab, s[c] * K + (int)cl[c][j]);
          s[c] = off + j < n[c] ? nx : s[c];
        }
#pragma unroll
      for (int c = 0; c < kChains; ++c) ch[c] = nxt[c];
    }

#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int b = cur.b[c];
      if (b >= p.B) continue;
      if (p.out_finals != nullptr)
        p.out_finals[(size_t)bank * p.B + b] = s[c];
      if (p.accept == nullptr) continue;
      const size_t orow = (size_t)b * p.NB + bank;
      copy_words(acc + (size_t)s[c] * p.W, p.out_words + orow * p.W, p.W,
                 p.words_vec);
      if (ext != nullptr)
        copy_words(ext + (size_t)s[c] * p.Wg, p.out_extra + orow * p.Wg,
                   p.Wg, p.extra_vec);
    }
    cur = next;
  }
}

template <bool kSmem>
void launch(dim3 grid, int smem, cudaStream_t stream, int vec,
            const Params& p) {
  switch (vec) {
    case 16:
      dfa_dense_kernel<kSmem, 16><<<grid, kThreads, smem, stream>>>(p);
      break;
    case 4:
      dfa_dense_kernel<kSmem, 4><<<grid, kThreads, smem, stream>>>(p);
      break;
    default:
      dfa_dense_kernel<kSmem, 1><<<grid, kThreads, smem, stream>>>(p);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The launch plan (variant, CTAs per bank, dynamic shared memory, row
// load width) comes from dfa_dense_cuda.plan_launch; this entry point
// launches it as given and returns cudaGetLastError(). Its arguments
// come as one int64 array (pointers as addresses), so that the caller
// converts one ctypes argument instead of 25: trans, byteclass, start,
// accept, extra, data, lengths, out_words, out_extra, out_finals, NB,
// S, K, W, Wg, B, L, row_stride, len_stride, smem_variant, words_smem,
// grid_x, smem_bytes, vec, stream.
extern "C" int ct_dfa_dense(const long long* a) {
  Params p;
  p.trans = (const int32_t*)a[0];
  p.byteclass = (const int32_t*)a[1];
  p.start = (const int32_t*)a[2];
  p.accept = (const int32_t*)a[3];
  p.extra = (const int32_t*)a[4];
  p.data = (const uint8_t*)a[5];
  p.lengths = (const int32_t*)a[6];
  p.out_words = (int32_t*)a[7];
  p.out_extra = (int32_t*)a[8];
  p.out_finals = (int32_t*)a[9];
  p.NB = (int)a[10]; p.S = (int)a[11]; p.K = (int)a[12]; p.W = (int)a[13];
  p.Wg = (int)a[14]; p.B = (int)a[15]; p.L = (int)a[16];
  p.row_stride = a[17];
  p.len_stride = a[18];
  const bool smem_variant = a[19] != 0;
  const dim3 grid((unsigned)a[21], (unsigned)p.NB);
  const int smem_bytes = (int)a[22], vec = (int)a[23];
  const cudaStream_t stream = (cudaStream_t)a[24];
  if (p.B == 0 || p.NB == 0) return 0;
  p.words_vec =
      p.W % 4 == 0 && aligned16(p.accept) && aligned16(p.out_words);
  p.extra_vec =
      p.Wg % 4 == 0 && aligned16(p.extra) && aligned16(p.out_extra);
  p.words_smem = smem_variant && a[20] != 0;
  if (smem_variant) {
    // the shared-memory ceiling is raised once per device
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64 && !raised[dev]) {
      void (*kernels[])(const Params) = {dfa_dense_kernel<true, 16>,
                                         dfa_dense_kernel<true, 4>,
                                         dfa_dense_kernel<true, 1>};
      for (auto k : kernels) {
        err = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err != cudaSuccess) return (int)err;
      }
      raised[dev] = true;
    }
    launch<true>(grid, smem_bytes, stream, vec, p);
  } else {
    launch<false>(grid, smem_bytes, stream, vec, p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
