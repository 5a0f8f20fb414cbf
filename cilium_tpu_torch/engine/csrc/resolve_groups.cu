// KR — the group-space resolve of the fused verdict step, for sm_90a.
//
// Replaces: the reference's engine/megakernel.py:542 fused_verdict_core,
// its resolve down to _combine_l7_match (XLA fuses it; not Pallas). In
// plain PyTorch the same resolve materialises [B, G] and [B, G, H]
// temporaries, folds 32 bit planes a word and takes two argmaxes a
// family: some 190 launches a batch.
//
// Function, per row b (every bit as resolve_cuda.resolve_groups_plain):
//   rs = clamp(ruleset[b], 0, RS - 1) (each mask table's row index
//   clamped to its own rows as well);
//   HTTP (l7t == HTTP): group g < G is ok when its method, host and
//   every header lane bit is set in the row's words (_rule_bit: lane
//   < 0 reads true, the word index clamps to [0, NW - 1]) and it is
//   any-path or its bit is set in the row's path-group words; the
//   winner is the lowest ok g in rp_rs_gmask[rs]; l7_log_http is set
//   when some ok member has a LOG lane whose bit is clear;
//   DNS (l7t == DNS): the lowest bit of dns_w & rp_dns_rsmask[rs];
//   kafka (l7t == KAFKA): the lowest member group whose api-key mask,
//   version, client and topic predicate holds;
//   generic (gen block given, l7t == GENERIC): the lowest member group
//   of the row's proto whose required pair ids are all among the row's;
//   frontend (staged, l7g words given): the lowest member group of the
//   row's family whose l7g lane bit is set and whose pairs are there;
//   l7_ok = any family ok; l7_match = the winner of the first ok family
//   in the order HTTP, kafka, DNS, generic, frontend, else -1.
// A family whose l7-type the row does not carry is never ok, so it is
// not evaluated; group bits at or past a family's G are never ok.
//
// Bound on this card: bytes. A row reads its rule set, its l7 type and
// the columns of its own family (an HTTP row: its method, host, header
// and path-group words, 24 bytes in all at http-1k) and writes 6;
// 262144 HTTP rows are 7.9 MB, 2.3 us at 3.35 TB/s. The group tables
// are a few KB and stay in L1.
//
// Design, and what each item does about the bound:
// 1. Sparse over the rule set: a row walks the set bits of its rule
//    set's mask words in ascending order (__ffs) and evaluates only
//    those groups, stopping at the first ok one (at the first ok one
//    with a failed LOG lane for HTTP, evaluating only LOG groups past
//    the winner). No [B, G] temporary exists.
// 2. One row a thread: the rows of one rule set walk the same groups
//    in lockstep.
// 3. Rows in lockstep read the same group entry, so the tables are
//    read through the read-only path (one broadcast from L1), not
//    staged in shared memory: a thread's walk is data dependent, and a
//    staged copy would cost each CTA the whole table for the few groups
//    it reads.
// 4. The per-row columns are read in place through their base pointer
//    and row stride (the capture step's rows[:, col] views), so no copy
//    kernel runs before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // threads per CTA

struct Col {              // an int32 column: rows s elements apart
  const int32_t* p;
  long long s;
};

struct Words {            // match words [B, nw], rows s elements apart
  const int32_t* p;
  long long s;
  int nw;
};

struct Params {
  Col ruleset, l7t, k_api, k_ver, k_cli, k_top, gen_proto;
  Words gen_pairs;                            // [B, F]: nw is F
  Words method, host, hdr, dns, gw, l7g;
  // HTTP signature groups
  const int32_t *g_method, *g_host, *g_hdr, *g_log, *rs_gmask;
  const uint8_t *g_anypath, *g_haslog;
  int G, Hm, Lm, Gw, RSg;
  // DNS lane masks
  const int32_t* dns_rsmask;
  int NWd, RSd;
  // kafka predicate groups
  const int32_t *k_mask, *kg_ver, *kg_cli, *kg_top, *rs_kmask;
  int Gk, Gkw, RSk;
  // generic groups (null without a generic block)
  const int32_t *gen_g_proto, *gen_g_pairs, *rs_genmask;
  int Gg, Kg, Ggw, RSgen;
  // frontend groups (null unless staged and l7g words are given)
  const int32_t *fe_family, *fe_lane, *fe_pairs, *rs_femask;
  int Gf, Kf, Gfw, RSf;
  int B, RS;
  int t_http, t_kafka, t_dns, t_generic;
  uint8_t *l7_ok, *l7_log;
  int32_t* l7_match;
};

__device__ __forceinline__ int at(const Col& c, long long row) {
  return __ldg(c.p + row * c.s);
}

// verdict._rule_bit for one lane of one row's words
__device__ __forceinline__ bool rule_bit(const int32_t* row, int nw,
                                         int lane) {
  if (lane < 0) return true;
  const int w = min(lane >> 5, nw - 1);
  return ((static_cast<uint32_t>(__ldg(row + w)) >> (lane & 31)) & 1u) != 0;
}

// verdict._pair_subset_ok for one group: every required id (>= 0) of
// req[0..k) is among the row's f pair ids
__device__ __forceinline__ bool pairs_ok(const int32_t* req, int k,
                                         const int32_t* have, int f) {
  for (int i = 0; i < k; ++i) {
    const int r = __ldg(req + i);
    if (r < 0) continue;
    bool found = false;
    for (int j = 0; j < f && !found; ++j) found = __ldg(have + j) == r;
    if (!found) return false;
  }
  return true;
}

// The lowest group g < G in the mask words m[0..gw) for which
// check(g, past_winner) reports ok (bit 0); *log is set when an ok
// member also reports a failed LOG lane (bit 1). check(g, true) is asked
// only past the winner, where only bit 1 matters. Returns -1 when no
// member is ok.
template <class Check>
__device__ __forceinline__ int scan(const int32_t* m, int gw, int G,
                                    bool want_log, bool* log, Check check) {
  int win = -1;
  bool lg = false;
  for (int w = 0; w < gw; ++w) {
    uint32_t bits = static_cast<uint32_t>(__ldg(m + w));
    while (bits) {
      const int g = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1;
      if (g >= G) {
        *log = lg;
        return win;
      }
      const int r = check(g, win >= 0);
      if (r & 1) {
        if (win < 0) win = g;
        lg = lg || (r & 2);
        if (lg || !want_log) {
          *log = lg;
          return win;
        }
      }
    }
  }
  *log = lg;
  return win;
}

// the first set bit of (words & mask) over nw words, -1 when none
__device__ __forceinline__ int first_bit(const int32_t* words,
                                         const int32_t* mask, int nw) {
  for (int w = 0; w < nw; ++w) {
    const uint32_t v = static_cast<uint32_t>(__ldg(words + w) & __ldg(mask + w));
    if (v) return 32 * w + __ffs(v) - 1;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
    resolve_groups_kernel(const Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= p.B) return;
  const int rs = min(max(at(p.ruleset, row), 0), p.RS - 1);
  const int l7t = at(p.l7t, row);
  bool unused = false;
  int http = -1, kafka = -1, dns = -1, gen = -1, fe = -1;
  bool log = false;

  if (l7t == p.t_http) {
    const int32_t* mw = p.method.p + row * p.method.s;
    const int32_t* hw = p.host.p + row * p.host.s;
    const int32_t* dw = p.hdr.p + row * p.hdr.s;
    const int32_t* gw = p.gw.p + row * p.gw.s;
    const int32_t* m = p.rs_gmask + static_cast<long long>(min(rs, p.RSg - 1)) * p.Gw;
    http = scan(m, p.Gw, p.G, true, &log, [&](int g, bool past) {
      const bool haslog = __ldg(p.g_haslog + g) != 0;
      if (past && !haslog) return 0;
      bool ok = rule_bit(mw, p.method.nw, __ldg(p.g_method + g)) &&
                rule_bit(hw, p.host.nw, __ldg(p.g_host + g)) &&
                (__ldg(p.g_anypath + g) != 0 || rule_bit(gw, p.gw.nw, g));
      for (int h = 0; ok && h < p.Hm; ++h)
        ok = rule_bit(dw, p.hdr.nw, __ldg(p.g_hdr + g * p.Hm + h));
      if (!ok) return 0;
      bool fail = false;
      for (int l = 0; haslog && !fail && l < p.Lm; ++l)
        fail = !rule_bit(dw, p.hdr.nw, __ldg(p.g_log + g * p.Lm + l));
      return 1 | (fail ? 2 : 0);
    });
  } else if (l7t == p.t_dns) {
    dns = first_bit(p.dns.p + row * p.dns.s,
                    p.dns_rsmask + static_cast<long long>(min(rs, p.RSd - 1)) * p.NWd,
                    p.NWd);
  } else if (l7t == p.t_kafka) {
    const int api = at(p.k_api, row), ver = at(p.k_ver, row);
    const int cli = at(p.k_cli, row), top = at(p.k_top, row);
    const int ak = min(max(api, 0), 31);
    const int32_t* m = p.rs_kmask + static_cast<long long>(min(rs, p.RSk - 1)) * p.Gkw;
    kafka = scan(m, p.Gkw, p.Gk, false, &unused, [&](int g, bool) {
      const uint32_t am = static_cast<uint32_t>(__ldg(p.k_mask + g));
      const int gv = __ldg(p.kg_ver + g), gc = __ldg(p.kg_cli + g);
      const int gt = __ldg(p.kg_top + g);
      return static_cast<int>(
          (am == 0 || (((am >> ak) & 1u) && api >= 0)) &&
          (gv < 0 || gv == ver) && (gc < 0 || gc == cli) &&
          (gt < 0 || gt == top));
    });
  } else if (l7t == p.t_generic && p.gen_g_proto != nullptr) {
    const int proto = at(p.gen_proto, row);
    const int32_t* have = p.gen_pairs.p + row * p.gen_pairs.s;
    const int32_t* m = p.rs_genmask + static_cast<long long>(min(rs, p.RSgen - 1)) * p.Ggw;
    gen = scan(m, p.Ggw, p.Gg, false, &unused, [&](int g, bool) {
      const int gp = __ldg(p.gen_g_proto + g);
      return static_cast<int>(gp >= 0 && gp == proto &&
                              pairs_ok(p.gen_g_pairs + g * p.Kg, p.Kg, have,
                                       p.gen_pairs.nw));
    });
  }
  if (p.fe_family != nullptr) {
    const int32_t* have = p.gen_pairs.p + row * p.gen_pairs.s;
    const int32_t* lw = p.l7g.p + row * p.l7g.s;
    const int32_t* m = p.rs_femask + static_cast<long long>(min(rs, p.RSf - 1)) * p.Gfw;
    fe = scan(m, p.Gfw, p.Gf, false, &unused, [&](int g, bool) {
      const int fam = __ldg(p.fe_family + g);
      return static_cast<int>(fam >= 0 && fam == l7t &&
                              rule_bit(lw, p.l7g.nw, __ldg(p.fe_lane + g)) &&
                              pairs_ok(p.fe_pairs + g * p.Kf, p.Kf, have,
                                       p.gen_pairs.nw));
    });
  }
  // verdict._combine_l7_match: a family is ok exactly when it has a winner
  const int match = http >= 0 ? http : kafka >= 0 ? kafka : dns >= 0 ? dns
                  : gen >= 0 ? gen : fe;
  p.l7_ok[row] = match >= 0;
  p.l7_log[row] = http >= 0 && log;
  p.l7_match[row] = match;
}

// Reads the launch's arguments in the order the wrapper lays them out.
struct Args {
  const long long* a;
  long long next() { return *a++; }
  template <class T> const T* ptr() { return reinterpret_cast<const T*>(next()); }
  Col col() {
    Col c;
    c.p = ptr<int32_t>();
    c.s = next();
    return c;
  }
  Words words() {
    Words w;
    w.p = ptr<int32_t>();
    w.s = next();
    w.nw = static_cast<int>(next());
    return w;
  }
  int i() { return static_cast<int>(next()); }
};

}  // namespace

// Launches KR on the given stream and returns cudaGetLastError(). Its
// arguments come as one int64 array, in the order of Params: the seven
// columns (pointer, row stride), the gen pairs and six word fields
// (pointer, row stride, width), the HTTP tables and G, Hm, Lm, Gw, RSg,
// the DNS mask and NWd, RSd, the kafka tables and Gk, Gkw, RSk, the
// generic tables and Gg, Kg, Ggw, RSgen, the frontend tables and Gf,
// Kf, Gfw, RSf, B, RS, the four l7 types, the three outputs, then the
// stream.
extern "C" int ct_resolve_groups(const long long* a) {
  Args r{a};
  Params p;
  p.ruleset = r.col(); p.l7t = r.col();
  p.k_api = r.col(); p.k_ver = r.col(); p.k_cli = r.col(); p.k_top = r.col();
  p.gen_proto = r.col();
  p.gen_pairs = r.words();
  p.method = r.words(); p.host = r.words(); p.hdr = r.words();
  p.dns = r.words(); p.gw = r.words(); p.l7g = r.words();
  p.g_method = r.ptr<int32_t>(); p.g_host = r.ptr<int32_t>();
  p.g_hdr = r.ptr<int32_t>(); p.g_log = r.ptr<int32_t>();
  p.rs_gmask = r.ptr<int32_t>();
  p.g_anypath = r.ptr<uint8_t>(); p.g_haslog = r.ptr<uint8_t>();
  p.G = r.i(); p.Hm = r.i(); p.Lm = r.i(); p.Gw = r.i(); p.RSg = r.i();
  p.dns_rsmask = r.ptr<int32_t>(); p.NWd = r.i(); p.RSd = r.i();
  p.k_mask = r.ptr<int32_t>(); p.kg_ver = r.ptr<int32_t>();
  p.kg_cli = r.ptr<int32_t>(); p.kg_top = r.ptr<int32_t>();
  p.rs_kmask = r.ptr<int32_t>();
  p.Gk = r.i(); p.Gkw = r.i(); p.RSk = r.i();
  p.gen_g_proto = r.ptr<int32_t>(); p.gen_g_pairs = r.ptr<int32_t>();
  p.rs_genmask = r.ptr<int32_t>();
  p.Gg = r.i(); p.Kg = r.i(); p.Ggw = r.i(); p.RSgen = r.i();
  p.fe_family = r.ptr<int32_t>(); p.fe_lane = r.ptr<int32_t>();
  p.fe_pairs = r.ptr<int32_t>(); p.rs_femask = r.ptr<int32_t>();
  p.Gf = r.i(); p.Kf = r.i(); p.Gfw = r.i(); p.RSf = r.i();
  p.B = r.i(); p.RS = r.i();
  p.t_http = r.i(); p.t_kafka = r.i(); p.t_dns = r.i(); p.t_generic = r.i();
  p.l7_ok = const_cast<uint8_t*>(r.ptr<uint8_t>());
  p.l7_log = const_cast<uint8_t*>(r.ptr<uint8_t>());
  p.l7_match = const_cast<int32_t*>(r.ptr<int32_t>());
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(r.next());
  if (p.B <= 0) return 0;
  const dim3 grid((p.B + kThreads - 1) / kThreads);
  resolve_groups_kernel<<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
