// falcon_native: host-native compute kernels for falcon_tpu_torch.
//
// C++ implementations of the assembler's host hot loops, semantically
// identical to the oracle-validated python kernels in falcon_tpu_torch/ops
// (which in turn are bit-exact vs the FALCON reference C sources -- see
// tests/test_*_oracle.py):
//
//   * banded O(ND) greedy difference alignment with traceback
//     (falcon_tpu_torch/ops/align.py semantics; cf. reference DW_banded.c:115)
//   * direct-address k-mer seeding + diagonal-histogram range finding
//     (falcon_tpu_torch/ops/kmer.py; cf. reference kmer_lookup.c)
//   * align-tag MSA accumulation + best-path consensus DP
//     (falcon_tpu_torch/ops/consensus_dp.py; cf. reference falcon.c)
//
// Exposed through a minimal C ABI consumed via ctypes
// (falcon_tpu_torch/ops/native.py).
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <climits>
#include <cstdio>
#include <ctime>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

using std::string;
using std::vector;

// ---------------------------------------------------------------- aligner

struct AlnResult {
  int q_s = 0, q_e = 0, t_s = 0, t_e = 0, dist = 0, size = 0;
  string qa, ta;  // gapped alignment strings (when requested)
};

// Per-(d, k) trace record: x before extension, x after extension, pre_k.
// Records for one d are contiguous; k = rec_min_k[d] + 2*slot.
struct TraceStore {
  vector<int> x1, x2, pre_k;
  vector<size_t> d_start;  // offset of each d's records
  vector<int> d_min_k;
};

bool ond_align(const uint8_t* q, int q_len, const uint8_t* t, int t_len,
               int band_tol, bool want_strings, AlnResult* out) {
  const long max_d = (long)(0.3 * (q_len + t_len));
  const long band_size = (long)band_tol * 2;
  if (max_d <= 0) return false;

  vector<int> V(2 * max_d + 1, 0), U(2 * max_d + 1, 0);
  const long off = max_d;

  TraceStore tr;
  if (want_strings) {
    tr.d_start.reserve(max_d + 1);
    tr.d_min_k.reserve(max_d + 1);
  }

  long best_m = -1;
  long min_k = 0, max_k = 0;
  bool aligned = false;
  long fin_d = 0, fin_k = 0, fin_x = 0, fin_y = 0;

  for (long d = 0; d < max_d; ++d) {
    if (max_k - min_k > band_size) break;

    if (want_strings) {
      tr.d_start.push_back(tr.x1.size());
      tr.d_min_k.push_back((int)min_k);
    }

    for (long k = min_k; k <= max_k; k += 2) {
      long x, pre_k;
      if (k == min_k || (k != max_k && V[k - 1 + off] < V[k + 1 + off])) {
        pre_k = k + 1;
        x = V[k + 1 + off];
      } else {
        pre_k = k - 1;
        x = V[k - 1 + off] + 1;
      }
      long y = x - k;
      const long x0 = x;
      while (x < q_len && y < t_len && q[x] == t[y]) {
        ++x;
        ++y;
      }
      if (want_strings) {
        tr.x1.push_back((int)x0);
        tr.x2.push_back((int)x);
        tr.pre_k.push_back((int)pre_k);
      }
      V[k + off] = (int)x;
      U[k + off] = (int)(x + y);
      if (x + y > best_m) best_m = x + y;
      if (x >= q_len || y >= t_len) {
        aligned = true;
        fin_d = d;
        fin_k = k;
        fin_x = x;
        fin_y = y;
        break;
      }
    }

    // band trimming over the old [min_k, max_k]
    long new_min_k = max_k, new_max_k = min_k;
    for (long k2 = min_k; k2 <= max_k; k2 += 2) {
      if (U[k2 + off] >= best_m - band_tol) {
        if (k2 < new_min_k) new_min_k = k2;
        if (k2 > new_max_k) new_max_k = k2;
      }
    }
    min_k = new_min_k - 1;
    max_k = new_max_k + 1;
    if (aligned) break;
  }

  if (!aligned) return false;

  out->q_e = (int)fin_x;
  out->t_e = (int)fin_y;
  out->dist = (int)fin_d;
  out->size = (int)((fin_x + fin_y + fin_d) / 2);
  out->q_s = 0;
  out->t_s = 0;
  if (!want_strings) return true;

  // traceback through the per-d trace records
  vector<std::pair<int, int>> path;
  long cd = fin_d, ck = fin_k;
  while (cd >= 0 && (long)path.size() < q_len + t_len + 1) {
    const size_t base = tr.d_start[cd];
    const size_t slot = (size_t)((ck - tr.d_min_k[cd]) / 2);
    const int x1 = tr.x1[base + slot];
    const int x2 = tr.x2[base + slot];
    const int y1 = x1 - (int)ck, y2 = x2 - (int)ck;
    path.push_back({x2, y2});
    path.push_back({x1, y1});
    ck = tr.pre_k[base + slot];
    --cd;
  }
  size_t idx = path.size() - 1;
  int cx = path[idx].first, cy = path[idx].second;
  out->q_s = cx;
  out->t_s = cy;
  string& qa = out->qa;
  string& ta = out->ta;
  qa.reserve(out->size + 16);
  ta.reserve(out->size + 16);
  long aln_pos = 0;
  while (idx > 0) {
    --idx;
    const int nx = path[idx].first, ny = path[idx].second;
    if (cx == nx && cy == ny) continue;
    if (nx == cx && ny != cy) {  // advance in y
      qa.append(ny - cy, '-');
      for (int i = cy; i < ny; ++i) ta.push_back((char)t[i]);
      aln_pos += ny - cy;
    } else if (nx != cx && ny == cy) {  // advance in x
      for (int i = cx; i < nx; ++i) qa.push_back((char)q[i]);
      ta.append(nx - cx, '-');
      aln_pos += nx - cx;
    } else {  // diagonal
      for (int i = cx; i < nx; ++i) qa.push_back((char)q[i]);
      for (int i = cy; i < ny; ++i) ta.push_back((char)t[i]);
      aln_pos += ny - cy;
    }
    cx = nx;
    cy = ny;
  }
  out->size = (int)aln_pos;
  return true;
}

// ------------------------------------------------------------- k-mer table

// diag >> bin_shift below relies on arithmetic right shift of negative
// int64 (implementation-defined pre-C++20; guaranteed on gcc/clang)
static_assert((-1 >> 1) == -1, "arithmetic right shift required");

struct KmerIndex {
  int K;
  vector<int> starts;     // per key: offset into pos
  vector<int> counts;
  vector<int> pos;        // positions sorted by key then position
  explicit KmerIndex(const uint8_t* seq, int len, int K_) : K(K_) {
    const int nkeys = 1 << (2 * K);
    // code map: ACGT->0..3, other->0xff
    vector<int> codes(len);
    for (int i = 0; i < len; ++i) {
      switch (seq[i]) {
        case 'A': codes[i] = 0; break;
        case 'C': codes[i] = 1; break;
        case 'G': codes[i] = 2; break;
        case 'T': codes[i] = 3; break;
        default: codes[i] = 0xff; break;
      }
    }
    const int n = len - K;  // final k-mer at len-K excluded (ref quirk)
    counts.assign(nkeys, 0);
    starts.assign(nkeys + 1, 0);
    if (n <= 0) return;
    vector<int> keys(n);
    long key = 0;
    const long mask = (1L << (2 * K)) - 1;
    for (int i = 0; i < K; ++i) key = (key << 2) | (codes[i] & 3);
    for (int i = 0; i < n; ++i) {
      keys[i] = (int)key;
      ++counts[key];
      key = ((key << 2) | (codes[i + K] & 3)) & mask;
    }
    for (int k = 0; k < nkeys; ++k) starts[k + 1] = starts[k] + counts[k];
    pos.resize(n);
    vector<int> fill(starts.begin(), starts.end() - 1);
    for (int i = 0; i < n; ++i) pos[fill[keys[i]]++] = i;
  }
};

struct Hits {
  vector<int> q, t;
};

Hits find_hits(const KmerIndex& idx, const uint8_t* seq, int len) {
  Hits h;
  const int K = idx.K;
  const int half = K >> 1;
  if (len - K <= 0) return h;
  vector<int> codes(len);
  for (int i = 0; i < len; ++i) {
    switch (seq[i]) {
      case 'A': codes[i] = 0; break;
      case 'C': codes[i] = 1; break;
      case 'G': codes[i] = 2; break;
      case 'T': codes[i] = 3; break;
      default: codes[i] = 0xff; break;
    }
  }
  for (int i = 0; i < len - K; i += half) {
    long key = 0;
    for (int j = 0; j < K; ++j) key = (key << 2) | (codes[i + j] & 3);
    const int s = idx.starts[key], e = idx.starts[key + 1];
    for (int p = s; p < e; ++p) {
      h.q.push_back(i);
      h.t.push_back(idx.pos[p]);
    }
  }
  return h;
}

struct Range {
  int s1 = 0, e1 = 0, s2 = 0, e2 = 0;
  long score = 0;
};

// diagonal-histogram + Kadane range finder (ops/kmer.py
// find_best_aln_range semantics)
Range best_aln_range(const Hits& h, int bin_size, int count_th) {
  Range r;
  const size_t n = h.q.size();
  if (n == 0) return r;
  long d_min = LONG_MAX;
  for (size_t i = 0; i < n; ++i) {
    const long d = (long)h.q[i] - h.t[i];
    if (d < d_min) d_min = d;
  }
  long nbins = 0;
  vector<long> bins(n);
  for (size_t i = 0; i < n; ++i) {
    bins[i] = ((long)h.q[i] - h.t[i] - d_min) / bin_size;
    if (bins[i] + 1 > nbins) nbins = bins[i] + 1;
  }
  vector<long> cnt(nbins, 0);
  for (size_t i = 0; i < n; ++i) ++cnt[bins[i]];

  long max_count = 0, max_bin = -1;
  for (size_t i = 0; i < n; ++i) {
    if (cnt[bins[i]] > max_count) {
      max_count = cnt[bins[i]];
      max_bin = bins[i];
    }
  }
  vector<int> qc, tc;
  if (max_bin >= 0 && max_count > count_th) {
    for (size_t i = 0; i < n; ++i) {
      if (labs(bins[i] - max_bin) > 5) continue;
      if (cnt[bins[i]] > count_th) {
        qc.push_back(h.q[i]);
        tc.push_back(h.t[i]);
      }
    }
  }
  const size_t j = qc.size();
  if (j > 1) {
    r.s1 = r.e1 = qc[0];
    r.s2 = r.e2 = tc[0];
    long max_score = 0, cur = 0;
    size_t cur_start = 0;
    for (size_t i = 1; i < j; ++i) {
      cur += 32 - (qc[i] - qc[i - 1]);
      if (cur < 0) {
        cur = 0;
        cur_start = i;
      } else if (cur > max_score) {
        r.s1 = qc[cur_start];
        r.s2 = tc[cur_start];
        r.e1 = qc[i];
        r.e2 = tc[i];
        max_score = cur;
        r.score = max_score;
      }
    }
  }
  return r;
}

// ------------------------------------------------------------ consensus DP

struct Link {
  int p_t;
  uint8_t p_delta;
  uint8_t p_base;
  int count;
};

struct Col {
  int count = 0;
  double score = -1.0;
  int best_p_t = -1;
  uint8_t best_p_delta = 0;
  uint8_t best_p_base = 0;
  vector<Link> links;  // first-occurrence order
};

inline int base_idx(char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    case '-': return 4;
    default: return 4;  // non-ACGT- routed to the gap column
  }
}

struct Tag {
  int t_pos;
  uint8_t delta;
  char q_base;
  int p_t_pos;
  uint8_t p_delta;
  char p_q_base;
};

void make_tags(const string& qa, const string& ta, int s1, int s2,
               int t_offset, vector<Tag>* tags) {
  int i = s1 - 1, j = s2 - 1, jj = 0, p_j = -1, p_jj = 0;
  char p_q_base = '.';
  for (size_t k = 0; k < qa.size(); ++k) {
    if (qa[k] != '-') {
      ++i;
      ++jj;
    }
    if (ta[k] != '-') {
      ++j;
      jj = 0;
    }
    if (j + t_offset >= 0 && jj < 255 && p_jj < 255) {
      tags->push_back({j + t_offset, (uint8_t)jj, qa[k], p_j + t_offset,
                       (uint8_t)p_jj, p_q_base});
      p_j = j;
      p_jj = jj;
      p_q_base = qa[k];
    } else {
      break;
    }
  }
}

struct ColKey {
  int t;
  uint8_t delta;
  uint8_t base;
  bool operator==(const ColKey& o) const {
    return t == o.t && delta == o.delta && base == o.base;
  }
};
struct ColKeyHash {
  size_t operator()(const ColKey& k) const {
    return ((size_t)k.t << 11) ^ ((size_t)k.delta << 3) ^ k.base;
  }
};

string cns_from_tag_seqs(const vector<vector<Tag>>& tag_seqs, int t_len,
                         int min_cov) {
  vector<int> coverage(t_len, 0), max_delta(t_len, 0);
  std::unordered_map<ColKey, Col, ColKeyHash> cols;
  cols.reserve(t_len * 3);

  int t_pos = 0;
  for (const auto& tags : tag_seqs) {
    for (const auto& tg : tags) {
      if (tg.delta == 0) {
        t_pos = tg.t_pos;
        ++coverage[t_pos];
      }
      if (tg.delta > max_delta[t_pos]) max_delta[t_pos] = tg.delta;
      const ColKey key{t_pos, tg.delta, (uint8_t)base_idx(tg.q_base)};
      Col& col = cols[key];
      ++col.count;
      const int pb = base_idx(tg.p_q_base);
      bool found = false;
      for (auto& ln : col.links) {
        if (ln.p_t == tg.p_t_pos && ln.p_delta == tg.p_delta &&
            ln.p_base == (uint8_t)pb) {
          ++ln.count;
          found = true;
          break;
        }
      }
      if (!found) col.links.push_back({tg.p_t_pos, tg.p_delta, (uint8_t)pb, 1});
    }
  }

  // forward scoring in (t_pos, delta, base) order; strict '>' tie-breaking
  double g_best_score = -1.0;
  const Col* g_best_col = nullptr;
  int g_best_ck = -1, g_best_t = 0;
  for (int i = 0; i < t_len; ++i) {
    const double cov_term = 0.5 * coverage[i];
    for (int dj = 0; dj <= max_delta[i]; ++dj) {
      for (int kk = 0; kk < 5; ++kk) {
        auto it = cols.find(ColKey{i, (uint8_t)dj, (uint8_t)kk});
        if (it == cols.end()) continue;
        Col& col = it->second;
        double best = -1.0;
        int bck = -1;
        for (size_t ck = 0; ck < col.links.size(); ++ck) {
          const Link& ln = col.links[ck];
          double s;
          if (ln.p_t == -1) {
            s = (double)ln.count - cov_term;
          } else {
            auto pit = cols.find(ColKey{ln.p_t, ln.p_delta, ln.p_base});
            const double ps = (pit == cols.end()) ? -1.0 : pit->second.score;
            s = ps + (double)ln.count - cov_term;
          }
          if (s > best) {
            best = s;
            col.best_p_t = ln.p_t;
            col.best_p_delta = ln.p_delta;
            col.best_p_base = ln.p_base;
            bck = (int)ck;
          }
        }
        col.score = best;
        if (best > g_best_score) {
          g_best_score = best;
          g_best_col = &col;
          g_best_ck = bck;
          g_best_t = i;
        }
      }
    }
  }
  if (!g_best_col || g_best_score == -1.0) return "";

  // backtrack, preserving the reference's first-base-from-link-index quirk
  string out;
  int ck = g_best_ck;
  int i = g_best_t;
  const Col* cur = g_best_col;
  long index = 0;
  static const char UP[] = "ACGT-";
  static const char LO[] = "acgt-";
  while (true) {
    char bb = '$';
    if (ck >= 0 && ck < 5) bb = (coverage[i] > min_cov) ? UP[ck] : LO[ck];
    const int pi = cur->best_p_t;
    i = pi;
    if (i == -1 || index >= (long)t_len * 2) break;
    ck = cur->best_p_base;
    auto it = cols.find(ColKey{pi, cur->best_p_delta, cur->best_p_base});
    if (it == cols.end()) break;  // unreachable for t_offset==0 inputs
    cur = &it->second;
    if (bb != '-') {
      out.push_back(bb);
      ++index;
    }
  }
  std::reverse(out.begin(), out.end());
  return out;
}

string generate_consensus_impl(const char** seqs, unsigned n_seq,
                               unsigned min_cov, unsigned K, double min_idt) {
  if (n_seq == 0) return "";
  const double max_diff = 1.0 - min_idt;
  const uint8_t* seed = (const uint8_t*)seqs[0];
  const int seed_len = (int)strlen(seqs[0]);
  KmerIndex idx(seed, seed_len, (int)K);

  vector<vector<Tag>> tag_seqs;
  for (unsigned j = 1; j < n_seq; ++j) {
    const uint8_t* s = (const uint8_t*)seqs[j];
    const int slen = (int)strlen(seqs[j]);
    Hits h = find_hits(idx, s, slen);
    if (h.q.empty()) continue;
    Range r = best_aln_range(h, (int)(K * 6), 5);
    if (r.e1 - r.s1 < 100 || r.e2 - r.s2 < 100 ||
        abs((r.e1 - r.s1) - (r.e2 - r.s2)) >
            (int)(0.5 * 0.10 * (r.e1 - r.s1 + r.e2 - r.s2)))
      continue;
    AlnResult aln;
    if (!ond_align(s + r.s1, r.e1 - r.s1, seed + r.s2, r.e2 - r.s2, 150,
                   true, &aln))
      continue;
    if (aln.size > 500 && ((double)aln.dist / (double)aln.size) < max_diff) {
      tag_seqs.emplace_back();
      make_tags(aln.qa, aln.ta, r.s1, r.s2, 0, &tag_seqs.back());
    }
  }
  if (tag_seqs.empty()) return "";
  return cns_from_tag_seqs(tag_seqs, seed_len, (int)min_cov);
}

}  // namespace

extern "C" {

char* ftpu_generate_consensus(const char** seqs, unsigned n_seq,
                              unsigned min_cov, unsigned K, double min_idt) {
  const string s = generate_consensus_impl(seqs, n_seq, min_cov, K, min_idt);
  char* out = (char*)malloc(s.size() + 1);
  memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

void ftpu_free(char* p) { free(p); }

// Consensus from precomputed gapped alignments -- the back half of
// generate_consensus (tags -> MSA -> DP -> backtrack) with the seeding and
// alignment already done elsewhere (the TPU alignment+traceback kernel,
// falcon_tpu_torch/ops/align_tb.py).  qas/tas: n NUL-terminated gapped ASCII
// strings; s1s/s2s: the per-alignment range starts in support/seed
// coordinates (the reference's aln_range s1/s2, falcon.c:119-120).
char* ftpu_cns_from_alns(int t_len, int n, const char** qas,
                         const char** tas, const int* s1s, const int* s2s,
                         unsigned min_cov) {
  vector<vector<Tag>> tag_seqs;
  tag_seqs.reserve(n);
  for (int j = 0; j < n; ++j) {
    tag_seqs.emplace_back();
    make_tags(string(qas[j]), string(tas[j]), s1s[j], s2s[j], 0,
              &tag_seqs.back());
  }
  string s;
  if (!tag_seqs.empty()) s = cns_from_tag_seqs(tag_seqs, t_len, (int)min_cov);
  char* out = (char*)malloc(s.size() + 1);
  memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

// Banded O(ND) alignment.  out6 = [q_s, q_e, t_s, t_e, dist, size].
// With want_strings, *q_aln/*t_aln receive malloc'd NUL-terminated gapped
// strings (caller frees with ftpu_free).  Returns 1 if aligned.
int ftpu_align(const char* q, int q_len, const char* t, int t_len,
               int band_tol, int want_strings, int* out6, char** q_aln,
               char** t_aln) {
  AlnResult r;
  const bool ok = ond_align((const uint8_t*)q, q_len, (const uint8_t*)t,
                            t_len, band_tol, want_strings != 0, &r);
  out6[0] = r.q_s;
  out6[1] = r.q_e;
  out6[2] = r.t_s;
  out6[3] = r.t_e;
  out6[4] = r.dist;
  out6[5] = r.size;
  if (want_strings) {
    char* qa = (char*)malloc(r.qa.size() + 1);
    memcpy(qa, r.qa.c_str(), r.qa.size() + 1);
    char* ta = (char*)malloc(r.ta.size() + 1);
    memcpy(ta, r.ta.c_str(), r.ta.size() + 1);
    *q_aln = qa;
    *t_aln = ta;
  }
  return ok ? 1 : 0;
}

}  // extern "C"

// ------------------------------------------------- block seed matching
//
// The overlap engine's seed join (the daligner-equivalent inner loop of
// block x block comparison): build a sorted k-mer table over the target
// block, then stream the query block's k-mers (at `stride`) against it.
// Positions are in flat block coordinates; k-mers crossing read
// boundaries or containing non-ACGT codes are skipped; over-represented
// target k-mers (count > max_freq) are masked (the daligner -t analog).

static void pack_kmers(const uint8_t* codes, const int64_t* offsets,
                       long n_reads, int K, int stride,
                       vector<uint64_t>& out) {
  // packed = key << SHIFT | flat_pos, per read, skipping non-ACGT
  const int SHIFT = 34;
  const uint32_t kmask = (uint32_t)((1ULL << (2 * K)) - 1);
  out.clear();
  out.reserve((size_t)(offsets[n_reads] / (stride > 1 ? stride : 1)) + 1);
  for (long r = 0; r < n_reads; ++r) {
    const int64_t beg = offsets[r], end = offsets[r + 1];
    uint32_t key = 0;
    int valid = 0;
    for (int64_t i = beg; i < end; ++i) {
      const uint8_t c = codes[i];
      if (c > 3) {
        valid = 0;
        key = 0;
        continue;
      }
      key = ((key << 2) | c) & kmask;
      if (++valid < K) continue;
      const int64_t pos = i - K + 1;
      if (stride > 1 && ((pos - beg) % stride) != 0) continue;
      out.push_back(((uint64_t)key << SHIFT) | (uint64_t)pos);
    }
  }
}

static inline long read_of(const int64_t* offsets, long n, int64_t pos,
                           long hint) {
  // find r with offsets[r] <= pos < offsets[r+1]; hint = last answer
  // (positions of one run arrive roughly clustered)
  if (offsets[hint] <= pos && pos < offsets[hint + 1]) return hint;
  long lo = 0, hi = n;  // invariant: offsets[lo] <= pos < offsets[hi]
  while (hi - lo > 1) {
    const long mid = (lo + hi) >> 1;
    if (offsets[mid] <= pos) lo = mid; else hi = mid;
  }
  return lo;
}

long ftpu_seed_hits_impl(const uint8_t* q_codes, const int64_t* q_offsets,
                         long n_q, const uint8_t* t_codes,
                         const int64_t* t_offsets, long n_t, int K,
                         int stride, int max_freq, int64_t** q_pos_out,
                         int64_t** t_pos_out) {
  // Sort both sides and do one linear merge join over equal-key runs.
  // (A per-query binary search over the target table is ~25 dependent
  // cache misses per k-mer -- tens of seconds per 200MB block pair; the
  // merge join is two sequential scans.)
  const int SHIFT = 34;  // packed = key << SHIFT | pos
  const uint64_t POS_MASK = (1ULL << SHIFT) - 1;

  vector<uint64_t> table, qarr;
  pack_kmers(t_codes, t_offsets, n_t, K, 1, table);
  pack_kmers(q_codes, q_offsets, n_q, K, stride, qarr);
  std::sort(table.begin(), table.end());
  std::sort(qarr.begin(), qarr.end());

  vector<int64_t> qhits, thits;
  qhits.reserve(1 << 20);
  thits.reserve(1 << 20);
  const size_t nq = qarr.size(), nt = table.size();
  size_t i = 0, j = 0;
  while (i < nq && j < nt) {
    const uint64_t qk = qarr[i] >> SHIFT;
    const uint64_t tk = table[j] >> SHIFT;
    if (qk < tk) { ++i; continue; }
    if (tk < qk) { ++j; continue; }
    size_t ie = i + 1;
    while (ie < nq && (qarr[ie] >> SHIFT) == qk) ++ie;
    size_t je = j + 1;
    while (je < nt && (table[je] >> SHIFT) == tk) ++je;
    if ((long)(je - j) <= max_freq) {
      for (size_t a = i; a < ie; ++a) {
        const int64_t qpos = (int64_t)(qarr[a] & POS_MASK);
        for (size_t b = j; b < je; ++b) {
          qhits.push_back(qpos);
          thits.push_back((int64_t)(table[b] & POS_MASK));
        }
      }
    }
    i = ie;
    j = je;
  }
  const long n = (long)qhits.size();
  int64_t* qp = (int64_t*)malloc(sizeof(int64_t) * (n ? n : 1));
  int64_t* tp = (int64_t*)malloc(sizeof(int64_t) * (n ? n : 1));
  memcpy(qp, qhits.data(), sizeof(int64_t) * n);
  memcpy(tp, thits.data(), sizeof(int64_t) * n);
  *q_pos_out = qp;
  *t_pos_out = tp;
  return n;
}

// Like ftpu_seed_hits but emits per-hit READ indices and LOCAL positions
// as int32 (a_idx, qpos, b_idx, tpos), replacing the caller's
// searchsorted coordinate mapping over tens of millions of hits.
long ftpu_seed_hits_idx_impl(const uint8_t* q_codes,
                             const int64_t* q_offsets, long n_q,
                             const uint8_t* t_codes,
                             const int64_t* t_offsets, long n_t, int K,
                             int stride, int max_freq, int32_t** out4) {
  const int SHIFT = 34;
  const uint64_t POS_MASK = (1ULL << SHIFT) - 1;

  vector<uint64_t> table, qarr;
  pack_kmers(t_codes, t_offsets, n_t, K, 1, table);
  pack_kmers(q_codes, q_offsets, n_q, K, stride, qarr);
  std::sort(table.begin(), table.end());
  std::sort(qarr.begin(), qarr.end());

  vector<int32_t> ai, qp, bi, tp;
  ai.reserve(1 << 20); qp.reserve(1 << 20);
  bi.reserve(1 << 20); tp.reserve(1 << 20);
  const size_t nq = qarr.size(), nt = table.size();
  size_t i = 0, j = 0;
  long q_hint = 0, t_hint = 0;
  while (i < nq && j < nt) {
    const uint64_t qk = qarr[i] >> SHIFT;
    const uint64_t tk = table[j] >> SHIFT;
    if (qk < tk) { ++i; continue; }
    if (tk < qk) { ++j; continue; }
    size_t ie = i + 1;
    while (ie < nq && (qarr[ie] >> SHIFT) == qk) ++ie;
    size_t je = j + 1;
    while (je < nt && (table[je] >> SHIFT) == tk) ++je;
    if ((long)(je - j) <= max_freq) {
      for (size_t a = i; a < ie; ++a) {
        const int64_t qflat = (int64_t)(qarr[a] & POS_MASK);
        q_hint = read_of(q_offsets, n_q, qflat, q_hint);
        const int32_t a_read = (int32_t)q_hint;
        const int32_t q_loc = (int32_t)(qflat - q_offsets[q_hint]);
        for (size_t b = j; b < je; ++b) {
          const int64_t tflat = (int64_t)(table[b] & POS_MASK);
          t_hint = read_of(t_offsets, n_t, tflat, t_hint);
          ai.push_back(a_read);
          qp.push_back(q_loc);
          bi.push_back((int32_t)t_hint);
          tp.push_back((int32_t)(tflat - t_offsets[t_hint]));
        }
      }
    }
    i = ie;
    j = je;
  }
  const long n = (long)ai.size();
  const size_t sz = sizeof(int32_t) * (n ? n : 1);
  for (int c = 0; c < 4; ++c) out4[c] = (int32_t*)malloc(sz);
  memcpy(out4[0], ai.data(), sizeof(int32_t) * n);
  memcpy(out4[1], qp.data(), sizeof(int32_t) * n);
  memcpy(out4[2], bi.data(), sizeof(int32_t) * n);
  memcpy(out4[3], tp.data(), sizeof(int32_t) * n);
  return n;
}

// LSD radix sort, 11-bit digits.  ~3-4x std::sort on the 10^8-element
// k-mer tables of a 200MB block pair.  Only bits [lo_bit, hi_bit) are
// sorted: the packed k-mer tables carry the key in the top bits and the
// flat position as payload below, and every downstream reduction over an
// equal-key run (hit count, min-packed anchor) is order-invariant, so
// the 34 position bits never need sorting -- 3 passes instead of 6.
static void radix_sort_u64(vector<uint64_t>& v, int lo_bit, int hi_bit) {
  const int DIG = 11, NB = 1 << DIG;
  vector<uint64_t> tmp(v.size());
  size_t cnt[NB + 1];
  for (int shift = lo_bit; shift < hi_bit; shift += DIG) {
    memset(cnt, 0, sizeof(cnt));
    for (uint64_t x : v) ++cnt[((x >> shift) & (NB - 1)) + 1];
    for (int b = 0; b < NB; ++b) cnt[b + 1] += cnt[b];
    for (uint64_t x : v) tmp[cnt[(x >> shift) & (NB - 1)]++] = x;
    v.swap(tmp);
  }
}

struct Kv { uint64_t key, val; };

static void radix_sort_kv(vector<Kv>& v, int bits) {
  const int DIG = 11, NB = 1 << DIG;
  vector<Kv> tmp(v.size());
  size_t cnt[NB + 1];
  for (int shift = 0; shift < bits; shift += DIG) {
    memset(cnt, 0, sizeof(cnt));
    for (const Kv& x : v) ++cnt[((x.key >> shift) & (NB - 1)) + 1];
    for (int b = 0; b < NB; ++b) cnt[b + 1] += cnt[b];
    for (const Kv& x : v) tmp[cnt[(x.key >> shift) & (NB - 1)]++] = x;
    v.swap(tmp);
  }
}

// Fused seed join + diagonal-window chaining for one strand (the numpy
// falcon_tpu_torch.overlap.engine._chain_candidates semantics, kept in exact
// agreement -- see tests/test_engine_chain.py):
//   hit key = pair(a,b) * nbins + bin(qpos - tpos), radix-sorted;
//   per (pair, bin) run: count + min packed (qpos<<21|tpos);
//   window = run + next run when it is the pair's adjacent bin;
//   top-k DISJOINT windows per pair by (count desc, bin asc), each
//   >= min_hits (after a selection, runs within +-1 bin are suppressed
//   -- the daligner multiple-local-alignments analog);
//   anchor = window run's min, or the adjacent run's min when that one
//   starts strictly earlier on the query;
//   per-pair candidates emitted sorted by (qpos, tpos, count) to match
//   the numpy path's deterministic order.
// filter_mode: 0 = none, 1 = keep rids_a[a] < rids_b[b], 2 = keep !=.
// Returns n candidates; out6 = six int32 arrays (a, b, strand is the
// caller's, qpos, tpos, n_seeds) -- caller frees with ftpu_free_i32.
// Pack + key-sort one side's k-mer table (packed = key << 34 | flat_pos).
// The sorted table is reusable across every pair that side participates
// in: the driver caches B-side tables per (block, strand) and A-side
// tables per block, so each block's pack+sort runs once per phase
// instead of once per (pair, strand).
long ftpu_kmer_table_impl(const uint8_t* codes, const int64_t* offsets,
                          long n_reads, int K, int stride, uint64_t** out) {
  const int SHIFT = 34;
  vector<uint64_t> v;
  pack_kmers(codes, offsets, n_reads, K, stride, v);
  radix_sort_u64(v, SHIFT, SHIFT + 2 * K);
  const long n = (long)v.size();
  // multi-GB on 400MB blocks: a failed malloc must surface as a Python
  // MemoryError (negative sentinel), not a segfault in memcpy
  *out = (uint64_t*)malloc(sizeof(uint64_t) * (n ? n : 1));
  if (!*out) return -1;
  memcpy(*out, v.data(), sizeof(uint64_t) * n);
  return n;
}

long ftpu_seed_chain_tables_impl(
    const uint64_t* qarr_p, long nq_e, const uint64_t* table_p, long nt_e,
    const int64_t* q_offsets, long n_q, const int64_t* t_offsets, long n_t,
    int max_freq, int bin_size, int min_hits, int filter_mode, int topk,
    const int64_t* rids_a, const int64_t* rids_b, int32_t** out5) {
  const int SHIFT = 34;
  const uint64_t POS_MASK = (1ULL << SHIFT) - 1;

  // bin layout: diag in [-max_len, max_len]
  int64_t max_len = 1;
  for (long r = 0; r < n_q; ++r)
    max_len = std::max(max_len, q_offsets[r + 1] - q_offsets[r]);
  for (long r = 0; r < n_t; ++r)
    max_len = std::max(max_len, t_offsets[r + 1] - t_offsets[r]);
  const int64_t bin_base = max_len / bin_size + 2;
  const uint64_t nbins = 2 * bin_base + 3;
  int bin_shift = -1;   // >= 0 when bin_size == 1 << bin_shift
  for (int s = 0; s < 31; ++s)
    if ((1 << s) == bin_size) { bin_shift = s; break; }

  vector<Kv> hits;
  hits.reserve(1 << 20);
  const size_t nq = (size_t)nq_e, nt = (size_t)nt_e;
  const uint64_t* qarr = qarr_p;
  const uint64_t* table = table_p;
  struct timespec tm0, tm1;
  if (getenv("FTPU_CHAIN_PROF")) clock_gettime(CLOCK_MONOTONIC, &tm0);
  size_t i = 0, j = 0;
  long q_hint = 0, t_hint = 0;
  while (i < nq && j < nt) {
    const uint64_t qk = qarr[i] >> SHIFT;
    const uint64_t tk = table[j] >> SHIFT;
    if (qk < tk) { ++i; continue; }
    if (tk < qk) { ++j; continue; }
    size_t ie = i + 1;
    while (ie < nq && (qarr[ie] >> SHIFT) == qk) ++ie;
    size_t je = j + 1;
    while (je < nt && (table[je] >> SHIFT) == tk) ++je;
    if ((long)(je - j) <= max_freq) {
      for (size_t a = i; a < ie; ++a) {
        const int64_t qflat = (int64_t)(qarr[a] & POS_MASK);
        // positions stay ascending within an equal-key run (the radix
        // sort is stable on the top key bits only), so the hint-based
        // read_of is O(1) amortized -- measured equal to a flat
        // pos->read lookup table, which is why no such table exists.
        q_hint = read_of(q_offsets, n_q, qflat, q_hint);
        const int64_t q_loc = qflat - q_offsets[q_hint];
        const int64_t a_rid = rids_a[q_hint];
        for (size_t b = j; b < je; ++b) {
          const int64_t tflat = (int64_t)(table[b] & POS_MASK);
          t_hint = read_of(t_offsets, n_t, tflat, t_hint);
          const int64_t b_rid = rids_b[t_hint];
          if (filter_mode == 1 ? !(a_rid < b_rid)
                               : (filter_mode == 2 && a_rid == b_rid))
            continue;
          const int64_t t_loc = tflat - t_offsets[t_hint];
          const int64_t diag = q_loc - t_loc;
          // floor division (match python //); arithmetic shift when
          // bin_size is a power of two (the default 256) -- the two
          // integer divides are real per-hit cost at 10^8 hits/pair
          const int64_t bin =
              bin_shift >= 0 ? (diag >> bin_shift)
                             : (diag >= 0 ? diag / bin_size
                                : -((-diag + bin_size - 1) / bin_size));
          const uint64_t pair = (uint64_t)q_hint * (uint64_t)n_t
                                + (uint64_t)t_hint;
          hits.push_back({pair * nbins + (uint64_t)(bin + bin_base),
                          ((uint64_t)q_loc << 21) | (uint64_t)t_loc});
        }
      }
    }
    i = ie;
    j = je;
  }
  // key bits: pair < n_q*n_t (<= 2^42 for 2^21-read blocks) * nbins
  int key_bits = 1;
  {
    uint64_t mx = (uint64_t)n_q * (uint64_t)n_t * nbins + nbins;
    while ((1ULL << key_bits) < mx && key_bits < 63) ++key_bits;
  }
  struct timespec tj0, tj1;
  const bool prof = getenv("FTPU_CHAIN_PROF") != nullptr;
  if (prof) clock_gettime(CLOCK_MONOTONIC, &tj0);
  radix_sort_kv(hits, key_bits);
  if (prof) {
    clock_gettime(CLOCK_MONOTONIC, &tj1);
    fprintf(stderr, "[chain] %zu hits: join %.2fs, sort(%d bits) %.2fs\n",
            hits.size(),
            (tj0.tv_sec - tm0.tv_sec) + 1e-9 * (tj0.tv_nsec - tm0.tv_nsec),
            key_bits,
            (tj1.tv_sec - tj0.tv_sec) + 1e-9 * (tj1.tv_nsec - tj0.tv_nsec));
    tm1 = tj1;
  }

  // scan runs -> per-pair best window -> candidates
  vector<int32_t> oa, ob, oq, ot, oc;
  const size_t nh = hits.size();
  size_t r = 0;
  // per-run arrays for the current pair
  vector<uint64_t> rbin;
  vector<int64_t> rcnt;
  vector<uint64_t> rmin;
  while (r < nh) {
    const uint64_t pair = hits[r].key / nbins;
    rbin.clear(); rcnt.clear(); rmin.clear();
    while (r < nh && hits[r].key / nbins == pair) {
      const uint64_t key = hits[r].key;
      uint64_t mn = hits[r].val;
      int64_t c = 0;
      while (r < nh && hits[r].key == key) {
        mn = std::min(mn, hits[r].val);
        ++c; ++r;
      }
      rbin.push_back(key % nbins);
      rcnt.push_back(c);
      rmin.push_back(mn);
    }
    // top-k windows: count(run)+count(adjacent next) desc, then bin
    // asc; after each pick, suppress runs within +-1 bin (a window
    // covers bins {b, b+1}; disjointness needs |b' - b| >= 2).  comb
    // values are computed once (not re-derived after suppression) --
    // the numpy _chain_candidates does the same.
    const long nr = (long)rbin.size();
    std::vector<int64_t> comb(nr);
    for (long x = 0; x < nr; ++x) {
      comb[x] = rcnt[x];
      if (x + 1 < nr && rbin[x + 1] == rbin[x] + 1) comb[x] += rcnt[x + 1];
    }
    std::vector<char> alive(nr, 1);
    // per-pair candidates (qpos, tpos, count), sorted before emission
    std::vector<std::tuple<int32_t, int32_t, int32_t>> pcands;
    for (int round = 0; round < (topk > 0 ? topk : 1); ++round) {
      long best = -1;
      int64_t best_comb = -1;
      for (long x = 0; x < nr; ++x)
        if (alive[x] && comb[x] > best_comb) {
          best_comb = comb[x];
          best = x;
        }
      if (best < 0 || best_comb < min_hits) break;
      uint64_t anchor = rmin[best];
      if (best + 1 < nr && rbin[best + 1] == rbin[best] + 1 &&
          (rmin[best + 1] >> 21) < (anchor >> 21))
        anchor = rmin[best + 1];
      pcands.emplace_back((int32_t)(anchor >> 21),
                          (int32_t)(anchor & ((1ULL << 21) - 1)),
                          (int32_t)std::min<int64_t>(best_comb, INT32_MAX));
      const uint64_t b0 = rbin[best];
      for (long x = 0; x < nr; ++x)
        if (alive[x] && rbin[x] + 1 >= b0 && rbin[x] <= b0 + 1)
          alive[x] = 0;
    }
    std::sort(pcands.begin(), pcands.end());
    for (const auto& pc : pcands) {
      oa.push_back((int32_t)(pair / (uint64_t)n_t));
      ob.push_back((int32_t)(pair % (uint64_t)n_t));
      oq.push_back(std::get<0>(pc));
      ot.push_back(std::get<1>(pc));
      oc.push_back(std::get<2>(pc));
    }
  }
  if (getenv("FTPU_CHAIN_PROF")) {
    struct timespec te;
    clock_gettime(CLOCK_MONOTONIC, &te);
    fprintf(stderr, "[chain] scan %.2fs, %zu cands\n",
            (te.tv_sec - tm1.tv_sec) + 1e-9 * (te.tv_nsec - tm1.tv_nsec),
            oa.size());
  }
  const long n = (long)oa.size();
  const size_t sz = sizeof(int32_t) * (n ? n : 1);
  for (int c = 0; c < 5; ++c) out5[c] = (int32_t*)malloc(sz);
  memcpy(out5[0], oa.data(), sizeof(int32_t) * n);
  memcpy(out5[1], ob.data(), sizeof(int32_t) * n);
  memcpy(out5[2], oq.data(), sizeof(int32_t) * n);
  memcpy(out5[3], ot.data(), sizeof(int32_t) * n);
  memcpy(out5[4], oc.data(), sizeof(int32_t) * n);
  return n;
}

long ftpu_seed_chain_impl(const uint8_t* q_codes, const int64_t* q_offsets,
                          long n_q, const uint8_t* t_codes,
                          const int64_t* t_offsets, long n_t, int K,
                          int stride, int max_freq, int bin_size,
                          int min_hits, int filter_mode, int topk,
                          const int64_t* rids_a, const int64_t* rids_b,
                          int32_t** out5) {
  const int SHIFT = 34;
  vector<uint64_t> table, qarr;
  pack_kmers(t_codes, t_offsets, n_t, K, 1, table);
  pack_kmers(q_codes, q_offsets, n_q, K, stride, qarr);
  radix_sort_u64(table, SHIFT, SHIFT + 2 * K);
  radix_sort_u64(qarr, SHIFT, SHIFT + 2 * K);
  return ftpu_seed_chain_tables_impl(
      qarr.data(), (long)qarr.size(), table.data(), (long)table.size(),
      q_offsets, n_q, t_offsets, n_t, max_freq, bin_size, min_hits,
      filter_mode, topk, rids_a, rids_b, out5);
}

// Batch gapped-alignment reconstruction from the device traceback
// kernel's packed move planes (ops.align_tb: 4 moves/byte, stream in
// END->START order, code 3 = inactive).  packed_t is the TRANSPOSED
// plane [n_lanes_total, P] so each lane's walk is contiguous.  For task
// i, lane lanes[i] is walked start->end emitting 'ACGT-' strings into
// caller-allocated qa/ta at out_offs[i]; returns columns per task.
void ftpu_moves_to_alns(const uint8_t* packed_t, long P, long n_tasks,
                        const int32_t* lanes, const uint8_t* qcat,
                        const int64_t* q_offs, const uint8_t* tcat,
                        const int64_t* t_offs, char* qa, char* ta,
                        const int64_t* out_offs, int32_t* ncols) {
  static const char BASE[] = "ACGT";
  for (long i = 0; i < n_tasks; ++i) {
    const uint8_t* col = packed_t + (int64_t)lanes[i] * P;
    const uint8_t* q = qcat + q_offs[i];
    const uint8_t* t = tcat + t_offs[i];
    char* qo = qa + out_offs[i];
    char* to = ta + out_offs[i];
    long n = 0, qi = -1, tj = -1;
    for (long p = P - 1; p >= 0; --p) {
      const uint8_t byte = col[p];
      if (byte == 0xFF) continue;  // 4x inactive
      for (int sub = 3; sub >= 0; --sub) {
        const int mv = (byte >> (2 * sub)) & 3;
        if (mv == 3) continue;
        if (mv != 1) ++qi;
        if (mv != 2) ++tj;
        qo[n] = (mv == 1) ? '-' : BASE[q[qi] > 3 ? 3 : q[qi]];
        to[n] = (mv == 2) ? '-' : BASE[t[tj] > 3 ? 3 : t[tj]];
        ++n;
      }
    }
    ncols[i] = (int32_t)n;
  }
}

extern "C" {

void ftpu_moves_to_alns_c(const uint8_t* packed_t, long P, long n_tasks,
                          const int32_t* lanes, const uint8_t* qcat,
                          const int64_t* q_offs, const uint8_t* tcat,
                          const int64_t* t_offs, char* qa, char* ta,
                          const int64_t* out_offs, int32_t* ncols) {
  ftpu_moves_to_alns(packed_t, P, n_tasks, lanes, qcat, q_offs, tcat,
                     t_offs, qa, ta, out_offs, ncols);
}

long ftpu_seed_hits(const uint8_t* q_codes, const int64_t* q_offsets,
                    long n_q, const uint8_t* t_codes,
                    const int64_t* t_offsets, long n_t, int K, int stride,
                    int max_freq, int64_t** q_pos_out,
                    int64_t** t_pos_out) {
  return ftpu_seed_hits_impl(q_codes, q_offsets, n_q, t_codes, t_offsets,
                             n_t, K, stride, max_freq, q_pos_out,
                             t_pos_out);
}

long ftpu_seed_chain(const uint8_t* q_codes, const int64_t* q_offsets,
                     long n_q, const uint8_t* t_codes,
                     const int64_t* t_offsets, long n_t, int K,
                     int stride, int max_freq, int bin_size, int min_hits,
                     int filter_mode, int topk, const int64_t* rids_a,
                     const int64_t* rids_b, int32_t** out5) {
  return ftpu_seed_chain_impl(q_codes, q_offsets, n_q, t_codes, t_offsets,
                              n_t, K, stride, max_freq, bin_size,
                              min_hits, filter_mode, topk, rids_a, rids_b,
                              out5);
}

long ftpu_kmer_table(const uint8_t* codes, const int64_t* offsets,
                     long n_reads, int K, int stride, uint64_t** out) {
  return ftpu_kmer_table_impl(codes, offsets, n_reads, K, stride, out);
}

long ftpu_seed_chain_tables(
    const uint64_t* qarr, long nq_e, const uint64_t* table, long nt_e,
    const int64_t* q_offsets, long n_q, const int64_t* t_offsets, long n_t,
    int max_freq, int bin_size, int min_hits, int filter_mode, int topk,
    const int64_t* rids_a, const int64_t* rids_b, int32_t** out5) {
  return ftpu_seed_chain_tables_impl(
      qarr, nq_e, table, nt_e, q_offsets, n_q, t_offsets, n_t, max_freq,
      bin_size, min_hits, filter_mode, topk, rids_a, rids_b, out5);
}

void ftpu_free_u64(uint64_t* p) { free(p); }

long ftpu_seed_hits_idx(const uint8_t* q_codes, const int64_t* q_offsets,
                        long n_q, const uint8_t* t_codes,
                        const int64_t* t_offsets, long n_t, int K,
                        int stride, int max_freq, int32_t** out4) {
  return ftpu_seed_hits_idx_impl(q_codes, q_offsets, n_q, t_codes,
                                 t_offsets, n_t, K, stride, max_freq,
                                 out4);
}

void ftpu_free_i64(int64_t* p) { free(p); }

void ftpu_free_i32(int32_t* p) { free(p); }

}  // extern "C"

// ------------------------------------------------------------- soft masks
// C++ ports of falcon_tpu_torch.io.masking.dust_mask / tandem_mask with
// BIT-IDENTICAL output (pinned by tests/test_masking.py parity cases).
// The python versions are numpy-vectorized but still cost ~0.7s/Mbase on
// the 2-core host (815s of the 40Mb e2e); these are single linear passes.

namespace {

// ok[i] = triplet/k-mer window [i, i+K) has no non-ACGT base and does not
// cross a read boundary; also fills keys (2-bit rolling).
static void kmer_keys_ok(const uint8_t* codes, long n,
                         const int64_t* offsets, long n_reads, int K,
                         std::vector<int32_t>& keys,
                         std::vector<char>& ok) {
  const long nk = n - K + 1;
  if (nk <= 0) { keys.clear(); ok.clear(); return; }
  keys.assign(nk, 0);
  ok.assign(nk, 1);
  const int32_t mask = (int32_t)((1u << (2 * K)) - 1);
  int32_t key = 0;
  long bad_run = 0;   // # of bad bases in current window tail
  // rolling key over all positions; ok via counting bad bases in window
  // (recompute simple: track last bad index)
  long last_bad = -1;
  for (long i = 0; i < n; ++i) {
    const int c = codes[i];
    const int cc = (c > 3) ? 0 : c;
    if (c > 3) last_bad = i;
    key = ((key << 2) | cc) & mask;
    const long s = i - K + 1;
    if (s >= 0) {
      keys[s] = key;
      if (last_bad >= s) ok[s] = 0;
    }
  }
  (void)bad_run;
  // read-boundary invalidation: kmer starting in read r must end before
  // offsets[r+1]
  long r = 0;
  for (long s = 0; s < nk; ++s) {
    while (r + 1 < n_reads && s >= offsets[r + 1]) ++r;
    if (s + K > offsets[r + 1]) ok[s] = 0;
  }
}

long dust_mask_impl(const uint8_t* codes, long n, const int64_t* offsets,
                    long n_reads, int window, int max_dist,
                    double min_frac, uint8_t* mask_out) {
  memset(mask_out, 0, (size_t)n);
  if (n < 3) return 0;
  std::vector<int32_t> keys;
  std::vector<char> ok;
  kmer_keys_ok(codes, n, offsets, n_reads, 3, keys, ok);
  const long nk = (long)keys.size();
  // dstart: distance to read start, capped 255
  std::vector<uint8_t> dstart(nk);
  {
    long r = 0;
    for (long i = 0; i < nk; ++i) {
      while (r + 1 < n_reads && i >= offsets[r + 1]) ++r;
      const long d = i - offsets[r];
      dstart[i] = (uint8_t)(d > 255 ? 255 : d);
    }
  }
  // rep_b[i] = any j in [1, max_dist]: keys[i-j]==keys[i], both ok,
  // dstart[i] >= j
  std::vector<char> rep(nk, 0);
  for (long i = 1; i < nk; ++i) {
    if (!ok[i]) continue;
    const int jmax = (int)std::min<long>(max_dist, i);
    const int dmax = dstart[i];
    for (int j = 1; j <= jmax; ++j) {
      if (j > dmax) break;
      if (ok[i - j] && keys[i - j] == keys[i]) { rep[i] = 1; break; }
    }
  }
  const long w = std::min<long>(window, nk);
  if (w < 8) return 0;
  // sliding window count of rep over [i, i+w); hot paints [i, i+w+2)
  std::vector<int32_t> dif(n + 1, 0);
  long cnt = 0;
  for (long i = 0; i < w; ++i) cnt += rep[i];
  const double thr = min_frac * (double)w;
  long nwin = nk - w + 1;
  for (long i = 0; i < nwin; ++i) {
    if ((double)cnt >= thr) {
      dif[i] += 1;
      dif[std::min<long>(i + w + 2, n)] -= 1;
    }
    if (i + 1 < nwin) cnt += rep[i + w] - rep[i];
  }
  long acc = 0, painted = 0;
  for (long i = 0; i < n; ++i) {
    acc += dif[i];
    if (acc > 0) { mask_out[i] = 1; ++painted; }
  }
  return painted;
}

long tandem_mask_impl(const uint8_t* codes, long n, const int64_t* offsets,
                      long n_reads, int k, int max_period,
                      uint8_t* mask_out) {
  memset(mask_out, 0, (size_t)n);
  std::vector<int32_t> keys;
  std::vector<char> ok;
  kmer_keys_ok(codes, n, offsets, n_reads, k, keys, ok);
  const long nk = (long)keys.size();
  if (nk == 0) return 0;
  // distance to previous ok occurrence of the same key (exactly the
  // python _near_repeat_hits dedup-min semantics)
  std::vector<int64_t> last((size_t)1 << (2 * k), -1);
  std::vector<int64_t> hp;
  std::vector<int32_t> hd;
  hp.reserve(1 << 16);
  hd.reserve(1 << 16);
  long r = 0;
  for (long i = 0; i < nk; ++i) {
    if (!ok[i]) continue;
    const int32_t key = keys[i];
    const int64_t prev = last[(uint32_t)key];
    last[(uint32_t)key] = i;
    if (prev < 0) continue;
    const long d = i - prev;
    if (d <= 0 || d > max_period) continue;
    // same-read + period gates (hd >= k, start within the read)
    while (r + 1 < n_reads && i >= offsets[r + 1]) ++r;
    // r tracks read_of(i) only if i is visited ascending -- it is
    if (d < k) continue;
    if (i - d < offsets[r]) continue;
    hp.push_back(i);
    hd.push_back((int32_t)d);
  }
  const long nh = (long)hp.size();
  if (nh == 0) return 0;
  // confirmation: adjacent hits with close positions + consistent period
  std::vector<char> conf(nh, 0);
  for (long i = 0; i + 1 < nh; ++i) {
    if (hp[i + 1] - hp[i] <= 2 * k &&
        std::abs((long)hd[i + 1] - (long)hd[i]) <= 8) {
      conf[i] = 1;
      conf[i + 1] = 1;
    }
  }
  std::vector<int32_t> dif(n + 1, 0);
  for (long i = 0; i < nh; ++i) {
    if (!conf[i]) continue;
    dif[hp[i] - hd[i]] += 1;
    dif[std::min<long>(hp[i] + k, n)] -= 1;
  }
  long acc = 0, painted = 0;
  for (long i = 0; i < n; ++i) {
    acc += dif[i];
    if (acc > 0) { mask_out[i] = 1; ++painted; }
  }
  return painted;
}

}  // namespace

extern "C" {

long ftpu_dust_mask(const uint8_t* codes, long n, const int64_t* offsets,
                    long n_reads, int window, int max_dist,
                    double min_frac, uint8_t* mask_out) {
  return dust_mask_impl(codes, n, offsets, n_reads, window, max_dist,
                        min_frac, mask_out);
}

long ftpu_tandem_mask(const uint8_t* codes, long n,
                      const int64_t* offsets, long n_reads, int k,
                      int max_period, uint8_t* mask_out) {
  if (k < 4 || k > 14) return -1;   // last-seen table is 4^k entries
  return tandem_mask_impl(codes, n, offsets, n_reads, k, max_period,
                          mask_out);
}

}  // extern "C"
