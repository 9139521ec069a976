// Native runtime components of vln_goat_tpu_torch (C ABI, loaded via ctypes
// by native/lib.py).  The port's own copy of the JAX package's
// csrc/goat_native.cpp, the same functions and arithmetic:
// - apsp / nearest_view: the rendering-free MatterSim graph core
//   (connectivity graph -> all-pairs shortest paths + discretized-view
//   candidate geometry);
// - bleu_stats: corpus BLEU n-gram counting (fairseq/clib/libbleu
//   equivalent);
// - edit_distance_batch: batched Levenshtein (fairseq/clib/libnat
//   equivalent);
// - bucket_by_size: batch-by-size token bucketing
//   (fairseq/data/data_utils_fast.pyx equivalent);
// - kmeans_lloyd: Lloyd iterations;
// - token_block_slices / block_to_dataset_index: fairseq's
//   token_block_utils_fast.
//
// Build: native/lib.py compiles it at first use with
// g++ -O3 -fPIC -std=c++17 -shared into vln_goat_tpu_torch/build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// All-pairs shortest paths over a weighted undirected graph.
// edges: E pairs (a[i], b[i]) with weight w[i].  Outputs row-major [V, V]:
// dist (FLT_MAX-ish 1e30 when unreachable), hops (#edges), nexthop (first
// node after the source on the shortest path; -1 unreachable, diag = self).
void apsp(int V, int E, const int32_t* ea, const int32_t* eb, const float* w,
          float* dist, int32_t* hops, int32_t* nexthop) {
  std::vector<std::vector<std::pair<int, float>>> adj(V);
  for (int i = 0; i < E; ++i) {
    adj[ea[i]].push_back({eb[i], w[i]});
    adj[eb[i]].push_back({ea[i], w[i]});
  }
  const float INF = 1e30f;
  std::vector<float> d(V);
  std::vector<int> h(V), pred(V);
  using QE = std::pair<float, int>;
  for (int s = 0; s < V; ++s) {
    std::fill(d.begin(), d.end(), INF);
    std::fill(h.begin(), h.end(), 0);
    std::fill(pred.begin(), pred.end(), -1);
    d[s] = 0.f;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    pq.push({0.f, s});
    while (!pq.empty()) {
      auto [du, u] = pq.top();
      pq.pop();
      if (du > d[u]) continue;
      for (auto [v, wv] : adj[u]) {
        float nd = du + wv;
        if (nd < d[v] - 1e-12f) {
          d[v] = nd;
          h[v] = h[u] + 1;
          pred[v] = u;
          pq.push({nd, v});
        }
      }
    }
    for (int t = 0; t < V; ++t) {
      dist[(size_t)s * V + t] = d[t];
      hops[(size_t)s * V + t] = h[t];
      if (t == s) {
        nexthop[(size_t)s * V + t] = t;
      } else if (pred[t] < 0) {
        nexthop[(size_t)s * V + t] = -1;
      } else {
        int cur = t, first = t;
        while (pred[cur] != s && pred[cur] >= 0) {
          cur = pred[cur];
          first = cur;
        }
        nexthop[(size_t)s * V + t] = (pred[cur] == s) ? first : -1;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Nearest discretized 36-view index for directions (heading, elevation):
// argmin over view centers of dh^2 + de^2 with heading wrap (the net effect
// of the reference's 36-view candidate sweep, r2r/env.py:249-314).
void nearest_view(int n, const float* heading, const float* elev,
                  int32_t* out) {
  const float rad30 = 0.5235987755982988f;
  const float twopi = 6.283185307179586f;
  for (int i = 0; i < n; ++i) {
    float best = 1e30f;
    int bi = 0;
    for (int ix = 0; ix < 36; ++ix) {
      float vh = (ix % 12) * rad30;
      float ve = (ix / 12 - 1) * rad30;
      float dh = std::remainder(heading[i] - vh, twopi);
      float de = elev[i] - ve;
      float c = dh * dh + de * de;
      if (c < best) {
        best = c;
        bi = ix;
      }
    }
    out[i] = bi;
  }
}

// ---------------------------------------------------------------------------
// BLEU n-gram statistics for one (hypothesis, multi-reference) pair.
// Accumulates clipped/total counts for n in [1, max_n] and the closest
// reference length.  Caller reduces across the corpus and applies BP.
static uint64_t hash_gram(const int32_t* a, int n) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < n; ++i) {
    h ^= (uint64_t)(uint32_t)a[i];
    h *= 1099511628211ull;
  }
  return h;
}

void bleu_stats(int hyp_len, const int32_t* hyp, int n_refs,
                const int32_t* ref_lens, const int32_t* refs_flat, int max_n,
                int64_t* clipped, int64_t* totals, int32_t* closest_ref_len) {
  int best_diff = 1 << 30, best_len = 0;
  for (int r = 0; r < n_refs; ++r) {
    int diff = std::abs(ref_lens[r] - hyp_len);
    if (diff < best_diff || (diff == best_diff && ref_lens[r] < best_len)) {
      best_diff = diff;
      best_len = ref_lens[r];
    }
  }
  *closest_ref_len = best_len;

  for (int n = 1; n <= max_n; ++n) {
    if (hyp_len < n) continue;
    std::map<uint64_t, int> hyp_cnt, ref_max;
    for (int i = 0; i + n <= hyp_len; ++i) hyp_cnt[hash_gram(hyp + i, n)]++;
    int o = 0;
    for (int r = 0; r < n_refs; ++r) {
      std::map<uint64_t, int> rc;
      for (int i = 0; i + n <= ref_lens[r]; ++i)
        rc[hash_gram(refs_flat + o + i, n)]++;
      for (auto& kv : rc) {
        auto it = ref_max.find(kv.first);
        if (it == ref_max.end() || it->second < kv.second)
          ref_max[kv.first] = kv.second;
      }
      o += ref_lens[r];
    }
    for (auto& kv : hyp_cnt) {
      totals[n - 1] += kv.second;
      auto it = ref_max.find(kv.first);
      if (it != ref_max.end())
        clipped[n - 1] += std::min(kv.second, it->second);
    }
  }
}

// ---------------------------------------------------------------------------
// Batched Levenshtein edit distance (insert/delete/substitute cost 1).
void edit_distance_batch(int B, int maxa, int maxb, const int32_t* a,
                         const int32_t* la, const int32_t* b,
                         const int32_t* lb, int32_t* out) {
  std::vector<int> prev(maxb + 1), cur(maxb + 1);
  for (int i = 0; i < B; ++i) {
    const int32_t* xa = a + (size_t)i * maxa;
    const int32_t* xb = b + (size_t)i * maxb;
    int n = la[i], m = lb[i];
    for (int j = 0; j <= m; ++j) prev[j] = j;
    for (int r = 1; r <= n; ++r) {
      cur[0] = r;
      for (int j = 1; j <= m; ++j) {
        int sub = prev[j - 1] + (xa[r - 1] != xb[j - 1]);
        cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
      }
      std::swap(prev, cur);
    }
    out[i] = prev[m];
  }
}

// ---------------------------------------------------------------------------
// Greedy batch-by-size bucketing: given per-item sizes (any order), fill
// batches so that batch_tokens >= (#items * max_size_in_batch) stays under
// max_tokens and #items <= max_items.  Writes batch id per item (in the
// given order); returns the number of batches.
int bucket_by_size(int n, const int32_t* sizes, int max_tokens, int max_items,
                   int32_t* batch_ids) {
  int bid = 0, cnt = 0, bmax = 0;
  for (int i = 0; i < n; ++i) {
    int s = sizes[i];
    int nmax = std::max(bmax, s);
    if (cnt > 0 && ((cnt + 1) * nmax > max_tokens || cnt + 1 > max_items)) {
      ++bid;
      cnt = 0;
      bmax = 0;
      nmax = s;
    }
    batch_ids[i] = bid;
    ++cnt;
    bmax = nmax;
  }
  return n > 0 ? bid + 1 : 0;
}

// ---------------------------------------------------------------------------
// KMeans Lloyd iterations (centers pre-seeded by the caller).
void kmeans_lloyd(int n, int d, int k, int iters, const float* x,
                  float* centers, int32_t* assign) {
  std::vector<double> sums((size_t)k * d);
  std::vector<int> cnts(k);
  for (int it = 0; it < iters; ++it) {
    std::fill(sums.begin(), sums.end(), 0.0);
    std::fill(cnts.begin(), cnts.end(), 0);
    for (int i = 0; i < n; ++i) {
      const float* xi = x + (size_t)i * d;
      float best = 1e30f;
      int bi = 0;
      for (int c = 0; c < k; ++c) {
        const float* cc = centers + (size_t)c * d;
        float dist = 0.f;
        for (int j = 0; j < d; ++j) {
          float t = xi[j] - cc[j];
          dist += t * t;
        }
        if (dist < best) {
          best = dist;
          bi = c;
        }
      }
      assign[i] = bi;
      cnts[bi]++;
      double* sc = sums.data() + (size_t)bi * d;
      for (int j = 0; j < d; ++j) sc[j] += xi[j];
    }
    for (int c = 0; c < k; ++c) {
      if (cnts[c] == 0) continue;
      float* cc = centers + (size_t)c * d;
      const double* sc = sums.data() + (size_t)c * d;
      for (int j = 0; j < d; ++j) cc[j] = (float)(sc[j] / cnts[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Token-block slicing (fairseq/data/token_block_utils_fast.pyx
// _get_slice_indices_fast): partition the flat token stream of `n`
// sentences with lengths `sizes` into blocks.  mode: 0=none (fixed
// block_size windows), 1=complete (whole sentences up to block_size),
// 2=complete_doc (document_sep_len-sized sentences are doc breaks; only
// blocks with >1 token kept), 3=eos (one block per sentence).
// block_sizes (may be null) = per-block target sizes when
// block_multiple_max > 1, else block_size *= block_multiple_min.
// Writes (start, end) int64 pairs into out (capacity cap pairs); returns
// the block count (call with cap=0 to size the output).
int token_block_slices(int n, const int64_t* sizes, int mode,
                       int64_t block_size, int64_t document_sep_len,
                       int block_multiple_min, int block_multiple_max,
                       const int64_t* block_sizes, int64_t* out, int cap) {
  int64_t total = 0;
  for (int i = 0; i < n; ++i) total += sizes[i];
  int m = 0;
  auto emit = [&](int64_t s, int64_t e) {
    if (m < cap) {
      out[2 * m] = s;
      out[2 * m + 1] = e;
    }
    ++m;
  };
  if (mode == 0) {
    int64_t length = (total + block_size - 1) / block_size;
    for (int64_t i = 0; i < length; ++i)
      emit(i * block_size, std::min((i + 1) * block_size, total));
    return m;
  }
  if (mode == 3) {
    int64_t tok = 0;
    for (int i = 0; i < n; ++i) {
      emit(tok, tok + sizes[i]);
      tok += sizes[i];
    }
    return m;
  }
  int counter = 0;
  int64_t bs = (block_multiple_max > 1 && block_sizes)
                   ? block_sizes[counter]
                   : (int64_t)block_multiple_min * block_size;
  int64_t tok = 0, curr = 0;
  int64_t sz_idx = 0;
  if (mode == 1) {  // complete
    while (sz_idx < n) {
      if (curr + sizes[sz_idx] <= bs || curr == 0) {
        curr += sizes[sz_idx];
        ++sz_idx;
      } else {
        emit(tok, tok + curr);
        tok += curr;
        curr = 0;
        if (block_multiple_max > 1 && block_sizes) bs = block_sizes[++counter];
      }
    }
    if (curr > 0) emit(tok, tok + curr);
    return m;
  }
  // complete_doc
  while (sz_idx < n) {
    if ((curr + sizes[sz_idx] <= bs || curr == 0) &&
        sizes[sz_idx] != document_sep_len) {
      curr += sizes[sz_idx];
      ++sz_idx;
    } else {
      if (curr > 1) emit(tok, tok + curr);
      tok += curr;
      curr = 0;
      if (block_multiple_max > 1 && block_sizes) bs = block_sizes[++counter];
      if (sizes[sz_idx] == document_sep_len) {
        tok += sizes[sz_idx];
        ++sz_idx;
      }
    }
  }
  if (curr > 1) emit(tok, tok + curr);
  return m;
}

// _get_block_to_dataset_index_fast: map flat (start, end) slices to
// (start_ds_idx, start_offset, end_ds_idx) via a linear DatasetSearcher
// walk.  out: mk * 3 int64.
void block_to_dataset_index(int n, const int64_t* sizes, int mk,
                            const int64_t* slices, int64_t* out) {
  // cumulative sentence starts
  std::vector<int64_t> cum(n + 1, 0);
  for (int i = 0; i < n; ++i) cum[i + 1] = cum[i] + sizes[i];
  int idx = 0;
  auto seek = [&](int64_t pos) {
    while (idx + 1 <= n && cum[idx + 1] <= pos) ++idx;
    while (idx > 0 && cum[idx] > pos) --idx;
    return idx;
  };
  for (int b = 0; b < mk; ++b) {
    int64_t s = slices[2 * b], e = slices[2 * b + 1];
    int sdi = seek(s);
    int64_t soff = s - cum[sdi];
    int edi = (e <= s) ? sdi : seek(e - 1);
    out[3 * b] = sdi;
    out[3 * b + 1] = soff;
    out[3 * b + 2] = edi;
  }
}

}  // extern "C"
