// Native enclosing-subgraph extraction engine (a copy of the JAX
// package's igmc_tpu/native/extract.cpp; built and bound by
// igmc_torch/native/build.py and igmc_torch/graphs/native.py).
//
// A multithreaded C++ CSR walker. Semantics match
// igmc_torch/graphs/extract.py: h-hop alternating BFS, sorted-unique
// fringes, per-hop sample_ratio / max_nodes_per_hop subsampling,
// target-edge removal, 2d/2d+1 hop/side labels, edge types = adjacency
// value - 1.
//
// Determinism: each link uses an xoshiro256** stream seeded by
// splitmix64(seed, stream_id) — stream_id defaults to the link's position
// but callers may pass global dataset indices — independent of thread
// count/scheduling. (The NumPy engine uses NumPy's Generator for
// subsampling, so sampled extractions differ between engines by RNG
// stream only — unsampled extractions are bit-identical.)
//
// Memory: per-thread epoch-stamped scratch arrays (no clearing between
// links); results land in per-link vectors gathered into one packed
// structure-of-arrays matching batching/dataset.py _PackedGraphs.
//
// C ABI (ctypes-friendly), two-phase: run -> query sizes -> fill -> free.
//
// The same library builds the fused R-GCN aggregate's block plans
// (igmc_plan_blocks; igmc_torch/kernels/rgcn_aggregate.py
// block_align_edges and its src-sorted twin) for a batch in one call, with
// counting sorts: O(edges + nodes), no Python work per chunk or block; and
// collates a flat batch from the packed tables (igmc_collate_flat;
// igmc_torch/batching/batch.py collate_packed) in one pass.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Xoshiro {
  uint64_t s[4];
  static uint64_t splitmix64(uint64_t& x) {
    uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  explicit Xoshiro(uint64_t seed) {
    for (int i = 0; i < 4; ++i) s[i] = splitmix64(seed);
  }
  static uint64_t rotl(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
    s[2] ^= t; s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = (0 - n) % n;
      while (l < t) { x = next(); m = (__uint128_t)x * n; l = (uint64_t)m; }
    }
    return (uint64_t)(m >> 64);
  }
};

struct SubgraphOut {
  std::vector<int32_t> src, dst, etype, node_label;
  int32_t num_u = 0, num_v = 0;
};

struct Csr {
  const int64_t* indptr;
  const int32_t* indices;
  const float* data;
  int64_t n;
};

struct Engine {
  Csr rows, cols;  // users->items, items->users
  int h;
  double sample_ratio;
  int64_t max_nodes_per_hop;
  uint64_t seed;
  std::vector<SubgraphOut> out;
};

// Per-thread scratch with epoch stamping.
struct Scratch {
  std::vector<int64_t> u_stamp, v_stamp;   // visited epoch per global node
  std::vector<int32_t> v_local;            // item -> local index (stamped)
  std::vector<int64_t> v_local_stamp;
  int64_t epoch = 0;
  Scratch(int64_t nu, int64_t nv)
      : u_stamp(nu, -1), v_stamp(nv, -1), v_local(nv, -1),
        v_local_stamp(nv, -1) {}
};

void subsample(std::vector<int32_t>& fringe, double ratio, int64_t cap,
               Xoshiro& rng) {
  size_t keep = fringe.size();
  if (ratio < 1.0) keep = (size_t)(ratio * fringe.size());
  if (cap >= 0 && (size_t)cap < keep) keep = (size_t)cap;
  if (keep >= fringe.size()) return;
  // partial Fisher-Yates, then restore sorted order (matches sorted-unique
  // fringe semantics of the NumPy path up to which elements survive)
  for (size_t i = 0; i < keep; ++i) {
    size_t j = i + (size_t)rng.bounded(fringe.size() - i);
    std::swap(fringe[i], fringe[j]);
  }
  fringe.resize(keep);
  std::sort(fringe.begin(), fringe.end());
}

void extract_one(const Engine& eng, Scratch& sc, int64_t link_u,
                 int64_t link_v, uint64_t rng_seed, SubgraphOut& out) {
  Xoshiro rng(rng_seed);
  const int64_t ep = ++sc.epoch;

  std::vector<int32_t> u_nodes{(int32_t)link_u}, v_nodes{(int32_t)link_v};
  std::vector<int32_t> u_dist{0}, v_dist{0};
  sc.u_stamp[link_u] = ep;
  sc.v_stamp[link_v] = ep;
  std::vector<int32_t> u_fringe{(int32_t)link_u}, v_fringe{(int32_t)link_v};
  std::vector<int32_t> new_u, new_v;

  for (int dist = 1; dist <= eng.h; ++dist) {
    new_v.clear();
    for (int32_t u : u_fringe) {
      for (int64_t k = eng.rows.indptr[u]; k < eng.rows.indptr[u + 1]; ++k) {
        int32_t it = eng.rows.indices[k];
        if (sc.v_stamp[it] != ep) { sc.v_stamp[it] = ep; new_v.push_back(it); }
      }
    }
    new_u.clear();
    for (int32_t v : v_fringe) {
      for (int64_t k = eng.cols.indptr[v]; k < eng.cols.indptr[v + 1]; ++k) {
        int32_t us = eng.cols.indices[k];
        if (sc.u_stamp[us] != ep) { sc.u_stamp[us] = ep; new_u.push_back(us); }
      }
    }
    std::sort(new_u.begin(), new_u.end());
    std::sort(new_v.begin(), new_v.end());
    subsample(new_u, eng.sample_ratio, eng.max_nodes_per_hop, rng);
    subsample(new_v, eng.sample_ratio, eng.max_nodes_per_hop, rng);
    if (new_u.empty() && new_v.empty()) break;
    u_fringe = new_u;
    v_fringe = new_v;
    u_nodes.insert(u_nodes.end(), new_u.begin(), new_u.end());
    v_nodes.insert(v_nodes.end(), new_v.begin(), new_v.end());
    u_dist.insert(u_dist.end(), new_u.size(), dist);
    v_dist.insert(v_dist.end(), new_v.size(), dist);
  }

  const int32_t nu = (int32_t)u_nodes.size();
  const int32_t nv = (int32_t)v_nodes.size();
  out.num_u = nu;
  out.num_v = nv;

  // local item index map (stamped)
  for (int32_t j = 0; j < nv; ++j) {
    sc.v_local[v_nodes[j]] = j;
    sc.v_local_stamp[v_nodes[j]] = ep;
  }

  // collect edges: iterate selected user rows in order; keep selected items
  out.src.clear(); out.dst.clear(); out.etype.clear();
  for (int32_t i = 0; i < nu; ++i) {
    const int32_t u = u_nodes[i];
    for (int64_t k = eng.rows.indptr[u]; k < eng.rows.indptr[u + 1]; ++k) {
      const int32_t it = eng.rows.indices[k];
      if (sc.v_local_stamp[it] != ep) continue;
      const int32_t j = sc.v_local[it];
      if (i == 0 && j == 0) continue;  // remove the target edge
      out.src.push_back(i);
      out.dst.push_back(nu + j);
      out.etype.push_back((int32_t)(eng.rows.data[k] - 1.0f));
    }
  }

  out.node_label.resize(nu + nv);
  for (int32_t i = 0; i < nu; ++i) out.node_label[i] = 2 * u_dist[i];
  for (int32_t j = 0; j < nv; ++j) out.node_label[nu + j] = 2 * v_dist[j] + 1;
}

// One block plan: edges sorted stably by (scatter row, etype), packed into
// blocks of `eblk` slots such that a block only holds edges of one chunk
// of `rows` scatter rows. `scatter` is edge_dst for the forward plan and
// edge_src for the twin, `gather` the other endpoint; `degree` counts the
// real edges of each scatter row.
struct PlanOut {
  int32_t *gather, *local, *etype;
  float* mask;
  int32_t *ukey, *chunk_of_block, *first_of_chunk;
};

// An edge's dropout key, the same in both plans: edge_canon * 2 + (src <
// dst) from the edges' canonical ids, or a key given per edge.
struct EdgeKeys {
  const int32_t *in, *src, *dst;
  bool from_canon;
  int32_t operator()(int32_t e) const {
    return from_canon ? (int32_t)((int64_t)in[e] * 2 + (src[e] < dst[e])) : in[e];
  }
};

// Blocks each chunk needs, max(1, ceil(edges / eblk)); returns their sum.
int64_t chunk_blocks(const std::vector<int64_t>& degree, int64_t rows,
                     int64_t eblk, std::vector<int64_t>& blocks) {
  int64_t total = 0;
  for (size_t c = 0; c < blocks.size(); ++c) {
    int64_t edges = 0;
    for (int64_t r = c * rows; r < (int64_t)(c + 1) * rows; ++r) edges += degree[r];
    blocks[c] = std::max<int64_t>(1, (edges + eblk - 1) / eblk);
    total += blocks[c];
  }
  return total;
}

// Lays the chunks' blocks out (the `num_blocks - needed` padding blocks
// join chunk 0), then gives each real edge, taken in (etype, index) order
// (`by_etype`), the next free slot of its scatter row: a row's slots
// follow those of the rows before it in its chunk, so the slots come out
// in (row, etype, index) order. Then writes every slot in turn, padding
// slots as zeros.
void fill_plan(const int32_t* scatter, const int32_t* gather,
               const int32_t* etype, const std::vector<int32_t>& by_etype,
               const std::vector<int64_t>& degree,
               const std::vector<int64_t>& blocks, int64_t needed,
               const EdgeKeys& keys, int64_t rows, int64_t eblk,
               int64_t num_blocks, const PlanOut& out) {
  std::vector<int64_t> next(degree.size());  // each row's next free slot
  int64_t block = 0;
  for (size_t c = 0; c < blocks.size(); ++c) {
    int64_t slot = block * eblk;
    for (int64_t r = c * rows; r < (int64_t)(c + 1) * rows; ++r) {
      next[r] = slot;
      slot += degree[r];
    }
    const int64_t nb = blocks[c] + (c == 0 ? num_blocks - needed : 0);
    for (int64_t k = 0; k < nb; ++k, ++block) {
      out.chunk_of_block[block] = (int32_t)c;
      out.first_of_chunk[block] = k == 0;
    }
  }
  const int64_t slots = num_blocks * eblk;
  std::vector<int32_t> edge_of(slots, -1);
  for (int32_t e : by_etype) edge_of[next[scatter[e]]++] = e;
  for (int64_t s = 0; s < slots; ++s) {
    const int32_t e = edge_of[s];
    const bool real = e >= 0;
    out.gather[s] = real ? gather[e] : 0;
    out.local[s] = real ? (int32_t)(scatter[e] % rows) : 0;
    out.etype[s] = real ? etype[e] : 0;
    out.mask[s] = real ? 1.0f : 0.0f;
    if (out.ukey) out.ukey[s] = real ? keys(e) : 0;
  }
}

}  // namespace

extern "C" {

void* igmc_extract_run(
    const int64_t* u_indptr, const int32_t* u_indices, const float* u_data,
    int64_t num_users,
    const int64_t* v_indptr, const int32_t* v_indices, const float* v_data,
    int64_t num_items,
    const int64_t* link_u, const int64_t* link_v, int64_t n_links,
    const int64_t* stream_ids,  // per-link RNG stream id; NULL -> position i
    int32_t h, double sample_ratio, int64_t max_nodes_per_hop,
    uint64_t seed, int32_t n_threads) {
  auto* eng = new Engine{
      {u_indptr, u_indices, u_data, num_users},
      {v_indptr, v_indices, v_data, num_items},
      (int)h, sample_ratio, max_nodes_per_hop, seed, {}};
  eng->out.resize(n_links);

  if (n_threads <= 0)
    n_threads = (int32_t)std::max(1u, std::thread::hardware_concurrency());
  n_threads = (int32_t)std::min<int64_t>(n_threads, std::max<int64_t>(1, n_links));

  std::atomic<int64_t> next(0);
  auto work = [&]() {
    Scratch sc(num_users, num_items);
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_links) break;
      uint64_t sid = stream_ids ? (uint64_t)stream_ids[i] : (uint64_t)i;
      uint64_t x = seed;
      uint64_t s1 = Xoshiro::splitmix64(x);
      x = s1 ^ sid * 0x9e3779b97f4a7c15ULL;
      extract_one(*eng, sc, link_u[i], link_v[i], Xoshiro::splitmix64(x),
                  eng->out[i]);
    }
  };
  if (n_threads == 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return eng;
}

// Per-link node/edge counts and num_u (arrays of length n_links).
void igmc_extract_sizes(void* handle, int64_t* node_counts,
                        int64_t* edge_counts, int32_t* num_u) {
  auto* eng = (Engine*)handle;
  for (size_t i = 0; i < eng->out.size(); ++i) {
    node_counts[i] = (int64_t)eng->out[i].node_label.size();
    edge_counts[i] = (int64_t)eng->out[i].src.size();
    num_u[i] = eng->out[i].num_u;
  }
}

// Fill packed arrays; offsets are the caller-computed exclusive prefix sums.
void igmc_extract_fill(void* handle, const int64_t* node_offsets,
                       const int64_t* edge_offsets, int32_t* node_label,
                       int32_t* src, int32_t* dst, int32_t* etype) {
  auto* eng = (Engine*)handle;
  for (size_t i = 0; i < eng->out.size(); ++i) {
    const auto& g = eng->out[i];
    std::memcpy(node_label + node_offsets[i], g.node_label.data(),
                g.node_label.size() * sizeof(int32_t));
    std::memcpy(src + edge_offsets[i], g.src.data(),
                g.src.size() * sizeof(int32_t));
    std::memcpy(dst + edge_offsets[i], g.dst.data(),
                g.dst.size() * sizeof(int32_t));
    std::memcpy(etype + edge_offsets[i], g.etype.data(),
                g.etype.size() * sizeof(int32_t));
  }
}

void igmc_extract_free(void* handle) { delete (Engine*)handle; }

// The fused aggregate's block plans of one batch, from one read of its
// edge arrays: the dst-sorted plan (bit 0 of `want`) and its src-sorted
// twin (bit 1), each edge in the slot block_align_edges and
// block_align_edges_transposed give it. Real edges are those with
// edge_mask[e] != 0. `ukey_in` (NULL: no ukey) holds per-edge values: with
// `ukey_from_canon` they are edge_canon and an edge's key is
// edge_canon * 2 + (src < dst), else they are the keys. `num_blocks` < 0
// plans exactly the blocks needed. `needed[p]` gets the blocks plan p
// needs. `out` holds 7 pointers a plan, the forward's then the twin's:
// gather, local, etype, mask (float), ukey (NULL without keys),
// chunk_of_block, first_of_chunk, of num_blocks * eblk slots or num_blocks
// blocks each; with `out` NULL the call only counts. The twin is filled on
// a second thread. Returns 0, or 1 (num_nodes not a multiple of rows), 2
// (an endpoint outside [0, num_nodes)), 3 + p (plan p needs more than
// num_blocks blocks).
int32_t igmc_plan_blocks(const int32_t* edge_src, const int32_t* edge_dst,
                         const int32_t* edge_type, const uint8_t* edge_mask,
                         const int32_t* ukey_in, int32_t ukey_from_canon,
                         int64_t n_edges, int64_t num_nodes, int64_t rows,
                         int64_t eblk, int64_t num_blocks, int32_t want,
                         int64_t* needed, void* const* out) {
  if (rows <= 0 || eblk <= 0 || num_nodes % rows) return 1;
  std::vector<int32_t> real;
  real.reserve(n_edges);
  std::vector<int64_t> degree[2] = {std::vector<int64_t>(num_nodes, 0),
                                    std::vector<int64_t>(num_nodes, 0)};
  int32_t lo = INT32_MAX, hi = INT32_MIN;
  for (int64_t e = 0; e < n_edges; ++e) {
    if (!edge_mask[e]) continue;
    const int32_t s = edge_src[e], d = edge_dst[e];
    if (s < 0 || s >= num_nodes || d < 0 || d >= num_nodes) return 2;
    real.push_back((int32_t)e);
    ++degree[0][d];
    ++degree[1][s];
    lo = std::min(lo, edge_type[e]);
    hi = std::max(hi, edge_type[e]);
  }
  std::vector<int64_t> blocks[2];
  for (int p = 0; p < 2; ++p) {
    if (!(want & (1 << p))) continue;
    blocks[p].resize(num_nodes / rows);
    needed[p] = chunk_blocks(degree[p], rows, eblk, blocks[p]);
    if (num_blocks >= 0 && needed[p] > num_blocks) return 3 + p;
  }
  if (!out) return 0;

  // the real edges stably by relation, for both plans: a counting sort
  // over the relations' range, or a comparison sort if it is wide
  std::vector<int32_t> by_etype(real.size());
  if (!real.empty() && (int64_t)hi - lo <= (int64_t)real.size() + 1024) {
    std::vector<int64_t> at((int64_t)hi - lo + 2, 0);
    for (int32_t e : real) ++at[edge_type[e] - lo + 1];
    for (size_t r = 1; r < at.size(); ++r) at[r] += at[r - 1];
    for (int32_t e : real) by_etype[at[edge_type[e] - lo]++] = e;
  } else {
    by_etype = real;
    std::stable_sort(by_etype.begin(), by_etype.end(), [edge_type](int32_t a, int32_t b) {
      return edge_type[a] < edge_type[b];
    });
  }
  const EdgeKeys keys{ukey_in, edge_src, edge_dst, ukey_from_canon != 0};
  const int32_t* scatter[2] = {edge_dst, edge_src};
  const int32_t* gather[2] = {edge_src, edge_dst};
  auto fill = [&](int p) {
    void* const* o = out + 7 * p;
    const PlanOut plan{(int32_t*)o[0], (int32_t*)o[1], (int32_t*)o[2],
                       (float*)o[3],   (int32_t*)o[4], (int32_t*)o[5],
                       (int32_t*)o[6]};
    fill_plan(scatter[p], gather[p], edge_type, by_etype, degree[p], blocks[p],
              needed[p], keys, rows, eblk,
              num_blocks < 0 ? needed[p] : num_blocks, plan);
  };
  if (want == 3) {
    std::thread twin(fill, 1);
    fill(0);
    twin.join();
  } else if (want) {
    fill(want == 2);
  }
  return 0;
}

// One flat batch (igmc_torch/batching/batch.py collate_packed) of the `n`
// graphs at rows `gids` of packed tables (`node_offsets` / `edge_offsets`
// of n_packed + 1 entries over node_label / src, dst, etype; num_u, y of
// n_packed), in one pass. Graph i's nodes follow graph i-1's; its `ne`
// forward edges fill ne slots and their reverse copies the next ne, with
// endpoints shifted by the nodes before it. Edge j of graph i gets id
// id_base[i] + j, or its forward slot when id_base is NULL. `out` holds 13
// caller-allocated arrays, every slot of which is written: node_label,
// node2graph, node_mask (uint8) of node_pad; edge_src, edge_dst,
// edge_type, edge_canon, edge_mask (uint8), edge_id (int64) of edge_pad;
// y (float), graph_mask (uint8), target_u, target_v of num_graphs.
// Padding is zero, but a padding edge's canon is its own slot and a
// reverse copy's its forward slot. `totals` gets the batch's nodes and
// directed edges. Returns 0, or 1 (more than num_graphs graphs), 2 (the
// totals exceed node_pad or edge_pad), 3 (a gid outside [0, n_packed)).
int32_t igmc_collate_flat(const int64_t* node_offsets, const int64_t* edge_offsets,
                          const int32_t* node_label, const int32_t* src,
                          const int32_t* dst, const int32_t* etype,
                          const int32_t* num_u, const float* y_in, int64_t n_packed,
                          const int64_t* gids, const int64_t* id_base, int64_t n,
                          int64_t num_graphs, int64_t node_pad, int64_t edge_pad,
                          int64_t* totals, void* const* out) {
  if (n > num_graphs) return 1;
  int64_t nodes = 0, edges = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = gids[i];
    if (g < 0 || g >= n_packed) return 3;
    nodes += node_offsets[g + 1] - node_offsets[g];
    edges += 2 * (edge_offsets[g + 1] - edge_offsets[g]);
  }
  totals[0] = nodes;
  totals[1] = edges;
  if (nodes > node_pad || edges > edge_pad) return 2;

  int32_t* o_label = (int32_t*)out[0];
  int32_t* o_node2graph = (int32_t*)out[1];
  uint8_t* o_node_mask = (uint8_t*)out[2];
  int32_t* o_src = (int32_t*)out[3];
  int32_t* o_dst = (int32_t*)out[4];
  int32_t* o_type = (int32_t*)out[5];
  int32_t* o_canon = (int32_t*)out[6];
  uint8_t* o_edge_mask = (uint8_t*)out[7];
  int64_t* o_id = (int64_t*)out[8];
  float* o_y = (float*)out[9];
  uint8_t* o_graph_mask = (uint8_t*)out[10];
  int32_t* o_target_u = (int32_t*)out[11];
  int32_t* o_target_v = (int32_t*)out[12];

  int64_t n_off = 0, e_off = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = gids[i];
    const int64_t ns = node_offsets[g], nn = node_offsets[g + 1] - ns;
    const int64_t es = edge_offsets[g], ne = edge_offsets[g + 1] - es;
    std::memcpy(o_label + n_off, node_label + ns, nn * sizeof(int32_t));
    std::fill(o_node2graph + n_off, o_node2graph + n_off + nn, (int32_t)i);
    std::memset(o_node_mask + n_off, 1, nn);
    const int32_t shift = (int32_t)n_off;
    for (int64_t j = 0; j < ne; ++j) {
      const int64_t f = e_off + j, r = f + ne;
      const int32_t s = src[es + j] + shift, d = dst[es + j] + shift;
      const int64_t id = id_base ? id_base[i] + j : f;
      o_src[f] = s;
      o_dst[f] = d;
      o_src[r] = d;
      o_dst[r] = s;
      o_type[f] = o_type[r] = etype[es + j];
      o_canon[f] = (int32_t)f;
      o_canon[r] = (int32_t)f;
      o_id[f] = o_id[r] = id;
    }
    std::memset(o_edge_mask + e_off, 1, 2 * ne);
    o_y[i] = y_in[g];
    o_graph_mask[i] = 1;
    o_target_u[i] = shift;               // the target user is the first user node
    o_target_v[i] = shift + num_u[g];    // the target item the first item node
    n_off += nn;
    e_off += 2 * ne;
  }
  const int64_t pad_n = node_pad - n_off, pad_e = edge_pad - e_off, pad_g = num_graphs - n;
  std::memset(o_label + n_off, 0, pad_n * sizeof(int32_t));
  std::memset(o_node2graph + n_off, 0, pad_n * sizeof(int32_t));
  std::memset(o_node_mask + n_off, 0, pad_n);
  std::memset(o_src + e_off, 0, pad_e * sizeof(int32_t));
  std::memset(o_dst + e_off, 0, pad_e * sizeof(int32_t));
  std::memset(o_type + e_off, 0, pad_e * sizeof(int32_t));
  for (int64_t e = e_off; e < edge_pad; ++e) o_canon[e] = (int32_t)e;
  std::memset(o_edge_mask + e_off, 0, pad_e);
  std::memset(o_id + e_off, 0, pad_e * sizeof(int64_t));
  std::memset(o_y + n, 0, pad_g * sizeof(float));
  std::memset(o_graph_mask + n, 0, pad_g);
  std::memset(o_target_u + n, 0, pad_g * sizeof(int32_t));
  std::memset(o_target_v + n, 0, pad_g * sizeof(int32_t));
  return 0;
}

// Bump on any signature change; the ctypes loader refuses/rebuilds a .so
// whose version (or absence of this symbol) does not match, instead of
// calling through a misaligned ABI.
int32_t igmc_extract_abi_version() { return 4; }

}  // extern "C"
