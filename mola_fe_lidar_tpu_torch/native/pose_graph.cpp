// Native pose-graph runtime (E10) — C ABI for ctypes binding.
//
// The reference's local pose graph is mrpt::graphs::CNetworkOfPoses3D with
// dijkstra_nodes_estimate (reference src/LidarOdometry.cpp:528-551). Here
// the graph lives in C++ for O(E log V) Dijkstra with zero Python overhead
// — this is host runtime, not device compute, mirroring the reference's
// C++ placement. Poses are row-major double R[9] + t[3]; edges store the
// pose of `b` in frame `a`.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Edge {
  int64_t a, b;
  double R[9];
  double t[3];
};

struct Graph {
  std::unordered_set<int64_t> nodes;
  std::vector<Edge> edges;
  std::unordered_map<int64_t, std::vector<size_t>> adj;
  int64_t root = -1;
};

inline void mat_mul(const double* A, const double* B, double* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += A[i * 3 + k] * B[k * 3 + j];
      C[i * 3 + j] = s;
    }
}

inline void mat_vec(const double* A, const double* v, double* o) {
  for (int i = 0; i < 3; ++i)
    o[i] = A[i * 3 + 0] * v[0] + A[i * 3 + 1] * v[1] + A[i * 3 + 2] * v[2];
}

// (Ra,ta) ∘ (Rb,tb)
inline void compose(const double* Ra, const double* ta, const double* Rb,
                    const double* tb, double* Rc, double* tc) {
  mat_mul(Ra, Rb, Rc);
  mat_vec(Ra, tb, tc);
  for (int i = 0; i < 3; ++i) tc[i] += ta[i];
}

inline void invert(const double* R, const double* t, double* Ri, double* ti) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Ri[i * 3 + j] = R[j * 3 + i];
  double tmp[3];
  mat_vec(Ri, t, tmp);
  for (int i = 0; i < 3; ++i) ti[i] = -tmp[i];
}

}  // namespace

extern "C" {

void* pg_create() { return new Graph(); }

void pg_destroy(void* h) { delete static_cast<Graph*>(h); }

void pg_insert_node(void* h, int64_t node) {
  auto* g = static_cast<Graph*>(h);
  if (g->nodes.insert(node).second) {
    g->adj.try_emplace(node);
    if (g->root < 0) g->root = node;
  }
}

void pg_insert_edge(void* h, int64_t a, int64_t b, const double* R,
                    const double* t) {
  auto* g = static_cast<Graph*>(h);
  pg_insert_node(h, a);
  pg_insert_node(h, b);
  Edge e;
  e.a = a;
  e.b = b;
  std::memcpy(e.R, R, 9 * sizeof(double));
  std::memcpy(e.t, t, 3 * sizeof(double));
  size_t idx = g->edges.size();
  g->edges.push_back(e);
  g->adj[a].push_back(idx);
  g->adj[b].push_back(idx);
}

int pg_has_edge(void* h, int64_t a, int64_t b) {
  auto* g = static_cast<Graph*>(h);
  auto it = g->adj.find(a);
  if (it == g->adj.end()) return 0;
  for (size_t idx : it->second) {
    const Edge& e = g->edges[idx];
    if ((e.a == a && e.b == b) || (e.a == b && e.b == a)) return 1;
  }
  return 0;
}

int64_t pg_num_nodes(void* h) {
  return static_cast<int64_t>(static_cast<Graph*>(h)->nodes.size());
}

int64_t pg_num_edges(void* h) {
  return static_cast<int64_t>(static_cast<Graph*>(h)->edges.size());
}

int64_t pg_root(void* h) { return static_cast<Graph*>(h)->root; }

void pg_remove_node(void* h, int64_t node) {
  auto* g = static_cast<Graph*>(h);
  if (!g->nodes.erase(node)) return;
  std::vector<Edge> kept;
  kept.reserve(g->edges.size());
  for (const Edge& e : g->edges)
    if (e.a != node && e.b != node) kept.push_back(e);
  g->edges = std::move(kept);
  g->adj.clear();
  for (int64_t n : g->nodes) g->adj.try_emplace(n);
  for (size_t i = 0; i < g->edges.size(); ++i) {
    g->adj[g->edges[i].a].push_back(i);
    g->adj[g->edges[i].b].push_back(i);
  }
  if (g->root == node) {
    g->root = -1;
    for (int64_t n : g->nodes)
      if (g->root < 0 || n < g->root) g->root = n;
  }
}

// Dijkstra from `source` (or root if <0). Writes up to `cap` results:
// node ids, topological depth, R[9], t[3] per reached node.
// Returns the number of reached nodes (may exceed cap; only cap written).
int64_t pg_dijkstra(void* h, int64_t source, int64_t cap, int64_t* out_nodes,
                    int64_t* out_topo, double* out_R, double* out_t) {
  auto* g = static_cast<Graph*>(h);
  int64_t src = source >= 0 ? source : g->root;
  if (src < 0 || !g->nodes.count(src)) return 0;

  struct State {
    double R[9];
    double t[3];
    double dist;
    int64_t topo;
    bool done = false;
    bool seen = false;
  };
  std::unordered_map<int64_t, State> st;
  auto& s0 = st[src];
  s0.dist = 0.0;
  s0.topo = 0;
  s0.seen = true;
  static const double I[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  std::memcpy(s0.R, I, sizeof(I));
  s0.t[0] = s0.t[1] = s0.t[2] = 0;

  using QE = std::pair<double, int64_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  heap.push({0.0, src});

  int64_t written = 0, reached = 0;
  while (!heap.empty()) {
    auto [d, u] = heap.top();
    heap.pop();
    State& su = st[u];
    if (su.done) continue;
    su.done = true;
    ++reached;
    if (written < cap) {
      out_nodes[written] = u;
      out_topo[written] = su.topo;
      std::memcpy(out_R + 9 * written, su.R, 9 * sizeof(double));
      std::memcpy(out_t + 3 * written, su.t, 3 * sizeof(double));
      ++written;
    }
    auto it = g->adj.find(u);
    if (it == g->adj.end()) continue;
    for (size_t idx : it->second) {
      const Edge& e = g->edges[idx];
      int64_t v = (e.a == u) ? e.b : e.a;
      State& sv = st[v];
      if (sv.done) continue;
      double Rv[9], tv[3];
      if (e.a == u) {
        compose(su.R, su.t, e.R, e.t, Rv, tv);
      } else {
        double Ri[9], ti[3];
        invert(e.R, e.t, Ri, ti);
        compose(su.R, su.t, Ri, ti, Rv, tv);
      }
      double w = std::sqrt(e.t[0] * e.t[0] + e.t[1] * e.t[1] + e.t[2] * e.t[2]);
      double nd = d + w;
      if (!sv.seen || nd < sv.dist) {
        sv.seen = true;
        sv.dist = nd;
        sv.topo = su.topo + 1;
        std::memcpy(sv.R, Rv, sizeof(Rv));
        std::memcpy(sv.t, tv, sizeof(tv));
        heap.push({nd, v});
      }
    }
  }
  return reached;
}

}  // extern "C"
