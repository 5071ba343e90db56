// mcmf_oracle — CPU min-cost max-flow oracle speaking DIMACS.
//
// The native-equivalent of the reference's external solver seam: Poseidon
// ships Goldberg's cs2 / Flowlessly as separate binaries invoked by
// Firmament's SolverDispatcher (reference deploy/poseidon.cfg:8-10,
// deploy/run.sh:7, README.md:21). This binary is (a) the correctness
// oracle for the TPU solver's differential tests and (b) the CPU baseline
// for the >=20x benchmark comparison.
//
// Algorithms (selectable, mirroring the reference's
// --flowlessly_algorithm flag, poseidon.cfg:10):
//   ssp           successive shortest paths (Bellman-Ford potentials init
//                 when negative costs exist, then Dijkstra + potentials)
//   cost_scaling  Goldberg-Tarjan cost-scaling push-relabel on the
//                 min-cost circulation with a -BIG forcing arc
//                 (cs2-family)
//   cs2           tuned cost-scaling with cs2's signature heuristics:
//                 flat CSR edge arrays, FIFO discharge, and the global
//                 price-update heuristic (multi-source shortest-path in
//                 eps units from deficit nodes, applied at refine start
//                 and periodically between relabels). Goldberg's actual
//                 cs2 sources are not obtainable in this offline build
//                 environment; this is an independent implementation of
//                 the same algorithm family and heuristics, kept as the
//                 STRONGEST CPU baseline so the >=20x comparison is
//                 against a tuned solver, not a strawman.
//
// All are exact over int64 arithmetic (prices in int128).
//
// I/O contract:
//   stdin:  DIMACS min ("p min N M", "n id supply", "a src dst 0 cap cost")
//   stdout: "s <total_cost>" then exactly one "f <src> <dst> <flow>" line
//           per input arc IN INPUT ORDER (1-indexed endpoints), then
//           "c time_ms <solve milliseconds>".
//   exit 1 with "c infeasible" if the supplies cannot be routed.
//
// Usage: mcmf_oracle [ssp|cost_scaling] < problem.dimacs

#include <algorithm>
#include <array>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>
#include <queue>
#include <string>
#include <vector>

namespace {

using i64 = int64_t;
using i128 = __int128;
constexpr i64 kInf = std::numeric_limits<i64>::max() / 4;

struct Edge {
  int to;
  i64 cap;   // residual capacity
  i64 cost;  // unit cost
  int rev;   // index of reverse edge in graph_[to]
};

struct Solver {
  int n_ = 0;
  std::vector<std::vector<Edge>> graph_;
  // (node, index into graph_[node]) of each *input* arc's forward edge
  std::vector<std::pair<int, int>> input_arcs_;
  std::vector<i64> input_cap_;

  void Init(int n) {
    n_ = n;
    graph_.assign(n, {});
  }

  int AddEdge(int from, int to, i64 cap, i64 cost) {
    // Self-loops put both half-edges in the same list: compute indices
    // up front so rev-pointers and the returned forward index stay right.
    int fwd = (int)graph_[from].size();
    int bwd = (int)graph_[to].size() + (from == to ? 1 : 0);
    graph_[from].push_back({to, cap, cost, bwd});
    graph_[to].push_back({from, 0, -cost, fwd});
    return fwd;
  }

  void AddInputArc(int from, int to, i64 cap, i64 cost) {
    int idx = AddEdge(from, to, cap, cost);
    input_arcs_.emplace_back(from, idx);
    input_cap_.push_back(cap);
  }

  i64 MaxAbsCost() const {
    i64 maxc = 0;
    for (int v = 0; v < n_; ++v)
      for (const Edge& e : graph_[v])
        maxc = std::max(maxc, e.cost < 0 ? -e.cost : e.cost);
    return maxc;
  }

  bool HasNegativeCost() const {
    for (size_t a = 0; a < input_arcs_.size(); ++a) {
      auto [v, i] = input_arcs_[a];
      if (graph_[v][i].cost < 0) return true;
    }
    return false;
  }

  // ---- successive shortest paths with potentials ----
  // Pushes up to `want` units s->t; returns (flow_routed, total_cost).
  std::pair<i64, i64> SolveSSP(int s, int t, i64 want) {
    std::vector<i64> pot(n_, 0);
    if (HasNegativeCost()) BellmanFordPotentials(s, &pot);
    i64 flow = 0, cost = 0;
    std::vector<i64> dist(n_);
    std::vector<int> pv(n_), pe(n_);
    using QE = std::pair<i64, int>;
    while (flow < want) {
      std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
      std::fill(dist.begin(), dist.end(), kInf);
      dist[s] = 0;
      pq.push({0, s});
      while (!pq.empty()) {
        auto [d, v] = pq.top();
        pq.pop();
        if (d > dist[v]) continue;
        for (int i = 0; i < (int)graph_[v].size(); ++i) {
          const Edge& e = graph_[v][i];
          if (e.cap <= 0) continue;
          i64 nd = d + e.cost + pot[v] - pot[e.to];
          if (nd < dist[e.to]) {
            dist[e.to] = nd;
            pv[e.to] = v;
            pe[e.to] = i;
            pq.push({nd, e.to});
          }
        }
      }
      if (dist[t] >= kInf) break;  // no augmenting path left
      for (int v = 0; v < n_; ++v)
        if (dist[v] < kInf) pot[v] += dist[v];
      i64 push = want - flow;
      for (int v = t; v != s; v = pv[v])
        push = std::min(push, graph_[pv[v]][pe[v]].cap);
      for (int v = t; v != s; v = pv[v]) {
        Edge& e = graph_[pv[v]][pe[v]];
        e.cap -= push;
        graph_[v][e.rev].cap += push;
        cost += push * e.cost;
      }
      flow += push;
    }
    return {flow, cost};
  }

  void BellmanFordPotentials(int s, std::vector<i64>* pot) {
    std::vector<i64>& p = *pot;
    std::fill(p.begin(), p.end(), kInf);
    p[s] = 0;
    for (int round = 0; round < n_; ++round) {
      bool changed = false;
      for (int v = 0; v < n_; ++v) {
        if (p[v] >= kInf) continue;
        for (const Edge& e : graph_[v]) {
          if (e.cap > 0 && p[v] + e.cost < p[e.to]) {
            p[e.to] = p[v] + e.cost;
            changed = true;
          }
        }
      }
      if (!changed) break;
    }
    for (int v = 0; v < n_; ++v)
      if (p[v] >= kInf) p[v] = 0;  // unreachable: any finite potential works
  }

  // ---- cost-scaling push-relabel on the forced circulation ----
  // Adds a t->s arc with cap `want` and cost -BIG (BIG dominating every
  // simple path cost), then finds a min-cost circulation by epsilon-
  // scaling: refine(eps) saturates all negative-reduced-cost residual
  // arcs and discharges active nodes until no excess remains. Exact once
  // eps < 1/n in the n-scaled cost domain. Flow routed = flow on the
  // forcing arc; if it is < want the instance is capacity-infeasible.
  std::pair<i64, i64> SolveCostScaling(int s, int t, i64 want) {
    const i64 maxc = MaxAbsCost();
    const i64 big = (maxc + 1) * (i64)(n_ + 1);
    int force_node = t;
    AddEdge(t, s, want, -big);
    const int force_idx = (int)graph_[t].size() - 1;

    const i64 scale = (i64)n_;  // work in cost*n so eps==1 is exact
    std::vector<i128> price(n_, 0);
    auto rcost = [&](int v, const Edge& e) -> i128 {
      return (i128)e.cost * scale + price[v] - price[e.to];
    };

    const i64 kAlpha = 8;
    i64 eps = (maxc > big ? maxc : big) * scale;
    std::vector<int> cur(n_, 0);
    std::vector<i64> excess(n_, 0);
    std::vector<int> active;
    active.reserve(n_);

    while (true) {
      // --- refine(eps): saturate every negative-reduced-cost arc ---
      for (int v = 0; v < n_; ++v) {
        for (Edge& e : graph_[v]) {
          if (e.cap > 0 && rcost(v, e) < 0) {
            excess[v] -= e.cap;
            excess[e.to] += e.cap;
            graph_[e.to][e.rev].cap += e.cap;
            e.cap = 0;
          }
        }
      }
      std::fill(cur.begin(), cur.end(), 0);
      active.clear();
      for (int v = 0; v < n_; ++v)
        if (excess[v] > 0) active.push_back(v);

      while (!active.empty()) {
        int v = active.back();
        active.pop_back();
        while (excess[v] > 0) {
          if (cur[v] == (int)graph_[v].size()) {
            // relabel: largest price making some residual arc admissible
            bool any = false;
            i128 best = 0;
            for (const Edge& e : graph_[v]) {
              if (e.cap > 0) {
                i128 np = price[e.to] - (i128)e.cost * scale - eps;
                if (!any || np > best) best = np, any = true;
              }
            }
            if (!any) {
              // isolated excess: cannot happen in a circulation with
              // reverse arcs present; defensive bail
              std::fprintf(stderr, "cost_scaling: stuck node %d\n", v);
              return {-1, 0};
            }
            price[v] = best;
            cur[v] = 0;
          }
          Edge& e = graph_[v][cur[v]];
          if (e.cap > 0 && rcost(v, e) < 0) {
            i64 push = std::min(excess[v], e.cap);
            e.cap -= push;
            graph_[e.to][e.rev].cap += push;
            excess[v] -= push;
            bool was_inactive = excess[e.to] <= 0;
            excess[e.to] += push;
            if (was_inactive && excess[e.to] > 0) active.push_back(e.to);
          } else {
            ++cur[v];
          }
        }
      }
      if (eps == 1) break;
      eps = std::max<i64>(1, eps / kAlpha);
    }

    // routed = flow on the forcing arc = want - residual cap
    i64 routed = want - graph_[force_node][force_idx].cap;
    i64 cost = 0;
    for (size_t a = 0; a < input_arcs_.size(); ++a)
      cost += FlowOnInputArc(a) * graph_[input_arcs_[a].first][input_arcs_[a].second].cost;
    return {routed, cost};
  }

  i64 FlowOnInputArc(size_t a) const {
    auto [v, i] = input_arcs_[a];
    return input_cap_[a] - graph_[v][i].cap;
  }
};

// ---- cs2-class tuned cost-scaling ------------------------------------
// Independent implementation of the cs2 algorithm family (Goldberg's
// cost-scaling push-relabel) with its documented performance heuristics:
//  - flat CSR edge arrays (cache-friendly adjacency, no per-node vectors)
//  - FIFO discharge of active nodes
//  - the GLOBAL PRICE UPDATE heuristic: a multi-source shortest-path in
//    eps units from deficit nodes, run at each refine start and again
//    every O(n) relabels, collapsing long relabel waves into one pass.
// Exact over int64 flows with int128 prices (arbitrary DIMACS costs).
struct CS2Solver {
  int n_ = 0;
  long m_ = 0;  // directed edge slots (forward + backward)
  std::vector<int> first_;   // CSR offsets, size n_+1
  std::vector<int> head_;    // edge target
  std::vector<i64> resid_;   // residual capacity
  std::vector<i64> cost_;    // unit cost (unscaled)
  std::vector<int> rev_;     // paired reverse edge id
  std::vector<int> input_edge_;  // input arc a -> forward edge id
  std::vector<i64> input_cap_;

  // build-time edge staging (from, to, cap, cost); CSR assembled once
  std::vector<std::array<i64, 4>> staged_;
  std::vector<int> staged_input_;  // indices into staged_ of input arcs
  std::vector<int> staged_fwd_;   // staged index -> forward edge id

  void Init(int n) { n_ = n; }

  // returns the staged index (resolve to an edge id via staged_fwd_
  // after Assemble)
  int AddEdgeStaged(int from, int to, i64 cap, i64 cost, bool input) {
    if (input) staged_input_.push_back((int)staged_.size());
    staged_.push_back({from, to, cap, cost});
    return (int)staged_.size() - 1;
  }

  void Assemble() {
    long E = (long)staged_.size();
    m_ = 2 * E;
    std::vector<int> deg(n_ + 1, 0);
    for (auto& e : staged_) {
      deg[(int)e[0] + 1]++;
      deg[(int)e[1] + 1]++;
    }
    first_.assign(n_ + 1, 0);
    for (int v = 1; v <= n_; ++v) first_[v] = first_[v - 1] + deg[v];
    head_.assign(m_, 0);
    resid_.assign(m_, 0);
    cost_.assign(m_, 0);
    rev_.assign(m_, 0);
    std::vector<int> fill(first_.begin(), first_.end() - 1);
    std::vector<int> fwd_id(E), bwd_id(E);
    for (long a = 0; a < E; ++a) {
      int u = (int)staged_[a][0], v = (int)staged_[a][1];
      fwd_id[a] = fill[u]++;
      bwd_id[a] = fill[v]++;
    }
    for (long a = 0; a < E; ++a) {
      int u = (int)staged_[a][0], v = (int)staged_[a][1];
      int f = fwd_id[a], b = bwd_id[a];
      head_[f] = v; resid_[f] = staged_[a][2]; cost_[f] = staged_[a][3];
      rev_[f] = b;
      head_[b] = u; resid_[b] = 0; cost_[b] = -staged_[a][3];
      rev_[b] = f;
    }
    input_edge_.reserve(staged_input_.size());
    for (int a : staged_input_) {
      input_edge_.push_back(fwd_id[a]);
      input_cap_.push_back(staged_[a][2]);
    }
    staged_fwd_ = std::move(fwd_id);
    staged_.clear();
    staged_.shrink_to_fit();
  }

  i64 FlowOnInputArc(size_t a) const {
    return input_cap_[a] - resid_[input_edge_[a]];
  }

  // Tuning knobs, measured on the BASELINE ladder instances (flagship
  // Quincy 1k x 10k, CoCo 1k x 8k): alpha 8-12 tie within noise and
  // beat 4/16/32; the PERIODIC mid-refine update consistently LOSES on
  // these shallow scheduling graphs (the refine-start update already
  // settles the 4-layer price landscape, and each periodic update pays
  // a full Dijkstra plus a mandatory arc-cursor reset), so it defaults
  // off. update_div == 0 disables it (the refine-start update always
  // runs). Net vs the plain cost_scaling mode: ~1.2-1.5x faster
  // (flagship 168 vs 228 ms, coco ~80 vs 112 ms).
  i64 alpha_ = 12;
  long update_div_ = 0;  // if >0, also update every n_/update_div_ relabels

  // Solve the forced circulation; returns the exact cost over the
  // input arcs (the caller reads routed flow off the forcing edge).
  i64 Solve(i64 scale, i64 eps0, i64 alpha) {
    std::vector<i128> price(n_, 0);
    std::vector<i64> excess(n_, 0);
    std::vector<int> cur(n_, 0);
    std::deque<int> fifo;
    std::vector<char> in_q(n_, 0);

    auto rc = [&](int v, int e) -> i128 {
      return (i128)cost_[e] * scale + price[v] - price[head_[e]];
    };

    // global price update: k[v] = least relabel count (in eps units)
    // opening an admissible path to a deficit; price[v] -= k[v]*eps.
    // Dijkstra over lengths max(0, floor(rc/eps) + 1).
    std::vector<i64> kdist(n_);
    using QE = std::pair<i64, int>;
    auto price_update = [&](i64 eps) {
      std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
      std::fill(kdist.begin(), kdist.end(), kInf);
      for (int v = 0; v < n_; ++v)
        if (excess[v] < 0) { kdist[v] = 0; pq.push({0, v}); }
      if (pq.empty()) return;
      while (!pq.empty()) {
        auto [d, v] = pq.top(); pq.pop();
        if (d > kdist[v]) continue;
        // scan IN-arcs of v = reverse edges out of v with residual on
        // the paired edge; CSR stores both directions adjacently, so
        // walk v's list and use the reverse pairing
        for (int e = first_[v]; e < first_[v + 1]; ++e) {
          int u = head_[e];           // candidate predecessor
          int er = rev_[e];           // u -> v edge
          if (resid_[er] <= 0) continue;
          i128 r = rc(u, er);
          // length in eps units to make u->v admissible after lowering
          // price[u] by k*eps: need rc - k*eps < 0 => k > rc/eps
          i64 len = r < 0 ? 0 : (i64)(r / eps) + 1;
          i64 nd = d + len;
          if (nd < kdist[u]) { kdist[u] = nd; pq.push({nd, u}); }
        }
      }
      i64 kmax = 0;
      for (int v = 0; v < n_; ++v)
        if (kdist[v] < kInf && kdist[v] > kmax) kmax = kdist[v];
      for (int v = 0; v < n_; ++v) {
        i64 k = kdist[v] < kInf ? kdist[v] : kmax + 1;
        price[v] -= (i128)k * eps;
      }
    };

    i64 eps = eps0;
    const long update_every =
        update_div_ > 0 ? std::max<long>(256, n_ / update_div_)
                        : std::numeric_limits<long>::max();
    while (true) {
      // refine(eps): saturate all negative-reduced-cost arcs
      for (int v = 0; v < n_; ++v) {
        for (int e = first_[v]; e < first_[v + 1]; ++e) {
          if (resid_[e] > 0 && rc(v, e) < 0) {
            excess[v] -= resid_[e];
            excess[head_[e]] += resid_[e];
            resid_[rev_[e]] += resid_[e];
            resid_[e] = 0;
          }
        }
      }
      price_update(eps);
      std::fill(cur.begin(), cur.end(), 0);
      fifo.clear();
      std::fill(in_q.begin(), in_q.end(), 0);
      for (int v = 0; v < n_; ++v)
        if (excess[v] > 0) { fifo.push_back(v); in_q[v] = 1; }
      long relabels = 0;

      while (!fifo.empty()) {
        int v = fifo.front();
        fifo.pop_front();
        in_q[v] = 0;
        while (excess[v] > 0) {
          if (cur[v] == first_[v + 1] - first_[v]) {
            // relabel to the largest admissible-making price
            bool any = false;
            i128 best = 0;
            for (int e = first_[v]; e < first_[v + 1]; ++e) {
              if (resid_[e] > 0) {
                i128 np =
                    price[head_[e]] - (i128)cost_[e] * scale - eps;
                if (!any || np > best) { best = np; any = true; }
              }
            }
            if (!any) {
              std::fprintf(stderr, "cs2: stuck node %d\n", v);
              std::exit(3);  // cannot happen in a circulation
            }
            price[v] = best;
            cur[v] = 0;
            if (++relabels % update_every == 0) {
              price_update(eps);
              // prices moved globally: restart arc cursors
              std::fill(cur.begin(), cur.end(), 0);
            }
          }
          int e = first_[v] + cur[v];
          if (resid_[e] > 0 && rc(v, e) < 0) {
            i64 push = std::min(excess[v], resid_[e]);
            resid_[e] -= push;
            resid_[rev_[e]] += push;
            excess[v] -= push;
            int w = head_[e];
            bool was_inactive = excess[w] <= 0;
            excess[w] += push;
            if (was_inactive && excess[w] > 0 && !in_q[w]) {
              fifo.push_back(w);
              in_q[w] = 1;
            }
          } else {
            ++cur[v];
          }
        }
      }
      if (eps == 1) break;
      eps = std::max<i64>(1, eps / alpha);
    }

    i64 cost = 0;
    for (size_t a = 0; a < input_edge_.size(); ++a)
      cost += FlowOnInputArc(a) * cost_[input_edge_[a]];
    return cost;
  }
};

}  // namespace

int main(int argc, char** argv) {
  std::string algo = argc > 1 ? argv[1] : "ssp";
  if (algo != "ssp" && algo != "cost_scaling" && algo != "cs2") {
    std::fprintf(stderr, "usage: %s [ssp|cost_scaling|cs2] < dimacs\n",
                 argv[0]);
    return 2;
  }

  int n = -1;
  long m = -1;
  Solver solver;
  std::vector<i64> supply;
  std::vector<std::array<i64, 4>> arcs;  // src, dst, cap, cost (0-indexed)
  {
    char line[256];
    while (std::fgets(line, sizeof line, stdin)) {
      if (line[0] == 'c' || line[0] == '\n') continue;
      if (line[0] == 'p') {
        char kind[16];
        if (std::sscanf(line, "p %15s %d %ld", kind, &n, &m) != 3 ||
            std::strcmp(kind, "min") != 0) {
          std::fprintf(stderr, "bad problem line\n");
          return 2;
        }
        supply.assign(n, 0);
      } else if (line[0] == 'n') {
        long v = 0;
        long long s = 0;
        if (std::sscanf(line, "n %ld %lld", &v, &s) != 2 || v < 1 || v > n) {
          std::fprintf(stderr, "bad node line: %s", line);
          return 2;
        }
        supply[v - 1] = s;
      } else if (line[0] == 'a') {
        long u = 0, v = 0;
        long long low = 0, cap = 0, cost = 0;
        if (std::sscanf(line, "a %ld %ld %lld %lld %lld", &u, &v, &low, &cap,
                        &cost) != 5 ||
            u < 1 || u > n || v < 1 || v > n) {
          std::fprintf(stderr, "bad arc line: %s", line);
          return 2;
        }
        if (low != 0) {
          std::fprintf(stderr, "nonzero lower bound unsupported\n");
          return 2;
        }
        arcs.push_back({u - 1, v - 1, cap, cost});
      }
    }
  }
  if (n < 0) {
    std::fprintf(stderr, "no problem line\n");
    return 2;
  }

  // Super source/sink framing.
  int S = n, T = n + 1;
  i64 total_supply = 0;
  for (int v = 0; v < n; ++v)
    if (supply[v] > 0) total_supply += supply[v];

  if (algo == "cs2" || algo == "cost_scaling") {
    // Both scaling modes start the eps ladder at
    // eps0 = (maxc+1)*(n+3)*(n+2) (cs2: big=(maxc+1)*(n+3) times
    // scale=n+2; cost_scaling: big=(maxc+1)*(n_+1) times scale=n_
    // with n_=n+2 — the same product). Computed in 64-bit that wraps
    // silently for maxc ~ 2^63/n^2 and the ladder then starts from a
    // garbage (possibly negative) eps — check the product in 128-bit
    // and refuse loudly instead, mirroring the alpha < 2 guard below.
    // abs and +1 in 128-bit: both wrap in int64 at the extremes the
    // guard exists to refuse (|INT64_MIN| and INT64_MAX + 1)
    i128 maxc_all = 0;
    for (auto& a : arcs) {
      i128 c = (i128)a[3];
      if (c < 0) c = -c;
      maxc_all = std::max(maxc_all, c);
    }
    i128 eps0_wide = (maxc_all + 1) * (i128)(n + 3) * (i128)(n + 2);
    if (eps0_wide > (i128)INT64_MAX) {
      i128 shown = maxc_all > (i128)INT64_MAX ? (i128)INT64_MAX
                                              : maxc_all;
      std::fprintf(stderr,
                   "%s: eps0 = (maxc+1)(n+3)(n+2) overflows int64 "
                   "(maxc=%lld, n=%d)\n",
                   algo.c_str(), (long long)shown, n);
      return 2;
    }
  }

  if (algo == "cs2") {
    CS2Solver cs2;
    cs2.Init(n + 2);
    for (auto& a : arcs)
      cs2.AddEdgeStaged((int)a[0], (int)a[1], a[2], a[3], true);
    i64 maxc = 0;
    for (auto& a : arcs) maxc = std::max(maxc, a[3] < 0 ? -a[3] : a[3]);
    for (int v = 0; v < n; ++v) {
      if (supply[v] > 0) cs2.AddEdgeStaged(S, v, supply[v], 0, false);
      else if (supply[v] < 0) cs2.AddEdgeStaged(v, T, -supply[v], 0, false);
    }
    const i64 big = (maxc + 1) * (i64)(n + 3);
    int force_staged =
        cs2.AddEdgeStaged(T, S, total_supply, -big, false);
    cs2.Assemble();
    int force_edge = cs2.staged_fwd_[force_staged];

    const i64 scale = (i64)(n + 2);
    i64 eps0 = big * scale;
    // optional tuning overrides: mcmf_oracle cs2 [alpha] [update_div]
    if (argc > 2) cs2.alpha_ = std::atoll(argv[2]);
    if (argc > 3) cs2.update_div_ = std::atol(argv[3]);
    if (cs2.alpha_ < 2) {
      // alpha 0 would SIGFPE on the eps division and alpha 1 would
      // never shrink eps (infinite scaling loop)
      std::fprintf(stderr, "cs2: alpha must be >= 2 (got %lld)\n",
                   (long long)cs2.alpha_);
      return 2;
    }
    auto t0 = std::chrono::steady_clock::now();
    i64 cost = cs2.Solve(scale, eps0, cs2.alpha_);
    auto t1 = std::chrono::steady_clock::now();
    double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();

    i64 routed = total_supply - cs2.resid_[force_edge];
    if (routed != total_supply) {
      std::printf("c infeasible routed=%lld of %lld\n", (long long)routed,
                  (long long)total_supply);
      return 1;
    }
    std::printf("s %lld\n", (long long)cost);
    for (size_t a = 0; a < arcs.size(); ++a) {
      std::printf("f %lld %lld %lld\n", (long long)(arcs[a][0] + 1),
                  (long long)(arcs[a][1] + 1),
                  (long long)cs2.FlowOnInputArc(a));
    }
    std::printf("c time_ms %.3f\n", ms);
    return 0;
  }

  solver.Init(n + 2);
  for (auto& a : arcs)
    solver.AddInputArc((int)a[0], (int)a[1], a[2], a[3]);
  for (int v = 0; v < n; ++v) {
    if (supply[v] > 0) {
      solver.AddEdge(S, v, supply[v], 0);
    } else if (supply[v] < 0) {
      solver.AddEdge(v, T, -supply[v], 0);
    }
  }

  auto t0 = std::chrono::steady_clock::now();
  std::pair<i64, i64> res = algo == "ssp"
                                ? solver.SolveSSP(S, T, total_supply)
                                : solver.SolveCostScaling(S, T, total_supply);
  auto t1 = std::chrono::steady_clock::now();
  double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();

  if (res.first != total_supply) {
    std::printf("c infeasible routed=%lld of %lld\n", (long long)res.first,
                (long long)total_supply);
    return 1;
  }
  std::printf("s %lld\n", (long long)res.second);
  for (size_t a = 0; a < arcs.size(); ++a) {
    std::printf("f %lld %lld %lld\n", (long long)(arcs[a][0] + 1),
                (long long)(arcs[a][1] + 1),
                (long long)solver.FlowOnInputArc(a));
  }
  std::printf("c time_ms %.3f\n", ms);
  return 0;
}
