// Exact maximum-weight general-graph matching, O(n^3) primal-dual blossom
// algorithm (Edmonds' blossoms with integral duals on doubled weights).
//
// Replaces the reference's vendored blossom5 binary + text-file subprocess
// protocol (reference: src/mwpm.py:376-404) with an in-memory C API used
// from Python via ctypes: no temp files, no exec per call, thread-safe
// (no globals).
//
// Minimum-weight perfect matching is obtained by maximizing with
// transformed weights W = OFFSET - w for a large OFFSET, which forces
// maximum cardinality first (perfect when one exists) and minimum total
// weight among those.
//
// Algorithmic lineage: the primal-dual skeleton (st_/lab_/flower_from_/
// get_pr slot structure) follows the well-known public O(n^3) general-graph
// maximum-weight matching template from the competitive-programming
// literature (an implementation of Edmonds' blossom algorithm with integral
// duals on doubled weights, as described in Galil's 1986 survey), adapted
// here with the min-weight transform, a C API and no global state.  It is
// validated against brute-force enumeration in tests/test_matching.py.

#include <algorithm>
#include <cstring>
#include <deque>
#include <vector>

typedef long long ll;
static const ll NEG_INF = -(1LL << 60);

namespace {

struct Edge {
  int u, v;
  ll w;  // doubled weight
};

class Matcher {
 public:
  explicit Matcher(int n)
      : n_(n),
        cap_(2 * n + 1),
        g_(cap_, std::vector<Edge>(cap_)),
        lab_(cap_, 0),
        match_(cap_, 0),
        slack_(cap_, 0),
        st_(cap_, 0),
        pa_(cap_, 0),
        s_(cap_, 0),
        vis_(cap_, 0),
        flower_(cap_),
        flower_from_(cap_, std::vector<int>(n + 1, 0)) {
    for (int u = 0; u <= 2 * n_; ++u)
      for (int v = 0; v <= 2 * n_; ++v) g_[u][v] = Edge{u, v, NEG_INF};
  }

  void add_edge(int u, int v, ll w2) {  // w2 = doubled weight
    if (w2 > g_[u][v].w) {
      g_[u][v].w = w2;
      g_[v][u].w = w2;
    }
  }

  // Returns total doubled weight; match[i] = partner of i (0 if unmatched).
  ll solve(std::vector<int>* match_out) {
    n_x_ = n_;
    ll ans = 0;
    for (int u = 0; u <= n_; ++u) st_[u] = u, flower_[u].clear();
    ll w_max = 0;
    for (int u = 1; u <= n_; ++u)
      for (int v = 1; v <= n_; ++v) {
        flower_from_[u][v] = (u == v ? u : 0);
        if (g_[u][v].w > NEG_INF) w_max = std::max(w_max, g_[u][v].w);
      }
    for (int u = 1; u <= n_; ++u) lab_[u] = w_max;
    while (matching()) {
    }
    for (int u = 1; u <= n_; ++u)
      if (match_[u] && match_[u] < u) ans += g_[u][match_[u]].w;
    match_out->assign(match_.begin(), match_.begin() + n_ + 1);
    return ans;
  }

 private:
  int n_, cap_, n_x_;
  int lca_t_ = 0;
  std::vector<std::vector<Edge>> g_;
  std::vector<ll> lab_;
  std::vector<int> match_, slack_, st_, pa_, s_, vis_;
  std::vector<std::vector<int>> flower_;
  std::vector<std::vector<int>> flower_from_;
  std::deque<int> q_;

  ll e_delta(const Edge& e) const {
    return lab_[e.u] + lab_[e.v] - g_[e.u][e.v].w * 2;
  }

  void update_slack(int u, int x) {
    if (!slack_[x] || e_delta(g_[u][x]) < e_delta(g_[slack_[x]][x]))
      slack_[x] = u;
  }

  void set_slack(int x) {
    slack_[x] = 0;
    for (int u = 1; u <= n_; ++u)
      if (g_[u][x].w > NEG_INF && st_[u] != x && s_[st_[u]] == 0)
        update_slack(u, x);
  }

  void q_push(int x) {
    if (x <= n_) {
      q_.push_back(x);
    } else {
      for (int t : flower_[x]) q_push(t);
    }
  }

  void set_st(int x, int b) {
    st_[x] = b;
    if (x > n_)
      for (int t : flower_[x]) set_st(t, b);
  }

  int get_pr(int b, int xr) {
    int pr = (int)(std::find(flower_[b].begin(), flower_[b].end(), xr) -
                   flower_[b].begin());
    if (pr % 2 == 1) {  // odd position: reverse the cycle to make it even
      std::reverse(flower_[b].begin() + 1, flower_[b].end());
      return (int)flower_[b].size() - pr;
    }
    return pr;
  }

  void set_match(int u, int v) {
    match_[u] = g_[u][v].v;
    if (u > n_) {
      const Edge& e = g_[u][v];
      int xr = flower_from_[u][e.u];
      int pr = get_pr(u, xr);
      for (int i = 0; i < pr; ++i)
        set_match(flower_[u][i], flower_[u][i ^ 1]);
      set_match(xr, v);
      std::rotate(flower_[u].begin(), flower_[u].begin() + pr,
                  flower_[u].end());
    }
  }

  void augment(int u, int v) {
    while (true) {
      int xnv = st_[match_[u]];
      set_match(u, v);
      if (!xnv) return;
      set_match(xnv, st_[pa_[xnv]]);
      u = st_[pa_[xnv]];
      v = xnv;
    }
  }

  int get_lca(int u, int v) {
    // per-instance visit stamp (a function-local static would be shared
    // across threads; concurrent solves would corrupt each other's vis_)
    int &t = lca_t_;
    for (++t; u || v; std::swap(u, v)) {
      if (u == 0) continue;
      if (vis_[u] == t) return u;
      vis_[u] = t;
      u = st_[match_[u]];
      if (u) u = st_[pa_[u]];
    }
    return 0;
  }

  void add_blossom(int u, int lca, int v) {
    int b = n_ + 1;
    while (b <= n_x_ && st_[b]) ++b;
    if (b > n_x_) ++n_x_;
    lab_[b] = 0;
    s_[b] = 0;
    match_[b] = match_[lca];
    flower_[b].clear();
    flower_[b].push_back(lca);
    for (int x = u, y; x != lca; x = st_[pa_[y]]) {
      flower_[b].push_back(x);
      y = st_[match_[x]];
      flower_[b].push_back(y);
      q_push(y);
    }
    std::reverse(flower_[b].begin() + 1, flower_[b].end());
    for (int x = v, y; x != lca; x = st_[pa_[y]]) {
      flower_[b].push_back(x);
      y = st_[match_[x]];
      flower_[b].push_back(y);
      q_push(y);
    }
    set_st(b, b);
    for (int x = 1; x <= n_x_; ++x) g_[b][x].w = g_[x][b].w = NEG_INF;
    for (int x = 1; x <= n_; ++x) flower_from_[b][x] = 0;
    for (int xs : flower_[b]) {
      for (int x = 1; x <= n_x_; ++x)
        if (g_[xs][x].w > NEG_INF &&
            (g_[b][x].w == NEG_INF ||
             e_delta(g_[xs][x]) < e_delta(g_[b][x]))) {
          g_[b][x] = g_[xs][x];
          g_[x][b] = g_[x][xs];
        }
      for (int x = 1; x <= n_; ++x)
        if (flower_from_[xs][x]) flower_from_[b][x] = xs;
    }
    set_slack(b);
  }

  void expand_blossom(int b) {
    for (int t : flower_[b]) set_st(t, t);
    int xr = flower_from_[b][g_[b][pa_[b]].u];
    int pr = get_pr(b, xr);
    for (int i = 0; i < pr; i += 2) {
      int xs = flower_[b][i];
      int xns = flower_[b][i + 1];
      pa_[xs] = g_[xns][xs].u;
      s_[xs] = 1;
      s_[xns] = 0;
      slack_[xs] = 0;
      set_slack(xns);
      q_push(xns);
    }
    s_[xr] = 1;
    pa_[xr] = pa_[b];
    for (size_t i = pr + 1; i < flower_[b].size(); ++i) {
      int xs = flower_[b][i];
      s_[xs] = -1;
      set_slack(xs);
    }
    st_[b] = 0;
  }

  bool on_found_edge(const Edge& e) {
    int u = st_[e.u], v = st_[e.v];
    if (s_[v] == -1) {
      pa_[v] = e.u;
      s_[v] = 1;
      int nu = st_[match_[v]];
      slack_[v] = slack_[nu] = 0;
      s_[nu] = 0;
      q_push(nu);
    } else if (s_[v] == 0) {
      int lca = get_lca(u, v);
      if (!lca) {
        augment(u, v);
        augment(v, u);
        return true;
      }
      add_blossom(u, lca, v);
    }
    return false;
  }

  bool matching() {
    std::fill(s_.begin(), s_.begin() + n_x_ + 1, -1);
    std::fill(slack_.begin(), slack_.begin() + n_x_ + 1, 0);
    q_.clear();
    for (int x = 1; x <= n_x_; ++x)
      if (st_[x] == x && !match_[x]) {
        pa_[x] = 0;
        s_[x] = 0;
        q_push(x);
      }
    if (q_.empty()) return false;
    while (true) {
      while (!q_.empty()) {
        int u = q_.front();
        q_.pop_front();
        if (s_[st_[u]] == 1) continue;
        for (int v = 1; v <= n_; ++v)
          if (g_[u][v].w > NEG_INF && st_[u] != st_[v]) {
            if (e_delta(g_[u][v]) == 0) {
              if (on_found_edge(g_[u][v])) return true;
            } else {
              update_slack(u, st_[v]);
            }
          }
      }
      ll d = (1LL << 62);
      for (int b = n_ + 1; b <= n_x_; ++b)
        if (st_[b] == b && s_[b] == 1) d = std::min(d, lab_[b] / 2);
      for (int x = 1; x <= n_x_; ++x)
        if (st_[x] == x && slack_[x]) {
          if (s_[x] == -1)
            d = std::min(d, e_delta(g_[slack_[x]][x]));
          else if (s_[x] == 0)
            d = std::min(d, e_delta(g_[slack_[x]][x]) / 2);
        }
      for (int u = 1; u <= n_; ++u) {
        if (s_[st_[u]] == 0) {
          if (lab_[u] <= d) return false;  // dual hit zero: no augmenting path
          lab_[u] -= d;
        } else if (s_[st_[u]] == 1) {
          lab_[u] += d;
        }
      }
      for (int b = n_ + 1; b <= n_x_; ++b)
        if (st_[b] == b) {
          if (s_[b] == 0)
            lab_[b] += d * 2;
          else if (s_[b] == 1)
            lab_[b] -= d * 2;
        }
      q_.clear();
      for (int x = 1; x <= n_x_; ++x)
        if (st_[x] == x && slack_[x] && st_[slack_[x]] != x &&
            e_delta(g_[slack_[x]][x]) == 0) {
          if (on_found_edge(g_[slack_[x]][x])) return true;
        }
      for (int b = n_ + 1; b <= n_x_; ++b)
        if (st_[b] == b && s_[b] == 1 && lab_[b] == 0) expand_blossom(b);
    }
    return false;
  }
};

}  // namespace

extern "C" {

// Minimum-weight perfect matching.
// nodes are 0..n-1 (n even for a perfect matching to exist);
// edges: (u[i], v[i], w[i]), i < m, integer weights >= 0.
// match_out: length n; match_out[i] = partner of i, or -1 if unmatched.
// Returns total weight of the matching, or -1 if no perfect matching.
ll mwpm_solve(int n, int m, const int* eu, const int* ev, const ll* ew,
              int* match_out) {
  if (n == 0) return 0;
  ll wmax = 0;
  for (int i = 0; i < m; ++i) wmax = std::max(wmax, ew[i]);
  const ll OFFSET = (wmax + 1) * (ll)(n + 1);  // forces max cardinality
  Matcher M(n);
  for (int i = 0; i < m; ++i) {
    // e_delta doubles weights internally, keeping duals integral
    M.add_edge(eu[i] + 1, ev[i] + 1, OFFSET - ew[i]);
  }
  std::vector<int> match;
  M.solve(&match);
  ll total = 0;
  int matched = 0;
  for (int i = 1; i <= n; ++i) {
    match_out[i - 1] = match[i] ? match[i] - 1 : -1;
    if (match[i]) ++matched;
  }
  if (matched != n) return -1;
  // recompute original weight (min weight among parallel edges per pair)
  std::vector<ll> best(n, -1);
  for (int i = 0; i < m; ++i) {
    int a = eu[i], b = ev[i];
    if (match_out[a] == b) {
      if (best[a] < 0 || ew[i] < best[a]) best[a] = ew[i];
      if (best[b] < 0 || ew[i] < best[b]) best[b] = ew[i];
    }
  }
  for (int i = 0; i < n; ++i)
    if (match_out[i] > i) total += best[i];
  return total;
}
}
