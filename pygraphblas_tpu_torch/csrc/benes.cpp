// Benes routing for the static permutation plans of
// pygraphblas_tpu_torch/core/perm.py (PermPlan.build).
//
// A copy of the routing code of the JAX package's native runtime
// (native/fastio.cpp: BenesCtx, benes_orient, benes_split, benes_rec,
// benes_par, benes_color, benes_stages), with a plain C interface in
// place of the CPython one so that it loads through ctypes.  Built at
// first use by pygraphblas_tpu_torch/_native.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -o libpgb_benes.so benes.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <thread>

#include <sys/mman.h>

#ifndef MADV_COLLAPSE
#define MADV_COLLAPSE 25
#endif

// Back a populated buffer with 2 MB huge pages (synchronous THP
// collapse, Linux 6.1+).  The Benes trail walk randomly accesses
// multi-GB arrays; with 4 KB pages the page tables themselves fall out
// of L2 at GAP scale, adding a second DRAM hit to every access and
// making the coloring superlinear in the edge count.  Best-effort:
// EINVAL/old kernels are ignored.
// PYGB_BENES_PROF=1: accumulate per-phase walls, printed by
// benes_stages (stderr)
#include <chrono>
static double bt_build = 0, bt_walk = 0, bt_resolve = 0, bt_part = 0,
              bt_outer = 0, bt_init = 0, bt_leaf = 0;
static bool bt_on = false;
struct BTimer {
  std::chrono::steady_clock::time_point t0;
  double* acc;
  BTimer(double* a) : acc(a) { if (bt_on) t0 = std::chrono::steady_clock::now(); }
  void stop() {
    if (bt_on && acc) {
      *acc += std::chrono::duration<double>(
          std::chrono::steady_clock::now() - t0).count();
      acc = nullptr;
    }
  }
  ~BTimer() { stop(); }
};

static void collapse_huge(void* p, size_t len) {
  if (len < (4u << 20)) return;
  uintptr_t a = ((uintptr_t)p + ((1u << 21) - 1)) & ~(uintptr_t)((1u << 21) - 1);
  uintptr_t end = ((uintptr_t)p + len) & ~(uintptr_t)((1u << 21) - 1);
  if (end <= a) return;
  madvise((void*)a, end - a, MADV_HUGEPAGE);
  madvise((void*)a, end - a, MADV_COLLAPSE);
}

namespace {

// ---------------------------------------------------------------------------
// Benes-routing edge coloring.
//
// Colors the edges of a d-regular (d = 2^bits) bipartite multigraph with
// exactly d colors so that every node sees each color once.  This is the
// host-side routing step for the static-permutation primitive
// (core/perm.py): colors become the lane assignment of the
// middle stage of a Clos/Benes decomposition, so an arbitrary N-element
// permutation executes on-device as lane-gather passes + transposes.
// Method: recursive Euler splits (orient an Euler circuit; left-to-right
// edges form one half, right-to-left the other; each half is d/2-regular).
// Implementation: recursive splits via a "transition system" walk — pair
// consecutive incident edges at every node; the pairing decomposes the
// multigraph into closed trails that alternate sides (bipartite), so
// alternating orientation along each trail halves every node's degree
// exactly.  The walk itself is a dependent pointer chase (2-3 DRAM
// misses per edge), so large subproblems run W interleaved walkers in a
// lockstep software pipeline (prefetch one phase ahead) — the other
// walkers' visits hide each walker's miss latency.  Walkers claim edges
// into "segments"; every pairing constraint is simply "the two paired
// edges get opposite bits", so the untraversed boundary pairings of the
// segments (tail at start, head at collision) become parity relations
// between segments, resolved exactly with a parity union-find (the
// relations along an edge-cycle are consistent: even cycles are
// 2-colorable).  Edge arrays (u, v, id) are kept contiguous per call
// and partitioned together, so deeper levels are cache-resident.
// Offsets are int32: callers guarantee n < 2^30 edges per subproblem.
struct BenesRec { int32_t u, v, su, sv; };  // endpoints + slots, 1 line
struct BenesSeg {                           // POD, no per-seg allocation
  int32_t tail_e, tail_x;  // (own edge, partner across start pairing)
  int32_t head_e, head_x;  // (own edge, collision edge)
};

struct BenesCtx {
  std::vector<int32_t> seg;    // per node-key: -(segment start + 1), or 0
  std::vector<int32_t> fill;   // per node-key: fill cursor
  std::vector<int32_t> adj;    // incidence slots -> local edge id
  std::vector<BenesRec> rec;   // per local edge
  std::vector<int32_t> owner;  // per local edge: segment id, or -1
  std::vector<uint8_t> bit;    // per local edge
  std::vector<int32_t> su, sv, sid;  // partition scratch (size m)
  uint8_t* color;
  int32_t next_color = 0;
};

// Orient edges 0..n-1 (local ids; uu/vv contiguous) so each node's degree
// splits exactly in half between bit 0 and bit 1.
static void benes_orient(BenesCtx& c, const int32_t* uu, const int32_t* vv,
                         int64_t n) {
  BTimer tb(&bt_build);
  // degree count into seg (node keys: left u -> 2u, right v -> 2v+1)
  for (int64_t i = 0; i < n; ++i) {
    c.seg[2 * (int64_t)uu[i]]++;
    c.seg[2 * (int64_t)vv[i] + 1]++;
  }
  // first-touch segment reservation
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t ku = 2 * (int64_t)uu[i], kv = 2 * (int64_t)vv[i] + 1;
    if (c.seg[ku] > 0) {
      int32_t d = c.seg[ku];
      c.seg[ku] = (int32_t)(-(off + 1));
      c.fill[ku] = (int32_t)off;
      off += d;
    }
    if (c.seg[kv] > 0) {
      int32_t d = c.seg[kv];
      c.seg[kv] = (int32_t)(-(off + 1));
      c.fill[kv] = (int32_t)off;
      off += d;
    }
  }
  // fill incidence; record each edge's endpoints + slots in one line
  for (int64_t i = 0; i < n; ++i) {
    int32_t su_ = c.fill[2 * (int64_t)uu[i]]++;
    int32_t sv_ = c.fill[2 * (int64_t)vv[i] + 1]++;
    c.adj[su_] = (int32_t)i;
    c.adj[sv_] = (int32_t)i;
    c.rec[i] = {uu[i], vv[i], su_, sv_};
  }

  tb.stop();
  if (n < (1 << 16)) {
    BTimer tw(&bt_walk);
    // cache-resident subproblem: serial walk, no segment machinery
    for (int64_t i = 0; i < n; ++i) {
      if (c.owner[i] >= 0) continue;
      int64_t e = i;
      int side = 0;
      while (c.owner[e] < 0) {
        c.owner[e] = 0;
        c.bit[e] = (uint8_t)side;
        const BenesRec& r = c.rec[e];
        int64_t arrive_key; int32_t s;
        if (side == 0) { arrive_key = 2 * (int64_t)r.v + 1; s = r.sv; }
        else           { arrive_key = 2 * (int64_t)r.u;     s = r.su; }
        int32_t st = -(c.seg[arrive_key]) - 1;
        int32_t ps = st + ((s - st) ^ 1);
        e = c.adj[ps];
        side = (arrive_key & 1) ? 1 : 0;
      }
    }
  } else {
    // ---- multi-walker trail walk ----
    BTimer tw(&bt_walk);
    constexpr int W = 32;
    struct Walker { int64_t e; int side; int32_t seg_id; bool active; };
    std::vector<BenesSeg> segs;
    segs.reserve(1024);
    Walker wk[W];
    // staggered start regions: consecutive edges are often pairing
    // partners (the v incidence fills in edge order), so walkers
    // starting at adjacent edges would collide on their first step
    int64_t region_scan[W], region_end[W];
    for (int i = 0; i < W; ++i) {
      region_scan[i] = n * i / W;
      region_end[i] = n * (i + 1) / W;
    }
    int64_t scan = 0;  // shared fallback
    int n_active = 0;
    auto start_walker = [&](Walker& w, int i) {
      int64_t s = -1;
      while (region_scan[i] < region_end[i]) {
        if (c.owner[region_scan[i]] < 0) { s = region_scan[i]++; break; }
        ++region_scan[i];
      }
      if (s < 0) {
        while (scan < n && c.owner[scan] >= 0) ++scan;
        if (scan >= n) { w.active = false; return false; }
        s = scan++;
      }
      w.e = s; w.side = 0; w.active = true;
      w.seg_id = (int32_t)segs.size();
      c.owner[s] = w.seg_id;
      c.bit[s] = 0;
      // tail pairing: entering at the u side (side=0), the u-slot
      // pairing is never traversed by this walker — record its partner
      const BenesRec& r0 = c.rec[s];
      int32_t st = -(c.seg[2 * (int64_t)r0.u]) - 1;
      int32_t ps = st + ((r0.su - st) ^ 1);
      segs.push_back({(int32_t)s, c.adj[ps], -1, -1});
      return true;
    };
    for (int i = 0; i < W; ++i) n_active += start_walker(wk[i], i) ? 1 : 0;
    // lockstep batches: tight predictable loops; a walker's prefetch is
    // covered by the other walkers' visits in the same batch
    //   phase 0: rec[e] -> partner slot ps; prefetch adj[ps]
    //   phase 1: j = adj[ps]; prefetch rec[j] + owner[j]
    //   phase 2: claim j (or collide + restart)
    struct Pipe { int32_t ps, nside; int64_t j; };
    Pipe pp[W];
    for (int i = 0; i < W; ++i)
      if (wk[i].active) __builtin_prefetch(&c.rec[wk[i].e]);
    while (n_active > 0) {
      for (int i = 0; i < W; ++i) {
        Walker& w = wk[i];
        if (!w.active) continue;
        const BenesRec& r = c.rec[w.e];
        int64_t arrive_key; int32_t s;
        if (w.side == 0) { arrive_key = 2 * (int64_t)r.v + 1; s = r.sv; }
        else             { arrive_key = 2 * (int64_t)r.u;     s = r.su; }
        int32_t st = -(c.seg[arrive_key]) - 1;
        Pipe& p = pp[i];
        p.ps = st + ((s - st) ^ 1);
        p.nside = (arrive_key & 1) ? 1 : 0;
        __builtin_prefetch(&c.adj[p.ps]);
      }
      for (int i = 0; i < W; ++i) {
        if (!wk[i].active) continue;
        pp[i].j = c.adj[pp[i].ps];
        __builtin_prefetch(&c.rec[pp[i].j]);
        __builtin_prefetch(&c.owner[pp[i].j]);
      }
      for (int i = 0; i < W; ++i) {
        Walker& w = wk[i];
        if (!w.active) continue;
        Pipe& p = pp[i];
        int64_t j = p.j;
        if (c.owner[j] < 0) {
          c.owner[j] = w.seg_id;
          c.bit[j] = (uint8_t)p.nside;
          w.e = j; w.side = p.nside;
        } else {
          BenesSeg& sg = segs[w.seg_id];
          sg.head_e = (int32_t)w.e;
          sg.head_x = (int32_t)j;
          if (!start_walker(w, i)) { --n_active; continue; }
          __builtin_prefetch(&c.rec[w.e]);
        }
      }
    }

    tw.stop();
    // ---- phase resolution: parity union-find over segments ----
    //   flip(s) ^ flip(owner(x)) = 1 ^ bit[e] ^ bit[x]
    BTimer tr(&bt_resolve);
    int32_t k = (int32_t)segs.size();
    std::vector<int32_t> parent(k);
    std::vector<uint8_t> rel(k, 0);  // parity to parent
    for (int32_t s = 0; s < k; ++s) parent[s] = s;
    std::vector<int32_t> path;
    auto find = [&](int32_t s, uint8_t& par) {
      uint8_t p = 0;
      path.clear();
      while (parent[s] != s) { path.push_back(s); s = parent[s]; }
      for (int64_t i = (int64_t)path.size() - 1; i >= 0; --i) {
        int32_t v = path[i];
        p ^= rel[v];
        parent[v] = s;  // full path compression
        rel[v] = p;
      }
      par = path.empty() ? 0 : rel[path[0]];
      return s;
    };
    auto unite = [&](int32_t a, int32_t b, uint8_t p) {
      uint8_t pa, pb;
      int32_t ra = find(a, pa), rb = find(b, pb);
      if (ra == rb) return;  // consistent by construction
      parent[ra] = rb;
      rel[ra] = (uint8_t)(pa ^ p ^ pb);
    };
    for (int32_t s = 0; s < k; ++s) {
      const BenesSeg& sg = segs[s];
      int32_t t = c.owner[sg.tail_x];
      if (t != s)
        unite(s, t,
              (uint8_t)((1 ^ c.bit[sg.tail_e] ^ c.bit[sg.tail_x]) & 1));
      if (sg.head_e >= 0) {
        t = c.owner[sg.head_x];
        if (t != s)
          unite(s, t,
                (uint8_t)((1 ^ c.bit[sg.head_e] ^ c.bit[sg.head_x]) & 1));
      }
    }
    std::vector<uint8_t> flip(k);
    for (int32_t s = 0; s < k; ++s) {
      uint8_t p;
      find(s, p);
      flip[s] = p;
    }
    for (int64_t i = 0; i < n; ++i) c.bit[i] ^= flip[c.owner[i]];
  }

  // reset touched keys + owners
  BTimer tb2(&bt_build);
  for (int64_t i = 0; i < n; ++i) {
    c.seg[2 * (int64_t)uu[i]] = 0;
    c.seg[2 * (int64_t)vv[i] + 1] = 0;
    c.owner[i] = -1;
  }
}

// orient + stable partition by bit; returns the size of the bit-0 half
static int64_t benes_split(BenesCtx& c, int32_t* uu, int32_t* vv,
                           int32_t* eid, int64_t n) {
  benes_orient(c, uu, vv, n);
  BTimer tp(&bt_part);
  int64_t j0 = 0, j1 = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (c.bit[i] == 0) {
      uu[j0] = uu[i]; vv[j0] = vv[i]; eid[j0] = eid[i]; ++j0;
    } else {
      c.su[j1] = uu[i]; c.sv[j1] = vv[i]; c.sid[j1] = eid[i]; ++j1;
    }
  }
  memcpy(uu + j0, c.su.data(), j1 * sizeof(int32_t));
  memcpy(vv + j0, c.sv.data(), j1 * sizeof(int32_t));
  memcpy(eid + j0, c.sid.data(), j1 * sizeof(int32_t));
  return j0;
}

static void benes_init_ctx(BenesCtx& c, int64_t nkeys, int64_t m,
                           uint8_t* color) {
  BTimer ti(&bt_init);
  c.seg.assign(nkeys, 0);
  c.fill.assign(nkeys, 0);
  c.adj.resize(2 * m);
  c.rec.resize(m);
  c.owner.assign(m, -1);
  c.bit.assign(m, 0);
  c.su.resize(m);
  c.sv.resize(m);
  c.sid.resize(m);
  c.color = color;
  // the walk's random-access arrays: huge-page them (see collapse_huge)
  collapse_huge(c.adj.data(), c.adj.size() * sizeof(int32_t));
  collapse_huge(c.rec.data(), c.rec.size() * sizeof(BenesRec));
  collapse_huge(c.owner.data(), c.owner.size() * sizeof(int32_t));
  collapse_huge(c.bit.data(), c.bit.size());
}

// colors assigned by bit path (level-0 split = MSB), matching the
// sequential DFS leaf order
static void benes_rec(BenesCtx& c, int32_t* uu, int32_t* vv, int32_t* eid,
                      int64_t n, int bits, int32_t base) {
  if (bits == 0) {
    BTimer tl(&bt_leaf);
    uint8_t col = (uint8_t)base;
    for (int64_t i = 0; i < n; ++i) c.color[eid[i]] = col;
    return;
  }
  int64_t n0 = benes_split(c, uu, vv, eid, n);
  benes_rec(c, uu, vv, eid, n0, bits - 1, base);
  benes_rec(c, uu + n0, vv + n0, eid + n0, n - n0, bits - 1,
            base + (1 << (bits - 1)));
}

// parallel top levels: after a split the halves are independent
// subproblems; each thread gets its own context (no shared state)
// reuse: an already-initialized context for repeated same-size calls
// (benes_stages runs one call per level; re-allocating + re-huge-paging
// the multi-GB context per level cost ~50s/level at 67M edges)
static void benes_par(int32_t* uu, int32_t* vv, int32_t* eid, int64_t n,
                      int bits, int32_t base, int64_t nkeys,
                      uint8_t* color, int depth,
                      BenesCtx* reuse = nullptr) {
  if (depth <= 0 || bits == 0 || n < (1 << 20)) {
    if (reuse != nullptr) {
      reuse->color = color;
      benes_rec(*reuse, uu, vv, eid, n, bits, base);
      return;
    }
    BenesCtx c;
    benes_init_ctx(c, nkeys, n, color);
    benes_rec(c, uu, vv, eid, n, bits, base);
    return;
  }
  int64_t n0;
  {
    BenesCtx c;
    benes_init_ctx(c, nkeys, n, color);
    n0 = benes_split(c, uu, vv, eid, n);
  }  // free the parent context before spawning children
  std::thread t(benes_par, uu, vv, eid, n0, bits - 1, base, nkeys, color,
                depth - 1, nullptr);
  benes_par(uu + n0, vv + n0, eid + n0, n - n0, bits - 1,
            base + (1 << (bits - 1)), nkeys, color, depth - 1, nullptr);
  t.join();
}

}  // namespace

extern "C" {

// Color the m edges (u[i], v[i]) of a 2^bits-regular bipartite
// multigraph with 2^bits colors, one per edge into color_out.
// Returns 0, or 1 on bad arguments.
int pgb_benes_color(const int32_t* u, const int32_t* v, int64_t m,
                    int64_t n_left, int64_t n_right, int bits,
                    uint8_t* color_out) {
  // m < 2^30: incidence offsets (2m) are int32 in BenesCtx
  if (bits < 0 || bits > 7 || m < 0 || m >= (1LL << 30)) return 1;
  int64_t nkeys = 2 * std::max(n_left, n_right) + 2;
  std::vector<int32_t> uu(u, u + m);
  std::vector<int32_t> vv(v, v + m);
  std::vector<int32_t> eid(m);
  for (int64_t i = 0; i < m; ++i) eid[i] = (int32_t)i;
  unsigned hc = std::thread::hardware_concurrency();
  int depth = hc >= 8 ? 3 : hc >= 4 ? 2 : hc >= 2 ? 1 : 0;
  benes_par(uu.data(), vv.data(), eid.data(), m, bits, 0, nkeys, color_out,
            depth);
  return 0;
}

// Full Benes plan assembly for the K == 128 embedding: per level, exact
// Euler-split coloring of the 128-regular bipartite subproblems plus the
// A/C stage tables, then the bottom sublane-select table.  buf holds
//   [A stages: D * R0*128 int8][C stages: D * R0*128 int8]
//   [ssel: 128^(D-1) * S * 128 int8, present iff S > 1]
// Returns 0, or 1 on bad arguments.
int pgb_benes_stages(const int64_t* src, int64_t n, int64_t D, int64_t S,
                     int64_t R0, int8_t* buf) {
  const int64_t Np = R0 * 128;
  // Np < 2^30: incidence offsets (2*Np) are int32 in BenesCtx
  if (n > Np || D < 1 || Np >= (1LL << 30)) return 1;
  int64_t nsub = 1;
  for (int d = 1; d < D; ++d) nsub *= 128;
  const int64_t ssel_sz = S > 1 ? nsub * S * 128 : 0;
  std::vector<int64_t> u(Np), v(Np), g(Np, 0);
  // K == 128 embedding is the identity; junk tail cells map to
  // themselves (any pairing of free cells keeps rows 128-regular)
  for (int64_t i = 0; i < n; ++i) u[i] = src[i];
  for (int64_t i = n; i < Np; ++i) u[i] = i;
  for (int64_t i = 0; i < Np; ++i) v[i] = i;
  std::vector<uint8_t> color(Np);
  std::vector<int32_t> uu(Np), vv(Np), eid(Np);
  // the color scatter (c.color[eid[i]]) and the stage-table writes
  // below are random over Np-sized buffers: huge-page them
  collapse_huge(color.data(), Np);
  memset(buf, 0, 2 * D * Np + ssel_sz);  // populate before collapse
  collapse_huge(buf, 2 * D * Np + ssel_sz);
  unsigned hc = std::thread::hardware_concurrency();
  int depth = hc >= 8 ? 3 : hc >= 4 ? 2 : hc >= 2 ? 1 : 0;
  BenesCtx shared_ctx;
  BenesCtx* reuse = nullptr;
  if (depth == 0) {
    benes_init_ctx(shared_ctx, 2 * R0 + 2, Np, nullptr);
    reuse = &shared_ctx;
  }
  bt_on = getenv("PYGB_BENES_PROF") != nullptr;
  bt_build = bt_walk = bt_resolve = bt_part = bt_outer = 0;
  int64_t rows = R0;
  for (int lvl = 0; lvl < D; ++lvl) {
    BTimer to(&bt_outer);
    for (int64_t i = 0; i < Np; ++i) {
      uu[i] = (int32_t)(g[i] * rows + (u[i] >> 7));
      vv[i] = (int32_t)(g[i] * rows + (v[i] >> 7));
      eid[i] = (int32_t)i;
    }
    to.stop();
    benes_par(uu.data(), vv.data(), eid.data(), Np, 7, 0, 2 * R0 + 2,
              color.data(), depth, reuse);
    BTimer to2(&bt_outer);
    int8_t* a = buf + (int64_t)lvl * Np;
    int8_t* c = buf + (int64_t)(D + lvl) * Np;
    for (int64_t r = 0; r < R0; ++r)
      for (int64_t j = 0; j < 128; ++j)
        a[r * 128 + j] = (int8_t)j;
    memcpy(c, a, Np);
    for (int64_t i = 0; i < Np; ++i) {
      int64_t col = color[i];
      int64_t nu = g[i] * rows + (u[i] >> 7);
      int64_t nv = g[i] * rows + (v[i] >> 7);
      a[nu * 128 + col] = (int8_t)(u[i] & 127);
      c[nv * 128 + (v[i] & 127)] = (int8_t)col;
      g[i] = g[i] * 128 + col;
      u[i] >>= 7;
      v[i] >>= 7;
    }
    rows /= 128;
    if (bt_on)
      fprintf(stderr,
              "[benes prof] lvl %d cum: build %.1f walk %.1f resolve "
              "%.1f part %.1f outer %.1f init %.1f leaf %.1f\n",
              lvl, bt_build, bt_walk, bt_resolve, bt_part, bt_outer,
              bt_init, bt_leaf);
  }
  if (S > 1) {
    int8_t* ss = buf + 2 * D * Np;
    memset(ss, 0, ssel_sz);
    for (int64_t i = 0; i < Np; ++i)
      ss[(g[i] >> 7) * S * 128 + v[i] * 128 + (g[i] & 127)] = (int8_t)u[i];
  }
  return 0;
}

}  // extern "C"
