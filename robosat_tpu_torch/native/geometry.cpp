// Slab-decomposition polygon boolean overlay — native engine.
//
// C++ port of robosat_tpu_torch/geo/clip.py's overlay (same snapping and slab
// semantics; the Python implementation doubles as the test oracle). This is
// the hot path of `rs merge` / `rs dedupe` over large feature collections
// (reference call sites: robosat/tools/merge.py:47-65, dedupe.py:53-63) —
// the role GEOS played for the reference.
//
// Exposed C ABI (ctypes):
//   rs_overlay_area(...)  -> double area of the boolean result
//   rs_overlay_edges(...) -> directed interior-left boundary edges
//   rs_free(ptr)
//
// Geometries arrive as flat coordinate arrays + ring lengths; op codes:
// 0=union, 1=intersection, 2=difference, 3=xor, 4=nunion (N-ary winding-rule
// union of operand a's rings — shells CCW, holes CW; covered where the
// winding number is positive; operand b must be empty).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Pt {
    double x, y;
    bool operator<(const Pt& o) const { return x < o.x || (x == o.x && y < o.y); }
    bool operator==(const Pt& o) const { return x == o.x && y == o.y; }
};

struct PtHash {
    size_t operator()(const Pt& p) const {
        uint64_t a, b;
        static_assert(sizeof(double) == 8, "");
        std::memcpy(&a, &p.x, 8);
        std::memcpy(&b, &p.y, 8);
        return std::hash<uint64_t>()(a * 1000003ull ^ b);
    }
};

struct Seg {
    Pt p, q;
    int pa, pb;  // even-odd parity toggles per input tag
};

double snap(double v, double q) { return std::round(v / q) * q; }

// Split points where segment b cuts segment a (and vice versa); mirrors
// _seg_split_points in clip.py.
void seg_split_points(const Pt& a1, const Pt& a2, const Pt& b1, const Pt& b2,
                      std::vector<Pt>& on_a, std::vector<Pt>& on_b) {
    double ax = a2.x - a1.x, ay = a2.y - a1.y;
    double bx = b2.x - b1.x, by = b2.y - b1.y;
    double denom = ax * by - ay * bx;

    if (denom != 0.0) {
        // Parameter-range tests in cross-product form (u = t*denom,
        // v = s*denom): the common rejected pair pays no division. Mirrors
        // clip.py _seg_split_points bit for bit (same multiply-form
        // comparisons decide acceptance).
        double cx = b1.x - a1.x, cy = b1.y - a1.y;
        double u = cx * by - cy * bx;
        if (denom > 0.0) {
            if (u < -1e-12 * denom || u > (1.0 + 1e-12) * denom) return;
            double v = cx * ay - cy * ax;
            if (v < -1e-12 * denom || v > (1.0 + 1e-12) * denom) return;
        } else {
            if (u > -1e-12 * denom || u < (1.0 + 1e-12) * denom) return;
            double v = cx * ay - cy * ax;
            if (v > -1e-12 * denom || v < (1.0 + 1e-12) * denom) return;
        }
        double t = u / denom;
        Pt p{a1.x + t * ax, a1.y + t * ay};
        on_a.push_back(p);
        on_b.push_back(p);
        return;
    }
    // Parallel: collinear only if b1 lies on a's line.
    if ((b1.x - a1.x) * ay - (b1.y - a1.y) * ax != 0.0) return;
    on_a.push_back(b1);
    on_a.push_back(b2);
    on_b.push_back(a1);
    on_b.push_back(a2);
}

// Parameter of p along [s1, s2] via the dominant axis; <0 when outside (0,1).
double param_on(const Pt& p, const Pt& s1, const Pt& s2) {
    double dx = s2.x - s1.x, dy = s2.y - s1.y;
    double t;
    if (std::fabs(dx) >= std::fabs(dy)) {
        if (dx == 0.0) return -1.0;
        t = (p.x - s1.x) / dx;
    } else {
        t = (p.y - s1.y) / dy;
    }
    return (t > 0.0 && t < 1.0) ? t : -1.0;
}

// Parameter of p along [s1, s2] when p lies within q of the segment; <0
// otherwise. Snap-rounding T-junction weld (mirrors _param_near_segment).
double param_near(const Pt& p, const Pt& s1, const Pt& s2, double q) {
    double dx = s2.x - s1.x, dy = s2.y - s1.y;
    double len2 = dx * dx + dy * dy;
    if (len2 == 0.0) return -1.0;
    double cross = dx * (p.y - s1.y) - dy * (p.x - s1.x);
    if (cross * cross > q * q * len2) return -1.0;
    return param_on(p, s1, s2);
}

bool pred(int op, bool a, bool b) {
    switch (op) {
        case 0: return a || b;
        case 1: return a && b;
        case 2: return a && !b;
        default: return a != b;
    }
}

struct Overlay {
    double area = 0.0;
    double area2 = 0.0;         // op 6 (iou): union area alongside intersection
    double q = 0.0;             // snap quantum used
    double sx = 0.0, sy = 0.0;  // local-origin shift: edges are in the
                                // shifted frame; add (sx, sy) to restore
    std::vector<double> edges;  // x1,y1,x2,y2 per directed edge
};

Overlay run_overlay(const double* coords_a, const int32_t* rings_a, int n_rings_a,
                    const double* coords_b, const int32_t* rings_b, int n_rings_b,
                    int op, bool want_edges) {
    Overlay result;

    // Overlay frame — snap quantum + local-origin shift (mirrors
    // _overlay_frame in clip.py bit-for-bit; see its docstring for why the
    // quantum must scale with the EXTENT, not the coordinate magnitude).
    double lox = INFINITY, hix = -INFINITY, loy = INFINITY, hiy = -INFINITY;
    auto scan = [&](const double* c, const int32_t* r, int n) {
        int64_t total = 0;
        for (int i = 0; i < n; i++) total += r[i];
        for (int64_t i = 0; i < total; i++) {
            lox = std::min(lox, c[2 * i]);
            hix = std::max(hix, c[2 * i]);
            loy = std::min(loy, c[2 * i + 1]);
            hiy = std::max(hiy, c[2 * i + 1]);
        }
    };
    if (n_rings_a) scan(coords_a, rings_a, n_rings_a);
    if (n_rings_b) scan(coords_b, rings_b, n_rings_b);
    if (!std::isfinite(lox)) return result;
    double extent = std::max(std::max(hix - lox, hiy - loy), 1e-30);
    double q = extent * 1e-10;
    result.q = q;
    double sx = (lox + hix) / 2, sy = (loy + hiy) / 2;
    result.sx = sx;
    result.sy = sy;

    // Snapped segments with per-tag parity, translated to the local frame.
    std::vector<Seg> segs;
    auto add_rings = [&](const double* c, const int32_t* r, int n, int tag) {
        int64_t off = 0;
        for (int ri = 0; ri < n; ri++) {
            int len = r[ri];
            if (len >= 3) {
                std::vector<Pt> snapped(len);
                for (int i = 0; i < len; i++)
                    snapped[i] = Pt{snap(c[2 * (off + i)] - sx, q), snap(c[2 * (off + i) + 1] - sy, q)};
                for (int i = 0; i < len; i++) {
                    Pt p1 = snapped[i], p2 = snapped[(i + 1) % len];
                    if (!(p1 == p2)) segs.push_back(Seg{p1, p2, tag == 0, tag == 1});
                }
            }
            off += len;
        }
    };
    add_rings(coords_a, rings_a, n_rings_a, 0);
    add_rings(coords_b, rings_b, n_rings_b, 1);
    if (segs.empty()) return result;

    // Pairwise splitting with an x-sorted sweep prefilter. Split points
    // collect into flat vectors (sorted + deduped at rebuild) — the former
    // per-segment std::set cost one allocation per insertion, which
    // dominated small overlays (the per-feature buffer unions of rs merge).
    size_t n = segs.size();
    // Flat split-record list (seg, t, point), sorted once — the former
    // per-segment vectors cost one heap allocation per split-carrying
    // segment on every overlay.
    struct SplitRec {
        uint32_t seg;
        double t;
        Pt p;
    };
    std::vector<SplitRec> splits;
    struct Box { double x0, y0, x1, y1; };
    std::vector<Box> boxes(n);
    for (size_t i = 0; i < n; i++) {
        // Inflated by q so near-miss T-junctions pass the prefilter.
        boxes[i] = Box{std::min(segs[i].p.x, segs[i].q.x) - q, std::min(segs[i].p.y, segs[i].q.y) - q,
                       std::max(segs[i].p.x, segs[i].q.x) + q, std::max(segs[i].p.y, segs[i].q.y) + q};
    }
    // Sort (x0, idx) pairs directly — the indirect comparator through
    // `boxes` cost more cache misses than the whole pair sort.
    std::vector<std::pair<double, uint32_t>> xorder(n);
    for (size_t i = 0; i < n; i++) xorder[i] = {boxes[i].x0, (uint32_t)i};
    std::sort(xorder.begin(), xorder.end());
    std::vector<size_t> order(n);
    for (size_t i = 0; i < n; i++) order[i] = xorder[i].second;

    std::vector<Pt> on_a, on_b;
    for (size_t oi = 0; oi < n; oi++) {
        size_t i = order[oi];
        const Box& bi = boxes[i];
        for (size_t oj = oi + 1; oj < n; oj++) {
            size_t j = order[oj];
            const Box& bj = boxes[j];
            if (bj.x0 > bi.x1) break;
            if (bj.x1 < bi.x0 || bj.y0 > bi.y1 || bj.y1 < bi.y0) continue;
            on_a.clear();
            on_b.clear();
            seg_split_points(segs[i].p, segs[i].q, segs[j].p, segs[j].q, on_a, on_b);
            for (const Pt& p : on_a) {
                Pt sp{snap(p.x, q), snap(p.y, q)};
                double t = param_on(sp, segs[i].p, segs[i].q);
                if (t > 0.0) splits.push_back({(uint32_t)i, t, sp});
            }
            for (const Pt& p : on_b) {
                Pt sp{snap(p.x, q), snap(p.y, q)};
                double t = param_on(sp, segs[j].p, segs[j].q);
                if (t > 0.0) splits.push_back({(uint32_t)j, t, sp});
            }
            // Weld endpoints onto segments passing within the snap quantum.
            for (const Pt& v : {segs[j].p, segs[j].q}) {
                double t = param_near(v, segs[i].p, segs[i].q, q);
                if (t > 0.0) splits.push_back({(uint32_t)i, t, v});
            }
            for (const Pt& v : {segs[i].p, segs[i].q}) {
                double t = param_near(v, segs[j].p, segs[j].q, q);
                if (t > 0.0) splits.push_back({(uint32_t)j, t, v});
            }
        }
    }

    // Rebuild split segments, merging coincident ones with parity XOR.
    struct KeyHash {
        size_t operator()(const std::pair<Pt, Pt>& k) const {
            PtHash h;
            return h(k.first) * 31 ^ h(k.second);
        }
    };
    struct KeyEq {
        bool operator()(const std::pair<Pt, Pt>& a, const std::pair<Pt, Pt>& b) const {
            return a.first == b.first && a.second == b.second;
        }
    };
    std::unordered_map<std::pair<Pt, Pt>, std::pair<int, int>, KeyHash, KeyEq> merged;
    merged.reserve(n + splits.size());
    bool winding = (op == 4);
    bool erode_in = (op == 7);       // base even-odd AND curve winding > 0
    bool iou_wind = (op == 8);       // iou of even-odd a vs winding union of b
    bool erode_mode = (op == 5) || erode_in || iou_wind;  // same parity builder
    bool iou_mode = (op == 6);  // accumulate intersection AND union areas
    std::sort(splits.begin(), splits.end(), [](const SplitRec& a, const SplitRec& b) {
        return a.seg < b.seg || (a.seg == b.seg && (a.t < b.t || (a.t == b.t && a.p < b.p)));
    });
    size_t sp_ptr = 0;
    for (size_t i = 0; i < n; i++) {
        Pt prev = segs[i].p;
        auto flush = [&](const Pt& a, const Pt& b) {
            if (a == b) return;
            auto key = (a < b) ? std::make_pair(a, b) : std::make_pair(b, a);
            auto& par = merged[key];
            if (winding) {
                // Signed winding weight relative to the canonical key order
                // (mirrors _canonical_segments_signed in clip.py).
                par.first += (a < b) ? 1 : -1;
            } else if (erode_mode) {
                // Base (tag a): even-odd parity; halo (tag b): signed winding
                // (mirrors _canonical_segments_erode in clip.py).
                if (segs[i].pa) par.first ^= 1;
                else par.second += (a < b) ? 1 : -1;
            } else {
                par.first ^= segs[i].pa;
                par.second ^= segs[i].pb;
            }
        };
        double last_t = -1.0;
        Pt last_p{0.0, 0.0};
        bool have_last = false;
        for (; sp_ptr < splits.size() && splits[sp_ptr].seg == i; sp_ptr++) {
            const SplitRec& r = splits[sp_ptr];
            if (have_last && r.t == last_t && r.p == last_p) continue;  // dedupe
            flush(prev, r.p);
            prev = r.p;
            last_t = r.t;
            last_p = r.p;
            have_last = true;
        }
        flush(prev, segs[i].q);
    }

    struct Span {
        Pt lo, hi;
        double m;  // precomputed slope dy/dx — the per-slab interpolations
                   // were three divisions per span-slab, the sweep's top cost
        int pa, pb;
    };
    std::vector<Span> spans;
    std::vector<double> xs_v;
    for (const auto& [key, par] : merged) {
        if (!par.first && !par.second) continue;
        xs_v.push_back(key.first.x);
        xs_v.push_back(key.second.x);
        if (key.first.x != key.second.x) {
            Span s;
            if (key.first.x < key.second.x) { s.lo = key.first; s.hi = key.second; }
            else { s.lo = key.second; s.hi = key.first; }
            s.m = (s.hi.y - s.lo.y) / (s.hi.x - s.lo.x);
            s.pa = par.first;
            s.pb = par.second;
            spans.push_back(s);
        }
    }
    std::sort(xs_v.begin(), xs_v.end());
    xs_v.erase(std::unique(xs_v.begin(), xs_v.end()), xs_v.end());

    // Slab sweep with an active list: spans sorted by entry x are admitted
    // once and compacted out once their right end falls behind the slab.
    struct Active { double ym, y0, y1; int pa, pb; uint32_t src; };
    std::vector<Active> active;
    std::vector<char> covered_gap;
    // Vertical boundary pieces collect into a flat vector (x, ylo, yhi,
    // sign) and group by x after the sweep — the former std::map<double,
    // vector> cost a red-black insert per piece (~3.5M per 10k merge).
    std::vector<std::array<double, 4>> vertical;

    // Boundary-run coalescing: a covered gap whose bottom (or top) rides the
    // SAME span across consecutive slabs with contiguous snapped endpoints
    // emits ONE edge for the whole run instead of one per slab. Runs break
    // exactly where the trapezoid structure changes — which is also where
    // the netted vertical boundary pieces attach — so the welded topology is
    // preserved while the edge soup shrinks by the average slab count per
    // boundary span (~20x on city-scale merges; see docs/PERF.md round 3).
    // Open runs live in per-span slots (a span has at most one open run per
    // side) — the former unordered_map<Span*, Run> hashed ~9M lookups.
    struct Run { double x0, y0, x1, y1; };
    std::vector<Run> run_slot[2];
    std::vector<char> run_open[2];
    for (int side = 0; side < 2; side++) {
        run_slot[side].resize(spans.size());
        run_open[side].assign(spans.size(), 0);
    }
    auto flush_run = [&](int side, uint32_t key, double nx0, double ny0, double nx1, double ny1) {
        Run& r = run_slot[side][key];
        if (run_open[side][key]) {
            if (r.x1 == nx0 && r.y1 == ny0) {  // contiguous: extend
                r.x1 = nx1;
                r.y1 = ny1;
                return;
            }
            if (side) result.edges.insert(result.edges.end(), {r.x1, r.y1, r.x0, r.y0});
            else result.edges.insert(result.edges.end(), {r.x0, r.y0, r.x1, r.y1});
        }
        run_open[side][key] = 1;
        r = Run{nx0, ny0, nx1, ny1};
    };
    auto flush_all = [&]() {
        for (size_t i = 0; i < spans.size(); i++) {
            if (run_open[0][i]) {
                const Run& r = run_slot[0][i];
                result.edges.insert(result.edges.end(), {r.x0, r.y0, r.x1, r.y1});
            }
            if (run_open[1][i]) {
                const Run& r = run_slot[1][i];
                result.edges.insert(result.edges.end(), {r.x1, r.y1, r.x0, r.y0});
            }
        }
    };

    // Sort span INDICES by entry x (spans themselves stay put so the run
    // slots above stay index-stable). (key, idx) pairs sort directly — the
    // indirect comparator through `spans` cost more cache misses than the
    // whole pair sort (same finding as the segment-box sort above).
    std::vector<std::pair<double, uint32_t>> sp_order(spans.size());
    for (size_t i = 0; i < spans.size(); i++) sp_order[i] = {spans[i].lo.x, (uint32_t)i};
    std::sort(sp_order.begin(), sp_order.end());
    std::vector<uint32_t> order_sp(spans.size());
    for (size_t i = 0; i < spans.size(); i++) order_sp[i] = sp_order[i].second;
    size_t ptr = 0;
    // Incrementally maintained active order: after splitting, no two spans
    // cross strictly inside a slab, so the ym-order is invariant while both
    // stay active — the per-slab sort becomes a stable compaction of
    // leavers plus an ordered insertion per ENTERING span (binary search on
    // ym at the entry slab). This was the dominant cost of city-scale
    // erodes (one ~30-element sort per slab, ~2k slabs per call).
    std::vector<uint32_t> current;
    auto ym_at = [&](const Span& s, double xm) {
        return s.lo.y + (xm - s.lo.x) * s.m;
    };
    for (size_t k = 0; k + 1 < xs_v.size(); k++) {
        double x0 = xs_v[k], x1 = xs_v[k + 1];
        if (x1 <= x0) continue;
        // A span ending before x1 never spans a later slab either.
        size_t w = 0;
        for (size_t r = 0; r < current.size(); r++)
            if (spans[current[r]].hi.x >= x1) current[w++] = current[r];
        current.resize(w);
        double xm = 0.5 * (x0 + x1);
        while (ptr < order_sp.size() && spans[order_sp[ptr]].lo.x <= x0) {
            uint32_t si = order_sp[ptr++];
            const Span* s = &spans[si];
            if (s->hi.x < x1) continue;
            double y = ym_at(*s, xm);
            size_t lo = 0, hi = current.size();
            while (lo < hi) {
                size_t mid = (lo + hi) / 2;
                if (ym_at(spans[current[mid]], xm) < y) lo = mid + 1;
                else hi = mid;
            }
            current.insert(current.begin() + lo, si);
        }

        active.clear();
        for (uint32_t si : current) {
            const Span& s = spans[si];
            Active a;
            a.ym = s.lo.y + (xm - s.lo.x) * s.m;
            a.y0 = s.lo.y + (x0 - s.lo.x) * s.m;
            a.y1 = s.lo.y + (x1 - s.lo.x) * s.m;
            a.pa = s.pa;
            a.pb = s.pb;
            a.src = si;
            active.push_back(a);
        }
        if (active.empty()) continue;
        // Rounding can nudge neighbors out of order at slab scale; a single
        // adjacency-repair pass (insertion sort on an almost-sorted list)
        // keeps the walk identical to a full sort at ~O(n).
        for (size_t i = 1; i < active.size(); i++) {
            if (active[i].ym < active[i - 1].ym) {
                Active tmp = active[i];
                uint32_t tsp = current[i];
                size_t j = i;
                while (j > 0 && active[j - 1].ym > tmp.ym) {
                    active[j] = active[j - 1];
                    current[j] = current[j - 1];
                    j--;
                }
                active[j] = tmp;
                current[j] = tsp;
            }
        }

        bool in_a = false, in_b = false;
        int wind = 0;
        covered_gap.assign(active.size(), 0);  // covered_gap[i]: gap above active[i]
        for (size_t idx = 0; idx + 1 < active.size(); idx++) {
            const Active& cur = active[idx];
            bool covered;
            if (winding) {
                wind += cur.pa;
                covered = wind > 0;
            } else if (iou_wind) {
                // Intersection AND union areas of (even-odd a) vs (winding
                // union of b's rings) in one sweep — the rs dedupe hot path
                // without materializing union(overlapping OSM shapes)
                // (robosat/tools/dedupe.py:49's iou-vs-union).
                if (cur.pa) in_a = !in_a;
                wind += cur.pb;
                bool b_in = wind > 0;
                if (in_a || b_in) {
                    const Active& nx = active[idx + 1];
                    double trap = (x1 - x0) * (nx.ym - cur.ym);
                    result.area2 += trap;
                    if (in_a && b_in) result.area += trap;
                }
                continue;
            } else if (erode_mode) {
                if (cur.pa) in_a = !in_a;
                wind += cur.pb;
                // op 5: base minus halo pieces (winding == 0); op 7: base
                // AND inward raw offset curves wind positively (the base
                // test clamps snapped curve wobble within the polygon —
                // mirrors clip.py's erode_in sweep branch).
                covered = in_a && (erode_in ? wind > 0 : wind == 0);
            } else if (iou_mode) {
                if (cur.pa) in_a = !in_a;
                if (cur.pb) in_b = !in_b;
                if (in_a || in_b) {
                    const Active& nx = active[idx + 1];
                    double trap = (x1 - x0) * (nx.ym - cur.ym);
                    result.area2 += trap;
                    if (in_a && in_b) result.area += trap;
                }
                continue;
            } else {
                if (cur.pa) in_a = !in_a;
                if (cur.pb) in_b = !in_b;
                covered = pred(op, in_a, in_b);
            }
            if (!covered) continue;
            covered_gap[idx] = 1;
            const Active& nxt = active[idx + 1];
            result.area += (x1 - x0) * (nxt.ym - cur.ym);
            if (want_edges) {
                double by1 = snap(cur.y1, q);
                double ty0 = snap(nxt.y0, q), ty1 = snap(nxt.y1, q);
                double by0 = snap(cur.y0, q);
                if (ty1 > by1) vertical.push_back({x1, by1, ty1, +1.0});
                if (ty0 > by0) vertical.push_back({x0, by0, ty0, -1.0});
            }
        }
        if (want_edges) {
            // Directed boundary edges where coverage CHANGES across a span
            // (interior spans — covered on both sides — cancel here rather
            // than in the later net pass, so coalesced runs on the two
            // sides can never partially overlap).
            for (size_t idx = 0; idx < active.size(); idx++) {
                bool above = covered_gap[idx];
                bool below = idx > 0 && covered_gap[idx - 1];
                if (above == below) continue;
                const Active& a = active[idx];
                double y0 = snap(a.y0, q), y1 = snap(a.y1, q);
                if (above) flush_run(0, a.src, x0, y0, x1, y1);  // L->R
                else flush_run(1, a.src, x0, y0, x1, y1);        // R->L
            }
        }
    }

    if (!want_edges) return result;
    flush_all();

    // Cancel opposite horizontal-ish edges.
    std::unordered_map<std::pair<Pt, Pt>, int, KeyHash, KeyEq> net;
    std::vector<double> kept;
    for (size_t i = 0; i + 3 < result.edges.size(); i += 4) {
        Pt p1{result.edges[i], result.edges[i + 1]}, p2{result.edges[i + 2], result.edges[i + 3]};
        if (p1 == p2) continue;
        if (p1 < p2) net[{p1, p2}] += 1;
        else net[{p2, p1}] -= 1;
    }
    for (const auto& [key, count] : net) {
        for (int c = 0; c < std::abs(count); c++) {
            if (count > 0) kept.insert(kept.end(), {key.first.x, key.first.y, key.second.x, key.second.y});
            else kept.insert(kept.end(), {key.second.x, key.second.y, key.first.x, key.first.y});
        }
    }

    // Net vertical boundary intervals per x (flat vector grouped by x).
    std::sort(vertical.begin(), vertical.end(),
              [](const std::array<double, 4>& a, const std::array<double, 4>& b) { return a[0] < b[0]; });
    std::vector<double> breaks;
    for (size_t g = 0; g < vertical.size();) {
        size_t g_end = g;
        double x = vertical[g][0];
        while (g_end < vertical.size() && vertical[g_end][0] == x) g_end++;
        breaks.clear();
        for (size_t i = g; i < g_end; i++) {
            breaks.push_back(vertical[i][1]);
            breaks.push_back(vertical[i][2]);
        }
        std::sort(breaks.begin(), breaks.end());
        breaks.erase(std::unique(breaks.begin(), breaks.end()), breaks.end());
        for (size_t i = 0; i + 1 < breaks.size(); i++) {
            double lo_y = breaks[i], hi_y = breaks[i + 1];
            double mid = 0.5 * (lo_y + hi_y);
            int cover = 0;
            for (size_t j = g; j < g_end; j++)
                if (vertical[j][1] < mid && mid < vertical[j][2]) cover += (int)vertical[j][3];
            if (cover > 0) kept.insert(kept.end(), {x, lo_y, x, hi_y});
            else if (cover < 0) kept.insert(kept.end(), {x, hi_y, x, lo_y});
        }
        g = g_end;
    }

    result.edges = std::move(kept);
    return result;
}

// ---- Vertex welding + ring linking (ports of clip.py's _weld_edges and
// _link_rings; keeps the expensive per-junction work out of Python). ----

struct CellKey {
    long long x, y;
    bool operator==(const CellKey& o) const { return x == o.x && y == o.y; }
};
struct CellHash {
    size_t operator()(const CellKey& k) const {
        return std::hash<long long>()(k.x * 1000003ll ^ k.y);
    }
};

struct LinkedRings {
    std::vector<double> coords;  // x,y flattened over all rings
    std::vector<int32_t> lens;   // vertices per ring
};

// Non-compounding collinear simplification (port of _simplify_collinear):
// drop a vertex only while it stays within 2q of the chord from the last
// KEPT vertex to its successor, so drift from the true boundary stays O(q).
std::vector<Pt> simplify_collinear(const std::vector<Pt>& ring, double q) {
    if (ring.size() < 3) return {};
    double tol = 2.0 * q;
    auto within = [&](const Pt& a, const Pt& b, const Pt& c) {
        double acx = c.x - a.x, acy = c.y - a.y;
        double chord = std::hypot(acx, acy);
        if (chord == 0.0) return true;  // spike a -> b -> a
        double cross = (b.x - a.x) * acy - (b.y - a.y) * acx;
        return std::fabs(cross) / chord <= tol;
    };
    size_t n = ring.size();
    std::vector<Pt> kept;
    kept.push_back(ring[0]);
    for (size_t i = 1; i < n; i++) {
        if (!within(kept.back(), ring[i], ring[(i + 1) % n])) kept.push_back(ring[i]);
    }
    for (int pass = 0; pass < 2; pass++) {
        if (kept.size() >= 3 && within(kept.back(), kept[0], kept[1])) kept.erase(kept.begin());
        if (kept.size() >= 3 && within(kept[kept.size() - 2], kept.back(), kept[0])) kept.pop_back();
    }
    if (kept.size() < 3) kept.clear();
    return kept;
}

LinkedRings link_rings(const std::vector<double>& edge_soup, double q) {
    // Integer-grid weld + link. Every input coordinate is snap-rounded to a
    // multiple of q by the overlay, so endpoints convert EXACTLY to int64
    // grid indices k = llround(v / q); the weld tolerance 1.5q then becomes
    // "L-inf grid distance <= 1", and the whole weld runs as 9-neighbor
    // lookups in one flat integer hash map — measured ~4x faster than the
    // former double-keyed bucket grid, which dominated large erodes
    // (gprof: 60% of rs merge's erode calls in CellKey/Pt hashing).
    LinkedRings out;
    if (q <= 0.0) return out;

    struct IKey {
        long long x, y;
        bool operator==(const IKey& o) const { return x == o.x && y == o.y; }
    };
    struct IKeyHash {
        size_t operator()(const IKey& k) const {
            uint64_t h = (uint64_t)k.x * 0x9E3779B97F4A7C15ull;
            h ^= (uint64_t)k.y + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
            h ^= h >> 29; h *= 0xBF58476D1CE4E5B9ull; h ^= h >> 32;
            return (size_t)h;
        }
    };

    // Flat open-addressing map (linear probing) for the weld grid: the
    // 9-neighbor candidate scan is mostly FAILED lookups, which cost ~2
    // contiguous probes here vs a bucket-chain walk in unordered_map.
    struct FlatCells {
        struct Slot { long long x, y; IKey rep; };
        std::vector<Slot> slots;
        size_t mask = 0, count = 0;
        static uint64_t mix(long long x, long long y) {
            uint64_t h = (uint64_t)x * 0x9E3779B97F4A7C15ull;
            h ^= (uint64_t)y + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
            h ^= h >> 29; h *= 0xBF58476D1CE4E5B9ull; h ^= h >> 32;
            return h;
        }
        void init(size_t expect) {
            size_t cap = 16;
            while (cap < expect * 2) cap <<= 1;
            slots.assign(cap, Slot{INT64_MIN, INT64_MIN, IKey{0, 0}});
            mask = cap - 1;
            count = 0;
        }
        IKey* find(long long x, long long y) {
            size_t i = mix(x, y) & mask;
            while (slots[i].x != INT64_MIN) {
                if (slots[i].x == x && slots[i].y == y) return &slots[i].rep;
                i = (i + 1) & mask;
            }
            return nullptr;
        }
        void insert(long long x, long long y, IKey rep) {
            if ((count + 1) * 10 >= slots.size() * 7) {  // grow at 0.7 load
                std::vector<Slot> old = std::move(slots);
                init(old.size());
                count = 0;
                for (const Slot& s : old)
                    if (s.x != INT64_MIN) insert(s.x, s.y, s.rep);
            }
            size_t i = mix(x, y) & mask;
            while (slots[i].x != INT64_MIN) {
                if (slots[i].x == x && slots[i].y == y) { slots[i].rep = rep; return; }
                i = (i + 1) & mask;
            }
            slots[i] = Slot{x, y, rep};
            count++;
        }
    };
    FlatCells claimed;
    claimed.init(edge_soup.size() / 2 + 16);
    auto rep_for = [&](long long kx, long long ky) -> IKey {
        if (IKey* hit = claimed.find(kx, ky)) return *hit;
        for (long long dx = -1; dx <= 1; dx++) {
            for (long long dy = -1; dy <= 1; dy++) {
                if (dx == 0 && dy == 0) continue;
                if (IKey* n = claimed.find(kx + dx, ky + dy)) {
                    IKey rep = *n;
                    claimed.insert(kx, ky, rep);
                    return rep;
                }
            }
        }
        claimed.insert(kx, ky, IKey{kx, ky});
        return IKey{kx, ky};
    };

    struct EdgeKey {
        IKey a, b;
        bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
    };
    struct EdgeKeyHash {
        size_t operator()(const EdgeKey& k) const {
            IKeyHash h;
            return h(k.a) * 31 ^ h(k.b);
        }
    };
    auto iless = [](const IKey& a, const IKey& b) {
        return a.x < b.x || (a.x == b.x && a.y < b.y);
    };

    std::unordered_map<EdgeKey, int, EdgeKeyHash> net;
    net.reserve(edge_soup.size() / 4);
    for (size_t i = 0; i + 3 < edge_soup.size(); i += 4) {
        IKey r1 = rep_for((long long)std::llround(edge_soup[i] / q), (long long)std::llround(edge_soup[i + 1] / q));
        IKey r2 = rep_for((long long)std::llround(edge_soup[i + 2] / q), (long long)std::llround(edge_soup[i + 3] / q));
        if (r1 == r2) continue;
        if (iless(r1, r2)) net[EdgeKey{r1, r2}] += 1;
        else net[EdgeKey{r2, r1}] -= 1;
    }
    std::vector<std::pair<IKey, IKey>> directed;
    directed.reserve(net.size());
    for (const auto& [key, count] : net) {
        for (int c = 0; c < std::abs(count); c++) {
            if (count > 0) directed.push_back({key.a, key.b});
            else directed.push_back({key.b, key.a});
        }
    }

    // Link into rings: follow the sharpest-left-turn (min CCW angle) rule at
    // every junction (port of _link_rings).
    std::unordered_map<IKey, std::vector<size_t>, IKeyHash> out_edges;
    out_edges.reserve(directed.size());
    for (size_t i = 0; i < directed.size(); i++) out_edges[directed[i].first].push_back(i);
    std::vector<char> used(directed.size(), 0);

    for (size_t start = 0; start < directed.size(); start++) {
        if (used[start]) continue;
        std::vector<IKey> iring;
        size_t edge = start;
        bool closed = false;
        for (size_t step = 0; step <= directed.size(); step++) {
            used[edge] = 1;
            iring.push_back(directed[edge].first);
            IKey v = directed[edge].second;
            if (v == directed[start].first) {
                closed = true;
                break;
            }
            auto it = out_edges.find(v);
            if (it == out_edges.end()) break;
            double base = std::atan2((double)(v.y - directed[edge].first.y),
                                     (double)(v.x - directed[edge].first.x));
            double best = 1e30;
            size_t best_edge = SIZE_MAX;
            for (size_t cand : it->second) {
                if (used[cand]) continue;
                double a = std::atan2((double)(directed[cand].second.y - v.y),
                                      (double)(directed[cand].second.x - v.x)) - base;
                while (a <= 0) a += 2 * M_PI;
                while (a > 2 * M_PI) a -= 2 * M_PI;
                if (a < best) {
                    best = a;
                    best_edge = cand;
                }
            }
            if (best_edge == SIZE_MAX) break;
            edge = best_edge;
        }
        if (closed && iring.size() >= 3) {
            std::vector<Pt> ring(iring.size());
            for (size_t i = 0; i < iring.size(); i++) ring[i] = Pt{iring[i].x * q, iring[i].y * q};
            std::vector<Pt> slim = simplify_collinear(ring, q);
            if (slim.size() < 3) continue;
            out.lens.push_back((int32_t)slim.size());
            for (const Pt& p : slim) {
                out.coords.push_back(p.x);
                out.coords.push_back(p.y);
            }
        }
    }
    return out;
}


// ---------------------------------------------------------------------------
// Native Minkowski buffering (port of robosat_tpu_torch/geo/buffer.py)
//
// Piece generation (edge quads + vertex wedges + endpoint discs) + the
// boolean overlay + ring linking in ONE native call: the Python pieces path
// built ~100 small numpy rings per feature and crossed ctypes once per
// overlay, which dominated `rs merge` wall time (docs/PERF.md round 3).
// ---------------------------------------------------------------------------

double ring_signed_area(const std::vector<Pt>& r) {
    // Centered on the first vertex: raw shoelace products at projected-CRS
    // magnitudes (~1.4e7 m) carry ~0.008 m^2 of rounding EACH and a long
    // ring drifts ~1 m^2 (mirrors geo/geometry.py ring_area). Caveat kept
    // deliberately: the SUMMATION ORDER here is sequential while numpy's
    // ring_area dots through BLAS (blocked/pairwise), so EXACT-ZERO
    // classification of adversarially degenerate slivers can differ between
    // the engines by one rounding step; area VALUES agree to ~1e-9 relative
    // and no geometry this pipeline produces sits on that knife edge.
    double a = 0.0;
    const Pt& o = r[0];
    for (size_t i = 0; i < r.size(); i++) {
        const Pt& p = r[i];
        const Pt& q2 = r[(i + 1) % r.size()];
        a += (p.x - o.x) * (q2.y - o.y) - (q2.x - o.x) * (p.y - o.y);
    }
    return 0.5 * a;
}

struct RingSink {
    std::vector<double> coords;
    std::vector<int32_t> lens;
    void add_ccw(std::vector<Pt>&& ring) {
        if (ring.size() < 3) return;
        if (ring_signed_area(ring) < 0.0) std::reverse(ring.begin(), ring.end());
        lens.push_back((int32_t)ring.size());
        for (const Pt& p : ring) {
            coords.push_back(p.x);
            coords.push_back(p.y);
        }
    }
    void add_raw(const double* c, int len) {
        lens.push_back((int32_t)len);
        coords.insert(coords.end(), c, c + 2 * (size_t)len);
    }
};

void add_disc(const Pt& c, double r, int quad_segs, RingSink& out) {
    int n = std::max(4 * quad_segs, 4);
    std::vector<Pt> ring(n);
    for (int k = 0; k < n; k++) {
        double a = k * (2.0 * M_PI / n);
        ring[k] = Pt{c.x + r * std::cos(a), c.y + r * std::sin(a)};
    }
    out.add_ccw(std::move(ring));
}

// Port of buffer.py's _path_pieces scalar branch (the vectorized branch is
// numerically identical): edge quads, per-vertex uncovered wedges, discs at
// open-path endpoints and degenerate-neighbor vertices.
void path_pieces(const Pt* pts, int n, bool closed, double r, int quad_segs, RingSink& out) {
    int last = closed ? n : n - 1;
    if (last <= 0) {
        add_disc(pts[0], r, quad_segs, out);
        return;
    }
    std::vector<Pt> dirs(last);
    std::vector<char> ok(last, 0);
    for (int i = 0; i < last; i++) {
        const Pt& p1 = pts[i];
        const Pt& p2 = pts[(i + 1) % n];
        double dx = p2.x - p1.x, dy = p2.y - p1.y;
        double len = std::hypot(dx, dy);
        if (len == 0.0) continue;
        ok[i] = 1;
        dirs[i] = Pt{dx / len, dy / len};
        double nx = -dy / len * r, ny = dx / len * r;
        out.add_ccw({Pt{p1.x + nx, p1.y + ny}, Pt{p2.x + nx, p2.y + ny},
                     Pt{p2.x - nx, p2.y - ny}, Pt{p1.x - nx, p1.y - ny}});
    }
    double step_cap = 0.5 * M_PI / std::max(quad_segs, 1);
    for (int i = 0; i < n; i++) {
        int prev = (i - 1 + n) % n;
        if ((closed || (0 < i && i < n - 1)) && prev < last && i < last && ok[prev] && ok[i]) {
            double t1 = std::atan2(dirs[prev].y, dirs[prev].x);
            double t2 = std::atan2(dirs[i].y, dirs[i].x);
            double m = std::fmod(t2 - t1 + M_PI, 2.0 * M_PI);
            if (m < 0.0) m += 2.0 * M_PI;  // Python % semantics
            double turn = m - M_PI;
            double span = std::fabs(turn);
            if (span < 1e-9) continue;
            // The uncovered arc sits opposite the turn (see buffer.py).
            double a_start = (turn < 0.0) ? (t2 + 0.5 * M_PI) : (t1 - 0.5 * M_PI);
            int steps = std::max((int)std::ceil(span / step_cap), 1);
            std::vector<Pt> ring;
            ring.reserve(steps + 2);
            ring.push_back(pts[i]);
            for (int k = 0; k <= steps; k++) {
                double a = a_start + span * (double)k / steps;
                ring.push_back(Pt{pts[i].x + r * std::cos(a), pts[i].y + r * std::sin(a)});
            }
            out.add_ccw(std::move(ring));
            continue;
        }
        add_disc(pts[i], r, quad_segs, out);
    }
}

// Raw offset curve (the Chen & McMains / Clipper winding construction) of
// one closed canonically-oriented ring; port of buffer.py _offset_curve.
// Every edge translated by r along its left (inward=true, erosion) or right
// (dilation) normal; gap-opening turns joined by the forward round arc,
// rail-crossing turns by Clipper's 3-point pinch through the original
// vertex (see the Python docstring for why a backward arc would corrupt the
// winding). The winding>0 region (plus the base rings for dilation,
// intersected with the base for erosion) equals the quad/wedge pieces'
// coverage at ~4x fewer overlay segments. Returns false when the ring
// degenerates (callers fall back to path_pieces, whose endpoint discs
// handle it).
bool offset_curve(const Pt* in, int n_in, double r, int quad_segs, bool inward,
                  std::vector<Pt>& out) {
    // Drop an explicit closing vertex, then consecutive duplicates
    // (cyclically — index 0 compares against the last kept point).
    int n0 = n_in;
    if (n0 >= 2 && in[0] == in[n0 - 1]) n0--;
    std::vector<Pt> d;
    d.reserve(n0);
    for (int i = 0; i < n0; i++)
        if (!(in[i] == in[(i - 1 + n0) % n0])) d.push_back(in[i]);
    int n = (int)d.size();
    if (n < 3) return false;

    std::vector<double> theta(n), phi(n);
    for (int i = 0; i < n; i++) {
        const Pt& p1 = d[i];
        const Pt& p2 = d[(i + 1) % n];
        double dx = p2.x - p1.x, dy = p2.y - p1.y;
        if (dx == 0.0 && dy == 0.0) return false;
        theta[i] = std::atan2(dy, dx);
        phi[i] = theta[i] + (inward ? 0.5 * M_PI : -0.5 * M_PI);
    }
    double step_cap = 0.5 * M_PI / std::max(quad_segs, 1);
    out.clear();
    out.reserve(size_t(n) * (quad_segs / 2 + 2));
    for (int i = 0; i < n; i++) {
        int prev = (i - 1 + n) % n;
        double m = std::fmod(theta[i] - theta[prev] + M_PI, 2.0 * M_PI);
        if (m < 0.0) m += 2.0 * M_PI;  // Python % semantics
        double turn = m - M_PI;
        // Spike / collinear-reversal vertex: a +-pi turn always lands on
        // -pi, which would pinch-join a dilation spike tip instead of
        // capping it with a half disc. Degenerate ring: fall back to the
        // pieces construction (mirrors buffer.py _offset_curve).
        if (std::fabs(std::fabs(turn) - M_PI) < 1e-9) return false;
        const Pt& v = d[i];
        if (std::fabs(turn) < 1e-12) {
            out.push_back(Pt{v.x + r * std::cos(phi[i]), v.y + r * std::sin(phi[i])});
            continue;
        }
        if ((turn > 0.0) == inward) {
            // Rails cross: pinch through the original vertex.
            out.push_back(Pt{v.x + r * std::cos(phi[prev]), v.y + r * std::sin(phi[prev])});
            out.push_back(v);
            out.push_back(Pt{v.x + r * std::cos(phi[i]), v.y + r * std::sin(phi[i])});
            continue;
        }
        int steps = std::max((int)std::ceil(std::fabs(turn) / step_cap), 1);
        for (int k = 0; k <= steps; k++) {
            double a = phi[prev] + turn * (double)k / steps;
            out.push_back(Pt{v.x + r * std::cos(a), v.y + r * std::sin(a)});
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// Polygon-pair intersection predicate (port of geo/geometry.py's
// geometries_intersect inner loop: containment either way, else any boundary
// segments intersecting — closed segments, touching counts). Used by the
// merge/dedupe graph construction (robosat/tools/merge.py:54-56).
// ---------------------------------------------------------------------------

bool point_in_ring_c(double x, double y, const double* c, int len) {
    bool inside = false;
    for (int i = 0; i < len; i++) {
        double x1 = c[2 * i], y1 = c[2 * i + 1];
        int j = (i + 1) % len;
        double x2 = c[2 * j], y2 = c[2 * j + 1];
        double d = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1);
        if (d == 0.0 && std::min(x1, x2) <= x && x <= std::max(x1, x2) &&
            std::min(y1, y2) <= y && y <= std::max(y1, y2))
            return true;  // boundary counts as inside
        if ((y1 > y) != (y2 > y)) {
            double xint = x1 + (y - y1) * (x2 - x1) / (y2 - y1);
            if (x < xint) inside = !inside;
        }
    }
    return inside;
}

bool point_on_ring_boundary_c(double x, double y, const double* c, int len) {
    for (int i = 0; i < len; i++) {
        double x1 = c[2 * i], y1 = c[2 * i + 1];
        int j = (i + 1) % len;
        double x2 = c[2 * j], y2 = c[2 * j + 1];
        double d = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1);
        if (d == 0.0 && std::min(x1, x2) <= x && x <= std::max(x1, x2) &&
            std::min(y1, y2) <= y && y <= std::max(y1, y2))
            return true;
    }
    return false;
}

// Polygon (shell + holes) contains point: in shell, not strictly in a hole.
bool poly_contains_point_c(double x, double y, const double* coords, const int32_t* lens, int n_rings) {
    if (n_rings <= 0 || !point_in_ring_c(x, y, coords, lens[0])) return false;
    int64_t off = lens[0];
    for (int r = 1; r < n_rings; r++) {
        if (point_in_ring_c(x, y, coords + 2 * off, lens[r]) &&
            !point_on_ring_boundary_c(x, y, coords + 2 * off, lens[r]))
            return false;
        off += lens[r];
    }
    return true;
}

bool segs_intersect_c(double ax1, double ay1, double ax2, double ay2,
                      double bx1, double by1, double bx2, double by2) {
    double d1 = (bx2 - bx1) * (ay1 - by1) - (by2 - by1) * (ax1 - bx1);
    double d2 = (bx2 - bx1) * (ay2 - by1) - (by2 - by1) * (ax2 - bx1);
    double d3 = (ax2 - ax1) * (by1 - ay1) - (ay2 - ay1) * (bx1 - ax1);
    double d4 = (ax2 - ax1) * (by2 - ay1) - (ay2 - ay1) * (bx2 - ax1);
    if (((d1 > 0) != (d2 > 0)) && ((d3 > 0) != (d4 > 0)) &&
        d1 != 0 && d2 != 0 && d3 != 0 && d4 != 0)
        return true;
    auto on_b = [&](double x, double y) {
        return std::min(bx1, bx2) <= x && x <= std::max(bx1, bx2) &&
               std::min(by1, by2) <= y && y <= std::max(by1, by2);
    };
    auto on_a = [&](double x, double y) {
        return std::min(ax1, ax2) <= x && x <= std::max(ax1, ax2) &&
               std::min(ay1, ay2) <= y && y <= std::max(ay1, ay2);
    };
    return (d1 == 0 && on_b(ax1, ay1)) || (d2 == 0 && on_b(ax2, ay2)) ||
           (d3 == 0 && on_a(bx1, by1)) || (d4 == 0 && on_a(bx2, by2));
}


// Convex single-ring dilation: the Minkowski-sum boundary of a convex CCW
// ring is directly constructible — each edge offset outward by r, joined by
// the vertex arcs (the same arc discretization the wedge pieces use) — so
// the overlay/weld machinery is skipped entirely. Returns false when the
// ring is not strictly usable (non-convex, degenerate edges).
bool convex_dilate(const std::vector<Pt>& ring, double r, int quad_segs, std::vector<Pt>& out) {
    int n = (int)ring.size();
    if (n < 3) return false;
    // All edges non-degenerate and all turns left (CCW convex).
    std::vector<Pt> dir(n);
    for (int i = 0; i < n; i++) {
        const Pt& p1 = ring[i];
        const Pt& p2 = ring[(i + 1) % n];
        double dx = p2.x - p1.x, dy = p2.y - p1.y;
        double len = std::hypot(dx, dy);
        if (len == 0.0) return false;
        dir[i] = Pt{dx / len, dy / len};
    }
    for (int i = 0; i < n; i++) {
        const Pt& a = dir[(i - 1 + n) % n];
        const Pt& b = dir[i];
        if (a.x * b.y - a.y * b.x < 0.0) return false;  // right turn: not convex
    }
    double step_cap = 0.5 * M_PI / std::max(quad_segs, 1);
    out.clear();
    out.reserve(size_t(n) * (quad_segs + 2));
    for (int i = 0; i < n; i++) {
        const Pt& v = ring[i];
        const Pt& dprev = dir[(i - 1 + n) % n];
        const Pt& dnext = dir[i];
        // Arc from dprev's outward normal to dnext's (left normals for CCW).
        double t1 = std::atan2(dprev.y, dprev.x) - 0.5 * M_PI;
        double t2 = std::atan2(dnext.y, dnext.x) - 0.5 * M_PI;
        double m = std::fmod(t2 - t1, 2.0 * M_PI);
        if (m < 0.0) m += 2.0 * M_PI;  // left turn: span in [0, pi)
        double span = m;
        int steps = std::max((int)std::ceil(span / step_cap), 1);
        if (span < 1e-9) {
            out.push_back(Pt{v.x + r * std::cos(t1), v.y + r * std::sin(t1)});
            continue;
        }
        for (int k = 0; k <= steps; k++) {
            double a = t1 + span * (double)k / steps;
            out.push_back(Pt{v.x + r * std::cos(a), v.y + r * std::sin(a)});
        }
    }
    return true;
}

// Convex single-ring erosion: for a convex ring the eroded region
// {x in P : dist(x, boundary) >= r} is the intersection of the edges'
// inward-offset half-planes — interior points of a convex polygon always
// project perpendicularly onto an edge interior (the medial axis of a convex
// polygon has edge cells only), so vertex discs never govern and the arc
// pieces' chord slivers lie inside the edge quads' coverage. The half-plane
// intersection runs the classic deque algorithm (edges of a convex ring are
// already angle-sorted), then every output vertex is verified against every
// half-plane; any doubt returns false and the caller falls back to the
// overlay path. Accepts either orientation. Returns true with an empty
// `out` only when the erosion demonstrably vanishes (deque collapse with a
// strictly infeasible certificate is NOT attempted — those fall back too).
bool convex_erode(const std::vector<Pt>& ring, double r, std::vector<Pt>& out) {
    int n = (int)ring.size();
    if (n < 3) return false;
    // Normalize to CCW.
    double a2 = 0.0;
    for (int i = 0; i < n; i++) {
        const Pt& p = ring[i];
        const Pt& q = ring[(i + 1) % n];
        a2 += p.x * q.y - q.x * p.y;
    }
    std::vector<Pt> ccw(ring);
    if (a2 < 0.0) std::reverse(ccw.begin(), ccw.end());

    // Edge directions; require strict convexity (left or straight turns).
    std::vector<Pt> dir(n), anchor(n);
    for (int i = 0; i < n; i++) {
        const Pt& p1 = ccw[i];
        const Pt& p2 = ccw[(i + 1) % n];
        double dx = p2.x - p1.x, dy = p2.y - p1.y;
        double len = std::hypot(dx, dy);
        if (len == 0.0) return false;
        dir[i] = Pt{dx / len, dy / len};
        // Inward (left) offset anchor of the edge line.
        anchor[i] = Pt{p1.x - dir[i].y * r, p1.y + dir[i].x * r};
    }
    for (int i = 0; i < n; i++) {
        const Pt& a = dir[(i - 1 + n) % n];
        const Pt& b = dir[i];
        if (a.x * b.y - a.y * b.x < 0.0) return false;  // right turn: not convex
    }

    // Half-plane i keeps the left side of the directed line (anchor, dir).
    auto inside = [&](int h, const Pt& x, double eps) {
        return dir[h].x * (x.y - anchor[h].y) - dir[h].y * (x.x - anchor[h].x) >= -eps;
    };
    auto inter = [&](int h1, int h2, Pt& x) {
        double den = dir[h1].x * dir[h2].y - dir[h1].y * dir[h2].x;
        if (std::fabs(den) < 1e-14) return false;  // (near-)parallel
        double dx = anchor[h2].x - anchor[h1].x, dy = anchor[h2].y - anchor[h1].y;
        double t = (dx * dir[h2].y - dy * dir[h2].x) / den;
        x = Pt{anchor[h1].x + t * dir[h1].x, anchor[h1].y + t * dir[h1].y};
        return true;
    };

    std::vector<int> dq;
    dq.reserve(n);
    Pt x;
    for (int i = 0; i < n; i++) {
        while (dq.size() >= 2) {
            if (!inter(dq[dq.size() - 2], dq[dq.size() - 1], x)) return false;
            if (inside(i, x, 0.0)) break;
            dq.pop_back();
        }
        while (dq.size() >= 2) {
            if (!inter(dq[0], dq[1], x)) return false;
            if (inside(i, x, 0.0)) break;
            dq.erase(dq.begin());
        }
        if (!dq.empty()) {
            int b = dq.back();
            double crs = dir[b].x * dir[i].y - dir[b].y * dir[i].x;
            double dot = dir[b].x * dir[i].x + dir[b].y * dir[i].y;
            if (std::fabs(crs) < 1e-14 && dot > 0.0) {
                // Same direction: keep the more constraining line.
                if (inside(b, anchor[i], 0.0)) dq.pop_back();
                else continue;
            }
        }
        dq.push_back(i);
    }
    while (dq.size() >= 3) {
        if (!inter(dq[dq.size() - 2], dq[dq.size() - 1], x)) return false;
        if (inside(dq[0], x, 0.0)) break;
        dq.pop_back();
    }
    while (dq.size() >= 3) {
        if (!inter(dq[0], dq[1], x)) return false;
        if (inside(dq.back(), x, 0.0)) break;
        dq.erase(dq.begin());
    }
    if (dq.size() < 3) return false;  // vanished or degenerate: let the overlay decide

    // Vertices = consecutive line intersections; weld near-duplicates.
    double scale = 1e-30;
    for (const Pt& p : ccw) scale = std::max(scale, std::max(std::fabs(p.x), std::fabs(p.y)));
    double weld = scale * 1e-12;
    std::vector<Pt> verts;
    verts.reserve(dq.size());
    for (size_t k = 0; k < dq.size(); k++) {
        if (!inter(dq[k], dq[(k + 1) % dq.size()], x)) return false;
        if (!verts.empty() && std::fabs(x.x - verts.back().x) <= weld && std::fabs(x.y - verts.back().y) <= weld)
            continue;
        verts.push_back(x);
    }
    while (verts.size() >= 2 && std::fabs(verts.front().x - verts.back().x) <= weld &&
           std::fabs(verts.front().y - verts.back().y) <= weld)
        verts.pop_back();
    if (verts.size() < 3) return false;

    // Verification: every vertex satisfies every half-plane; positive area.
    double vtol = scale * 1e-9 + r * 1e-9;
    for (const Pt& v : verts)
        for (int h = 0; h < n; h++)
            if (!inside(h, v, vtol)) return false;
    double area2 = 0.0;
    for (size_t k = 0; k < verts.size(); k++) {
        const Pt& p = verts[k];
        const Pt& q = verts[(k + 1) % verts.size()];
        area2 += p.x * q.y - q.x * p.y;
    }
    if (area2 <= 0.0) return false;

    out = std::move(verts);
    return true;
}

// ---------------------------------------------------------------------------
// Buffer core shared by rs_buffer_rings and the fused merge-component path:
// fills `out` with final, input-frame rings and returns the snap quantum the
// overlay used (the convex fast paths compute the same extent-scaled quantum
// the Python wrapper expects even though no overlay ran).
// ---------------------------------------------------------------------------

struct RingsOut {
    std::vector<double> coords;
    std::vector<int32_t> lens;
};

double buffer_rings_core(const double* coords, const int32_t* ring_lens, int n_rings,
                         double radius, int quad_segs, int mode, RingsOut& out) {
    // Convex single-ring dilation/erosion needs no overlay at all.
    if ((mode == 0 || mode == 2) && n_rings == 1 && radius > 0.0) {
        int len = ring_lens[0];
        std::vector<Pt> ring(std::max(len, 0));
        for (int i = 0; i < len; i++) ring[i] = Pt{coords[2 * i], coords[2 * i + 1]};
        std::vector<Pt> dilated;
        bool ok = (mode == 0) ? convex_dilate(ring, radius, quad_segs, dilated)
                              : convex_erode(ring, radius, dilated);
        if (ok) {
            double lo = INFINITY, hi = -INFINITY;
            for (const Pt& p : dilated) {
                lo = std::min(lo, std::min(p.x, p.y));
                hi = std::max(hi, std::max(p.x, p.y));
            }
            out.lens.push_back((int32_t)dilated.size());
            for (const Pt& p : dilated) {
                out.coords.push_back(p.x);
                out.coords.push_back(p.y);
            }
            return std::max(std::max(hi - lo, std::fabs(hi)), std::max(std::fabs(lo), 1e-30)) * 1e-10;
        }
    }
    Overlay r;
    bool done = false;
    if ((mode == 0 || mode == 2) && radius > 0.0) {
        // Raw offset curves: one ~n + arcs ring per input ring replaces the
        // ~n overlapping quad/wedge pieces in the overlay (offset_curve
        // docstring above; mirrors buffer.py's curve-first construction).
        // Requires canonically-oriented rings (shells CCW, holes CW) — the
        // callers guarantee this for both modes.
        std::vector<double> ccoords;
        std::vector<int32_t> clens;
        bool all_ok = n_rings > 0;
        std::vector<Pt> pts, curve;
        int64_t coff = 0;
        for (int ri = 0; ri < n_rings && all_ok; ri++) {
            int len = ring_lens[ri];
            pts.assign(len, Pt{});
            for (int i = 0; i < len; i++)
                pts[i] = Pt{coords[2 * (coff + i)], coords[2 * (coff + i) + 1]};
            all_ok = len >= 3 && offset_curve(pts.data(), len, radius, quad_segs, mode == 2, curve);
            if (all_ok) {
                clens.push_back((int32_t)curve.size());
                for (const Pt& p : curve) {
                    ccoords.push_back(p.x);
                    ccoords.push_back(p.y);
                }
            }
            coff += len;
        }
        if (all_ok) {
            if (mode == 2) {
                // Erosion: in-base (even-odd) AND inward curves wind > 0.
                r = run_overlay(coords, ring_lens, n_rings, ccoords.data(), clens.data(),
                                (int)clens.size(), 7, true);
            } else {
                // Dilation: winding union of base rings + outward curves.
                std::vector<double> all_c(coords, coords + 2 * coff);
                all_c.insert(all_c.end(), ccoords.begin(), ccoords.end());
                std::vector<int32_t> all_l(ring_lens, ring_lens + n_rings);
                all_l.insert(all_l.end(), clens.begin(), clens.end());
                r = run_overlay(all_c.data(), all_l.data(), (int)all_l.size(),
                                nullptr, nullptr, 0, 4, true);
            }
            done = true;
        }
    }
    if (!done) {
        // Degenerate ring (or open-path mode): the pieces construction,
        // whose endpoint discs handle collapsed edges.
        RingSink pieces;
        int64_t off = 0;
        for (int ri = 0; ri < n_rings; ri++) {
            int len = ring_lens[ri];
            if (len > 0) {
                std::vector<Pt> pts2(len);
                for (int i = 0; i < len; i++)
                    pts2[i] = Pt{coords[2 * (off + i)], coords[2 * (off + i) + 1]};
                path_pieces(pts2.data(), len, mode != 1, radius, quad_segs, pieces);
            }
            off += len;
        }
        if (mode == 2) {
            r = run_overlay(coords, ring_lens, n_rings, pieces.coords.data(), pieces.lens.data(),
                            (int)pieces.lens.size(), 5, true);
        } else {
            if (mode == 0) {
                // The dilation must also cover the polygon interiors themselves.
                RingSink all;
                all.coords = pieces.coords;
                all.lens = pieces.lens;
                int64_t o2 = 0;
                for (int ri = 0; ri < n_rings; ri++) {
                    all.add_raw(coords + 2 * o2, ring_lens[ri]);
                    o2 += ring_lens[ri];
                }
                pieces = std::move(all);
            }
            r = run_overlay(pieces.coords.data(), pieces.lens.data(), (int)pieces.lens.size(),
                            nullptr, nullptr, 0, 4, true);
        }
    }
    LinkedRings linked = link_rings(r.edges, r.q);  // links in the shifted frame
    for (size_t ri = 0, off2 = 0; ri < linked.lens.size(); ri++) {
        out.lens.push_back(linked.lens[ri]);
        for (int i = 0; i < linked.lens[ri]; i++, off2++) {
            out.coords.push_back(linked.coords[2 * off2] + r.sx);
            out.coords.push_back(linked.coords[2 * off2 + 1] + r.sy);
        }
    }
    return r.q;
}

// One merge component, fused: N-ary winding union of the members' canonical
// rings (skipped for single-member components — the reference's
// functools.reduce union returns a lone element unchanged,
// robosat/spatial/core.py:25-40) followed by the negative buffer, without
// the Python round trip between the two overlays
// (robosat/tools/merge.py:58-65 is the behavior being fused).
void merge_component_core(const double* coords, const int32_t* ring_lens, int n_rings,
                          bool single, double radius, int quad_segs, RingsOut& out) {
    if (n_rings <= 0) return;
    if (single) {
        buffer_rings_core(coords, ring_lens, n_rings, radius, quad_segs, 2, out);
        return;
    }
    Overlay r = run_overlay(coords, ring_lens, n_rings, nullptr, nullptr, 0, 4, true);
    LinkedRings linked = link_rings(r.edges, r.q);
    if (linked.lens.empty()) return;
    // Shift back to the input frame (exactly what rs_overlay_rings hands the
    // Python caller between the two steps) and drop zero-area rings (the
    // shell/hole assembly between the steps discards them — clip.py
    // _assemble_polygons keeps only a != 0).
    RingsOut base;
    size_t off = 0;
    std::vector<Pt> ring;
    for (size_t ri = 0; ri < linked.lens.size(); ri++) {
        int len = linked.lens[ri];
        ring.assign(len, Pt{});
        for (int i = 0; i < len; i++)
            ring[i] = Pt{linked.coords[2 * (off + i)] + r.sx, linked.coords[2 * (off + i) + 1] + r.sy};
        off += len;
        if (ring_signed_area(ring) == 0.0) continue;
        base.lens.push_back(len);
        for (const Pt& p : ring) {
            base.coords.push_back(p.x);
            base.coords.push_back(p.y);
        }
    }
    if (base.lens.empty()) return;
    buffer_rings_core(base.coords.data(), base.lens.data(), (int)base.lens.size(),
                      radius, quad_segs, 2, out);
}

}  // namespace

extern "C" {

// Intersection AND union areas of (a, b) from ONE slab sweep (op 6); writes
// both through out2[0]=intersection, out2[1]=union. The iou hot path of
// rs dedupe formerly ran two full overlays per candidate pair.
void rs_overlay_iou_areas(const double* coords_a, const int32_t* rings_a, int32_t n_rings_a,
                          const double* coords_b, const int32_t* rings_b, int32_t n_rings_b,
                          double* out2) {
    Overlay r = run_overlay(coords_a, rings_a, n_rings_a, coords_b, rings_b, n_rings_b, 6, false);
    out2[0] = r.area;
    out2[1] = r.area2;
}

// 1 if the ring (len vertices, closing edge implied) is simple: no
// degenerate edges, no collinear overlap between adjacent edges, and no
// contact between non-adjacent edges (closed segments — touching counts as
// contact). Port of geo/geometry.py ring_is_simple.
static int32_t ring_is_simple_impl(const double* c, int32_t len) {
    if (len < 3) return 0;
    for (int i = 0; i < len; i++) {
        int j = (i + 1) % len;
        if (c[2 * i] == c[2 * j] && c[2 * i + 1] == c[2 * j + 1]) return 0;  // zero-length edge
    }
    // Adjacent edges: shared endpoint allowed, collinear overlap is not.
    for (int i = 0; i < len; i++) {
        int j = (i + 1) % len;
        int k = (i + 2) % len;
        double px = c[2 * i], py = c[2 * i + 1];
        double qx = c[2 * j], qy = c[2 * j + 1];
        double rx = c[2 * k], ry = c[2 * k + 1];
        // Collinear test of edge (p, q) against edge (q, r): both of r's
        // endpoints on line (p, q) — q is by construction, so only r needs
        // checking.
        double g1 = (qx - px) * (ry - py) - (qy - py) * (rx - px);
        if (g1 == 0.0) {
            // Collinear: overlap length along the dominant axis.
            bool use_x = std::fabs(qx - px) >= std::fabs(qy - py);
            double pa = use_x ? px : py, pb = use_x ? qx : qy;
            double qa = use_x ? qx : qy, qb = use_x ? rx : ry;
            double overlap = std::min(std::max(pa, pb), std::max(qa, qb)) -
                             std::max(std::min(pa, pb), std::min(qa, qb));
            if (overlap > 0.0) return 0;
        }
    }
    // Non-adjacent pairs with a per-edge bbox cull.
    for (int i = 0; i < len; i++) {
        int i2 = (i + 1) % len;
        double ax1 = c[2 * i], ay1 = c[2 * i + 1];
        double ax2 = c[2 * i2], ay2 = c[2 * i2 + 1];
        double axlo = std::min(ax1, ax2), axhi = std::max(ax1, ax2);
        double aylo = std::min(ay1, ay2), ayhi = std::max(ay1, ay2);
        for (int j = i + 2; j < len; j++) {
            if (i == 0 && j == len - 1) continue;  // adjacent via the closing edge
            int j2 = (j + 1) % len;
            double bx1 = c[2 * j], by1 = c[2 * j + 1];
            double bx2 = c[2 * j2], by2 = c[2 * j2 + 1];
            if (std::max(bx1, bx2) < axlo || std::min(bx1, bx2) > axhi ||
                std::max(by1, by2) < aylo || std::min(by1, by2) > ayhi)
                continue;
            if (segs_intersect_c(ax1, ay1, ax2, ay2, bx1, by1, bx2, by2)) return 0;
        }
    }
    return 1;
}

int32_t rs_ring_is_simple(const double* c, int32_t len) { return ring_is_simple_impl(c, len); }

// Batched polygon validity (mirrors geo/geometry.py Polygon.is_valid: shell
// >= 3 vertices with nonzero area and simple; every hole >= 3 vertices,
// simple, with all vertices inside the shell — boundary counts). One native
// call validates every merged feature (the per-ring ctypes crossings were
// ~0.5 s of a 10k rs merge).
void rs_polys_valid_batch(const double* coords, const int32_t* lens, const int64_t* ring_off,
                          const int64_t* coord_off, int32_t n_polys, int8_t* out) {
    for (int p = 0; p < n_polys; p++) {
        int64_t r0 = ring_off[p], r1 = ring_off[p + 1];
        const double* shell = coords + 2 * coord_off[p];
        int32_t slen = (r1 > r0) ? lens[r0] : 0;
        out[p] = 0;
        if (slen < 3) continue;
        {
            // Centered shoelace, zero test (mirrors ring_area's centering).
            double a = 0.0;
            double ox = shell[0], oy = shell[1];
            for (int32_t i = 0; i < slen; i++) {
                int32_t j = (i + 1) % slen;
                a += (shell[2 * i] - ox) * (shell[2 * j + 1] - oy) -
                     (shell[2 * j] - ox) * (shell[2 * i + 1] - oy);
            }
            if (a == 0.0) continue;
        }
        if (!ring_is_simple_impl(shell, slen)) continue;
        bool ok = true;
        const double* hc = shell + 2 * slen;
        for (int64_t r = r0 + 1; r < r1 && ok; r++) {
            int32_t hlen = lens[r];
            if (hlen < 3 || !ring_is_simple_impl(hc, hlen)) {
                ok = false;
                break;
            }
            for (int32_t i = 0; i < hlen; i++)
                if (!point_in_ring_c(hc[2 * i], hc[2 * i + 1], shell, slen)) {
                    ok = false;
                    break;
                }
            hc += 2 * hlen;
        }
        out[p] = ok ? 1 : 0;
    }
}

// 1 if polygon A (shell + holes) and polygon B share any point, else 0.
static int32_t rs_polys_intersect_impl(const double* ca, const int32_t* la, int32_t na,
                                       const double* cb, const int32_t* lb, int32_t nb) {
    if (na <= 0 || nb <= 0 || la[0] < 3 || lb[0] < 3) return 0;
    // Containment (either direction) via the first shell vertices.
    if (poly_contains_point_c(ca[0], ca[1], cb, lb, nb)) return 1;
    if (poly_contains_point_c(cb[0], cb[1], ca, la, na)) return 1;
    // Boundary crossing: all ring-segment pairs with per-segment bbox cull.
    int64_t offa = 0;
    for (int ra = 0; ra < na; ra++) {
        int lena = la[ra];
        const double* A = ca + 2 * offa;
        offa += lena;
        if (lena < 2) continue;
        int64_t offb = 0;
        for (int rb = 0; rb < nb; rb++) {
            int lenb = lb[rb];
            const double* B = cb + 2 * offb;
            offb += lenb;
            if (lenb < 2) continue;
            for (int i = 0; i < lena; i++) {
                double ax1 = A[2 * i], ay1 = A[2 * i + 1];
                int i2 = (i + 1) % lena;
                double ax2 = A[2 * i2], ay2 = A[2 * i2 + 1];
                double axlo = std::min(ax1, ax2), axhi = std::max(ax1, ax2);
                double aylo = std::min(ay1, ay2), ayhi = std::max(ay1, ay2);
                for (int j = 0; j < lenb; j++) {
                    double bx1 = B[2 * j], by1 = B[2 * j + 1];
                    int j2 = (j + 1) % lenb;
                    double bx2 = B[2 * j2], by2 = B[2 * j2 + 1];
                    if (std::max(bx1, bx2) < axlo || std::min(bx1, bx2) > axhi ||
                        std::max(by1, by2) < aylo || std::min(by1, by2) > ayhi)
                        continue;
                    if (segs_intersect_c(ax1, ay1, ax2, ay2, bx1, by1, bx2, by2)) return 1;
                }
            }
        }
    }
    return 0;
}

int32_t rs_polys_intersect(const double* ca, const int32_t* la, int32_t na,
                           const double* cb, const int32_t* lb, int32_t nb) {
    return rs_polys_intersect_impl(ca, la, na, cb, lb, nb);
}


double rs_overlay_area(const double* coords_a, const int32_t* rings_a, int32_t n_rings_a,
                       const double* coords_b, const int32_t* rings_b, int32_t n_rings_b,
                       int32_t op) {
    return run_overlay(coords_a, rings_a, n_rings_a, coords_b, rings_b, n_rings_b, op, false).area;
}

// Returns a malloc'd array of 4*count doubles (x1,y1,x2,y2 per edge); the
// caller frees it with rs_free. count is written through out_count.
double* rs_overlay_edges(const double* coords_a, const int32_t* rings_a, int32_t n_rings_a,
                         const double* coords_b, const int32_t* rings_b, int32_t n_rings_b,
                         int32_t op, int64_t* out_count) {
    Overlay r = run_overlay(coords_a, rings_a, n_rings_a, coords_b, rings_b, n_rings_b, op, true);
    *out_count = (int64_t)(r.edges.size() / 4);
    double* out = (double*)std::malloc(r.edges.size() * sizeof(double));
    if (out)
        for (size_t i = 0; i < r.edges.size(); i += 2) {
            out[i] = r.edges[i] + r.sx;
            out[i + 1] = r.edges[i + 1] + r.sy;
        }
    return out;
}

// Full boolean overlay returning welded+linked rings. Writes the number of
// rings through out_n_rings and a malloc'd int32 array of per-ring vertex
// counts through out_lens; returns a malloc'd double array of x,y coords
// (sum(lens) * 2 values). Caller frees both with rs_free.
double* rs_overlay_rings(const double* coords_a, const int32_t* rings_a, int32_t n_rings_a,
                         const double* coords_b, const int32_t* rings_b, int32_t n_rings_b,
                         int32_t op, int32_t** out_lens, int64_t* out_n_rings) {
    Overlay r = run_overlay(coords_a, rings_a, n_rings_a, coords_b, rings_b, n_rings_b, op, true);
    LinkedRings linked = link_rings(r.edges, r.q);  // links in the shifted frame
    *out_n_rings = (int64_t)linked.lens.size();
    *out_lens = (int32_t*)std::malloc(std::max(linked.lens.size(), (size_t)1) * sizeof(int32_t));
    if (*out_lens) std::copy(linked.lens.begin(), linked.lens.end(), *out_lens);
    double* out = (double*)std::malloc(std::max(linked.coords.size(), (size_t)1) * sizeof(double));
    if (out)
        for (size_t i = 0; i < linked.coords.size(); i += 2) {
            out[i] = linked.coords[i] + r.sx;
            out[i + 1] = linked.coords[i + 1] + r.sy;
        }
    return out;
}

// Minkowski buffer: piece generation + overlay + ring linking in one call.
// mode 0: polygon dilation — input rings (canonically oriented: shells CCW,
//   holes CW) enter the winding union together with per-ring quads/wedges.
// mode 1: open-path dilation — each input "ring" is an open path.
// mode 2: polygon erosion — input rings (canonically oriented, even-odd base)
//   intersected with the winding>0 region of their inward raw offset curves
//   (op 7), or minus the winding union of boundary halo pieces (op 5) when a
//   ring degenerates.
// Returns linked rings like rs_overlay_rings; writes the snap quantum used
// through out_q (for the caller's collinear-simplification tolerance).
double* rs_buffer_rings(const double* coords, const int32_t* ring_lens, int32_t n_rings,
                        double radius, int32_t quad_segs, int32_t mode,
                        int32_t** out_lens, int64_t* out_n_rings, double* out_q) {
    RingsOut rings;
    *out_q = buffer_rings_core(coords, ring_lens, n_rings, radius, quad_segs, mode, rings);
    *out_n_rings = (int64_t)rings.lens.size();
    *out_lens = (int32_t*)std::malloc(std::max(rings.lens.size(), (size_t)1) * sizeof(int32_t));
    if (*out_lens) std::copy(rings.lens.begin(), rings.lens.end(), *out_lens);
    double* out = (double*)std::malloc(std::max(rings.coords.size(), (size_t)1) * sizeof(double));
    if (out) std::copy(rings.coords.begin(), rings.coords.end(), out);
    return out;
}

// Batched Minkowski buffer: rs_buffer_rings over many independent geometries
// in ONE native call (the `rs merge` grow phase ran one ctypes crossing per
// feature, robosat/tools/merge.py:50-52), optionally threaded — geometries
// are independent and each writes its own output slot, so results are
// deterministic and thread-count independent.
double* rs_buffer_rings_batch(const double* coords, const int32_t* ring_lens,
                              const int32_t* geom_nrings, int32_t n_geoms,
                              double radius, int32_t quad_segs, int32_t mode,
                              int32_t n_threads,
                              int32_t** out_ring_lens, int32_t** out_geom_nrings,
                              int64_t* out_total_rings) {
    std::vector<int64_t> ring_off(n_geoms + 1, 0), coord_off(n_geoms + 1, 0);
    {
        int64_t roff = 0, coff = 0;
        for (int c = 0; c < n_geoms; c++) {
            ring_off[c] = roff;
            coord_off[c] = coff;
            for (int ri = 0; ri < geom_nrings[c]; ri++) coff += ring_lens[roff + ri];
            roff += geom_nrings[c];
        }
        ring_off[n_geoms] = roff;
        coord_off[n_geoms] = coff;
    }
    std::vector<RingsOut> outs(std::max(n_geoms, 1));
    auto work = [&](int t, int stride) {
        for (int c = t; c < n_geoms; c += stride)
            buffer_rings_core(coords + 2 * coord_off[c], ring_lens + ring_off[c],
                              geom_nrings[c], radius, quad_segs, mode, outs[c]);
    };
    if (n_threads <= 1 || n_geoms <= 1) {
        work(0, 1);
    } else {
        int t_use = std::min(n_threads, n_geoms);
        std::vector<std::thread> pool;
        pool.reserve(t_use - 1);
        for (int t = 1; t < t_use; t++) pool.emplace_back(work, t, t_use);
        work(0, t_use);
        for (auto& th : pool) th.join();
    }
    size_t total_rings = 0, total_coords = 0;
    for (const RingsOut& r : outs) {
        total_rings += r.lens.size();
        total_coords += r.coords.size();
    }
    *out_total_rings = (int64_t)total_rings;
    *out_geom_nrings = (int32_t*)std::malloc(std::max((size_t)n_geoms, (size_t)1) * sizeof(int32_t));
    *out_ring_lens = (int32_t*)std::malloc(std::max(total_rings, (size_t)1) * sizeof(int32_t));
    double* out = (double*)std::malloc(std::max(total_coords, (size_t)1) * sizeof(double));
    if (!*out_geom_nrings || !*out_ring_lens || !out) {
        // Partial malloc failure: report zero rings so the Python side
        // unpacks empties instead of dereferencing a NULL output pointer.
        *out_total_rings = 0;
        return out;
    }
    size_t rpos = 0, cpos = 0;
    for (int c = 0; c < n_geoms; c++) {
        (*out_geom_nrings)[c] = (int32_t)outs[c].lens.size();
        std::copy(outs[c].lens.begin(), outs[c].lens.end(), *out_ring_lens + rpos);
        rpos += outs[c].lens.size();
        std::copy(outs[c].coords.begin(), outs[c].coords.end(), out + cpos);
        cpos += outs[c].coords.size();
    }
    return out;
}

// Batched winding-IoU: per group, the intersection and union areas of
// (even-odd rings a) vs (the winding union of canonically-oriented rings b)
// from ONE overlay each — the rs dedupe scoring loop without materializing
// union(overlapping) per prediction (robosat/tools/dedupe.py:45-49), one
// ctypes crossing for the whole collection, threaded like the other batches.
void rs_iou_winding_batch(const double* ac, const int32_t* al, const int32_t* a_nrings,
                          const double* bc, const int32_t* bl, const int32_t* b_nrings,
                          int32_t n_groups, int32_t n_threads, double* out2) {
    std::vector<int64_t> a_roff(n_groups + 1, 0), a_coff(n_groups + 1, 0);
    std::vector<int64_t> b_roff(n_groups + 1, 0), b_coff(n_groups + 1, 0);
    for (int g = 0; g < n_groups; g++) {
        a_roff[g + 1] = a_roff[g] + a_nrings[g];
        b_roff[g + 1] = b_roff[g] + b_nrings[g];
        int64_t ca = 0, cb = 0;
        for (int64_t r = a_roff[g]; r < a_roff[g + 1]; r++) ca += al[r];
        for (int64_t r = b_roff[g]; r < b_roff[g + 1]; r++) cb += bl[r];
        a_coff[g + 1] = a_coff[g] + ca;
        b_coff[g + 1] = b_coff[g] + cb;
    }
    auto work = [&](int t, int stride) {
        for (int g = t; g < n_groups; g += stride) {
            Overlay r = run_overlay(ac + 2 * a_coff[g], al + a_roff[g], a_nrings[g],
                                    bc + 2 * b_coff[g], bl + b_roff[g], b_nrings[g], 8, false);
            out2[2 * g] = r.area;
            out2[2 * g + 1] = r.area2;
        }
    };
    if (n_threads <= 1 || n_groups <= 1) {
        work(0, 1);
    } else {
        int t_use = std::min(n_threads, n_groups);
        std::vector<std::thread> pool;
        pool.reserve(t_use - 1);
        for (int t = 1; t < t_use; t++) pool.emplace_back(work, t, t_use);
        work(0, t_use);
        for (auto& th : pool) th.join();
    }
}

// Full-native merge graph build: which grown buffers intersect which shapes
// (robosat/tools/merge.py:54-56). Broad phase is a uniform grid over the
// SHAPE polygons' bboxes probed by each GROWN polygon's bbox — exact
// relative to the R-tree + per-polygon-pair bbox-cull path (containment
// implies bbox overlap, so a skipped pair could only have answered false).
// Narrow phase reuses rs_polys_intersect_impl; a geometry pair is decided at
// its FIRST intersecting polygon pair. Returns malloc'd int32 (i, j) edge
// pairs (grown-geometry index, shape-geometry index), i != j.
// exclude_same: skip owner pairs with equal indices — the merge self-join
// must not test a geometry against itself, while dedupe's two DISTINCT
// collections must test equal indices like any other pair.
int32_t* rs_intersect_graph(const double* gc, const int32_t* gl, const int64_t* g_ring_off,
                            const int64_t* g_coord_off, const int32_t* g_owner, int32_t n_gpolys,
                            const double* sc, const int32_t* sl, const int64_t* s_ring_off,
                            const int64_t* s_coord_off, const int32_t* s_owner, int32_t n_spolys,
                            int32_t exclude_same, int64_t* out_n_edges) {
    struct Box { double x0, y0, x1, y1; };
    auto poly_box = [](const double* c, const int32_t* l, int64_t roff, int64_t coff,
                       int64_t roff_next) {
        Box b{INFINITY, INFINITY, -INFINITY, -INFINITY};
        int64_t npts = 0;
        for (int64_t r = roff; r < roff_next; r++) npts += l[r];
        const double* p = c + 2 * coff;
        for (int64_t i = 0; i < npts; i++) {
            b.x0 = std::min(b.x0, p[2 * i]);
            b.x1 = std::max(b.x1, p[2 * i]);
            b.y0 = std::min(b.y0, p[2 * i + 1]);
            b.y1 = std::max(b.y1, p[2 * i + 1]);
        }
        return b;
    };
    std::vector<Box> gb(n_gpolys), sb(n_spolys);
    double cell = 0.0;
    for (int i = 0; i < n_spolys; i++) {
        sb[i] = poly_box(sc, sl, s_ring_off[i], s_coord_off[i], s_ring_off[i + 1]);
        cell += (sb[i].x1 - sb[i].x0) + (sb[i].y1 - sb[i].y0);
    }
    for (int i = 0; i < n_gpolys; i++)
        gb[i] = poly_box(gc, gl, g_ring_off[i], g_coord_off[i], g_ring_off[i + 1]);
    if (n_spolys == 0 || n_gpolys == 0) {
        *out_n_edges = 0;
        return (int32_t*)std::malloc(sizeof(int32_t));
    }
    cell = std::max(cell / (2.0 * n_spolys), 1e-9);  // mean box half-perimeter

    // Uniform grid of shape-polygon indices (flat buckets via counting sort).
    double gx0 = INFINITY, gy0 = INFINITY, gx1 = -INFINITY, gy1 = -INFINITY;
    for (const Box& b : sb) {
        gx0 = std::min(gx0, b.x0);
        gy0 = std::min(gy0, b.y0);
        gx1 = std::max(gx1, b.x1);
        gy1 = std::max(gy1, b.y1);
    }
    int64_t nx = std::max<int64_t>(1, std::min<int64_t>((int64_t)((gx1 - gx0) / cell) + 1, 4096));
    int64_t ny = std::max<int64_t>(1, std::min<int64_t>((int64_t)((gy1 - gy0) / cell) + 1, 4096));
    double inv_cx = nx / std::max(gx1 - gx0, 1e-30);
    double inv_cy = ny / std::max(gy1 - gy0, 1e-30);
    auto cell_of = [&](double x, double y, int64_t& cx, int64_t& cy) {
        cx = std::min<int64_t>(std::max<int64_t>((int64_t)((x - gx0) * inv_cx), 0), nx - 1);
        cy = std::min<int64_t>(std::max<int64_t>((int64_t)((y - gy0) * inv_cy), 0), ny - 1);
    };
    std::vector<int64_t> counts(nx * ny + 1, 0);
    auto for_cells = [&](const Box& b, auto&& fn) {
        int64_t cx0, cy0, cx1, cy1;
        cell_of(b.x0, b.y0, cx0, cy0);
        cell_of(b.x1, b.y1, cx1, cy1);
        for (int64_t cy = cy0; cy <= cy1; cy++)
            for (int64_t cx = cx0; cx <= cx1; cx++) fn(cy * nx + cx);
    };
    for (int i = 0; i < n_spolys; i++) for_cells(sb[i], [&](int64_t c) { counts[c + 1]++; });
    for (size_t c = 1; c < counts.size(); c++) counts[c] += counts[c - 1];
    std::vector<int32_t> bucket(counts.back());
    {
        std::vector<int64_t> fill(counts.begin(), counts.end() - 1);
        for (int i = 0; i < n_spolys; i++)
            for_cells(sb[i], [&](int64_t c) { bucket[fill[c]++] = i; });
    }

    // Probe: per grown polygon, candidate shape polygons from its cells.
    std::unordered_map<uint64_t, char> decided;  // (i<<32|j) -> 0 probing, 1 edge
    std::vector<int32_t> edges;
    std::vector<char> seen(n_spolys, 0);
    std::vector<int32_t> seen_list;
    for (int gp = 0; gp < n_gpolys; gp++) {
        const Box& b = gb[gp];
        int32_t i = g_owner[gp];
        seen_list.clear();
        for_cells(b, [&](int64_t c) {
            for (int64_t k = counts[c]; k < counts[c + 1]; k++) {
                int32_t sp = bucket[k];
                if (seen[sp]) continue;
                seen[sp] = 1;
                seen_list.push_back(sp);
                const Box& o = sb[sp];
                if (o.x0 > b.x1 || o.x1 < b.x0 || o.y0 > b.y1 || o.y1 < b.y0) continue;
                int32_t j = s_owner[sp];
                if (exclude_same && i == j) continue;
                uint64_t key = ((uint64_t)(uint32_t)i << 32) | (uint32_t)j;
                auto it = decided.find(key);
                if (it != decided.end() && it->second) continue;
                if (rs_polys_intersect_impl(
                        gc + 2 * g_coord_off[gp], gl + g_ring_off[gp],
                        (int32_t)(g_ring_off[gp + 1] - g_ring_off[gp]),
                        sc + 2 * s_coord_off[sp], sl + s_ring_off[sp],
                        (int32_t)(s_ring_off[sp + 1] - s_ring_off[sp]))) {
                    decided[key] = 1;
                    edges.push_back(i);
                    edges.push_back(j);
                } else if (it == decided.end()) {
                    decided[key] = 0;
                }
            }
        });
        for (int32_t sp : seen_list) seen[sp] = 0;
    }
    *out_n_edges = (int64_t)(edges.size() / 2);
    int32_t* out = (int32_t*)std::malloc(std::max(edges.size(), (size_t)1) * sizeof(int32_t));
    if (out) std::copy(edges.begin(), edges.end(), out);
    return out;
}

// Fused, batched merge-component finisher: for every component, the N-ary
// union of its (grown) member rings followed by the negative buffer — the
// whole "Merging components" loop of rs merge (robosat/tools/merge.py:58-75's
// cascaded union + buffer(-threshold)) in ONE native call instead of two
// ctypes crossings plus a Python assemble/canonicalize round trip per
// component. Components are independent, so they optionally fan out over
// n_threads identical workers (deterministic: each writes its own slot).
//
// Inputs: all components' canonical rings concatenated (coords/ring_lens),
// comp_nrings[i] rings per component, comp_single[i] nonzero when the
// component has a single non-empty member (union skipped, reference
// semantics). Outputs mirror rs_buffer_rings, plus per-component ring counts.
double* rs_merge_components(const double* coords, const int32_t* ring_lens,
                            const int32_t* comp_nrings, const int32_t* comp_single,
                            int32_t n_comps, double radius, int32_t quad_segs,
                            int32_t n_threads,
                            int32_t** out_ring_lens, int32_t** out_comp_nrings,
                            int64_t* out_total_rings) {
    std::vector<int64_t> ring_off(n_comps + 1, 0), coord_off(n_comps + 1, 0);
    {
        int64_t roff = 0, coff = 0;
        for (int c = 0; c < n_comps; c++) {
            ring_off[c] = roff;
            coord_off[c] = coff;
            for (int ri = 0; ri < comp_nrings[c]; ri++) coff += ring_lens[roff + ri];
            roff += comp_nrings[c];
        }
        ring_off[n_comps] = roff;
        coord_off[n_comps] = coff;
    }
    std::vector<RingsOut> outs(std::max(n_comps, 1));
    auto work = [&](int t, int stride) {
        for (int c = t; c < n_comps; c += stride)
            merge_component_core(coords + 2 * coord_off[c], ring_lens + ring_off[c],
                                 comp_nrings[c], comp_single[c] != 0, radius, quad_segs, outs[c]);
    };
    if (n_threads <= 1 || n_comps <= 1) {
        work(0, 1);
    } else {
        int t_use = std::min(n_threads, n_comps);
        std::vector<std::thread> pool;
        pool.reserve(t_use - 1);
        for (int t = 1; t < t_use; t++) pool.emplace_back(work, t, t_use);
        work(0, t_use);
        for (auto& th : pool) th.join();
    }

    size_t total_rings = 0, total_coords = 0;
    for (const RingsOut& r : outs) {
        total_rings += r.lens.size();
        total_coords += r.coords.size();
    }
    *out_total_rings = (int64_t)total_rings;
    *out_comp_nrings = (int32_t*)std::malloc(std::max((size_t)n_comps, (size_t)1) * sizeof(int32_t));
    *out_ring_lens = (int32_t*)std::malloc(std::max(total_rings, (size_t)1) * sizeof(int32_t));
    double* out = (double*)std::malloc(std::max(total_coords, (size_t)1) * sizeof(double));
    if (!*out_comp_nrings || !*out_ring_lens || !out) {
        // Partial malloc failure: see rs_buffer_rings_batch.
        *out_total_rings = 0;
        return out;
    }
    size_t rpos = 0, cpos = 0;
    for (int c = 0; c < n_comps; c++) {
        (*out_comp_nrings)[c] = (int32_t)outs[c].lens.size();
        std::copy(outs[c].lens.begin(), outs[c].lens.end(), *out_ring_lens + rpos);
        rpos += outs[c].lens.size();
        std::copy(outs[c].coords.begin(), outs[c].coords.end(), out + cpos);
        cpos += outs[c].coords.size();
    }
    return out;
}

void rs_free(void* p) { std::free(p); }


}  // extern "C"
