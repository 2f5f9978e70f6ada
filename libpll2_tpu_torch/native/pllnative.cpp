// Native host-side routines of the port: the port's own copy of
// libpll2_tpu/native/pllnative.cpp.
//
//  * site-repeats class identification (pll_tpu_repeats_tips,
//    pll_tpu_repeats_update): the O(sites) lookup-buffer pass run once per
//    node per topology change (reference: libpll-2 src/repeats.c:189-254
//    tips, :334-347 inner nodes);
//  * the randomized stepwise-addition parsimony build (pll_tpu_stepwise);
//  * the topology search's whole-round candidate builder of the batched
//    NNI/SPR rounds (pll_tpu_move_candidates) and the streamed round's
//    target enumeration and schedule builder (pll_tpu_spr_stream_enum,
//    pll_tpu_spr_stream_build).
//
// Built with g++ at first use into libpll2_tpu_torch/_build/ and loaded via
// ctypes (native/__init__.py); without a toolchain the callers take their
// Python versions, which give bit-identical results.

#include <array>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" {

// Inner-node repeats identification: class the parent by (left, right)
// class pairs in first-occurrence order. `lookup` is caller-owned scratch
// of at least ids_l*ids_r int32, filled with -1 on entry; it is restored to
// -1 before returning (the reference's toclean trick). Returns the number
// of classes.
int64_t pll_tpu_repeats_update(const int32_t* site_id_l,
                               const int32_t* site_id_r,
                               int64_t ids_l,
                               int64_t sites,
                               int32_t* lookup,
                               int32_t* site_id_out,
                               int32_t* id_site_out)
{
    int32_t curr = 0;
    for (int64_t s = 0; s < sites; ++s) {
        const int64_t key = (int64_t)site_id_l[s]
                          + (int64_t)site_id_r[s] * ids_l;
        int32_t id = lookup[key];
        if (id < 0) {
            id = curr;
            lookup[key] = curr;
            id_site_out[curr] = (int32_t)s;
            ++curr;
        }
        site_id_out[s] = id;
    }
    for (int32_t c = 0; c < curr; ++c) {
        const int64_t s = id_site_out[c];
        lookup[(int64_t)site_id_l[s] + (int64_t)site_id_r[s] * ids_l] = -1;
    }
    return curr;
}

// Tip repeats identification: class sites by their (64-bit) state code in
// first-occurrence order. Unbounded key space, so a hash map is used.
int64_t pll_tpu_repeats_tips(const uint64_t* codes,
                             int64_t sites,
                             int32_t* site_id_out,
                             int32_t* id_site_out)
{
    std::unordered_map<uint64_t, int32_t> lookup;
    lookup.reserve(64);
    int32_t curr = 0;
    for (int64_t s = 0; s < sites; ++s) {
        auto it = lookup.find(codes[s]);
        int32_t id;
        if (it == lookup.end()) {
            id = curr;
            lookup.emplace(codes[s], curr);
            id_site_out[curr] = (int32_t)s;
            ++curr;
        } else {
            id = it->second;
        }
        site_id_out[s] = id;
    }
    return curr;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Native stepwise-addition engine.
//
// The stepwise build (reference: libpll-2 src/stepwise.c:391-594)
// is a host-latency-bound loop: ~N insertions x ~2N candidate edges of
// microsecond-scale bit-ops work, where every device launch would cost
// more than the work it carries. This is the same ALGORITHM as
// parsimony/stepwise.py + parsimony/fitch.py (identical traversal order,
// validity flags, first-minimum tie-breaking, so the produced topology is
// bit-identical per seed) executed on the host CPU. Multi-partition
// scores are summed per candidate exactly like
// pll_fastparsimony_stepwise (stepwise.c:337-346).
//
// Directional-vector layout: node_index addressing identical to the Python
// loop: tips 0..T-1, inner node i owns half-edges T+3i+k (k=0,1,2) in a
// ring. Each node slot holds `stride` uint32 words: partition p's state-k
// bitvector at [poff[p] + k*W[p] .. +W[p]).

namespace stepwise {

struct Ctx {
    int64_t T;                   // tip count
    int64_t stride;              // words per node slot
    int64_t P;                   // partitions
    const int64_t* states;       // [P]
    const int64_t* W;            // [P] words per state vector
    const int64_t* poff;         // [P] word offset of partition p
    std::vector<uint32_t> vec;   // [node_count * stride]
    std::vector<int64_t> cost;   // [node_count]
    std::vector<int32_t> back;   // [node_count]
    std::vector<int32_t> next;   // [node_count]
    std::vector<uint8_t> valid;  // [node_count]
    std::vector<uint32_t> tmp;   // [stride] join scratch
    std::vector<uint32_t> uni;   // [max W] union scratch

    bool is_tip(int32_t n) const { return n < (int32_t)T; }
    uint32_t* v(int32_t n) { return vec.data() + (int64_t)n * stride; }
};

// popcount of ~uni over a word run (the Fitch step count): uint64 pairs
// feed the hardware popcnt.
static inline int64_t count_steps(const uint32_t* uni, int64_t W)
{
    int64_t steps = 0, w = 0;
    for (; w + 2 <= W; w += 2) {
        uint64_t u;
        std::memcpy(&u, uni + w, 8);
        steps += __builtin_popcountll(~u);
    }
    for (; w < W; ++w)
        steps += __builtin_popcount(~uni[w]);
    return steps;
}

// Fitch join of children c1, c2 into `out`; returns the step count.
// out may alias neither child. (fitch.py _update_kernel semantics.)
// Word-contiguous inner loops so -O3 autovectorizes the
// AND/OR/ANDN passes.
static int64_t join(Ctx& c, const uint32_t* a, const uint32_t* b,
                    uint32_t* out)
{
    int64_t steps = 0;
    uint32_t* uni = c.uni.data();
    for (int64_t p = 0; p < c.P; ++p) {
        const int64_t S = c.states[p], W = c.W[p], off = c.poff[p];
        for (int64_t w = 0; w < W; ++w)
            uni[w] = a[off + w] & b[off + w];
        for (int64_t k = 1; k < S; ++k) {
            const uint32_t* ak = a + off + k * W;
            const uint32_t* bk = b + off + k * W;
            for (int64_t w = 0; w < W; ++w)
                uni[w] |= ak[w] & bk[w];
        }
        for (int64_t k = 0; k < S; ++k) {
            const uint32_t* ak = a + off + k * W;
            const uint32_t* bk = b + off + k * W;
            uint32_t* ok = out + off + k * W;
            for (int64_t w = 0; w < W; ++w)
                ok[w] = (ak[w] & bk[w]) | (~uni[w] & (ak[w] | bk[w]));
        }
        steps += count_steps(uni, W);
    }
    return steps;
}

// OR-of-ANDs edge score between two existing vectors (no join output).
static int64_t score(Ctx& c, const uint32_t* a, const uint32_t* b)
{
    int64_t steps = 0;
    uint32_t* uni = c.uni.data();
    for (int64_t p = 0; p < c.P; ++p) {
        const int64_t S = c.states[p], W = c.W[p], off = c.poff[p];
        for (int64_t w = 0; w < W; ++w)
            uni[w] = a[off + w] & b[off + w];
        for (int64_t k = 1; k < S; ++k) {
            const uint32_t* ak = a + off + k * W;
            const uint32_t* bk = b + off + k * W;
            for (int64_t w = 0; w < W; ++w)
                uni[w] |= ak[w] & bk[w];
        }
        steps += count_steps(uni, W);
    }
    return steps;
}

// Partial postorder over still-invalid directional vectors, emitting
// (parent, c1, c2) joins in dependency order (stepwise.py _partial_ops /
// utree.py traverse: rec(root.back) then rec(root)).
static void partial_rec(Ctx& c, int32_t n,
                        std::vector<std::array<int32_t, 3>>& ops);

static void partial_ops(Ctx& c, int32_t r,
                        std::vector<std::array<int32_t, 3>>& ops)
{
    partial_rec(c, c.back[r], ops);
    partial_rec(c, r, ops);
}

static void partial_rec(Ctx& c, int32_t n,
                        std::vector<std::array<int32_t, 3>>& ops)
{
    if (c.is_tip(n))
        return;
    if (c.valid[n])
        return;                          // prune: subtree still valid
    c.valid[n] = 1;
    for (int32_t s = c.next[n]; s != n; s = c.next[s])
        partial_rec(c, c.back[s], ops);
    ops.push_back({n, c.back[c.next[n]], c.back[c.next[c.next[n]]]});
}

// Mark every inner directional vector facing `root` valid (the
// post-insertion re-validation walk: traverse(tip.back) with no pruning).
static void revalidate_rec(Ctx& c, int32_t n)
{
    if (c.is_tip(n))
        return;
    for (int32_t s = c.next[n]; s != n; s = c.next[s])
        revalidate_rec(c, c.back[s]);
    c.valid[n] = 1;
}

static void invalidate_ring(Ctx& c, int32_t n)
{
    c.valid[n] = 0;
    for (int32_t s = c.next[n]; s != n; s = c.next[s])
        c.valid[s] = 0;
}

}  // namespace stepwise

extern "C" {

// Runs the full randomized stepwise-addition build. `tip_vecs` is
// [T * stride] uint32 (per tip: partitions packed at poff[p] + k*W[p]);
// `order` the pre-shuffled tip insertion order (utils/rng.py glibc
// stream). Fills back_out[node_count] with half-edge back-links (-1 =
// unlinked) from which the caller rebuilds the tree; returns the final
// parsimony score over informative sites (caller adds const costs).
int64_t pll_tpu_stepwise(const uint32_t* tip_vecs,
                         int64_t T,
                         int64_t P,
                         const int64_t* states,
                         const int64_t* W,
                         int64_t stride,
                         const int32_t* order,
                         int32_t* back_out)
{
    using namespace stepwise;
    if (T < 3)
        return -1;
    const int64_t node_count = T + 3 * (T - 2);
    std::vector<int64_t> poff(P);
    int64_t off = 0;
    for (int64_t p = 0; p < P; ++p) {
        poff[p] = off;
        off += states[p] * W[p];
    }

    Ctx c;
    c.T = T;
    c.stride = stride;
    c.P = P;
    c.states = states;
    c.W = W;
    c.poff = poff.data();
    c.vec.assign(node_count * stride, 0);
    c.cost.assign(node_count, 0);
    c.back.assign(node_count, -1);
    c.next.assign(node_count, -1);
    c.valid.assign(node_count, 0);
    c.tmp.assign(stride, 0);
    int64_t max_w = 1;
    for (int64_t p = 0; p < P; ++p)
        max_w = W[p] > max_w ? W[p] : max_w;
    c.uni.assign(max_w, 0);
    std::memcpy(c.vec.data(), tip_vecs,
                (size_t)T * stride * sizeof(uint32_t));

    // inner node i: half-edges T+3i+{0,1,2} in a ring (stepwise.py
    // _inner_create); the start trifurcation uses inner ordinal T-3
    auto base = [&](int64_t i) { return (int32_t)(T + 3 * i); };
    for (int64_t i = 0; i < T - 2; ++i) {
        c.next[base(i)] = base(i) + 1;
        c.next[base(i) + 1] = base(i) + 2;
        c.next[base(i) + 2] = base(i);
    }
    auto link = [&](int32_t a, int32_t b) { c.back[a] = b; c.back[b] = a; };

    const int32_t root = base(T - 3);
    link(root, order[0]);
    link(root + 1, order[1]);
    link(root + 2, order[2]);
    std::vector<int32_t> edges = {root, root + 1, root + 2};

    std::vector<std::array<int32_t, 3>> ops;
    int64_t cost = 0;
    for (int64_t i = 3; i < T; ++i) {
        const int32_t b0 = base(i - 3);
        const int32_t tip = order[i];

        // refresh invalid directional vectors via partial traversals
        // rooted at every tip-adjacent inner half-edge
        ops.clear();
        for (int32_t e : edges) {
            const int32_t r = c.is_tip(e) ? c.back[e] : e;
            if (c.is_tip(c.back[r]))
                partial_ops(c, r, ops);
        }
        for (const auto& op : ops) {
            const int64_t steps =
                join(c, c.v(op[1]), c.v(op[2]), c.v(op[0]));
            c.cost[op[0]] = steps + c.cost[op[1]] + c.cost[op[2]];
        }

        // score the tip against every edge; keep the FIRST minimum
        int64_t best = -1, best_score = 0;
        for (size_t j = 0; j < edges.size(); ++j) {
            const int32_t e1 = edges[j], e2 = c.back[e1];
            const int64_t s1 =
                join(c, c.v(e1), c.v(e2), c.tmp.data());
            const int64_t s =
                s1 + c.cost[e1] + c.cost[e2] + c.cost[tip] +
                score(c, c.tmp.data(), c.v(tip));
            if (best < 0 || s < best_score) {
                best = (int64_t)j;
                best_score = s;
            }
        }
        cost = best_score;

        // splice: link(a.back, inner.next); link(a, inner);
        // link(inner.next.next, tip)  (stepwise.py _edgesplit)
        const int32_t a = edges[best];
        link(c.back[a], b0 + 1);
        link(a, b0);
        link(b0 + 2, tip);
        edges.push_back(b0 + 1);
        edges.push_back(b0 + 2);

        // invalidate everything, re-validate the side kept by the insert
        for (int32_t e : edges)
            if (!c.is_tip(e))
                invalidate_ring(c, e);
        const int32_t tb = c.back[tip];
        revalidate_rec(c, c.back[tb]);
        revalidate_rec(c, tb);
        invalidate_ring(c, b0);
    }

    std::memcpy(back_out, c.back.data(),
                (size_t)node_count * sizeof(int32_t));
    return cost;
}

}  // extern "C"


// ---------------------------------------------------------------------
// Native SPR candidate builder.
//
// A radius-SPR round is host-bound in Python: per candidate move the
// Python path does pointer surgery (trees/moves.py spr), a ~2N-node
// postorder walk building the fused kernel's op table
// (ops/fused.py fused_candidate_from_tree), then a rollback, while the
// device idles. This routine runs
// the whole round's candidate construction in one call over flat
// half-edge arrays: for every prune edge it enumerates the radius-bounded
// regraft targets (identical DFS order to search.py _radius_targets),
// applies the SPR (identical semantics to trees/moves.py spr /
// libpll-2 src/utree_moves.c:119-255), emits the packed table +
// branch vector + root indices (identical layout and slot allocation to
// fused_candidate_from_tree), and rolls back.
//
// Half-edge ids: tips 0..T-1 (their clv index), inner node i owns ids
// T+3i+{0,1,2} in ring order. next[h] < 0 marks a tip.

namespace sprcand {

struct Tree {
    std::vector<int32_t> back;   // mutated by moves
    std::vector<int32_t> pmat;   // mutated by moves
    std::vector<double> len;     // mutated by moves
    const int32_t* next;
    const int32_t* clv;
    const int32_t* scaler;
    const int32_t* ctip;         // tip clv -> raw-CLV row, or nullptr
    int64_t T;

    bool is_tip(int32_t h) const { return next[h] < 0; }

    void link(int32_t a, int32_t b, double l, int32_t m) {
        back[a] = b; back[b] = a;
        len[a] = len[b] = l;
        pmat[a] = pmat[b] = m;
    }
};

struct Saved { int32_t h, back, pmat; double len; };

// trees/moves.py spr(): returns false when the move is a no-change.
static bool apply_spr(Tree& t, int32_t p, int32_t r, Saved* sv)
{
    const int32_t np = t.next[p], nnp = t.next[np];
    if (r == p || r == t.back[p] || r == np || r == t.back[np] ||
        r == nnp || r == t.back[nnp])
        return false;
    const int32_t u = t.back[np], v = t.back[nnp], rb = t.back[r];
    const int32_t touched[6] = {np, nnp, u, v, r, rb};
    for (int i = 0; i < 6; ++i) {
        const int32_t h = touched[i];
        sv[i] = {h, t.back[h], t.pmat[h], t.len[h]};
    }
    t.link(u, v, t.len[u] + t.len[v], t.pmat[u]);
    t.back[np] = t.back[nnp] = -1;
    const double half = sv[4].len / 2.0;      // r's pre-move length
    t.link(rb, nnp, half, sv[1].pmat);        // p.next.next's pmatrix
    t.link(r, np, half, sv[4].pmat);          // r's pmatrix
    return true;
}

static void undo_move(Tree& t, const Saved* sv, int n)
{
    for (int i = 0; i < n; ++i) {
        t.back[sv[i].h] = sv[i].back;
        t.pmat[sv[i].h] = sv[i].pmat;
        t.len[sv[i].h] = sv[i].len;
    }
}

// trees/moves.py nni() + _swap(): kind 1 = LEFT (p.back.next), kind 2 =
// RIGHT (p.back.next.next). Returns false on a terminal branch.
static bool apply_nni(Tree& t, int32_t p, int32_t kind, Saved* sv)
{
    if (t.is_tip(p) || t.back[p] < 0 || t.is_tip(t.back[p]))
        return false;
    const int32_t t1 = t.next[p];
    const int32_t pb = t.back[p];
    const int32_t t2 = (kind == 1) ? t.next[pb] : t.next[t.next[pb]];
    const int32_t b1 = t.back[t1], b2 = t.back[t2];
    const int32_t touched[4] = {t1, t2, b1, b2};
    for (int i = 0; i < 4; ++i) {
        const int32_t h = touched[i];
        sv[i] = {h, t.back[h], t.pmat[h], t.len[h]};
    }
    // _swap: each subtree keeps the branch to its NEW parent
    t.link(t1, b2, sv[3].len, sv[3].pmat);
    t.link(t2, b1, sv[2].len, sv[2].pmat);
    return true;
}

struct WalkScratch {
    std::vector<int32_t> slot_of;               // [n_clv], -1 = free
    std::vector<int32_t> touched;                // slots to reset
    std::vector<int32_t> free_slots;
    std::vector<std::pair<int32_t, uint8_t>> stack;
};

// ops/pallas_fused.fused_candidate_from_tree on flat arrays. Returns the
// slot count (>= 1) or -1 when the kernel cannot run this topology.
static int32_t pack_walk(Tree& t, int32_t vroot, WalkScratch& w,
                         int64_t n_rows,           // T-1 (table rows)
                         int32_t* table,           // [n_rows * 8], zeroed
                         double* blens,            // [n_matrices], zeroed
                         int32_t* root_out)        // [5]
{
    const int32_t vback = t.back[vroot];
    w.touched.clear();
    w.free_slots.clear();
    w.stack.clear();
    w.stack.push_back({vroot, 0});
    w.stack.push_back({vback, 0});
    int32_t n_slots = 0;
    int64_t row_i = 0;

    auto tip_hi = [&](int32_t ci, int32_t* is_tip_o, int32_t* idx_o) {
        if (t.ctip && t.ctip[ci] >= 0) { *is_tip_o = 2; *idx_o = t.ctip[ci]; }
        else { *is_tip_o = 1; *idx_o = ci; }
    };
    auto fail = [&]() {
        for (int32_t ci : w.touched) w.slot_of[ci] = -1;
        return (int32_t)-1;
    };

    while (!w.stack.empty()) {
        const auto [h, done] = w.stack.back();
        w.stack.pop_back();
        const bool tip = t.is_tip(h);
        if (!done && !tip) {
            w.stack.push_back({h, 1});
            w.stack.push_back({t.back[t.next[t.next[h]]], 0});
            w.stack.push_back({t.back[t.next[h]], 0});
            continue;
        }
        if (h != vback)
            blens[t.pmat[h]] = t.len[h];
        if (tip)
            continue;
        if (t.scaler[h] < 0)
            return fail();
        if (row_i >= n_rows - 1)
            return fail();                          // non-binary artifact
        int32_t* row = table + row_i * 8;
        const int32_t kids[2] = {t.back[t.next[h]],
                                 t.back[t.next[t.next[h]]]};
        int32_t freed[2];
        int n_freed = 0;
        for (int pos = 0; pos < 2; ++pos) {
            const int32_t c = kids[pos];
            const int32_t ci = t.clv[c];
            if (ci < (int32_t)t.T) {
                tip_hi(ci, &row[1 + 3 * pos], &row[2 + 3 * pos]);
            } else {
                const int32_t s = w.slot_of[ci];
                if (s < 0)
                    return fail();                  // not a postorder
                w.slot_of[ci] = -1;                 // consumed exactly once
                row[1 + 3 * pos] = 0;
                row[2 + 3 * pos] = s;
                freed[n_freed++] = s;
            }
            row[3 + 3 * pos] = t.pmat[c];
        }
        for (int i = 0; i < n_freed; ++i)
            w.free_slots.push_back(freed[i]);
        int32_t ps;
        if (!w.free_slots.empty()) {
            ps = w.free_slots.back();
            w.free_slots.pop_back();
        } else {
            ps = n_slots++;
        }
        w.slot_of[t.clv[h]] = ps;
        w.touched.push_back(t.clv[h]);
        row[0] = ps;
        row[7] = 1;
        ++row_i;
    }
    if (row_i != n_rows - 1)
        return fail();                              // not a full traversal

    int32_t* last = table + row_i * 8;
    const int32_t ends[2] = {vroot, vback};
    for (int pos = 0; pos < 2; ++pos) {
        const int32_t ci = t.clv[ends[pos]];
        if (ci < (int32_t)t.T) {
            tip_hi(ci, &last[2 * pos], &last[1 + 2 * pos]);
        } else {
            if (w.slot_of[ci] < 0)
                return fail();
            last[2 * pos] = 0;
            last[1 + 2 * pos] = w.slot_of[ci];
        }
    }
    root_out[0] = t.clv[vroot];
    root_out[1] = t.scaler[vroot];
    root_out[2] = t.clv[vback];
    root_out[3] = t.scaler[vback];
    root_out[4] = t.pmat[vroot];
    for (int32_t ci : w.touched)
        w.slot_of[ci] = -1;
    return n_slots > 0 ? n_slots : 1;
}

}  // namespace sprcand

extern "C" {

// One call = one search round's candidate construction: for each move
// (kind 0 = SPR(a=prune, b=regraft); kind 1/2 = NNI-left/right on edge
// a), apply it, emit the packed fused-kernel candidate, roll back. The
// caller enumerates the moves (radius BFS / subsampling are cheap; this
// walk is the 95% host cost). `kept_out[k]` is 1 when move k produced a
// candidate (0 = rejected no-change/terminal move); outputs are written
// densely in kept order. Returns the number of candidates written, or
// -1 when a topology cannot be packed (caller falls back to Python).
int64_t pll_tpu_move_candidates(
    const int32_t* back, const int32_t* next_, const int32_t* clv,
    const int32_t* scaler, const int32_t* pmat, const double* length,
    int64_t H, int64_t T, int64_t n_clv,
    const int32_t* ctip_rows,                 // [T] or NULL
    const int32_t* moves_in, int64_t n_moves, // [n_moves, 3] (kind, a, b)
    int32_t vroot, int64_t n_matrices,
    int32_t* tables_out,                      // [n_moves, T-1, 8]
    double* blens_out,                        // [n_moves, n_matrices]
    int32_t* roots_out,                       // [n_moves, 5]
    int32_t* slots_out,                       // [n_moves]
    uint8_t* kept_out)                        // [n_moves]
{
    using namespace sprcand;
    Tree t;
    t.back.assign(back, back + H);
    t.pmat.assign(pmat, pmat + H);
    t.len.assign(length, length + H);
    t.next = next_;
    t.clv = clv;
    t.scaler = scaler;
    t.ctip = ctip_rows;
    t.T = T;

    WalkScratch w;
    w.slot_of.assign(n_clv, -1);
    const int64_t n_rows = T - 1;

    Saved sv[6];
    int64_t count = 0;
    for (int64_t k = 0; k < n_moves; ++k) {
        const int32_t kind = moves_in[k * 3];
        const int32_t a = moves_in[k * 3 + 1], b = moves_in[k * 3 + 2];
        kept_out[k] = 0;
        int n_saved;
        if (kind == 0) {
            if (t.is_tip(a) || t.back[b] < 0)
                continue;
            if (!apply_spr(t, a, b, sv))
                continue;
            n_saved = 6;
        } else {
            if (!apply_nni(t, a, kind, sv))
                continue;
            n_saved = 4;
        }
        int32_t* table = tables_out + count * n_rows * 8;
        double* blens = blens_out + count * n_matrices;
        std::memset(table, 0, (size_t)(n_rows * 8) * 4);
        std::memset(blens, 0, (size_t)n_matrices * 8);
        const int32_t ns = pack_walk(t, vroot, w, n_rows, table, blens,
                                     roots_out + count * 5);
        undo_move(t, sv, n_saved);
        if (ns < 0)
            return -1;
        slots_out[count] = ns;
        kept_out[k] = 1;
        ++count;
    }
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Native streamed-SPR schedule builder.
//
// ops/spr_stream.build_spr_stream is the host cost of a streamed search
// round in Python (the per-group target walk, the directional up-pass
// recursion and the greedy wave packing). This is the SAME construction on
// the flat half-edge arrays (bit-identical tables by design — the Python
// builder remains as fallback and as the parity oracle): enumeration
// order matches search._internal_edges + spr_stream.enumerate_targets,
// row emission order matches build_spr_stream's recursion and group
// loops, and wave assignment replicates pack_waves' greedy fill.
// Subsample rng parity stays in Python (the caller passes per-group
// kept-index lists); table padding/bucketing is vectorized numpy.

namespace sprstream {

// pack_waves' greedy wave assignment: an op lands in the earliest
// non-full wave strictly after all of its deps (up to 2, -1 = none).
static int64_t assign_waves(const int32_t* deps, int64_t n_deps,
                            int64_t n, int64_t width, int32_t* wave_out,
                            std::vector<int32_t>& fills)
{
    fills.clear();
    for (int64_t i = 0; i < n; ++i) {
        int64_t w = 0;
        for (int64_t j = 0; j < n_deps; ++j) {
            const int32_t d = deps[i * n_deps + j];
            if (d >= 0 && wave_out[d] + 1 > w)
                w = wave_out[d] + 1;
        }
        while (w < (int64_t)fills.size() && fills[w] >= width)
            ++w;
        while (w >= (int64_t)fills.size())
            fills.push_back(0);
        wave_out[i] = (int32_t)w;
        fills[w] += 1;
    }
    return (int64_t)fills.size();
}

}  // namespace sprstream

extern "C" {

// Radius-limited SPR target enumeration for every internal edge, in
// search._internal_edges x spr_stream.enumerate_targets order.
// tgt_parent: -1 = arrival via p.next, -2 = via p.next.next, else the
// in-group index of the arrival target. Returns the group count, or -1
// when a buffer would overflow (caller re-allocates).
int64_t pll_tpu_spr_stream_enum(
    const int32_t* back, const int32_t* next_, int64_t H, int64_t T,
    int32_t radius,
    int32_t* prune_out, int64_t* group_off,
    int32_t* tgt_out, int32_t* tgt_parent, int32_t* tgt_sib,
    int64_t ub_groups, int64_t ub_targets)
{
    std::vector<uint8_t> seen(H, 0);
    struct Item { int32_t nd, code, d; };
    std::vector<Item> stack;
    int64_t ng = 0, nt = 0;
    for (int64_t h = T; h < H; ++h) {
        const int32_t b = back[h];
        if (b < T)
            continue;                    // tip neighbour or unlinked
        if (seen[h] || seen[b])
            continue;
        seen[h] = 1;
        if (ng >= ub_groups)
            return -1;
        prune_out[ng] = (int32_t)h;
        group_off[ng] = nt;
        const int32_t pn = next_[h], pnn = next_[pn];
        stack.clear();
        if (back[pn] >= 0)
            stack.push_back({back[pn], -1, 1});
        if (back[pnn] >= 0)
            stack.push_back({back[pnn], -2, 1});
        while (!stack.empty()) {
            const Item it = stack.back();
            stack.pop_back();
            if (it.nd < T || it.d >= radius)
                continue;
            const int32_t c1 = next_[it.nd], c2 = next_[c1];
            const int32_t hs[2] = {c1, c2}, sb[2] = {c2, c1};
            for (int k = 0; k < 2; ++k) {
                const int32_t hh = hs[k];
                if (back[hh] < 0)
                    continue;
                if (nt >= ub_targets)
                    return -1;
                tgt_out[nt] = hh;
                tgt_parent[nt] = it.code;
                tgt_sib[nt] = sb[k];
                const int32_t my_idx = (int32_t)(nt - group_off[ng]);
                ++nt;
                stack.push_back({back[hh], my_idx, it.d + 1});
            }
        }
        ++ng;
    }
    group_off[ng] = nt;
    return ng;
}

// One call = one streamed round's schedule: directional up rows,
// postorder refresh rows, per-group corrected-CLV (A) rows, candidate
// rows and greedy wave assignments (see the namespace comment). kept /
// kept_off hold the caller's ORDERED per-group candidate index lists
// (rng-subsample order is score order). Outputs are dense; counts_out =
// [n_post, n_up, n_a, n_cand, n_merged, n_aux]. Returns 0.
int64_t pll_tpu_spr_stream_build(
    const int32_t* back, const int32_t* next_, const int32_t* clv,
    const int32_t* scaler, const int32_t* pmat, const double* length,
    int64_t H, int64_t T, int32_t vroot, int64_t width,
    const int32_t* prune, const int64_t* group_off,
    const int32_t* tgt, const int32_t* tgt_parent, const int32_t* tgt_sib,
    int64_t n_groups,
    const int32_t* kept, const int64_t* kept_off,
    int64_t n_nodes, int64_t n_scalers, int64_t n_edges,
    int32_t* post_rows, int32_t* post_wave,
    int32_t* up_rows, int32_t* up_wave,
    int32_t* a_rows, int32_t* a_wave,
    int32_t* cand, double* half_len, double* merged_len,
    int32_t* pair_prune, int32_t* pair_tgt,
    int32_t* rowmap_clv, int32_t* rowmap_sc,
    int64_t* counts_out)
{
    using sprstream::assign_waves;
    const int32_t vback = back[vroot];
    auto down_sc = [&](int32_t h) {
        const int32_t s = scaler[h];
        return s >= 0 ? s : -1;
    };

    // directional up pass (build_spr_stream recurse): aux row per
    // child-side half-edge, dep = the up op producing the parent-side row
    int64_t n_aux = 0, n_up = 0;
    std::vector<int32_t> updep;
    struct RItem { int32_t u, pmatv, prow, psc, pop; };
    std::vector<RItem> rstack;
    rowmap_clv[vroot] = clv[vroot];
    rowmap_sc[vroot] = down_sc(vroot);
    rowmap_clv[vback] = clv[vback];
    rowmap_sc[vback] = down_sc(vback);
    auto recurse = [&](int32_t u0, int32_t pm0, int32_t pr0, int32_t ps0,
                       int32_t po0) {
        rstack.clear();
        rstack.push_back({u0, pm0, pr0, ps0, po0});
        while (!rstack.empty()) {
            const RItem it = rstack.back();
            rstack.pop_back();
            rowmap_clv[it.u] = clv[it.u];
            rowmap_sc[it.u] = down_sc(it.u);
            if (it.u < T)
                continue;
            const int32_t n1 = next_[it.u], n2 = next_[n1];
            const int32_t hcs[2] = {n1, n2}, sibs[2] = {n2, n1};
            for (int k = 0; k < 2; ++k) {
                const int32_t hc = hcs[k], hsib = sibs[k];
                const int32_t crow = (int32_t)(n_nodes + n_aux);
                const int32_t csc = (int32_t)(n_scalers + n_aux);
                ++n_aux;
                rowmap_clv[hc] = crow;
                rowmap_sc[hc] = csc;
                const int32_t sb = back[hsib];
                int32_t* r = up_rows + n_up * 8;
                r[0] = crow; r[1] = csc;
                r[2] = it.prow; r[3] = it.pmatv; r[4] = it.psc;
                r[5] = clv[sb]; r[6] = pmat[hsib]; r[7] = down_sc(sb);
                updep.push_back(it.pop);
                const int32_t opi = (int32_t)n_up;
                ++n_up;
                rstack.push_back({back[hc], pmat[hc], crow, csc, opi});
            }
        }
    };
    const int32_t rmat = pmat[vroot];
    recurse(vback, rmat, clv[vroot], down_sc(vroot), -1);
    recurse(vroot, rmat, clv[vback], down_sc(vback), -1);

    // postorder refresh rows (traverse + create_operations order)
    int64_t n_post = 0;
    std::vector<int32_t> postdep;
    std::vector<int32_t> producer(n_nodes, -1);
    std::vector<std::pair<int32_t, uint8_t>> pstack;
    auto post_walk = [&](int32_t r0) {
        pstack.clear();
        pstack.push_back({r0, 0});
        while (!pstack.empty()) {
            const auto [nd, done] = pstack.back();
            pstack.pop_back();
            if (nd < T)
                continue;
            if (!done) {
                pstack.push_back({nd, 1});
                const int32_t n1 = next_[nd], n2 = next_[n1];
                pstack.push_back({back[n2], 0});
                pstack.push_back({back[n1], 0});
                continue;
            }
            const int32_t c1 = back[next_[nd]];
            const int32_t c2 = back[next_[next_[nd]]];
            int32_t* r = post_rows + n_post * 8;
            r[0] = clv[nd]; r[1] = down_sc(nd);
            r[2] = clv[c1]; r[3] = pmat[c1]; r[4] = down_sc(c1);
            r[5] = clv[c2]; r[6] = pmat[c2]; r[7] = down_sc(c2);
            postdep.push_back(producer[clv[c1]]);
            postdep.push_back(producer[clv[c2]]);
            producer[clv[nd]] = (int32_t)n_post;
            ++n_post;
        }
    };
    post_walk(back[vroot]);
    post_walk(vroot);

    // corrected-CLV pass + candidate rows per prune group
    const int64_t base_a = n_nodes + n_aux;
    const int64_t sc_a = n_scalers + n_aux;
    int64_t n_a = 0, n_cand = 0, n_merged = 0;
    std::vector<int32_t> adep;
    std::vector<int32_t> arr_row, arr_sc, arr_mat, arr_op;
    std::vector<int32_t> slot_row, slot_sc;
    std::vector<uint8_t> needed;
    for (int64_t g = 0; g < n_groups; ++g) {
        const int64_t t0 = group_off[g], gsz = group_off[g + 1] - t0;
        const int64_t k0 = kept_off[g], k1 = kept_off[g + 1];
        if (gsz == 0 || k1 == k0)
            continue;
        const int32_t p = prune[g];
        const int32_t pn = next_[p], pnn = next_[pn];
        needed.assign(gsz, 0);
        for (int64_t k = k0; k < k1; ++k) {
            int32_t cur = kept[k];
            while (cur >= 0 && !needed[cur]) {
                needed[cur] = 1;
                cur = tgt_parent[t0 + cur];
            }
        }
        const int32_t mi = (int32_t)(n_edges + n_merged);
        merged_len[n_merged] = length[back[pn]] + length[back[pnn]];
        ++n_merged;
        const int32_t pb = back[p];
        arr_row.assign(2 + gsz, 0);
        arr_sc.assign(2 + gsz, 0);
        arr_mat.assign(2 + gsz, 0);
        arr_op.assign(2 + gsz, -1);
        arr_row[0] = rowmap_clv[back[pnn]];
        arr_sc[0] = rowmap_sc[back[pnn]];
        arr_mat[0] = mi;
        arr_row[1] = rowmap_clv[back[pn]];
        arr_sc[1] = rowmap_sc[back[pn]];
        arr_mat[1] = mi;
        slot_row.assign(gsz, -1);
        slot_sc.assign(gsz, -1);
        for (int64_t i = 0; i < gsz; ++i) {
            if (!needed[i])
                continue;
            const int32_t code = tgt_parent[t0 + i];
            const int64_t ai = code == -1 ? 0 : code == -2 ? 1 : 2 + code;
            const int32_t sib = tgt_sib[t0 + i], sb = back[sib];
            const int32_t arow = (int32_t)(base_a + n_a);
            const int32_t asc = (int32_t)(sc_a + n_a);
            int32_t* r = a_rows + n_a * 8;
            r[0] = arow; r[1] = asc;
            r[2] = arr_row[ai]; r[3] = arr_mat[ai]; r[4] = arr_sc[ai];
            r[5] = rowmap_clv[sb]; r[6] = pmat[sib]; r[7] = rowmap_sc[sb];
            adep.push_back(arr_op[ai]);
            const int32_t tt = tgt[t0 + i];
            arr_row[2 + i] = arow;
            arr_sc[2 + i] = asc;
            arr_mat[2 + i] = pmat[tt];
            arr_op[2 + i] = (int32_t)n_a;
            slot_row[i] = arow;
            slot_sc[i] = asc;
            ++n_a;
        }
        for (int64_t k = k0; k < k1; ++k) {
            const int32_t i = kept[k];
            const int32_t tt = tgt[t0 + i], tb = back[tt];
            int32_t* c = cand + n_cand * 7;
            c[0] = slot_row[i]; c[1] = slot_sc[i];
            c[2] = rowmap_clv[tb]; c[3] = rowmap_sc[tb];
            c[4] = rowmap_clv[pb]; c[5] = rowmap_sc[pb];
            c[6] = pmat[p];
            half_len[n_cand] = length[tt] / 2.0;
            pair_prune[n_cand] = p;
            pair_tgt[n_cand] = tt;
            ++n_cand;
        }
    }

    std::vector<int32_t> fills;
    assign_waves(postdep.data(), 2, n_post, width, post_wave, fills);
    assign_waves(updep.data(), 1, n_up, width, up_wave, fills);
    assign_waves(adep.data(), 1, n_a, width, a_wave, fills);

    counts_out[0] = n_post;
    counts_out[1] = n_up;
    counts_out[2] = n_a;
    counts_out[3] = n_cand;
    counts_out[4] = n_merged;
    counts_out[5] = n_aux;
    return 0;
}

}  // extern "C"
