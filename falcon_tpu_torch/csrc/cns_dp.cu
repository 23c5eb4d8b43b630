// K4 + K5 + K6: the device-DP consensus (tag accumulation, forward scan,
// backtrack walk) for one DP batch of G seed groups padded to T columns.
//
// K4 ftt_tags_kernel replaces falcon_tpu/ops/cns_dp.py
// accumulate_tags_planes (with _column_tags_planes); K5
// ftt_cns_scan_kernel its consensus_scan (the sequential within-t chain);
// K6 ftt_cns_walk_kernel its backtrack + compact_emit, equivalently
// backtrack_walk with no step cap.  Plain twins:
// falcon_tpu_torch/ops/cns_dp.py.  None of the three was a Pallas kernel;
// on the TPU they are XLA scans and cumsums.
//
// Counts are uint16 in the flat [L0 | Ld | dump] buffer of falcon_tpu
// (msa_size).  CUDA has no 16-bit integer atomicAdd, so K4 adds 1 << 16*h
// to the aligned 32-bit word holding the count; a count stays below 2^16
// (it is bounded by one group's alignments), so no carry crosses halves.
// Tags of dead rows and out-of-range columns are dropped: the dump slot
// stays 0.
//
// What bounds them on the H100, and what the design does about it:
// - K4 is a scan along each row's column stream (running counts, a
//   first-bad latch, the last kept column) plus one scattered atomic per
//   kept column.  The streams are [., B]: a row's bytes lie B apart, so
//   one row's loads are sector-bound and, taken in stream order behind
//   its carries, latency-bound too.  So a block takes a few adjacent rows,
//   neighbouring lanes on neighbouring rows (one sector serves several),
//   and cuts each row into segments, a thread a segment: a row's work
//   spreads over several warps.  Three passes, with a barrier between:
//   (1) each segment counts its q-consuming, advancing and active columns
//   and notes its last advancing and last active column; composed in
//   segment order in shared memory these give every segment its carries
//   in, the row its keep gate (folded into this first pass) and every
//   segment the last active column before it; (2) each segment finds its
//   first column with delta >= D or tpos < 0 from its carries; (3) every
//   segment before the row's first such column adds its tags.  A thread
//   loads its next chunk of moves (and bases) before it decodes the
//   current one, so no load waits on a carry.  Integer atomics make the
//   counts independent of order, hence bit-equal run to run.
// - K5 is latency-bound: T dependent columns per group, each a chain of
//   up to D - 1 dependent levels of 5 x 6 max/argmax behind a delta-0
//   level of 5 x 16.  A launch has fewer groups than the card has warp
//   schedulers, and a warp that runs alone starts an instruction every
//   three or four clocks, so what shortens a launch is fewer instructions
//   on the warp that carries the chain.  One block per group: a chain warp
//   and three front warps, each on a scheduler of its own (a fourth front
//   would share the chain's), handing columns over through six slots of
//   shared memory guarded by named barriers.  (1) A front takes every
//   third column: it turns the column's counts (loaded two of its columns
//   ahead into registers) into float addends, a count of 0 as -inf so
//   that "no link" needs no branch, and finds with one warp reduction
//   each the coverage and dmax, the highest level that holds any count.
//   (2) The chain keeps S_cur[d][b] in lane b's register: a level is five
//   shuffles, six adds, a max tree, and the argmax as the first candidate
//   equal to the max, with no branch or shared-memory round trip; the best
//   delta >= 2 predecessor and the lane's best cell so far are running
//   first-maxima updated as each level finishes.  (3) Levels above dmax
//   are not run: with no count there every score is -1.0 and every code
//   255 whatever the level below held; the -1.0 enters the delta >= 2
//   maximum at the first such level, and never the group's best, which
//   only a score above -1.0 replaces.  (4) The chain touches no device
//   memory but the group's best cell after the last column: the front that
//   owns a slot stores the finished column's codes as one pass over
//   bp[t, g, :] when it takes the slot back, and the coverage as it
//   computes it.
// - K6 is latency-bound: each step reads the pred code that the step
//   before chose, and a device-memory read costs ~690 clocks.  But the walk
//   never moves forward (it stays in column t or moves to t - 1), so the
//   bytes it needs are known in order: a warp a group copies the columns
//   ahead of the walk into a ring of shared-memory windows with cp.async,
//   and the step's dependent read is a shared-memory load (~29 clocks).
//   The step decodes the code arithmetically (a jump code is the next
//   cell's byte in its column), and the emitted codes leave through a
//   shared buffer, 16 bytes a lane, off the chain.  The walk needs no step
//   cap: every step emits, moves down a delta level (at most D a column)
//   or moves to t - 1.  It takes bp as K5 writes it: stay codes only at
//   d >= 1, jump codes to a level below D.
//
// Every score is a multiple of 0.5 far below 2^23, so float32 adds are
// exact; a class with no link is skipped, where the twin's NEG candidate
// never wins; the halving is __fmul_rn so that it cannot be contracted.
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int NPC0 = 16;
constexpr int NPCD = 6;
constexpr int DMAX = 16;   // delta fits the 4-bit field of the latch
constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_FRONTS = 3;                   // K5: front warps a group
constexpr int SCAN_SLOTS = 6;                    // hand-over slots, a multiple
                                                 // of the fronts; 2 * slots
                                                 // named barriers, 15 at most
constexpr int SCAN_THREADS = 32 * (1 + SCAN_FRONTS);
constexpr int SCAN_AHEAD = 2;                    // columns a front loads ahead
constexpr int SCAN_L0W = 5 * NPC0 / 2;           // 32-bit words of a column's
constexpr int SCAN_LDW = 5 * NPCD / 2;           // L0 row, of one Ld level
constexpr int SCAN_WORDS = SCAN_L0W + (DMAX - 1) * SCAN_LDW;   // 265
constexpr int SCAN_PER_LANE = (SCAN_WORDS + 31) / 32;
constexpr int SCAN_ADD = SCAN_PER_LANE * 64;     // addends: two a word
}  // namespace

// ---------------------------------------------------------------- K4 ----
// A block takes `rows` adjacent rows b0 .. b0 + rows - 1 and cuts each
// row's column stream into `segs` segments of sb = ceil(P / segs) packed
// move bytes (4 columns a byte; segment s holds bytes [s * sb, (s + 1) *
// sb) counted from the START end).  Thread tid = s * rows + r takes
// segment s of row b0 + r, so that neighbouring lanes read neighbouring
// bytes of the [P, B] and [4P, B] streams.  Column k (START->END order) is
// stream index S - 1 - k of the END->START packed moves: byte P - 1 - k/4,
// bits 6 - 2 (k % 4).  Move m: 3 inactive, 0 and 1 advance t, 0 and 2
// consume q.

// Segment counts of pass 1, one int a thread each (shared memory).
enum { TAG_CONS, TAG_ADV, TAG_CQA, TAG_VALID, TAG_LAST, TAG_CQL, TAG_BASE,
       TAG_FIELDS };

constexpr int TAG_CHUNK = 4;   // move bytes a thread loads ahead

// Bytes [j, j + TAG_CHUNK) of the row's moves (and with BASES their
// columns' q bases) into registers; bytes at or past j1 read as inactive.
template <bool BASES>
__device__ __forceinline__ void ftt_tags_load(
    const uint8_t* __restrict__ mvp, const int8_t* __restrict__ basep,
    int b, int B, int P, int j, int j1, uint32_t (&mv)[TAG_CHUNK],
    int (&bs)[4 * TAG_CHUNK]) {
#pragma unroll
    for (int u = 0; u < TAG_CHUNK; ++u) {
        const bool in = j + u < j1;
        mv[u] = in ? mvp[(size_t)(P - 1 - (j + u)) * B + b] : 0xffu;
        if (BASES) {
#pragma unroll
            for (int v = 0; v < 4; ++v)
                bs[4 * u + v] =
                    in ? basep[(size_t)(4 * (j + u) + v) * B + b] : 0;
        }
    }
}

// Passes 2 and 3 over bytes [j0, j1) of one row, from the carries in: cq
// q-consuming and na t-advancing columns before the segment, cqa the cq at
// the last advancing one.  Pass 2 (EMIT false) returns the segment's first
// column with delta >= D or tpos < 0, or -1.  Pass 3 (EMIT true) adds the
// tags of the columns before `stop` (-1: none), pv being the last kept
// column's (k << 7 | delta << 3 | base) before the segment, or -1.  The
// next chunk's loads are issued before the current chunk is decoded, so no
// load waits on a carry.
template <bool EMIT>
__device__ int ftt_tags_scan(
    const uint8_t* __restrict__ mvp, const int8_t* __restrict__ basep,
    unsigned int* __restrict__ words, int b, int B, int P, int j0, int j1,
    int cq, int na, int cqa, int pv, int stop, int tpos0, int g, int T,
    int D, long long l0sz) {
    uint32_t mv[TAG_CHUNK], nmv[TAG_CHUNK];
    int bs[4 * TAG_CHUNK], nbs[4 * TAG_CHUNK];
    ftt_tags_load<EMIT>(mvp, basep, b, B, P, j0, j1, mv, bs);
    for (int j = j0; j < j1; j += TAG_CHUNK) {
        ftt_tags_load<EMIT>(mvp, basep, b, B, P, j + TAG_CHUNK, j1, nmv,
                            nbs);
#pragma unroll
        for (int u = 0; u < 4 * TAG_CHUNK; ++u) {
            const int m = (mv[u >> 2] >> (6 - 2 * (u & 3))) & 3;
            if (m == 3) continue;
            const int k = 4 * j + u;
            const bool adv = m < 2;
            cq += m != 1;
            if (adv) {
                ++na;
                cqa = cq;
            }
            const int delta = cq - cqa;       // 0 on an advancing column
            const int tpos = tpos0 + na;
            if (!EMIT) {
                if (delta >= D || tpos < 0) return k;
                continue;
            }
            if (k == stop) return stop;
            const int base = bs[u];
            if (tpos < T) {                   // tpos >= 0 before `stop`
                const bool pe = pv >= 0;
                const int pbase = pv & 7;
                const long long gT = (long long)g * T + tpos;
                long long idx;
                if (adv) {
                    const int pc0 = pe ? min((pv >> 3) & 15, 2) * 5 + pbase
                                       : NPC0 - 1;
                    idx = gT * (5 * NPC0) + base * NPC0 + pc0;
                } else {
                    const int pcd = pe ? pbase : NPCD - 1;
                    idx = l0sz + (gT * (D - 1) + (delta - 1)) * (5 * NPCD) +
                          base * NPCD + pcd;
                }
                atomicAdd(words + (idx >> 1), 1u << (16 * (int)(idx & 1)));
            }
            pv = (k << 7) | (delta << 3) | base;
        }
#pragma unroll
        for (int u = 0; u < TAG_CHUNK; ++u) mv[u] = nmv[u];
        if (EMIT) {
#pragma unroll
            for (int u = 0; u < 4 * TAG_CHUNK; ++u) bs[u] = nbs[u];
        }
    }
    return -1;
}

// Shared memory of a K4 block: the pass-1 fields and the first bad
// columns, an int a thread each.
__host__ __device__ inline size_t ftt_tags_smem(int rows, int segs) {
    return (size_t)(TAG_FIELDS + 1) * rows * segs * sizeof(int);
}

constexpr int TAG_THREADS = 512;   // most threads a K4 block takes

__global__ void __launch_bounds__(TAG_THREADS)
ftt_tags_kernel(uint16_t* __restrict__ msa, const uint8_t* __restrict__ mvp,
                const int8_t* __restrict__ basep, const int* __restrict__ bd,
                const int* __restrict__ gidx, const int* __restrict__ s2,
                int B, int P, int G, int T, int D, float max_diff, int rows,
                int segs) {
    extern __shared__ int tag_smem[];
    const int nt = rows * segs;
    const int tid = threadIdx.x;
    const int r = tid % rows;
    const int b = blockIdx.x * rows + r;
    const bool live = b < B;
    const int sb = (P + segs - 1) / segs;
    const int j0 = min(tid / rows * sb, P), j1 = min(j0 + sb, P);
    int* f = tag_smem;                        // [TAG_FIELDS][nt]
    int* badf = tag_smem + TAG_FIELDS * nt;   // [nt]

    // ---- pass 1: the segment's counts; the q-consuming count up to its
    // last advancing column and up to its last active column, that
    // column's index and base
    int cons = 0, adv = 0, cqa = -1, valid = 0, last = -1, cql = 0, lb = 0;
    if (live) {
        uint32_t mv[TAG_CHUNK], nmv[TAG_CHUNK];
        int none[4 * TAG_CHUNK];
        ftt_tags_load<false>(mvp, basep, b, B, P, j0, j1, mv, none);
        for (int j = j0; j < j1; j += TAG_CHUNK) {
            ftt_tags_load<false>(mvp, basep, b, B, P, j + TAG_CHUNK, j1,
                                 nmv, none);
#pragma unroll
            for (int u = 0; u < TAG_CHUNK; ++u) {
                // the field at bit 2e holds column 4 (j + u) + 3 - e
                const uint32_t x = mv[u];
                const uint32_t lo = x & 0x55u, hi = (x >> 1) & 0x55u;
                const uint32_t am = ~hi & 0x55u;          // advancing
                const uint32_t qm = ~lo & 0x55u;          // q-consuming
                const uint32_t vm = ~(lo & hi) & 0x55u;   // active
                if (am) cqa = cons + __popc(qm >> (__ffs(am) - 1));
                if (vm) {
                    const int e = __ffs(vm) - 1;          // the latest
                    last = 4 * (j + u) + 3 - (e >> 1);
                    cql = cons + __popc(qm >> e);
                }
                cons += __popc(qm);
                adv += __popc(am);
                valid += __popc(vm);
                mv[u] = nmv[u];
            }
        }
        if (last >= 0) lb = basep[(size_t)last * B + b];
    }
    f[TAG_CONS * nt + tid] = cons;
    f[TAG_ADV * nt + tid] = adv;
    f[TAG_CQA * nt + tid] = cqa;
    f[TAG_VALID * nt + tid] = valid;
    f[TAG_LAST * nt + tid] = last;
    f[TAG_CQL * nt + tid] = cql;
    f[TAG_BASE * nt + tid] = lb;
    __syncthreads();

    // ---- the carries into this segment, the row's active columns and the
    // last active column before the segment, composed in segment order
    int cq = 0, na = 0, cqa_in = 0, pv = -1, ncols = 0;
    for (int e = r; e < nt; e += rows) {
        ncols += f[TAG_VALID * nt + e];
        if (e >= tid) continue;
        const int el = f[TAG_LAST * nt + e], ea = f[TAG_CQA * nt + e];
        if (el >= 0) {
            const int dl = f[TAG_CQL * nt + e] - (ea >= 0 ? ea : cqa_in - cq);
            pv = (el << 7) | (dl << 3) | f[TAG_BASE * nt + e];
        }
        if (ea >= 0) cqa_in = cq + ea;
        cq += f[TAG_CONS * nt + e];
        na += f[TAG_ADV * nt + e];
    }
    const int g = live ? gidx[b] : -1;
    const bool keep = live && g >= 0 && g < G && ncols > 500 &&
                      (float)bd[b] < __fmul_rn(max_diff, (float)ncols);
    const int tpos0 = keep ? s2[b] - 1 : 0;
    const long long l0sz = (long long)G * T * 5 * NPC0;
    unsigned int* words = reinterpret_cast<unsigned int*>(msa);

    // ---- pass 2: the segment's first column that drops the rest of the
    // row
    const int bad = keep ? ftt_tags_scan<false>(
        mvp, basep, words, b, B, P, j0, j1, cq, na, cqa_in, -1, -1, tpos0,
        g, T, D, l0sz) : -1;
    badf[tid] = bad;
    __syncthreads();

    // ---- pass 3: the tags of every segment up to the row's first bad
    // column
    if (!keep) return;
    for (int e = r; e < tid; e += rows)
        if (badf[e] >= 0) return;
    ftt_tags_scan<true>(mvp, basep, words, b, B, P, j0, j1, cq, na, cqa_in,
                        pv, bad, tpos0, g, T, D, l0sz);
}

// ---------------------------------------------------------------- K5 ----
// One column's hand-over between a front warp and the chain warp: the
// column's addends, one float per count in the counts' own order (L0
// [b][16], then Ld [d-1][b][6]), its coverage and highest level in use, and
// the pred codes on their way back.
struct __align__(16) ScanSlot {
    float add[SCAN_ADD];
    int cov, dmax, pad[2];
    uint8_t code[DMAX * 5 + 16];
};

// Named barriers of a block (0 is __syncthreads'): column t's slot is
// t % SCAN_SLOTS; `full` is passed when its addends are written, `done`
// when its codes are.  Each pairs the chain warp with the one front warp
// that owns the slot: 64 threads.
__device__ __forceinline__ int ftt_scan_full(int slot) { return 1 + slot; }
__device__ __forceinline__ int ftt_scan_done(int slot) {
    return 1 + SCAN_SLOTS + slot;
}
__device__ __forceinline__ void ftt_bar_wait(int id) {
    asm volatile("bar.sync %0, 64;" :: "r"(id) : "memory");
}
__device__ __forceinline__ void ftt_bar_signal(int id) {
    __threadfence_block();               // this warp's writes, then the count
    asm volatile("bar.arrive %0, 64;" :: "r"(id) : "memory");
}

// Word w of step t's counts: L0 row (w < 40), then Ld row; 0 past the end.
__device__ __forceinline__ void ftt_scan_load(
    const unsigned int* __restrict__ words, long long w0, long long wd,
    int nw, int lane, unsigned int (&pre)[SCAN_PER_LANE]) {
#pragma unroll
    for (int j = 0; j < SCAN_PER_LANE; ++j) {
        const int w = lane + 32 * j;
        pre[j] = w < SCAN_L0W ? __ldcs(words + w0 + w)
               : (w < nw ? __ldcs(words + wd + (w - SCAN_L0W)) : 0u);
    }
}

// (float)n for a count n < 2^16 without the conversion unit: n in the
// mantissa of 2^23, minus 2^23 (exact).
__device__ __forceinline__ float ftt_count_float(unsigned int n) {
    return __int_as_float(0x4b000000u | n) - 8388608.0f;
}

// The first maximum of two candidates in index order: (b, ib) replaces
// (a, ia), ia < ib, only if it is strictly greater.
__device__ __forceinline__ void ftt_first_max(float& a, int& ia, float b,
                                              int ib) {
    const bool take = b > a;
    a = take ? b : a;
    ia = take ? ib : ia;
}

// The codes of a finished column leave as one pass of the warp over
// bp[t, g, :]; the levels the chain did not run hold 255: no link,
// whatever the level below held.
__device__ __forceinline__ void ftt_scan_store_codes(
    const ScanSlot& S, int D, int lane, uint8_t* __restrict__ bpt) {
    const int run = (S.dmax + 1) * 5;
#pragma unroll
    for (int j = 0; j < (DMAX * 5 + 31) / 32; ++j) {
        const int i = lane + 32 * j;
        if (i < D * 5) bpt[i] = i < run ? S.code[i] : (uint8_t)255;
    }
}

// A front warp: columns p, p + SCAN_FRONTS, ... of group g.  For each it
// takes back the slot (storing the codes of the column that held it),
// writes the column's addends, coverage and dmax, and hands the slot over.
__device__ void ftt_scan_front(ScanSlot* slots, int p, int lane,
                               const unsigned int* __restrict__ words,
                               int g, int G, int T, int D,
                               uint8_t* __restrict__ bp,
                               int* __restrict__ cov) {
    const float NINF = __int_as_float(0xff800000);
    const int ldw_step = (D - 1) * SCAN_LDW;              // Ld words a column
    const int nw = SCAN_L0W + ldw_step;
    const long long l0w = (long long)g * T * SCAN_L0W;
    const long long ldw = (long long)G * T * SCAN_L0W +
                          (long long)g * T * ldw_step;
    const size_t bp_step = (size_t)G * (D * 5);
    uint8_t* bpg = bp + (size_t)g * (D * 5);
    int* covrow = cov + (size_t)g * T;
    unsigned int pre[SCAN_AHEAD][SCAN_PER_LANE];
#pragma unroll
    for (int u = 0; u < SCAN_AHEAD; ++u) {
        const int t = p + u * SCAN_FRONTS;
        if (t < T)
            ftt_scan_load(words, l0w + (long long)t * SCAN_L0W,
                          ldw + (long long)t * ldw_step, nw, lane, pre[u]);
    }
    for (int t0 = p; t0 < T; t0 += SCAN_AHEAD * SCAN_FRONTS) {
#pragma unroll
        for (int u = 0; u < SCAN_AHEAD; ++u) {
            const int t = t0 + u * SCAN_FRONTS;
            if (t >= T) break;
            const int slot = t % SCAN_SLOTS;
            ScanSlot& S = slots[slot];
            if (t >= SCAN_SLOTS) {
                ftt_bar_wait(ftt_scan_done(slot));
                ftt_scan_store_codes(S, D, lane,
                                     bpg + (size_t)(t - SCAN_SLOTS) * bp_step);
                __syncwarp();            // the old dmax is read by all lanes
            }
            int c = 0, lvl = 0;
#pragma unroll
            for (int j = 0; j < SCAN_PER_LANE; ++j) {
                const int w = lane + 32 * j;
                const unsigned int x = pre[u][j];
                const unsigned int lo = x & 0xffffu, hi = x >> 16;
                float2 v;
                v.x = lo ? ftt_count_float(lo) : NINF;   // 0: no link
                v.y = hi ? ftt_count_float(hi) : NINF;
                *reinterpret_cast<float2*>(&S.add[2 * w]) = v;
                if (w < SCAN_L0W) c += (int)(lo + hi);
                else if (x) lvl = (w - SCAN_L0W) / SCAN_LDW + 1;
            }
            const int tn = t + SCAN_AHEAD * SCAN_FRONTS;
            if (tn < T)
                ftt_scan_load(words, l0w + (long long)tn * SCAN_L0W,
                              ldw + (long long)tn * ldw_step, nw, lane,
                              pre[u]);
            c = __reduce_add_sync(FULL, c);
            lvl = __reduce_max_sync(FULL, lvl);     // highest level in use
            if (lane == 0) {
                S.cov = c;
                S.dmax = lvl;
                covrow[t] = c;
            }
            ftt_bar_signal(ftt_scan_full(slot));
        }
    }
    // the columns whose slots no later column took back
    int t = T > SCAN_SLOTS ? T - SCAN_SLOTS : 0;
    t += ((p - t) % SCAN_FRONTS + SCAN_FRONTS) % SCAN_FRONTS;
    for (; t < T; t += SCAN_FRONTS) {
        const int slot = t % SCAN_SLOTS;
        ftt_bar_wait(ftt_scan_done(slot));
        ftt_scan_store_codes(slots[slot], D, lane, bpg + (size_t)t * bp_step);
    }
}

// The chain warp: every column of group g in order, from the slots.  Lane
// b < 5 owns base b (lanes 5-31 mirror lane 4); its state is the scores of
// the column before, S_prev[0][b], S_prev[1][b] and the first maximum of
// S_prev[2 ..][b] with its level, and the lane's best cell so far.
__device__ void ftt_scan_chain(ScanSlot* slots, int lane, int g, int T,
                               int D, float* __restrict__ gb_s,
                               int* __restrict__ gb_t,
                               int* __restrict__ gb_d,
                               int* __restrict__ gb_b) {
    const float NINF = __int_as_float(0xff800000);
    const int bl = lane < 5 ? lane : 4;
    float s0 = -1.0f, s1 = -1.0f, s2p = -1.0f, gbs = -1.0f;
    int a2 = 2, gbt = 0, gbd = 0;
    for (int t = 0; t < T; ++t) {
        const int slot = t % SCAN_SLOTS;
        ScanSlot& S = slots[slot];
        ftt_bar_wait(ftt_scan_full(slot));
        const int dmax = S.dmax;
        const float half = __fmul_rn(0.5f, (float)S.cov);

        // ---- delta 0: 16 pred classes, their scores by shuffle
        float cand[NPC0];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            cand[k] = __shfl_sync(FULL, s0, k);
            cand[5 + k] = __shfl_sync(FULL, s1, k);
            cand[10 + k] = __shfl_sync(FULL, s2p, k);
        }
        cand[NPC0 - 1] = 0.0f;
        const float4* a0 = reinterpret_cast<const float4*>(S.add + bl * NPC0);
#pragma unroll
        for (int i = 0; i < NPC0 / 4; ++i) {
            const float4 a = a0[i];
            cand[4 * i] += a.x;
            cand[4 * i + 1] += a.y;
            cand[4 * i + 2] += a.z;
            cand[4 * i + 3] += a.w;
        }
        // a tournament over neighbours in index order keeps the first
        // maximum
        int idx[NPC0];
#pragma unroll
        for (int k = 0; k < NPC0; ++k) idx[k] = k;
#pragma unroll
        for (int w = 1; w < NPC0; w *= 2)
#pragma unroll
            for (int k = 0; k < NPC0; k += 2 * w)
                ftt_first_max(cand[k], idx[k], cand[k + w], idx[k + w]);
        const int arg0 = idx[0];
        const bool ex0 = cand[0] > NINF;
        float sp = ex0 ? cand[0] - half : -1.0f;   // S_cur[d - 1][b]
        const int cls = (arg0 >= 5) + (arg0 >= 10) + (arg0 >= 15);
        const int pb = arg0 - 5 * cls;
        const int a2v = __shfl_sync(FULL, a2, pb);
        if (sp > gbs) { gbs = sp; gbt = t; gbd = 0; }
        const float ns0 = sp;
        float ns1 = -1.0f, r2 = NINF;
        int r2a = 2;

        // ---- the within-t chain, levels 1 .. dmax; a level's addends are
        // loaded while the level before it runs
        const float* ap = S.add + 5 * NPC0 + bl * NPCD;
        float2 a01 = *reinterpret_cast<const float2*>(ap);
        float2 a23 = *reinterpret_cast<const float2*>(ap + 2);
        float2 a45 = *reinterpret_cast<const float2*>(ap + 4);
        for (int d = 1; d <= dmax; ++d) {
            ap += 5 * NPCD;
            const float2 n01 = *reinterpret_cast<const float2*>(ap);
            const float2 n23 = *reinterpret_cast<const float2*>(ap + 2);
            const float2 n45 = *reinterpret_cast<const float2*>(ap + 4);
            const float c0 = __shfl_sync(FULL, sp, 0) + a01.x;
            const float c1 = __shfl_sync(FULL, sp, 1) + a01.y;
            const float c2 = __shfl_sync(FULL, sp, 2) + a23.x;
            const float c3 = __shfl_sync(FULL, sp, 3) + a23.y;
            const float c4 = __shfl_sync(FULL, sp, 4) + a45.x;
            const float c5 = a45.y;                   // the start class: 0 + n
            const float m =
                fmaxf(fmaxf(fmaxf(c0, c1), fmaxf(c2, c3)), fmaxf(c4, c5));
            const bool ex = m > NINF;
            sp = ex ? m - half : -1.0f;
            const int arg = c0 == m ? 0 : c1 == m ? 1 : c2 == m ? 2
                          : c3 == m ? 3 : c4 == m ? 4 : 5;
            if (lane < 5)
                S.code[d * 5 + lane] =
                    (uint8_t)(ex && arg != NPCD - 1 ? 128 + arg : 255);
            ns1 = d == 1 ? sp : ns1;
            if (d >= 2 && sp > r2) { r2 = sp; r2a = d; }
            if (sp > gbs) { gbs = sp; gbt = t; gbd = d; }
            a01 = n01;
            a23 = n23;
            a45 = n45;
        }
        if (lane < 5)
            S.code[lane] = (uint8_t)(
                !ex0 || arg0 == NPC0 - 1 ? 254
                                         : (cls < 2 ? cls : a2v) * 5 + pb);
        ftt_bar_signal(ftt_scan_done(slot));
        // the first level above the chain holds -1.0 and stands for every
        // level the chain did not run
        const int df = dmax + 1 > 2 ? dmax + 1 : 2;
        if (df < D && -1.0f > r2) { r2 = -1.0f; r2a = df; }
        s0 = ns0;
        s1 = ns1;
        s2p = r2;
        a2 = r2a;
    }
    // the five lanes' bests -> the group's: highest score, earliest t, then
    // the lowest flat index d * 5 + b
    float bs = lane < 5 ? gbs : NINF;
    int bt = gbt, bd = gbd, bb = lane;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        const float os = __shfl_xor_sync(FULL, bs, o);
        const int ot = __shfl_xor_sync(FULL, bt, o);
        const int od = __shfl_xor_sync(FULL, bd, o);
        const int ob = __shfl_xor_sync(FULL, bb, o);
        if (os > bs || (os == bs && (ot < bt || (ot == bt &&
                (od < bd || (od == bd && ob < bb)))))) {
            bs = os; bt = ot; bd = od; bb = ob;
        }
    }
    if (lane == 0) {
        gb_s[g] = bs;
        gb_t[g] = bt;
        gb_d[g] = bd;
        gb_b[g] = bb;
    }
}

// One block per group: warp 0 runs the chain, warps 1 .. SCAN_FRONTS the
// fronts.
__global__ void __launch_bounds__(SCAN_THREADS)
ftt_cns_scan_kernel(const uint16_t* __restrict__ msa, int G, int T, int D,
                    uint8_t* __restrict__ bp, int* __restrict__ cov,
                    float* __restrict__ gb_s, int* __restrict__ gb_t,
                    int* __restrict__ gb_d, int* __restrict__ gb_b) {
    __shared__ ScanSlot slots[SCAN_SLOTS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = blockIdx.x;
    if (warp == 0)
        ftt_scan_chain(slots, lane, g, T, D, gb_s, gb_t, gb_d, gb_b);
    else
        ftt_scan_front(slots, warp - 1, lane,
                       reinterpret_cast<const unsigned int*>(msa), g, G, T,
                       D, bp, cov);
}

// ---------------------------------------------------------------- K6 ----
// A warp walks one group; all 32 lanes run the same walk on broadcast
// shared-memory reads.  The walk only ever stays in column t or moves to
// t - 1, so the columns it needs are gb_t, gb_t - 1, ..., 0 in that order:
// a ring of WALK_RING windows of C = WALK_WINDOW columns holds the current
// window and the two after it, filled by cp.async.  Window w holds columns
// gb_t - w*C down to max(gb_t - w*C - C + 1, 0), column gb_t - w*C - c at
// index c of slot w % WALK_RING: the cw 4-byte words from the one holding
// bp[t, g, 0] (a column starts at byte (t*G + g) * D*5, 1- or 2-byte
// aligned) and cov[g, t].  When the walk enters window w + 1 the warp
// refills window w's slot with window w + WALK_RING and waits for window
// w + 1 only.  The emitted codes gather in a WALK_OUT-byte buffer that the
// warp writes out 16 bytes a lane.  Shared memory is addressed by offsets into walk_smem,
// so that every access is a shared-memory instruction with a 32-bit
// address.

constexpr int WALK_WARPS = 4;     // groups a block
constexpr int WALK_WINDOW = 32;   // columns a window
constexpr int WALK_RING = 3;      // windows a warp holds
constexpr int WALK_OUT = 512;     // emitted codes a warp buffers

extern __shared__ __align__(16) uint8_t walk_smem[];

__device__ __forceinline__ void ftt_cp_async4(int dst, const void* src,
                                              int n) {
    const unsigned s =
        (unsigned)__cvta_generic_to_shared(walk_smem + dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

// Words of a column's 4-byte-aligned superset, for any alignment.
__host__ __device__ constexpr int ftt_walk_words(int D) {
    return (D * 5 + 6) >> 2;
}

// Bytes of shared memory a warp of K6 takes: the ring's columns and
// coverage, then the output buffer at a 16-byte boundary.  At D = DMAX a
// block takes 35,840 bytes, within the 48 KiB a launch gets unasked.
__host__ __device__ constexpr int ftt_walk_ring_bytes(int D) {
    return (WALK_RING * WALK_WINDOW * (4 * ftt_walk_words(D) + 4) + 15) &
           ~15;
}
__host__ __device__ constexpr int ftt_walk_warp_bytes(int D) {
    return ftt_walk_ring_bytes(D) + WALK_OUT;
}
static_assert(WALK_WARPS * ftt_walk_warp_bytes(DMAX) <= 48 * 1024,
              "K6's shared memory needs an opt-in");

// Queue window w's copies as one cp.async group (empty past column 0):
// columns at offset cols, coverage at covs.  A word past the end of bp
// is zero-filled, not read.
__device__ void ftt_walk_fill(int cols, int covs,
                              const uint8_t* __restrict__ bp,
                              const int* __restrict__ cov, uintptr_t bp_end,
                              int g, int G, int T, int D, int top, int w,
                              int lane) {
    constexpr int C = WALK_WINDOW;
    const int hi = top - w * C;
    if (hi >= 0) {
        // a lane a column: its words are one run of addresses
        const int cw = ftt_walk_words(D);
        const int n = min(C, hi + 1);
        const int slot = w % WALK_RING;
        for (int c = lane; c < n; c += 32) {
            uintptr_t a =
                (uintptr_t)(bp + ((size_t)(hi - c) * G + g) * (D * 5)) &
                ~(uintptr_t)3;
            const int dst = cols + (slot * C + c) * cw * 4;
            for (int k = 0; k < cw; ++k, a += 4) {
                const uintptr_t rest = a < bp_end ? bp_end - a : 0;
                const int left = rest < 4 ? (int)rest : 4;
                ftt_cp_async4(dst + 4 * k, left ? (const void*)a
                                                : (const void*)cov, left);
            }
            ftt_cp_async4(covs + 4 * (slot * C + c),
                          cov + (size_t)g * T + hi - c, 4);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ftt_walk_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(WALK_RING - 1)
                 : "memory");
    __syncwarp();
}

// Bytes [0, n) of the output buffer (at offset obuf) to dst, n <=
// WALK_OUT; 16 bytes a lane for a full buffer at a 16-byte-aligned dst.
__device__ __forceinline__ void ftt_walk_flush(int obuf, uint8_t* dst, int n,
                                               int lane) {
    __syncwarp();
    if (n == WALK_OUT && !((uintptr_t)dst & 15))
        reinterpret_cast<uint4*>(dst)[lane] =
            reinterpret_cast<const uint4*>(walk_smem + obuf)[lane];
    else
        for (int i = lane; i < n; i += 32) dst[i] = walk_smem[obuf + i];
    __syncwarp();
}

// A step is one shared-memory read and selects: a stay and a jump take the
// same instructions, the next cell's read is issued before the step's
// bookkeeping, and only the rare events (a full output buffer, the walk's
// end, a new window) branch.
__global__ void __launch_bounds__(32 * WALK_WARPS)
ftt_cns_walk_kernel(const uint8_t* __restrict__ bp,
                    const int* __restrict__ cov,
                    const float* __restrict__ gb_s,
                    const int* __restrict__ gb_t,
                    const int* __restrict__ gb_d,
                    const int* __restrict__ gb_b, int min_cov, int G, int T,
                    int D, uint8_t* __restrict__ out,
                    int* __restrict__ counts) {
    constexpr int C = WALK_WINDOW;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = blockIdx.x * WALK_WARPS + warp;
    if (g >= G) return;                       // the whole warp leaves
    if (gb_s[g] == -1.0f) {                   // no path
        if (lane == 0) counts[g] = 0;
        return;
    }
    const int cw4 = 4 * ftt_walk_words(D);    // bytes of a column's words
    const int slot_bytes = C * cw4;
    const int cols = warp * ftt_walk_warp_bytes(D);
    const int covs = cols + WALK_RING * slot_bytes;
    const int obuf = cols + ftt_walk_ring_bytes(D);
    const uintptr_t bp_end = (uintptr_t)(bp + (size_t)T * G * (D * 5));
    const int top = gb_t[g];
    for (int w = 0; w < WALK_RING; ++w)
        ftt_walk_fill(cols, covs, bp, cov, bp_end, g, G, T, D, top, w,
                      lane);
    ftt_walk_wait();

    // the low two bits of column t's address place it in its words
    const unsigned gd5 = (unsigned)G * (D * 5);
    unsigned a32 = (unsigned)(uintptr_t)bp + ((unsigned)top * G + g) * (D * 5);
    const int cap = 2 * T;
    uint8_t* row = out + (size_t)g * cap;
    int t = top, w = 0, slot = 0, c = 0, n = 0;
    int ck = gb_b[g];                         // the cell's base
    int o = gb_d[g] * 5 + ck;                 // the cell's byte in column t
    int cb = cols;                            // column t's words
    int col = cb + (a32 & 3);                 // column t's byte 0
    int nxt = cb + cw4 + ((a32 - gd5) & 3);   // column t - 1's, same window
    int cvp = covs;                           // cov[g, t]
    int low = *reinterpret_cast<const int*>(walk_smem + cvp) <= min_cov
                  ? 5 : 0;
    int code = walk_smem[col + o];
    for (;;) {
        const bool start = code >= 250;       // the path's start
        const bool jump = code < 128;         // to (t-1, code/5, code%5)
        o = jump ? code : o + code - 128 - ck - 5;   // else stay at d - 1
        col = jump ? nxt : col;
        // the next cell's code, read before this step's bookkeeping; a new
        // window reads it again (the read stays inside the warp's shared
        // memory, and its value is not used when the walk ends here)
        int next = walk_smem[col + o];
        const bool em = ck != 4 && !start;
        walk_smem[obuf + (n & (WALK_OUT - 1))] = (uint8_t)(ck + low);
        n += em;
        ck = jump ? code - 5 * ((code * 205) >> 10) : code - 128;
        t -= jump;
        c += jump;
        a32 -= jump ? gd5 : 0u;
        cb += jump ? cw4 : 0;
        cvp += jump ? 4 : 0;
        const bool full = em && !(n & (WALK_OUT - 1));
        if (start | full | (n >= cap) | (t < 0) | (c == C)) {
            if (full)
                ftt_walk_flush(obuf, row + n - WALK_OUT, WALK_OUT, lane);
            if (start || n >= cap || t < 0) break;
            if (c == C) {                     // into window w + 1
                // every lane's reads of window w's slot come before the
                // copies that refill it
                __syncwarp();
                ftt_walk_fill(cols, covs, bp, cov, bp_end, g, G, T, D, top,
                              w + WALK_RING, lane);
                ++w;
                c = 0;
                slot = slot + 1 == WALK_RING ? 0 : slot + 1;
                ftt_walk_wait();
                cb = cols + slot * slot_bytes;
                cvp = covs + 4 * slot * C;
                col = cb + (a32 & 3);
                next = walk_smem[col + o];
            }
        }
        nxt = cb + cw4 + ((a32 - gd5) & 3);
        low = *reinterpret_cast<const int*>(walk_smem + cvp) <= min_cov
                  ? 5 : 0;
        code = next;
    }
    ftt_walk_flush(obuf, row + (n & ~(WALK_OUT - 1)), n & (WALK_OUT - 1),
                   lane);
    if (lane == 0) counts[g] = n;
}

// msa: flat uint16 [msa_size(G, T, D)], 4-byte aligned; mvp [P, B] uint8;
// basep [4P, B] int8; bd, gidx, s2 [B] int32; a block takes `rows` rows
// and cuts each into `segs` segments (rows * segs <= TAG_THREADS).  Returns
// cudaGetLastError().
extern "C" int ftt_tags(void* msa, const void* mvp, const void* basep,
                        const void* bd, const void* gidx, const void* s2,
                        int B, int P, int G, int T, int D, float max_diff,
                        int rows, int segs, void* stream) {
    ftt_tags_kernel<<<(B + rows - 1) / rows, rows * segs,
                      ftt_tags_smem(rows, segs), (cudaStream_t)stream>>>(
        (uint16_t*)msa, (const uint8_t*)mvp, (const int8_t*)basep,
        (const int*)bd, (const int*)gidx, (const int*)s2, B, P, G, T, D,
        max_diff, rows, segs);
    return (int)cudaGetLastError();
}

// bp [T, G, D*5] uint8; cov [G, T] int32; gb_s [G] float; gb_t/d/b [G].
extern "C" int ftt_cns_scan(const void* msa, int G, int T, int D, void* bp,
                            void* cov, void* gb_s, void* gb_t, void* gb_d,
                            void* gb_b, void* stream) {
    ftt_cns_scan_kernel<<<G, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)msa, G, T, D, (uint8_t*)bp, (int*)cov,
        (float*)gb_s, (int*)gb_t, (int*)gb_d, (int*)gb_b);
    return (int)cudaGetLastError();
}

// out [G, 2T] uint8 (zeroed by the caller), counts [G] int32.
extern "C" int ftt_cns_walk(const void* bp, const void* cov,
                            const void* gb_s, const void* gb_t,
                            const void* gb_d, const void* gb_b, int min_cov,
                            int G, int T, int D, void* out, void* counts,
                            void* stream) {
    const int smem = WALK_WARPS * ftt_walk_warp_bytes(D);
    ftt_cns_walk_kernel<<<(G + WALK_WARPS - 1) / WALK_WARPS,
                          32 * WALK_WARPS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)bp, (const int*)cov, (const float*)gb_s,
        (const int*)gb_t, (const int*)gb_d, (const int*)gb_b, min_cov, G, T,
        D, (uint8_t*)out, (int*)counts);
    return (int)cudaGetLastError();
}
