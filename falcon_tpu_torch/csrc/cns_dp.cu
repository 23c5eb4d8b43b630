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
//   kept column.  One warp per row takes 32 columns a step; ballots,
//   popcounts and shuffles stand in for the cumsum/cummax of the JAX
//   decode, and the carries between steps stay in registers.  A first pass
//   counts the row's columns for the keep gate.  The move and base streams
//   are [., B]: a warp reads bytes B apart, so the reads are sector-bound;
//   the four rows of a block share those sectors through L1/L2.  Integer
//   atomics make the counts independent of order, hence bit-equal run to
//   run.
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
// - K6 is latency-bound: each step reads the pred code that the previous
//   step pointed at.  One thread per group; the walk needs no step cap,
//   since every step either emits, moves down a delta level (at most D a
//   column) or moves to t - 1.  Prefetching bp along the likely path is
//   later work.
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
// One warp per row b.  Column k (START->END order) is stream index
// S - 1 - k of the END->START packed moves.
__global__ void ftt_tags_kernel(uint16_t* __restrict__ msa,
                                const uint8_t* __restrict__ mvp,
                                const int8_t* __restrict__ basep,
                                const int* __restrict__ bd,
                                const int* __restrict__ gidx,
                                const int* __restrict__ s2, int B, int P,
                                int G, int T, int D, float max_diff) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= B) return;                       // the whole warp leaves
    const int g = gidx[b];
    if (g < 0 || g >= G) return;
    const int S = 4 * P;
    int n = 0;                                // ncols: non-inactive moves
    for (int p = lane; p < P; p += 32) {
        const int x = mvp[(size_t)p * B + b];
        n += ((x & 3) != 3) + (((x >> 2) & 3) != 3) +
             (((x >> 4) & 3) != 3) + ((x >> 6) != 3);
    }
    for (int o = 16; o; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
    if (!(n > 500 && (float)bd[b] < __fmul_rn(max_diff, (float)n))) return;

    unsigned int* words = reinterpret_cast<unsigned int*>(msa);
    const long long l0sz = (long long)G * T * 5 * NPC0;
    const unsigned lt = (1u << lane) - 1u;
    const unsigned le = lt | (1u << lane);
    const int tpos0 = s2[b] - 1;
    int cq = 0;          // q-consuming columns so far
    int nadv = 0;        // t-advancing columns so far
    int cq_at_adv = 0;   // cq at the last t-advancing column
    int prev = -1;       // (k << 7 | delta << 3 | base) of the last kept
    for (int k0 = 0; k0 < S; k0 += 32) {
        const int k = k0 + lane;
        int m = 3, base = 4;
        if (k < S) {
            const int i = S - 1 - k;
            m = (mvp[(size_t)(i >> 2) * B + b] >> (2 * (i & 3))) & 3;
            base = basep[(size_t)k * B + b];
        }
        const bool valid = m != 3;
        const bool adv = m == 0 || m == 1;
        const unsigned bq = __ballot_sync(FULL, m == 0 || m == 2);
        const unsigned ba = __ballot_sync(FULL, adv);
        const int cq_k = cq + __popc(bq & le);
        const int tpos = tpos0 + nadv + __popc(ba & le);
        const unsigned ba_le = ba & le;
        const int cq_src = __shfl_sync(FULL, cq_k,
                                       ba_le ? 31 - __clz(ba_le) : 0);
        const int delta = adv ? 0 : cq_k - (ba_le ? cq_src : cq_at_adv);
        const unsigned bb =
            __ballot_sync(FULL, valid && (delta >= D || tpos < 0));
        const bool ok = valid && !(bb & le);
        const int enc = ok ? (k << 7) | (delta << 3) | base : -1;
        const unsigned bo = __ballot_sync(FULL, ok);
        const unsigned bo_lt = bo & lt;
        const int enc_src = __shfl_sync(FULL, enc,
                                        bo_lt ? 31 - __clz(bo_lt) : 0);
        const int pv = bo_lt ? enc_src : prev;
        if (ok && tpos < T) {                 // ok implies tpos >= 0
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
        cq += __popc(bq);
        nadv += __popc(ba);
        if (ba) cq_at_adv = __shfl_sync(FULL, cq_k, 31 - __clz(ba));
        if (bo) prev = __shfl_sync(FULL, enc, 31 - __clz(bo));
        if (bb) break;       // every later column of the row is dropped
    }
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
__global__ void ftt_cns_walk_kernel(const uint8_t* __restrict__ bp,
                                    const int* __restrict__ cov,
                                    const float* __restrict__ gb_s,
                                    const int* __restrict__ gb_t,
                                    const int* __restrict__ gb_d,
                                    const int* __restrict__ gb_b,
                                    int min_cov, int G, int T, int D,
                                    uint8_t* __restrict__ out,
                                    int* __restrict__ counts) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= G) return;
    const int cap = 2 * T;
    uint8_t* row = out + (size_t)g * cap;
    int t = gb_t[g], d = gb_d[g], b = gb_b[g], ck = b, n = 0;
    bool done = gb_s[g] == -1.0f;
    while (!done) {
        const int code = bp[((size_t)t * G + g) * (D * 5) + d * 5 + b];
        if (code >= 250) break;               // the path's start
        if (ck != 4 && n < cap)
            row[n++] = (uint8_t)(ck + (cov[(size_t)g * T + t] <= min_cov
                                       ? 5 : 0));
        if (code < 128) {                     // jump to (t-1, pd, pb)
            b = code % 5;
            d = code / 5;
            --t;
        } else {                              // stay at (t, d-1, pb)
            b = code - 128;
            --d;
        }
        ck = b;
        done = t < 0 || n >= cap;
    }
    counts[g] = n;
}

// msa: flat uint16 [msa_size(G, T, D)], 4-byte aligned; mvp [P, B] uint8;
// basep [4P, B] int8; bd, gidx, s2 [B] int32.  Returns cudaGetLastError().
extern "C" int ftt_tags(void* msa, const void* mvp, const void* basep,
                        const void* bd, const void* gidx, const void* s2,
                        int B, int P, int G, int T, int D, float max_diff,
                        void* stream) {
    const int rows = 4;   // warps (rows) a block
    ftt_tags_kernel<<<(B + rows - 1) / rows, 32 * rows, 0,
                      (cudaStream_t)stream>>>(
        (uint16_t*)msa, (const uint8_t*)mvp, (const int8_t*)basep,
        (const int*)bd, (const int*)gidx, (const int*)s2, B, P, G, T, D,
        max_diff);
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
    const int threads = 128;
    ftt_cns_walk_kernel<<<(G + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)bp, (const int*)cov, (const float*)gb_s,
        (const int*)gb_t, (const int*)gb_d, (const int*)gb_b, min_cov, G, T,
        D, (uint8_t*)out, (int*)counts);
    return (int)cudaGetLastError();
}
