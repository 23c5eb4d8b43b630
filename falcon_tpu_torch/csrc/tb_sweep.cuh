// Warp-resident banded anti-diagonal edit DP: with a two-bit trace (K2,
// TRACE = true) and without one (K1, TRACE = false; extend.cu).
//
// The DP is ops/align_device.py extend_batch's: anti-diagonal s = i + j,
// band cell l holds i = o(s) + l with o(s) = max(0, s/2 - W/2), j = s - i,
// edit costs 1, row 0 and column 0 forced, and the end-cell rule below.
// One warp sweeps one row, and lane n holds the C = W/32 consecutive band
// cells l = n*C .. n*C + C - 1 of anti-diagonals s-1 and s-2 in registers.
// The window offset moves by 0 or 1 per step, so a step needs one cell of
// a neighbouring lane per operand (shuffles) and no barrier; the C cells
// of a lane are independent and give the instruction-level parallelism
// that hides the arithmetic latency.  C is any of 1 .. 32 without the
// trace (K1: every multiple of 32 up to 1024 is one warp), and divides 16
// with it (K2's warp route).
//
// The sweep is bound by instruction issue, so a step is compiled three
// ways and the warp picks one per step (the choice depends on s, qlen and
// tlen alone, so a warp never diverges).  Interior steps -- every cell of
// the band a DP cell with 1 <= i < qlen and 1 <= j < tlen, and the window
// already moving (s >= W + 4) -- are the bulk of a long row; there the
// mask, the forced row 0 / column 0, the end-cell scoring and the clamp
// all fall away, d2 is 1 and d1 is the parity of s, fixed at compile time
// (FTT_TB_FAST0, FTT_TB_FAST1).  Every other step runs the general form
// (FTT_TB_EDGE).
//
// q and t reach the cells through two per-warp rings in shared memory.
// A chunk of FTT_TB_CHUNK steps reads only ring bytes; the bytes the next
// chunk needs are loaded into registers before the chunk's first step and
// stored into the rings after its last, so no cell waits on device memory.
// Registers and not cp.async carry them: a ring byte's place wraps and the
// first C are mirrored, byte by byte, the bytes in flight would need a
// ring twice the size (the chunk still reads the places they land on), and
// a lane's share is 7 loads and 7 stores per 128 steps, none of them on a
// step's dependent chain.
// A ring of R bytes holds the last R of its sequence: a chunk's cells span
// at most W + FTT_TB_CHUNK + 1 of t and W + FTT_TB_CHUNK/2 + 1 of q.  The
// first C bytes are mirrored behind the ring, so a lane's C consecutive
// bytes are read at fixed offsets from one wrapped base.  Ring bytes that
// were never loaded (index < 0 or >= L) are only read by cells that are
// masked (outside [0, qlen] x [0, tlen]) or forced (row 0, column 0), so
// their value is never used.
// Shared memory serves a warp's byte reads by 32-bit words, one word a
// bank a pass: lane n reads bytes nC + c, so at C = 16 a read touches 4
// words in a bank and at C = 32 eight (2 at most at every other C from 5
// to 31, 1 below), and the sweep without the trace ran at the rate of
// those passes (one warp at W 1024: 112 ms at the extender's (4096, 8192)
// on an H100, tools/tb_compare.py).  So without the trace, from C = 16 on,
// a step reads the lane's q and t runs as C/4 + 1 aligned words each,
// funnel-shifts them into place and compares four cells by one xor: ~8x
// fewer passes at C = 32 for about one more integer operation a cell
// (W 1024: 112 -> 37 ms; W 512: 28.8 -> 14.4 ms).  The mirror then covers
// what the words reach, 4 * ceil(C/4) bytes.  Below C = 16, and in K2,
// the byte reads stay: at most two words a bank, and the words measured
// 5-9% slower at C 3, and 8% slower and 6% faster at the extender's two
// shapes at C 8.
//
// The trace is two bits a cell (0 = diag, 1 = up, 2 = left; masked cells
// store 0) and never leaves its lane on the way out: a lane packs the
// moves of its own C cells, step after step, into one 32-bit word, which
// is full after G = 16/C steps, and the warp stores its 32 words as one
// 128-byte line.  trace[b][(s-1)/G][n] holds, for lane n, field
// ((s-1) % G) * C + c in bits 2*field and 2*field + 1: the move of band
// cell n*C + c at step s.  No ballot, no staging, one store per G steps;
// a step is W/4 bytes.  A row stores only the words of the steps it
// sweeps, s = 1 .. min(qlen + tlen, 2L).
//
// End cell: every lane keeps its best boundary cell with strict >, cells in
// i order, so within a lane ties go to the earliest s and then the lowest
// i; a butterfly of shuffles picks the winner by (highest score, earliest
// s, lowest i).  A row with no scored cell returns (0, 0, 0).
//
// Without the trace (TRACE = false) the step keeps the same three forms,
// rings and end-cell rule and drops the move bits, the trace word and its
// store: an interior cell is then the compare, the add and the two mins of
// the recurrence, and min(side + 1, v_diag) is Hopper's fused add-min
// (__viaddmin_s32), under 1% faster there.  With the trace the plain min
// stays: the fused form measured no faster at the short batch shape and 5%
// slower at the long one.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define FTT_INF (1 << 20)
#define FTT_NEG (-(1 << 30))
#define FTT_TB_CHUNK 128
#define FTT_TB_FULL 0xffffffffu
#define FTT_TB_EDGE 0
#define FTT_TB_FAST0 1          // interior step, d1 = 0 (s odd)
#define FTT_TB_FAST1 2          // interior step, d1 = 1 (s even)

// Ring bytes per sequence, and what one warp needs of shared memory: two
// rings with their mirrors.
#define FTT_TB_RING(C)                                                   \
    ((C) * 32 + FTT_TB_CHUNK + 8 <= 512    ? 512                          \
     : (C) * 32 + FTT_TB_CHUNK + 8 <= 1024 ? 1024                         \
                                           : 2048)
// Without the trace, from this many cells a lane, the step can read q and
// t as 32-bit words (ftt_tb_step)
#define FTT_TB_WORD_CELLS 16
// Bytes mirrored behind a ring: as far as a lane's reads run past its end
#define FTT_TB_MIRROR(C) ((C) >= FTT_TB_WORD_CELLS ? 4 * (((C) + 3) / 4) : (C))
#define FTT_TB_RING_ALLOC(C)                                             \
    (FTT_TB_RING(C) +                                                    \
     (FTT_TB_MIRROR(C) > 8 ? (FTT_TB_MIRROR(C) + 7) / 8 * 8 : 8))
#define FTT_TB_WARP_SMEM(C) (2 * FTT_TB_RING_ALLOC(C))
// Steps whose moves fill one 32-bit trace word of a lane
#define FTT_TB_GROUP(C) (16 / (C))

__device__ __forceinline__ int ftt_tb_off(int s, int W) {
    const int o = (s >> 1) - (W >> 1);   // s >= -1: >> floors
    return o > 0 ? o : 0;
}

// Bytes of q (t) that steps up to s can read: indices below these counts.
__device__ __forceinline__ int ftt_tb_need_q(int s, int W) {
    return ftt_tb_off(s, W) + W - 1;
}
__device__ __forceinline__ int ftt_tb_need_t(int s, int W) {
    return s - ftt_tb_off(s, W);
}

// The block route's share of a row (ftt_tb_seg_sweep): segment w of the
// row's nw, band cells 32Cw .. 32C(w+1) - 1.  edges holds each segment's
// first and last cell of the last two steps ([2][nw][2] words, step parity
// major), red each warp's best boundary cell ([nw][4]), both in shared
// memory.
struct FttTbSeg {
    int W;
    int w, nw;
    volatile unsigned* edges;
    int* red;
};

// An edge word: the cell's value v of step r as (v << 11) | (r % 1024) << 1,
// or (X << 1) | 1, "INF at every step up to X".  When a warp reads a slot
// for step r, its writer has stored there no step after r (it would need
// the reader's step r + 1 first) and none before r - 1023 (a segment
// starts its sweep before step W), so r % 1024 tells r from every step the
// slot held before; a one-bit tag would not, when a segment starts late.
// Values stay below 2^21 (INF plus at most one +1 a step).
#define FTT_TB_EDGE_ALWAYS 0x7fffffff
__device__ __forceinline__ bool ftt_tb_edge_ready(unsigned word, int r,
                                                  int& v) {
    if (word & 1) {
        v = FTT_INF;
        return r <= (int)(word >> 1);
    }
    v = (int)(word >> 11);
    return ((word >> 1) & 1023) == (unsigned)(r & 1023);
}

template <int C>
__device__ __forceinline__ void ftt_tb_ring_put(int8_t* ring, int x,
                                                int8_t v) {
    constexpr int R = FTT_TB_RING(C);
    const int p = x & (R - 1);
    ring[p] = v;
    if (p < FTT_TB_MIRROR(C)) ring[p + R] = v;   // the mirror
}

// One anti-diagonal of one row: updates the lane's cells (p1 becomes s,
// p2 becomes s-1) and its best boundary cell, and with TRACE ors the step's
// moves into the lane's trace word acc at bit `shift` = 2 * ((s-1) % G) * C.
// o is the band offset of the warp's first cell; lane `top` holds the
// warp's last cells; e_up is the cell past them at s-1, e_left and e_diag
// the cell before the warp's first at s-1 and s-2 (INF at the band's
// ends).
template <int C, int MODE, bool TRACE>
__device__ __forceinline__ void ftt_tb_step(
    int s, int o, int d1, int d2, int lane, int ql, int tl, int end_bonus,
    const int8_t* ring_q, const int8_t* ring_t, int (&p1)[C], int (&p2)[C],
    int& best, int& best_s, int& best_i, int& best_d, unsigned& acc,
    int shift, int top, int e_up, int e_left, int e_diag) {
    constexpr int R = FTT_TB_RING(C);
    constexpr bool FAST = MODE != FTT_TB_EDGE;
    if (FAST) { d1 = MODE == FTT_TB_FAST1; d2 = 1; }
    const int i0 = o + lane * C;
    // q[i-1] of cell c is qp[c]; t[j-1], j = s - i, is tp[C-1-c]
    const int qa = (i0 - 1) & (R - 1);
    const int8_t* qp = ring_q + qa;
    const int8_t* tp = ring_t + ((s - i0 - C) & (R - 1));
    // Or, without the trace and from FTT_TB_WORD_CELLS cells a lane, the
    // lane's q and t runs as aligned 32-bit words, four cells compared by
    // one xor: x[m] is the xor of cells 4m .. 4m+3's q and t bytes.
    constexpr bool WORDS = !TRACE && C >= FTT_TB_WORD_CELLS;
    constexpr int NX = WORDS ? (C + 3) / 4 : 1;
    unsigned x[NX];
    if constexpr (WORDS) {
        // t bytes of cells 4NX-1 .. 0 (the first 4NX - C before the run)
        const int ta = (s - i0 - 4 * NX) & (R - 1);
        const unsigned* qw = (const unsigned*)(ring_q + (qa & ~3));
        const unsigned* tw = (const unsigned*)(ring_t + (ta & ~3));
        unsigned qv[NX + 1], tv[NX + 1];
#pragma unroll
        for (int k = 0; k <= NX; ++k) { qv[k] = qw[k]; tv[k] = tw[k]; }
#pragma unroll
        for (int m = 0; m < NX; ++m)
            x[m] = __funnelshift_r(qv[m], qv[m + 1], 8 * (qa & 3)) ^
                   __byte_perm(__funnelshift_r(tv[NX - 1 - m], tv[NX - m],
                                               8 * (ta & 3)),
                               0, 0x0123);
    }
    // the one cell of a neighbour lane an operand can need; the warp's two
    // ends read the cells beyond them
    int nb_up = FTT_INF, nb_left = FTT_INF, nb_diag = FTT_INF;
    if (!FAST || d1) {
        nb_up = __shfl_down_sync(FTT_TB_FULL, p1[0], 1);
        if (lane == top) nb_up = e_up;
    }
    if (!FAST || !d1) {
        nb_left = __shfl_up_sync(FTT_TB_FULL, p1[C - 1], 1);
        if (lane == 0) nb_left = e_left;
    }
    if (!FAST) {
        nb_diag = __shfl_up_sync(FTT_TB_FULL, p2[C - 1], 1);
        if (lane == 0) nb_diag = e_diag;
    }
    int cur[C];
    unsigned mine = 0;                   // this step's 2C bits
#pragma unroll
    for (int c = 0; c < C; ++c) {
        int mis;                         // q[i-1] != t[j-1]
        if constexpr (WORDS) {
            mis = (x[c >> 2] >> (8 * (c & 3))) & 0xffu ? 1 : 0;
        } else {
            const int qc = qp[c];
            const int tc = tp[C - 1 - c];
            mis = qc != tc ? 1 : 0;
        }
        // D[i, j-1] is cell l + d1 of s-1, D[i-1, j] cell l + d1 - 1,
        // D[i-1, j-1] cell l + d2 - 1 of s-2
        const int p1_next = c + 1 < C ? p1[(c + 1) % C] : nb_up;
        const int p1_prev = c > 0 ? p1[(c + C - 1) % C] : nb_left;
        const int p2_prev = c > 0 ? p2[(c + C - 1) % C] : nb_diag;
        const int up = d1 ? p1_next : p1[c];
        const int left = d1 ? p1[c] : p1_prev;
        const int diag = d2 ? p2[c] : p2_prev;
        const int side = min(up, left);
        const int v_diag = diag + mis;
        // the fused add-min where the clock says it helps: without the
        // trace (with it, the moves need side and v_diag anyway)
        int cand = TRACE ? min(side + 1, v_diag)
                         : __viaddmin_s32(side, 1, v_diag);
        // ties prefer diag, then up, then left
        bool b0 = TRACE && v_diag != cand && up == side;   // move 1: up
        bool b1 = TRACE && v_diag != cand && up != side;   // move 2: left
        if (!FAST) {
            const int i = i0 + c;
            const int j = s - i;
            if (i == 0) { cand = j; b0 = true; b1 = false; }
            if (j == 0) { cand = i; b0 = false; b1 = true; }
            const bool valid = i <= ql && j >= 0 && j <= tl;
            cand = valid ? min(cand, FTT_INF) : FTT_INF;
            b0 = b0 && valid;
            b1 = b1 && valid;
            if ((i == ql || j == tl) && cand < FTT_INF) {
                const int sc = s - end_bonus * cand;
                if (sc > best) {
                    best = sc; best_s = s; best_i = i; best_d = cand;
                }
            }
        }
        cur[c] = cand;
        if (TRACE) mine |= (b0 ? 1u : (b1 ? 2u : 0u)) << (2 * c);
    }
    if (TRACE) acc |= mine << shift;
#pragma unroll
    for (int c = 0; c < C; ++c) { p2[c] = p1[c]; p1[c] = cur[c]; }
}

// Sweeps row b with the calling warp.  wsmem: this warp's
// FTT_TB_WARP_SMEM(C) bytes of shared memory.  trow: the row's trace,
// [2L / G][32] words (not touched without TRACE).  Lane 0 writes (i, j, d)
// to ends[b], ends[B + b], ends[2B + b].
template <int C, bool TRACE>
__device__ void ftt_tb_sweep(const int8_t* __restrict__ qr,
                             const int8_t* __restrict__ tr, int ql, int tl,
                             int b, int B, int L, int end_bonus,
                             int* __restrict__ ends,
                             unsigned* __restrict__ trow,
                             unsigned char* wsmem) {
    constexpr int W = 32 * C;
    constexpr int K = FTT_TB_CHUNK;
    constexpr int NQ = K / 64 + 1;       // prefetch registers: a chunk
    constexpr int NT = K / 32;           // needs <= K/2 + 1 new q, <= K new t
    static_assert(!TRACE || 16 % C == 0, "a trace word holds 16 / C steps");
    constexpr int G = TRACE ? FTT_TB_GROUP(C) : 1;
    int8_t* ring_q = (int8_t*)wsmem;
    int8_t* ring_t = ring_q + FTT_TB_RING_ALLOC(C);
    const int lane = threadIdx.x & 31;
    const int S = min(max(ql + tl, 0), 2 * L);

    // the bytes of the first chunk, loaded directly
    int fq = ftt_tb_need_q(K, W);
    int ft = ftt_tb_need_t(K, W);
    for (int x = lane; x < fq; x += 32)
        ftt_tb_ring_put<C>(ring_q, x, x < L ? qr[x] : (int8_t)4);
    for (int x = lane; x < ft; x += 32)
        ftt_tb_ring_put<C>(ring_t, x, x < L ? tr[x] : (int8_t)5);
    __syncwarp();

    int p1[C], p2[C];                    // anti-diagonals s-1 and s-2
#pragma unroll
    for (int c = 0; c < C; ++c) { p1[c] = FTT_INF; p2[c] = FTT_INF; }
    if (lane == 0) p1[0] = 0;            // s = 0: D[0, 0] at cell 0

    int best = FTT_NEG, best_s = 0, best_i = 0, best_d = 0;
    unsigned acc = 0;                    // the lane's trace word in the making
    for (int s0 = 1; s0 <= S; s0 += K) {
        // what the next chunk reads beyond the rings' fronts, into registers
        const bool more = s0 + K <= S;
        const int nq = ftt_tb_need_q(s0 + 2 * K - 1, W);
        const int nt = ftt_tb_need_t(s0 + 2 * K - 1, W);
        int8_t pq[NQ], pt[NT];
        if (more) {
#pragma unroll
            for (int u = 0; u < NQ; ++u) {
                const int x = fq + lane + 32 * u;
                pq[u] = (x < nq && x < L) ? qr[x] : (int8_t)4;
            }
#pragma unroll
            for (int u = 0; u < NT; ++u) {
                const int x = ft + lane + 32 * u;
                pt[u] = (x < nt && x < L) ? tr[x] : (int8_t)5;
            }
        }
        const int s_end = min(s0 + K - 1, S);
        for (int s = s0; s <= s_end; ++s) {
            const int o = ftt_tb_off(s, W);
            const int d1 = o - ftt_tb_off(s - 1, W);   // 0 or 1, per warp
            const int d2 = o - ftt_tb_off(s - 2, W);
            const int u = (s - 1) & (G - 1);
            const int shift = 2 * u * C;
            // interior: the window moves, and i in [o, o + W - 1] and
            // j in [s - o - W + 1, s - o] lie strictly inside the row
            const bool fast = s >= W + 4 && o + W - 1 < ql && s - o < tl &&
                              s - o - W >= 0;
            if (!fast)
                ftt_tb_step<C, FTT_TB_EDGE, TRACE>(
                    s, o, d1, d2, lane, ql, tl, end_bonus, ring_q, ring_t,
                    p1, p2, best, best_s, best_i, best_d, acc, shift, 31,
                    FTT_INF, FTT_INF, FTT_INF);
            else if (d1)
                ftt_tb_step<C, FTT_TB_FAST1, TRACE>(
                    s, o, d1, d2, lane, ql, tl, end_bonus, ring_q, ring_t,
                    p1, p2, best, best_s, best_i, best_d, acc, shift, 31,
                    FTT_INF, FTT_INF, FTT_INF);
            else
                ftt_tb_step<C, FTT_TB_FAST0, TRACE>(
                    s, o, d1, d2, lane, ql, tl, end_bonus, ring_q, ring_t,
                    p1, p2, best, best_s, best_i, best_d, acc, shift, 31,
                    FTT_INF, FTT_INF, FTT_INF);
            // the word is full, or the row ends
            if (TRACE && (u == G - 1 || s == S)) {
                trow[(size_t)((s - 1) / G) * 32 + lane] = acc;
                acc = 0;
            }
        }
        if (more) {
            __syncwarp();                // the chunk's reads are done
#pragma unroll
            for (int u = 0; u < NQ; ++u) {
                const int x = fq + lane + 32 * u;
                if (x < nq) ftt_tb_ring_put<C>(ring_q, x, pq[u]);
            }
#pragma unroll
            for (int u = 0; u < NT; ++u) {
                const int x = ft + lane + 32 * u;
                if (x < nt) ftt_tb_ring_put<C>(ring_t, x, pt[u]);
            }
            fq = nq;
            ft = nt;
            __syncwarp();
        }
    }
    // per-lane bests -> one winner: highest score, earliest s, lowest i
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
        const int o_sc = __shfl_xor_sync(FTT_TB_FULL, best, off);
        const int o_s = __shfl_xor_sync(FTT_TB_FULL, best_s, off);
        const int o_i = __shfl_xor_sync(FTT_TB_FULL, best_i, off);
        const int o_d = __shfl_xor_sync(FTT_TB_FULL, best_d, off);
        if (o_sc > best || (o_sc == best &&
                            (o_s < best_s ||
                             (o_s == best_s && o_i < best_i)))) {
            best = o_sc; best_s = o_s; best_i = o_i; best_d = o_d;
        }
    }
    if (lane == 0) {
        const bool found = best > FTT_NEG;
        ends[b] = found ? best_i : 0;
        ends[B + b] = found ? best_s - best_i : 0;
        ends[2 * B + b] = found ? best_d : 0;
    }
}

// The block route's sweep: the calling warp sweeps segment seg.w of row
// b's band, cells 32Cw .. min(32C(w+1), W) - 1 of a band W = seg.W wide,
// while the other warps of the block sweep the row's other segments.  It
// is ftt_tb_sweep with the trace (same step, rings, forms, trace words),
// and:
// - The last segment may hold fewer than 32 lanes of the band (W need not
//   be a multiple of 32C; W 96 is one warp of 24 lanes of C = 4).  The
//   lanes past the band sweep as padding: their cells are masked in the
//   general form (qlen -1 for them), their values reach no band lane (the
//   band's last lane takes e_up, not its neighbour's shuffle), and they
//   store no trace word and score no cell.
// - The neighbouring segments' edge cells come through seg.edges: after
//   each step lane 0 publishes its first cell and its band's last lane its
//   last, and
//   before the next the warp waits until both neighbours have published
//   theirs (ftt_tb_edge_ready).  No barrier spans the row: a warp waits on
//   its two neighbours' previous step alone.
// - A segment whose cells all lie outside [0, qlen] x [0, tlen] at a step
//   skips the arithmetic (its cells are INF, its moves 0).  Before its
//   first cell can be reached (j < 0 in every cell, s < 32Cw) it does not
//   step at all: its edge words say INF up to that step, and its sweep
//   starts one step before it, so that it reads its left neighbour's cell
//   of the step before its first.  Once every cell lies past qlen or past
//   tlen, which lasts to the row's end, it says INF for every later step,
//   stores its last trace word and stops; the rest of its trace is never
//   written (no walk reaches a cell outside the DP).
// With EXCH false the row is this one warp (nw = 1): no edge words, no
// waits, no skipped or stopped steps; what is left is the warp sweep with
// padding lanes.
// trow: the row's trace from this warp's first word, [2L / G][W/C] words.
// Lane 0 writes the warp's best boundary cell (score, s, i, d) to
// seg.red[4w .. 4w + 3]; the caller picks the row's.  It is a function of
// its own, not a flag of ftt_tb_sweep: folded into one (the segment code
// removed at compile time), the warp route compiled differently and its
// K2 ran 8% slower at L 16384 on the H100.
template <int C, bool EXCH>
__device__ void ftt_tb_seg_sweep(const int8_t* __restrict__ qr,
                                 const int8_t* __restrict__ tr, int ql,
                                 int tl, int L, int end_bonus,
                                 unsigned* __restrict__ trow,
                                 unsigned char* wsmem, const FttTbSeg seg) {
    constexpr int WS = 32 * C;           // the warp's cells
    constexpr int K = FTT_TB_CHUNK;
    constexpr int R = FTT_TB_RING(C);
    constexpr int NQ = K / 64 + 1;       // prefetch registers: a chunk
    constexpr int NT = K / 32;           // needs <= K/2 + 1 new q, <= K new t
    constexpr int G = FTT_TB_GROUP(C);
    const int W = seg.W;
    const int bw = seg.w * WS;           // the warp's first cell
    const int nl = min(32, (W - bw) / C);    // lanes of the band
    const int wb = nl * C;               // cells of the band
    const int pitch = W / C;             // trace words a group
    // bytes of q (t) that steps up to s can read in the segment
    auto need_q = [&](int s) { return ftt_tb_off(s, W) + bw + WS - 1; };
    auto need_t = [&](int s) { return s - ftt_tb_off(s, W) - bw; };
    int8_t* ring_q = (int8_t*)wsmem;
    int8_t* ring_t = ring_q + FTT_TB_RING_ALLOC(C);
    const int lane = threadIdx.x & 31;
    const int S = min(max(ql + tl, 0), 2 * L);
    // the first step that can reach a cell of the segment, less one
    const int s_first = max(1, bw - 1);
    volatile unsigned* ed = seg.edges;
    // slot (p, e) of this warp: edge e (0 first, 1 last) of step parity p
    auto mine = [&](int p, int e) { return ((p * seg.nw + seg.w) << 1) + e; };
    if (EXCH) {
        // before the sweep: INF up to the step before s_first, or for good
        // when every cell lies past qlen
        if (lane < 4)
            ed[mine(lane >> 1, lane & 1)] =
                ((unsigned)(bw > ql ? FTT_TB_EDGE_ALWAYS : s_first - 1)
                 << 1) | 1u;
        __syncthreads();                 // the one barrier, before the sweep
        if (bw > ql) {
            if (lane == 0) seg.red[4 * seg.w] = FTT_NEG;
            return;
        }
    }

    // the bytes of the first chunk, loaded directly
    int fq = need_q(s_first + K - 1);
    int ft = need_t(s_first + K - 1);
    for (int x = max(fq - R, 0) + lane; x < fq; x += 32)
        ftt_tb_ring_put<C>(ring_q, x, x < L ? qr[x] : (int8_t)4);
    for (int x = max(ft - R, 0) + lane; x < ft; x += 32)
        ftt_tb_ring_put<C>(ring_t, x, x < L ? tr[x] : (int8_t)5);
    __syncwarp();

    int p1[C], p2[C];                    // anti-diagonals s-1 and s-2
#pragma unroll
    for (int c = 0; c < C; ++c) { p1[c] = FTT_INF; p2[c] = FTT_INF; }
    if (lane == 0 && bw == 0) p1[0] = 0; // s = 0: D[0, 0] at cell 0

    int best = FTT_NEG, best_s = 0, best_i = 0, best_d = 0;
    unsigned acc = 0;                    // the lane's trace word in the making
    int e_diag = FTT_INF;                // the left neighbour's last, s-2
    bool stop = false;
    for (int s0 = s_first; s0 <= S && !stop; s0 += K) {
        // what the next chunk reads beyond the rings' fronts, into registers
        const bool more = s0 + K <= S;
        const int nq = need_q(s0 + 2 * K - 1);
        const int nt = need_t(s0 + 2 * K - 1);
        int8_t pq[NQ], pt[NT];
        if (more) {
#pragma unroll
            for (int u = 0; u < NQ; ++u) {
                const int x = fq + lane + 32 * u;
                pq[u] = (x < nq && x < L) ? qr[x] : (int8_t)4;
            }
#pragma unroll
            for (int u = 0; u < NT; ++u) {
                const int x = ft + lane + 32 * u;
                pt[u] = (x < nt && x < L) ? tr[x] : (int8_t)5;
            }
        }
        const int s_end = min(s0 + K - 1, S);
        for (int s = s0; s <= s_end; ++s) {
            const int o = ftt_tb_off(s, W);
            const int d1 = o - ftt_tb_off(s - 1, W);   // 0 or 1, per warp
            const int d2 = o - ftt_tb_off(s - 2, W);
            const int u = (s - 1) & (G - 1);
            const int shift = 2 * u * C;
            const int ob = o + bw;       // band offset of the warp's cell 0
            // the neighbours' edge cells of step s-1
            int e_up = FTT_INF, e_left = FTT_INF;
            const int sl = ((s - 1) & 1) * seg.nw;
            for (unsigned polls = 0; EXCH; ++polls) {
                // a fault of the protocol traps (a launch error), never
                // hangs: a neighbour is a step away, not 2^26 polls
                if (polls == (1u << 26)) __trap();
                bool ok = true;
                if (seg.w > 0)
                    ok = ftt_tb_edge_ready(ed[((sl + seg.w - 1) << 1) + 1],
                                           s - 1, e_left);
                if (seg.w + 1 < seg.nw)
                    ok = ftt_tb_edge_ready(ed[(sl + seg.w + 1) << 1], s - 1,
                                           e_up) && ok;
                if (__all_sync(FTT_TB_FULL, ok)) break;
            }
            // every cell past qlen or past tlen since step s-1: INF from
            // here on (its s-1 words said INF already, and its s-2 words
            // have been read: the neighbours are past s-1)
            const int ob1 = ftt_tb_off(s - 1, W) + bw;
            if (EXCH && s > s_first &&
                (ob1 > ql || s - 1 - ob1 - wb + 1 > tl)) {
                if (u != 0 && lane < nl) // step s-1 left its word unstored
                    trow[(size_t)((s - 2) / G) * pitch + lane] = acc;
                if (lane < 4)
                    ed[mine(lane >> 1, lane & 1)] =
                        ((unsigned)FTT_TB_EDGE_ALWAYS << 1) | 1u;
                stop = true;
                break;
            }
            // interior: the window moves, and the warp's i in
            // [ob, ob + wb - 1] and j in [s - ob - wb + 1, s - ob] lie
            // strictly inside the row
            const bool fast = s >= W + 4 && ob + wb - 1 < ql && s - ob < tl &&
                              s - ob - wb >= 0;
            if (EXCH && (ob > min(ql, s) || s - ob - wb + 1 > tl)) {
                // no cell of the segment in [0, qlen] x [0, tlen]
#pragma unroll
                for (int c = 0; c < C; ++c) { p2[c] = p1[c]; p1[c] = FTT_INF; }
            } else if (!fast)
                ftt_tb_step<C, FTT_TB_EDGE, true>(
                    s, ob, d1, d2, lane, lane < nl ? ql : -1, tl, end_bonus,
                    ring_q, ring_t, p1, p2, best, best_s, best_i, best_d, acc,
                    shift, nl - 1, e_up, e_left, e_diag);
            else if (d1)
                ftt_tb_step<C, FTT_TB_FAST1, true>(
                    s, ob, d1, d2, lane, ql, tl, end_bonus, ring_q, ring_t,
                    p1, p2, best, best_s, best_i, best_d, acc, shift, nl - 1,
                    e_up, e_left, e_diag);
            else
                ftt_tb_step<C, FTT_TB_FAST0, true>(
                    s, ob, d1, d2, lane, ql, tl, end_bonus, ring_q, ring_t,
                    p1, p2, best, best_s, best_i, best_d, acc, shift, nl - 1,
                    e_up, e_left, e_diag);
            if (EXCH) {
                const unsigned tag = (unsigned)(s & 1023) << 1;
                if (lane == 0)
                    ed[mine(s & 1, 0)] = ((unsigned)p1[0] << 11) | tag;
                if (lane == nl - 1)
                    ed[mine(s & 1, 1)] = ((unsigned)p1[C - 1] << 11) | tag;
                e_diag = e_left;
            }
            // the word is full, or the row ends
            if (u == G - 1 || s == S) {
                if (lane < nl)
                    trow[(size_t)((s - 1) / G) * pitch + lane] = acc;
                acc = 0;
            }
        }
        if (more && !stop) {
            __syncwarp();                // the chunk's reads are done
#pragma unroll
            for (int u = 0; u < NQ; ++u) {
                const int x = fq + lane + 32 * u;
                if (x < nq) ftt_tb_ring_put<C>(ring_q, x, pq[u]);
            }
#pragma unroll
            for (int u = 0; u < NT; ++u) {
                const int x = ft + lane + 32 * u;
                if (x < nt) ftt_tb_ring_put<C>(ring_t, x, pt[u]);
            }
            fq = nq;
            ft = nt;
            __syncwarp();
        }
    }
    // per-lane bests -> the warp's: highest score, earliest s, lowest i
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
        const int o_sc = __shfl_xor_sync(FTT_TB_FULL, best, off);
        const int o_s = __shfl_xor_sync(FTT_TB_FULL, best_s, off);
        const int o_i = __shfl_xor_sync(FTT_TB_FULL, best_i, off);
        const int o_d = __shfl_xor_sync(FTT_TB_FULL, best_d, off);
        if (o_sc > best || (o_sc == best &&
                            (o_s < best_s ||
                             (o_s == best_s && o_i < best_i)))) {
            best = o_sc; best_s = o_s; best_i = o_i; best_d = o_d;
        }
    }
    if (lane == 0) {
        int* r = seg.red + 4 * seg.w;
        r[0] = best; r[1] = best_s; r[2] = best_i; r[3] = best_d;
    }
}
