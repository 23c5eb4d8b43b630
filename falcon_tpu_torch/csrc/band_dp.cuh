// Banded anti-diagonal edit DP, a block per row: K1's and K2's kernel for
// the bands the warp-resident sweep (tb_sweep.cuh) is not instantiated for.
// extend.cu runs the warp sweep at W = 32, 64, 128, 256 and 512 and this
// one (TRACE = false) at every other multiple of 32 up to 1024; align_tb.cu
// runs the warp sweep with its trace at W = 32, 64, 128 and 256 and this one
// (TRACE = true) at every other multiple of 32 up to 1024.
//
// One thread block per batch row, one thread per band lane, so any W fits.
// Anti-diagonal s = i + j; lane l holds cell i = o(s) + l with
// o(s) = max(0, s/2 - W/2), j = s - i.  Three shared-memory rows hold
// anti-diagonals s-2, s-1 and s (each W lanes plus two INF lanes of padding
// at either end), so one __syncthreads() per step orders every read of step
// s before any write of step s+1.  q/t characters are read straight from
// global int8.  What bounds it is that barrier and the shared-memory round
// trip of every operand, not the arithmetic: it runs at about a quarter of
// the card's int32 rate, which the warp sweep exists to lift.
//
// Each row sweeps s = 1 .. min(qlen + tlen, 2L): no boundary cell
// (i == qlen or j == tlen) lies beyond qlen + tlen, so the row stops at its
// own last useful step (the Pallas kernels' per-tile max_s skip, per row).
//
// End cell: the boundary cell maximising (i + j) - end_bonus * D among
// cells with D < INF; ties go to the earliest s, then the lowest i (the
// XLA first-index argmax with strict > across steps).  Each thread keeps
// its own best with strict >, and one pass over the W lanes at the end
// picks the winner.  A row with no scored cell returns (0, 0, 0).
//
// With TRACE, every step also stores the cells' moves (0 = diag, 1 = up,
// 2 = left; ties prefer diag, then up, then left; row 0 forced up, column 0
// left; masked cells 0) as two bit planes of W bits: warp w of the block
// ballots its 32 lanes' low bits into word 0 and their high bits into word
// 1, and lanes 0 and 1 store the pair, so trace[b][s-1][w][k], [B, 2L, W/16]
// words, holds bit l % 32 of plane k for band cell 32w + l % 32.  That is
// two bits a cell, W/4 bytes a step, as the warp route's trace, and a row
// stores only the steps it sweeps.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define FTT_INF (1 << 20)
#define FTT_NEG (-(1 << 30))

__device__ __forceinline__ int ftt_band_off(int s, int W) {
    const int o = (s >> 1) - (W >> 1);   // s >= -1: >> floors
    return o > 0 ? o : 0;
}

// Sweeps row b.  Writes (i, j, d) to ends[0][b], ends[1][b], ends[2][b]
// ([3, B] int32), and with TRACE the row's moves to trace (unused without).
template <bool TRACE>
__device__ void ftt_band_dp(const int8_t* __restrict__ q,
                            const int8_t* __restrict__ t,
                            const int* __restrict__ qlen,
                            const int* __restrict__ tlen, int B, int L,
                            int W, int end_bonus, int* __restrict__ ends,
                            unsigned* __restrict__ trace) {
    extern __shared__ int ftt_band_smem[];
    int* smem = ftt_band_smem;
    const int b = blockIdx.x;
    const int l = threadIdx.x;
    const int P = W + 4;
    const int ql = qlen[b];
    const int tl = tlen[b];
    const int8_t* qr = q + (size_t)b * L;
    const int8_t* tr = t + (size_t)b * L;
    const int words = W / 16;            // trace words a step
    unsigned* trow = TRACE ? trace + (size_t)b * 2 * L * words : nullptr;

    for (int x = l; x < 3 * P; x += W) smem[x] = FTT_INF;
    __syncthreads();
    if (l == 0) smem[2] = 0;             // s = 0: D[0, 0] at lane 0
    __syncthreads();

    int best = FTT_NEG, best_s = 0, best_d = 0;
    int cur_b = 1, prev_b = 0, prev2_b = 2;  // rows of s, s-1, s-2
    const int S = min(max(ql + tl, 0), 2 * L);
    for (int s = 1; s <= S; ++s) {
        const int o = ftt_band_off(s, W);
        const int d1 = o - ftt_band_off(s - 1, W);
        const int d2 = o - ftt_band_off(s - 2, W);
        const int* prev = smem + prev_b * P;
        const int* prev2 = smem + prev2_b * P;
        const int i = o + l;
        const int j = s - i;
        int v = FTT_INF;
        int mv = 0;
        if (i <= ql && j >= 0 && j <= tl) {
            const int qc = (i >= 1 && i <= L) ? qr[i - 1] : 4;
            const int tc = (j >= 1 && j <= L) ? tr[j - 1] : 5;
            const int v_up = prev[2 + l + d1] + 1;      // D[i, j-1] + 1
            const int v_left = prev[1 + l + d1] + 1;    // D[i-1, j] + 1
            const int v_diag = prev2[1 + l + d2] + (qc != tc ? 1 : 0);
            int cand = min(min(v_up, v_left), v_diag);
            mv = v_diag == cand ? 0 : (v_up == cand ? 1 : 2);
            if (i == 0) { cand = j; mv = 1; }
            if (j == 0) { cand = i; mv = 2; }
            v = min(cand, FTT_INF);
            if ((i == ql || j == tl) && v < FTT_INF) {
                const int sc = s - end_bonus * v;
                if (sc > best) { best = sc; best_s = s; best_d = v; }
            }
        }
        smem[cur_b * P + 2 + l] = v;
        if (TRACE) {
            const unsigned lo = __ballot_sync(0xffffffffu, mv & 1);
            const unsigned hi = __ballot_sync(0xffffffffu, mv >> 1);
            if ((l & 31) < 2)
                trow[(size_t)(s - 1) * words + (l >> 5) * 2 + (l & 1)] =
                    (l & 1) ? hi : lo;
        }
        __syncthreads();
        const int old2 = prev2_b;
        prev2_b = prev_b;
        prev_b = cur_b;
        cur_b = old2;
    }

    // per-lane bests -> one winner: highest score, earliest s, lowest lane
    // (lane order is i order within one s)
    __syncthreads();
    int* r_score = smem;
    int* r_step = smem + W;
    int* r_dist = smem + 2 * W;
    r_score[l] = best;
    r_step[l] = best_s;
    r_dist[l] = best_d;
    __syncthreads();
    if (l == 0) {
        int bs = FTT_NEG, bst = 0, bl = 0, bd = 0;
        for (int k = 0; k < W; ++k) {
            const int sc = r_score[k];
            if (sc > bs || (sc == bs && sc > FTT_NEG && r_step[k] < bst)) {
                bs = sc;
                bst = r_step[k];
                bl = k;
                bd = r_dist[k];
            }
        }
        int bi = 0, bj = 0;
        if (bs > FTT_NEG) {
            bi = ftt_band_off(bst, W) + bl;
            bj = bst - bi;
        } else {
            bd = 0;
        }
        ends[b] = bi;
        ends[B + b] = bj;
        ends[2 * B + b] = bd;
    }
}
