// Banded anti-diagonal edit DP shared by K1 (extend.cu) and K2 (align_tb.cu).
//
// One thread block per batch row, one thread per band lane.  Anti-diagonal
// s = i + j; lane l holds cell i = o(s) + l with o(s) = max(0, s/2 - W/2),
// j = s - i.  Three shared-memory rows hold anti-diagonals s-2, s-1 and s
// (each W lanes plus two INF lanes of padding at either end), so one
// __syncthreads() per step orders every read of step s before any write of
// step s+1.  q/t characters are read straight from global int8.
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
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define FTT_INF (1 << 20)
#define FTT_NEG (-(1 << 30))

__device__ __forceinline__ int ftt_band_off(int s, int W) {
    const int o = (s >> 1) - (W >> 1);   // s >= -1: >> floors
    return o > 0 ? o : 0;
}

// Sweeps row b.  With TRACE, stores one byte per (s, lane) into
// trace[b][s-1][lane] ([B, 2L, W] int8): bits 0-1 the move (0 = diag,
// 1 = up, 2 = left), bits 2-4 min(q[i-1], 4).  Writes (i, j, d) to
// ends[0][b], ends[1][b], ends[2][b] ([3, B] int32).
template <bool TRACE>
__device__ void ftt_band_dp(const int8_t* __restrict__ q,
                            const int8_t* __restrict__ t,
                            const int* __restrict__ qlen,
                            const int* __restrict__ tlen, int B, int L,
                            int W, int end_bonus, int* __restrict__ ends,
                            int8_t* __restrict__ trace) {
    extern __shared__ int smem[];
    const int b = blockIdx.x;
    const int l = threadIdx.x;
    const int P = W + 4;
    const int ql = qlen[b];
    const int tl = tlen[b];
    const int8_t* qr = q + (size_t)b * L;
    const int8_t* tr = t + (size_t)b * L;
    int8_t* trow = TRACE ? trace + (size_t)b * 2 * L * W : nullptr;

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
        int qc = 4;
        if (i <= ql && j >= 0 && j <= tl) {
            if (i >= 1 && i <= L) qc = qr[i - 1];
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
        if (TRACE)
            trow[(size_t)(s - 1) * W + l] =
                (int8_t)(mv | (min(qc, 4) << 2));
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
