// K2 + K3: batched banded alignment with traceback (consensus alignment).
//
// K2 replaces falcon_tpu/ops/align_tb_pallas.py `_fwd_kernel`, K3 its
// `_bwd_kernel` (entry align_tb_batch_pallas); semantic reference
// falcon_tpu/ops/align_tb.py align_tb_batch, plain twin
// falcon_tpu_torch/ops/align_tb.py align_tb_batch.
//
// What bounds them on the H100: K2 is K1's integer issue plus the trace,
// one byte per cell, 2 * L * B * W bytes per call (2 GB at L = 16384,
// B = 256, W = 256), written once by K2 and read back along one path by
// K3.  K3 is bound by the latency of its dependent trace reads: each step
// of a row's walk needs the byte the previous step pointed at.
//
// What the design does about it: K2 lays the trace out [B, 2L, W], so a
// step's W lanes store W consecutive bytes (one coalesced 256-byte store
// at W = 256) and each row's trace is one contiguous span; a row stores
// only the anti-diagonals it sweeps (up to its qlen + tlen).  K3 runs one
// thread per row, so B walks overlap each other's read latency, and it
// writes the move and base streams [2L, B] with neighbouring threads on
// neighbouring bytes.  A warp-parallel walk, and packing the moves four
// to a byte inside K3, are later work.
#include "band_dp.cuh"

__global__ void ftt_tb_fwd_kernel(const int8_t* __restrict__ q,
                                  const int8_t* __restrict__ t,
                                  const int* __restrict__ qlen,
                                  const int* __restrict__ tlen, int B,
                                  int L, int W, int end_bonus,
                                  int* __restrict__ ends,
                                  int8_t* __restrict__ trace) {
    ftt_band_dp<true>(q, t, qlen, tlen, B, L, W, end_bonus, ends, trace);
}

// Walks row b from its end cell to (0, 0).  moves[2L - s][b] is the move
// taken from anti-diagonal s (end->start order, 3 = inactive step; a diag
// move drops s by 2, so a 3 follows it); bases[s - 1][b] is q[i-1] when
// that move consumes q (diag or left), else 4 (start->end order).
__global__ void ftt_tb_bwd_kernel(const int8_t* __restrict__ trace,
                                  const int* __restrict__ ends, int B,
                                  int L, int W,
                                  int8_t* __restrict__ moves,
                                  int8_t* __restrict__ bases) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int i = ends[b];
    int j = ends[B + b];
    bool done = (i == 0 && j == 0);
    const int S = 2 * L;
    const int8_t* trow = trace + (size_t)b * S * W;
    for (int s = S; s >= 1; --s) {
        int m = 3;
        int base = 4;
        if (!done && i + j == s) {
            const int lane = i - ftt_band_off(s, W);
            const int pk = (lane >= 0 && lane < W)
                               ? trow[(size_t)(s - 1) * W + lane] : 0;
            m = pk & 3;
            if (m != 1) base = pk >> 2;
            i -= (m == 0 || m == 2) ? 1 : 0;
            j -= (m == 0 || m == 1) ? 1 : 0;
            done = (i == 0 && j == 0);
        }
        moves[(size_t)(S - s) * B + b] = (int8_t)m;
        bases[(size_t)(s - 1) * B + b] = (int8_t)base;
    }
}

// q, t: [B, L] int8; qlen, tlen: [B] int32; ends: [3, B] int32;
// trace: [B, 2L, W] int8 scratch.  Returns cudaGetLastError().
extern "C" int ftt_tb_fwd(const void* q, const void* t, const void* qlen,
                          const void* tlen, int B, int L, int W,
                          int end_bonus, void* ends, void* trace,
                          void* stream) {
    const size_t smem = 3 * (size_t)(W + 4) * sizeof(int);
    ftt_tb_fwd_kernel<<<B, W, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
        (const int*)tlen, B, L, W, end_bonus, (int*)ends,
        (int8_t*)trace);
    return (int)cudaGetLastError();
}

// trace: K2's [B, 2L, W]; ends: K2's [3, B]; moves, bases: [2L, B] int8.
extern "C" int ftt_tb_bwd(const void* trace, const void* ends, int B,
                          int L, int W, void* moves, void* bases,
                          void* stream) {
    const int threads = 128;
    ftt_tb_bwd_kernel<<<(B + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
        (const int8_t*)trace, (const int*)ends, B, L, W, (int8_t*)moves,
        (int8_t*)bases);
    return (int)cudaGetLastError();
}
