// K2 + K3: batched banded alignment with traceback (consensus alignment).
//
// K2 replaces falcon_tpu/ops/align_tb_pallas.py `_fwd_kernel`, K3 its
// `_bwd_kernel` (entry align_tb_batch_pallas); semantic reference
// falcon_tpu/ops/align_tb.py align_tb_batch, plain twin
// falcon_tpu_torch/ops/align_tb.py align_tb_batch.
//
// What bounds them on the H100.  K2 is K1's DP plus the trace: its floor is
// integer issue (an interior step compiles to 15 instructions a cell and
// about 60 a step beside them, cuobjdump -sass), and what held the first
// port far from that floor was the latency of a step -- a block barrier
// behind global loads and a global store, with few warps to hide it -- and
// a trace of a byte a cell.  K3 is one dependent chain per row: each step
// needs the move the previous step pointed at, so its floor is steps times
// the latency of the memory a step reads.
//
// What the design does about it.  K2 (tb_sweep.cuh) keeps a row's band in
// the registers of one warp, takes neighbours by shuffle, reads q and t
// from shared-memory rings filled a chunk ahead, has no barrier in the
// sweep, and writes the trace as two bits a cell (W/4 bytes a step) that
// each lane packs for itself, so no ballot or staging is needed.  A lone
// warp still takes some 600 cycles a step (short dependent chains through
// predicates), so a launch wants several warps per scheduler: the batcher
// (cns.device.DeviceCns._batch_for) gives it up to 4096 rows.  K3
// runs a warp per row: a step's whole trace row is W/4 bytes, so nothing
// about the addresses of the next 32 steps depends on the path, and the
// warp copies the trace of a window of 32 anti-diagonals into shared memory
// with cp.async while it walks the window before; the walk reads shared
// memory only.  A row starts its walk at its own i + j (everything above is
// the constant filler: move 3, base 4) and stops reading once it reaches
// (0, 0).  K3 packs the moves four to a byte itself, and a block of 8 rows
// stages each window's output in shared memory and stores it transposed,
// neighbouring rows to neighbouring bytes, because the outputs keep the
// batch as their minor axis.  The walk is one dependent chain that every
// lane of the warp issues, so a block holds only 8 rows: a launch of 1024
// rows then spreads over all 132 SMs, two warps to a scheduler, and the
// chain's latency rather than instruction issue sets the time.
//
// The warp route holds W/32 cells a lane and packs 16/(W/32) steps into a
// lane's trace word, so it exists for W = 32, 64, 128 and 256 only.  Every
// other multiple of 32 up to 1024 takes the block route
// (ops.align_tb_cuda.kernel_for), which keeps no band the reference takes
// out of reach.  Its first form, a block of W threads a row with a barrier
// on every anti-diagonal and a thread walking each row's trace in device
// memory, ran 14-20x its bound in K2 and ~1,400 clocks a walked step in K3:
// the barrier, the shared-memory round trip of every operand and the
// per-cell global reads bound K2, the latency of a device read every step
// bound K3.  The block route is now the warp route's design at any W:
// - K2: a row's band lies in the registers of ceil(W/32C) warps of C
//   cells a lane (ops.align_tb_cuda.trace_cells).  Where 32 lanes of at
//   most 16 cells hold the band it is one warp, its top lanes padding
//   (W 96: 24 lanes of 4); a per-step exchange costs more than idle lanes,
//   so one warp measured faster wherever it fits.  Wider bands are warps
//   of 8 cells, a block of them a row, each running tb_sweep.cuh's step on
//   its segment (registers, shuffles, its own q/t rings, the step forms
//   chosen per warp) and taking the one cell a step it needs from each
//   neighbouring segment through a tagged shared-memory word: a warp waits
//   on its two neighbours' previous step, never on the row, and no barrier
//   spans the band.  A segment outside [0, qlen] x [0, tlen] skips its
//   arithmetic, and one that cannot be reached yet or never again does not
//   step at all, which at W = 1024 and reads of 512-1024 is much of the
//   band's first and last steps.  What bounds it now is the step's
//   latency plus the exchange (a neighbour's word is read, on the
//   dependent chain, every step).  The trace keeps the warp route's
//   lane-packed words: trace[b][(s-1)/G][x], G = 16/C, word x holding band
//   cells xC .. xC+C-1 (W/4 bytes a step, as before).
// - K3: the warp walk above on that layout.  Since a walked step moves the
//   band lane by at most one, the window after the one being walked stays
//   within 64 lanes of where the walk stands when its copy is issued, so a
//   window's copy is those lanes' words alone (FTT_TB_REACH), about 100
//   16-byte pieces whatever W, not the W/4 bytes of each of its 32 steps.
#include "tb_sweep.cuh"

#define FTT_TB_FWD_ROWS 4      // K2: warps (rows) per block
#define FTT_TB_BWD_ROWS 8      // K3: warps (rows) per block
#define FTT_TB_WIN 32          // K3: anti-diagonals per window

template <int C>
__global__ void __launch_bounds__(32 * FTT_TB_FWD_ROWS)
ftt_tb_fwd_kernel(const int8_t* __restrict__ q,
                  const int8_t* __restrict__ t,
                  const int* __restrict__ qlen,
                  const int* __restrict__ tlen, int B, int L,
                  int end_bonus, int* __restrict__ ends,
                  unsigned* __restrict__ trace) {
    __shared__ __align__(8) unsigned char
        wsmem[FTT_TB_FWD_ROWS][FTT_TB_WARP_SMEM(C)];
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * FTT_TB_FWD_ROWS + warp;
    if (b >= B) return;                  // whole warps leave; no block barrier
    ftt_tb_sweep<C, true>(q + (size_t)b * L, t + (size_t)b * L, qlen[b], tlen[b],
                    b, B, L, end_bonus, ends,
                    trace + (size_t)b * 4 * L * C, wsmem[warp]);
}

__device__ __forceinline__ void ftt_cp_async16(void* dst, const void* src) {
    const unsigned sa = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(sa), "l"(src));
}

// Shared memory of one K3 block: per warp two windows of the trace
// ([2][FTT_TB_WIN * 2C] words), then two stages of the block's output
// ([2][rows][2] words of packed moves, [2][rows][36] bases).
#define FTT_TB_BASE_PITCH 36   // 9 words: conflict-free transposed reads
#define FTT_TB_BWD_SMEM(C)                                              \
    ((size_t)FTT_TB_BWD_ROWS * 2 * FTT_TB_WIN * 2 * (C) *               \
         sizeof(unsigned) +                                              \
     2 * FTT_TB_BWD_ROWS * (2 * sizeof(unsigned) + FTT_TB_BASE_PITCH))

// Walks row b from its end cell to (0, 0), a warp per row, every lane
// walking the same path.  moves[(2L - s) / 4][b] holds, two bits each, the
// moves taken from anti-diagonals s (end->start order, earliest in the low
// bits, 3 = inactive step; a diag move drops s by 2, so a 3 follows it);
// bases[s - 1][b] is q[i-1] when that move consumes q (diag or left), else
// 4 (start->end order).  A cell outside the band reads as move 0, base 0.
// Needs 2L % 32 == 0.
//
// The walk of a window keeps only the 32 moves (two words) and a mask of
// the out-of-band steps; after it lane k reads its own step's move from
// them and finds the i that step started from by counting the q-consuming
// moves (bit 0 clear) before it.
template <int C>
__global__ void __launch_bounds__(32 * FTT_TB_BWD_ROWS)
ftt_tb_bwd_kernel(const unsigned* __restrict__ trace,
                  const int8_t* __restrict__ q,
                  const int* __restrict__ ends, int B, int L,
                  uint8_t* __restrict__ moves, int8_t* __restrict__ bases) {
    constexpr int W = 32 * C;
    constexpr int LOG2C = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3;
    constexpr int G = FTT_TB_GROUP(C);              // steps per trace word
    constexpr int WIN_WORDS = FTT_TB_WIN * 2 * C;   // a window of the trace
    constexpr int ROWS = FTT_TB_BWD_ROWS;
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    unsigned* win = (unsigned*)smem + (size_t)warp * 2 * WIN_WORDS;
    unsigned* st_moves =
        (unsigned*)smem + (size_t)ROWS * 2 * WIN_WORDS;      // [2][ROWS][2]
    int8_t* st_bases = (int8_t*)(st_moves + 2 * ROWS * 2);

    const int b0 = blockIdx.x * ROWS;
    const int b = b0 + warp;
    const bool live = b < B;
    int i = live ? ends[b] : 0;
    int j = live ? ends[B + b] : 0;
    const int s_start = i + j;
    bool done = s_start == 0;
    const unsigned* trow = trace + (size_t)(live ? b : 0) * 4 * L * C;
    const int8_t* qr = q + (size_t)(live ? b : 0) * L;
    const int S = 2 * L;
    const int n_win = S / FTT_TB_WIN;
    // the transposed store: this thread's row and step (or packed byte)
    const int t_row = threadIdx.x % ROWS;
    const int t_col = threadIdx.x / ROWS;

    // window n covers anti-diagonals S - 32n - 31 .. S - 32n; the row's
    // first is the one that holds s_start
    const int n_first = (S - s_start) / FTT_TB_WIN;
    if (!done) {
        const char* src = (const char*)(
            trow + (size_t)(S - FTT_TB_WIN * (n_first + 1)) * 2 * C);
        char* dst = (char*)(win + (n_first & 1) * WIN_WORDS);
        for (int x = lane; x < WIN_WORDS / 4; x += 32)
            ftt_cp_async16(dst + 16 * x, src + 16 * x);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    for (int n = 0; n < n_win; ++n) {
        const int s_hi = S - FTT_TB_WIN * n;
        const int s_lo = s_hi - FTT_TB_WIN + 1;
        const int par = n & 1;
        int my_base = 4;
        unsigned m_lo = ~0u, m_hi = ~0u;         // steps 0-15, 16-31
        if (!done && n >= n_first) {             // per warp
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
            __syncwarp();
            if (n + 1 < n_win) {                 // the next window, in flight
                const char* src = (const char*)(
                    trow + (size_t)(s_lo - 1 - FTT_TB_WIN) * 2 * C);
                char* dst = (char*)(win + (par ^ 1) * WIN_WORDS);
                for (int x = lane; x < WIN_WORDS / 4; x += 32)
                    ftt_cp_async16(dst + 16 * x, src + 16 * x);
            }
            asm volatile("cp.async.commit_group;\n" ::);
            // the walk loses at most one i a step: lane k holds q[i_top-1-k]
            const int i_top = i;
            const int qi = i_top - 1 - lane;
            const int qv = (qi >= 0 && qi < L) ? qr[qi] : 4;
            const unsigned* buf = win + par * WIN_WORDS;
            unsigned oob = 0;
            m_lo = m_hi = 0;
#pragma unroll
            for (int k = 0; k < FTT_TB_WIN; ++k) {
                const int s = s_hi - k;
                unsigned m = 3;
                if (!done && i + j == s) {
                    const int l = i - ftt_tb_off(s, W);
                    if ((unsigned)l < (unsigned)W) {
                        // step s is slot 31 - k of the window: word
                        // slot / G of lane l / C, field (slot % G) * C + c
                        const int slot = FTT_TB_WIN - 1 - k;
                        const unsigned w =
                            buf[(slot / G) * 32 + (l >> LOG2C)];
                        m = (w >> (2 * ((slot % G) * C + (l & (C - 1))))) & 3;
                    } else {
                        m = 0;
                        oob |= 1u << k;
                    }
                    i -= (m & 1) ^ 1;            // diag or left consumes q
                    j -= ((m >> 1) & 1) ^ 1;     // diag or up consumes t
                    done = (i | j) == 0;
                }
                if (k < 16) m_lo |= m << (2 * k);
                else m_hi |= m << (2 * (k - 16));
            }
            const int sh = 2 * (lane & 15);
            const unsigned my_m = ((lane < 16 ? m_lo : m_hi) >> sh) & 3;
            const unsigned eat_lo = ~m_lo & 0x55555555u;
            const unsigned eat_hi = ~m_hi & 0x55555555u;
            const unsigned below = (1u << sh) - 1;
            const int before = lane < 16
                ? __popc(eat_lo & below)
                : __popc(eat_lo) + __popc(eat_hi & below);
            const int my_i = i_top - before;
            const int qc = __shfl_sync(FTT_TB_FULL, qv, before);
            if (my_m == 3 || my_m == 1) my_base = 4;
            else if ((oob >> lane) & 1) my_base = 0;
            else my_base = my_i >= 1 ? min(qc, 4) : 4;
        }
        // stage this window's output, then store it with the batch minor
        if (lane == 0) {
            st_moves[(par * ROWS + warp) * 2] = m_lo;
            st_moves[(par * ROWS + warp) * 2 + 1] = m_hi;
        }
        st_bases[(par * ROWS + warp) * FTT_TB_BASE_PITCH + lane] =
            (int8_t)my_base;
        __syncthreads();
        // thread (row, k) stores step s_hi - k of its row; the first
        // 8 * ROWS threads also store packed byte k of the window
        if (b0 + t_row < B) {
            bases[(size_t)(s_hi - 1 - t_col) * B + b0 + t_row] =
                st_bases[(par * ROWS + t_row) * FTT_TB_BASE_PITCH + t_col];
            if (t_col < FTT_TB_WIN / 4)
                moves[(size_t)(n * (FTT_TB_WIN / 4) + t_col) * B + b0 +
                      t_row] =
                    (uint8_t)(st_moves[(par * ROWS + t_row) * 2 +
                                       (t_col >> 2)] >> (8 * (t_col & 3)));
        }
    }
    // a row that ended inside a window left the next one in flight
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int C>
static int ftt_tb_fwd_launch(const void* q, const void* t, const void* qlen,
                             const void* tlen, int B, int L, int end_bonus,
                             void* ends, void* trace, cudaStream_t stream) {
    const int blocks = (B + FTT_TB_FWD_ROWS - 1) / FTT_TB_FWD_ROWS;
    ftt_tb_fwd_kernel<C><<<blocks, 32 * FTT_TB_FWD_ROWS, 0, stream>>>(
        (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
        (const int*)tlen, B, L, end_bonus, (int*)ends, (unsigned*)trace);
    return (int)cudaGetLastError();
}

template <int C>
static int ftt_tb_bwd_launch(const void* trace, const void* q,
                             const void* ends, int B, int L, void* moves,
                             void* bases, cudaStream_t stream) {
    const size_t smem = FTT_TB_BWD_SMEM(C);
    cudaError_t err = cudaFuncSetAttribute(
        ftt_tb_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + FTT_TB_BWD_ROWS - 1) / FTT_TB_BWD_ROWS;
    ftt_tb_bwd_kernel<C><<<blocks, 32 * FTT_TB_BWD_ROWS, smem, stream>>>(
        (const unsigned*)trace, (const int8_t*)q, (const int*)ends, B, L,
        (uint8_t*)moves, (int8_t*)bases);
    return (int)cudaGetLastError();
}

// q, t: [B, L] int8; qlen, tlen: [B] int32; ends: [3, B] int32; trace:
// [B, 2L * W/512, 32] int32 scratch (tb_sweep.cuh's layout).  W is 32, 64, 128 or
// 256.  Returns cudaGetLastError(), or cudaErrorInvalidValue for another W.
extern "C" int ftt_tb_fwd(const void* q, const void* t, const void* qlen,
                          const void* tlen, int B, int L, int W,
                          int end_bonus, void* ends, void* trace,
                          void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (W) {
    case 32: return ftt_tb_fwd_launch<1>(q, t, qlen, tlen, B, L, end_bonus,
                                         ends, trace, st);
    case 64: return ftt_tb_fwd_launch<2>(q, t, qlen, tlen, B, L, end_bonus,
                                         ends, trace, st);
    case 128: return ftt_tb_fwd_launch<4>(q, t, qlen, tlen, B, L, end_bonus,
                                          ends, trace, st);
    case 256: return ftt_tb_fwd_launch<8>(q, t, qlen, tlen, B, L, end_bonus,
                                          ends, trace, st);
    }
    return (int)cudaErrorInvalidValue;
}

// trace: K2's; q: K2's [B, L] int8; ends: K2's [3, B]; moves: [2L/4, B]
// uint8; bases: [2L, B] int8.  L must be a multiple of 16.
extern "C" int ftt_tb_bwd(const void* trace, const void* q, const void* ends,
                          int B, int L, int W, void* moves, void* bases,
                          void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (L % 16) return (int)cudaErrorInvalidValue;
    switch (W) {
    case 32: return ftt_tb_bwd_launch<1>(trace, q, ends, B, L, moves, bases,
                                         st);
    case 64: return ftt_tb_bwd_launch<2>(trace, q, ends, B, L, moves, bases,
                                         st);
    case 128: return ftt_tb_bwd_launch<4>(trace, q, ends, B, L, moves, bases,
                                          st);
    case 256: return ftt_tb_bwd_launch<8>(trace, q, ends, B, L, moves, bases,
                                          st);
    }
    return (int)cudaErrorInvalidValue;
}

// K2, block route: one row a block, nw = blockDim.x / 32 warps each
// sweeping a segment of 32C cells (tb_sweep.cuh ftt_tb_seg_sweep); trace
// [B, ceil(2L/G), W/C] words.  Dynamic shared memory: FTT_TB_SEG_SMEM.
#define FTT_TB_SEG_WARPS 4      // at most 4 segments a row (W <= 1024)
#define FTT_TB_SEG_SMEM(C, nw) ((size_t)(nw) * (32 + FTT_TB_WARP_SMEM(C)))

template <int C, bool EXCH>
__global__ void __launch_bounds__(32 * FTT_TB_SEG_WARPS)
ftt_tb_fwd_seg_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ t,
                      const int* __restrict__ qlen,
                      const int* __restrict__ tlen, int B, int L, int W,
                      int end_bonus, int* __restrict__ ends,
                      unsigned* __restrict__ trace) {
    constexpr int G = FTT_TB_GROUP(C);
    extern __shared__ __align__(16) unsigned char seg_smem[];
    const int nw = blockDim.x >> 5;
    const int w = threadIdx.x >> 5;
    const int b = blockIdx.x;
    FttTbSeg seg;
    seg.W = W;
    seg.w = w;
    seg.nw = nw;
    seg.edges = (volatile unsigned*)seg_smem;            // [2][nw][2]
    seg.red = (int*)(seg_smem + 16 * nw);                // [nw][4]
    unsigned char* rings =
        seg_smem + 32 * nw + (size_t)w * FTT_TB_WARP_SMEM(C);
    const size_t row_words = (size_t)((2 * L + G - 1) / G) * (W / C);
    ftt_tb_seg_sweep<C, EXCH>(q + (size_t)b * L, t + (size_t)b * L, qlen[b],
                              tlen[b], L, end_bonus,
                              trace + b * row_words + 32 * w, rings, seg);
    __syncthreads();
    // the warps' bests -> one: highest score, earliest s, lowest i
    if (threadIdx.x == 0) {
        int bs = FTT_NEG, bst = 0, bi = 0, bd = 0;
        for (int k = 0; k < nw; ++k) {
            const int* r = seg.red + 4 * k;
            if (r[0] > bs || (r[0] == bs && r[0] > FTT_NEG &&
                              (r[1] < bst || (r[1] == bst && r[2] < bi)))) {
                bs = r[0]; bst = r[1]; bi = r[2]; bd = r[3];
            }
        }
        const bool found = bs > FTT_NEG;
        ends[b] = found ? bi : 0;
        ends[B + b] = found ? bst - bi : 0;
        ends[2 * B + b] = found ? bd : 0;
    }
}

// K3, block route: the warp walk of ftt_tb_bwd_kernel (same outputs, same
// rules, 8 rows a block, windows of 32 anti-diagonals counted down from
// 2L) on the block route's trace.  A window's steps touch at most
// FTT_TB_WIN / G + 1 trace groups (2L need not be a multiple of G), and
// of each group it stages FTT_TB_SPAN(C) words from x0, the 16-byte-aligned
// word of the lane FTT_TB_REACH below the walk's lane l_ref when the copy
// is issued: the lanes within FTT_TB_REACH of l_ref, which holds every lane
// the walk reads through the window it is walking and the next one (at
// most 63 anti-diagonals away, a lane each).  Steps before s = 1 and bytes
// past ceil(2L/4) are not stored.
#define FTT_TB_REACH 64
#define FTT_TB_SPAN(C) (4 * (2 * FTT_TB_REACH / (4 * (C)) + 1))
#define FTT_TB_WGROUPS(C) (FTT_TB_WIN / FTT_TB_GROUP(C) + 1)
#define FTT_TB_BWD_BLOCK_SMEM(C)                                        \
    ((size_t)FTT_TB_BWD_ROWS * 2 * FTT_TB_WGROUPS(C) * FTT_TB_SPAN(C) *  \
         sizeof(unsigned) +                                              \
     2 * FTT_TB_BWD_ROWS * (2 * sizeof(unsigned) + FTT_TB_BASE_PITCH))

template <int C>
__global__ void __launch_bounds__(32 * FTT_TB_BWD_ROWS)
ftt_tb_bwd_block_kernel(const unsigned* __restrict__ trace,
                        const int8_t* __restrict__ q,
                        const int* __restrict__ ends, int B, int L, int W,
                        uint8_t* __restrict__ moves,
                        int8_t* __restrict__ bases) {
    constexpr int LOG2C = C == 4 ? 2 : C == 8 ? 3 : 4;
    constexpr int G = FTT_TB_GROUP(C);
    constexpr int LOG2G = 4 - LOG2C;
    constexpr int SPAN = FTT_TB_SPAN(C);
    constexpr int NCH = SPAN / 4;                   // 16-byte pieces a group
    constexpr int WIN_WORDS = FTT_TB_WGROUPS(C) * SPAN;
    constexpr int ROWS = FTT_TB_BWD_ROWS;
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    unsigned* win = (unsigned*)smem + (size_t)warp * 2 * WIN_WORDS;
    unsigned* st_moves =
        (unsigned*)smem + (size_t)ROWS * 2 * WIN_WORDS;      // [2][ROWS][2]
    int8_t* st_bases = (int8_t*)(st_moves + 2 * ROWS * 2);

    const int b0 = blockIdx.x * ROWS;
    const int b = b0 + warp;
    const bool live = b < B;
    int i = live ? ends[b] : 0;
    int j = live ? ends[B + b] : 0;
    const int s_start = i + j;
    bool done = s_start == 0;
    const int S = 2 * L;
    const int NX = W >> LOG2C;                      // trace words a group
    const int NG = (S + G - 1) >> LOG2G;            // groups a row
    const unsigned* trow = trace + (size_t)(live ? b : 0) * NG * NX;
    const int8_t* qr = q + (size_t)(live ? b : 0) * L;
    const int n_win = (S + FTT_TB_WIN - 1) / FTT_TB_WIN;
    const int n_bytes = (S + 3) >> 2;
    const int t_row = threadIdx.x % ROWS;
    const int t_col = threadIdx.x / ROWS;

    // window n covers anti-diagonals S - 32n - 31 .. S - 32n, whose steps
    // lie in groups g0 .. g0 + FTT_TB_WGROUPS - 1; copies their words from
    // x0 into dst and returns x0
    auto stage = [&](int n, int l_ref, unsigned* dst) {
        const int g0 = (S - FTT_TB_WIN * (n + 1)) >> LOG2G;     // floor
        const int x0 = max((l_ref - FTT_TB_REACH) >> LOG2C, 0) & ~3;
        for (int k = lane; k < FTT_TB_WGROUPS(C) * NCH; k += 32) {
            const int gg = k / NCH;
            const int u = k - gg * NCH;
            const int g = g0 + gg;
            const int x = x0 + 4 * u;
            if (g >= 0 && g < NG && x < NX)
                ftt_cp_async16(dst + gg * SPAN + 4 * u,
                               trow + (size_t)g * NX + x);
        }
        return x0;
    };
    const int n_first = (S - s_start) / FTT_TB_WIN;
    int x0_cur = 0, x0_next = 0;
    if (!done)
        x0_cur = stage(n_first, i - ftt_tb_off(s_start, W),
                       win + (n_first & 1) * WIN_WORDS);
    asm volatile("cp.async.commit_group;\n" ::);

    for (int n = 0; n < n_win; ++n) {
        const int s_hi = S - FTT_TB_WIN * n;
        const int par = n & 1;
        int my_base = 4;
        unsigned m_lo = ~0u, m_hi = ~0u;         // steps 0-15, 16-31
        if (!done && n >= n_first) {             // per warp
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
            __syncwarp();
            if (n + 1 < n_win)                   // the next window, in flight
                x0_next = stage(n + 1, i - ftt_tb_off(i + j, W),
                                win + (par ^ 1) * WIN_WORDS);
            asm volatile("cp.async.commit_group;\n" ::);
            // the walk loses at most one i a step: lane k holds q[i_top-1-k]
            const int i_top = i;
            const int qi = i_top - 1 - lane;
            const int qv = (qi >= 0 && qi < L) ? qr[qi] : 4;
            const unsigned* buf = win + par * WIN_WORDS;
            const int g0 = (s_hi - FTT_TB_WIN) >> LOG2G;
            unsigned oob = 0;
            m_lo = m_hi = 0;
#pragma unroll
            for (int k = 0; k < FTT_TB_WIN; ++k) {
                const int s = s_hi - k;
                unsigned m = 3;
                if (!done && i + j == s) {
                    const int l = i - ftt_tb_off(s, W);
                    if ((unsigned)l < (unsigned)W) {
                        // step s: group (s-1) / G, field
                        // ((s-1) % G) * C + l % C of word l / C
                        const int row =
                            (((s - 1) >> LOG2G) - g0) * SPAN - x0_cur;
                        const unsigned w = buf[row + (l >> LOG2C)];
                        m = (w >> (2 * (((s - 1) & (G - 1)) * C +
                                        (l & (C - 1))))) & 3;
                    } else {
                        m = 0;
                        oob |= 1u << k;
                    }
                    i -= (m & 1) ^ 1;            // diag or left consumes q
                    j -= ((m >> 1) & 1) ^ 1;     // diag or up consumes t
                    done = (i | j) == 0;
                }
                if (k < 16) m_lo |= m << (2 * k);
                else m_hi |= m << (2 * (k - 16));
            }
            x0_cur = x0_next;
            const int sh = 2 * (lane & 15);
            const unsigned my_m = ((lane < 16 ? m_lo : m_hi) >> sh) & 3;
            const unsigned eat_lo = ~m_lo & 0x55555555u;
            const unsigned eat_hi = ~m_hi & 0x55555555u;
            const unsigned below = (1u << sh) - 1;
            const int before = lane < 16
                ? __popc(eat_lo & below)
                : __popc(eat_lo) + __popc(eat_hi & below);
            const int my_i = i_top - before;
            const int qc = __shfl_sync(FTT_TB_FULL, qv, before);
            if (my_m == 3 || my_m == 1) my_base = 4;
            else if ((oob >> lane) & 1) my_base = 0;
            else my_base = my_i >= 1 ? min(qc, 4) : 4;
        }
        // stage this window's output, then store it with the batch minor
        if (lane == 0) {
            st_moves[(par * ROWS + warp) * 2] = m_lo;
            st_moves[(par * ROWS + warp) * 2 + 1] = m_hi;
        }
        st_bases[(par * ROWS + warp) * FTT_TB_BASE_PITCH + lane] =
            (int8_t)my_base;
        __syncthreads();
        if (b0 + t_row < B) {
            const int sb = s_hi - 1 - t_col;
            if (sb >= 0)
                bases[(size_t)sb * B + b0 + t_row] =
                    st_bases[(par * ROWS + t_row) * FTT_TB_BASE_PITCH + t_col];
            const int byte = n * (FTT_TB_WIN / 4) + t_col;
            if (t_col < FTT_TB_WIN / 4 && byte < n_bytes)
                moves[(size_t)byte * B + b0 + t_row] =
                    (uint8_t)(st_moves[(par * ROWS + t_row) * 2 +
                                       (t_col >> 2)] >> (8 * (t_col & 3)));
        }
    }
    // a row that ended inside a window left the next one in flight
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int C>
static int ftt_tb_fwd_seg_launch(const void* q, const void* t,
                                 const void* qlen, const void* tlen, int B,
                                 int L, int W, int end_bonus, void* ends,
                                 void* trace, cudaStream_t stream) {
    const int nw = (W + 32 * C - 1) / (32 * C);
    if (nw > FTT_TB_SEG_WARPS) return (int)cudaErrorInvalidValue;
    const size_t smem = FTT_TB_SEG_SMEM(C, nw);
    if (nw == 1)
        ftt_tb_fwd_seg_kernel<C, false><<<B, 32, smem, stream>>>(
            (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
            (const int*)tlen, B, L, W, end_bonus, (int*)ends,
            (unsigned*)trace);
    else
        ftt_tb_fwd_seg_kernel<C, true><<<B, 32 * nw, smem, stream>>>(
            (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
            (const int*)tlen, B, L, W, end_bonus, (int*)ends,
            (unsigned*)trace);
    return (int)cudaGetLastError();
}

template <int C>
static int ftt_tb_bwd_block_launch(const void* trace, const void* q,
                                   const void* ends, int B, int L, int W,
                                   void* moves, void* bases,
                                   cudaStream_t stream) {
    const size_t smem = FTT_TB_BWD_BLOCK_SMEM(C);
    cudaError_t err = cudaFuncSetAttribute(
        ftt_tb_bwd_block_kernel<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (B + FTT_TB_BWD_ROWS - 1) / FTT_TB_BWD_ROWS;
    ftt_tb_bwd_block_kernel<C><<<blocks, 32 * FTT_TB_BWD_ROWS, smem,
                                 stream>>>(
        (const unsigned*)trace, (const int8_t*)q, (const int*)ends, B, L, W,
        (uint8_t*)moves, (int8_t*)bases);
    return (int)cudaGetLastError();
}

// The block route: W any multiple of 32 up to 1024 with C = 4, 8 or 16
// cells a lane (W/C a multiple of 4, so that a group of the trace is whole
// 16-byte pieces for K3; at most 4 warps a row), L any.  ftt_tb_fwd_block
// takes ftt_tb_fwd's arguments and C, with trace [B, ceil(2L/G), W/C]
// int32, G = 16/C; W 512 at C 16 runs the warp route's kernel, whose
// trace is that layout, any other band ceil(W/32C) warps a row.
// ftt_tb_bwd_block takes ftt_tb_bwd's and C, with moves [ceil(2L/4), B]
// uint8.
static bool ftt_tb_block_shape(int W, int C) {
    return W % 32 == 0 && W >= 32 && W <= 1024 &&
           (C == 4 || C == 8 || C == 16) && W % (4 * C) == 0;
}

extern "C" int ftt_tb_fwd_block(const void* q, const void* t,
                                const void* qlen, const void* tlen, int B,
                                int L, int W, int C, int end_bonus,
                                void* ends, void* trace, void* stream) {
    if (!ftt_tb_block_shape(W, C)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (W == 32 * C && C == 16)          // 80 registers, not the sweep's 117
        return ftt_tb_fwd_launch<16>(q, t, qlen, tlen, B, L, end_bonus, ends,
                                     trace, st);
    switch (C) {
    case 4: return ftt_tb_fwd_seg_launch<4>(q, t, qlen, tlen, B, L, W,
                                            end_bonus, ends, trace, st);
    case 8: return ftt_tb_fwd_seg_launch<8>(q, t, qlen, tlen, B, L, W,
                                            end_bonus, ends, trace, st);
    default: return ftt_tb_fwd_seg_launch<16>(q, t, qlen, tlen, B, L, W,
                                              end_bonus, ends, trace, st);
    }
}

extern "C" int ftt_tb_bwd_block(const void* trace, const void* q,
                                const void* ends, int B, int L, int W, int C,
                                void* moves, void* bases, void* stream) {
    if (!ftt_tb_block_shape(W, C)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (C) {
    case 4: return ftt_tb_bwd_block_launch<4>(trace, q, ends, B, L, W,
                                              moves, bases, st);
    case 8: return ftt_tb_bwd_block_launch<8>(trace, q, ends, B, L, W,
                                              moves, bases, st);
    default: return ftt_tb_bwd_block_launch<16>(trace, q, ends, B, L, W,
                                                moves, bases, st);
    }
}
