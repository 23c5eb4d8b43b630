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
// out of reach: K2 is band_dp.cuh's block-per-row sweep with its two-bit
// trace (W/4 bytes a step, the same bytes as the warp route's, laid out as
// two bit planes), and K3 walks each row with one thread, reading the pair
// of plane words that holds its cell straight from device memory.  Each
// step of that walk waits on its own load, so the latency of those loads
// sets the block route's K3 time; it is the simple form, not a tuned one.
#include "band_dp.cuh"
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

// K2, block route: a block of W threads per row (band_dp.cuh with TRACE).
__global__ void __launch_bounds__(1024)
ftt_tb_fwd_block_kernel(const int8_t* __restrict__ q,
                        const int8_t* __restrict__ t,
                        const int* __restrict__ qlen,
                        const int* __restrict__ tlen, int B, int L, int W,
                        int end_bonus, int* __restrict__ ends,
                        unsigned* __restrict__ trace) {
    ftt_band_dp<true>(q, t, qlen, tlen, B, L, W, end_bonus, ends, trace);
}

#define FTT_TB_BWD_BLOCK_THREADS 64

// K3, block route: thread b walks row b of the block route's trace
// ([B, 2L, W/16] words) with the warp route's rules (the move stream packed
// four to a byte, 3 past the walk and as the padding of a last byte when
// 2L % 4 != 0; an out-of-band cell reads as move 0, base 0).
__global__ void __launch_bounds__(FTT_TB_BWD_BLOCK_THREADS)
ftt_tb_bwd_block_kernel(const unsigned* __restrict__ trace,
                        const int8_t* __restrict__ q,
                        const int* __restrict__ ends, int B, int L, int W,
                        uint8_t* __restrict__ moves,
                        int8_t* __restrict__ bases) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int words = W / 16;
    const int S = 2 * L;
    const unsigned* trow = trace + (size_t)b * S * words;
    const int8_t* qr = q + (size_t)b * L;
    int i = ends[b];
    int j = ends[B + b];
    bool done = (i | j) == 0;
    unsigned byte = 0;
    for (int s = S; s >= 1; --s) {
        const int k = S - s;             // index in the END->START stream
        int m = 3, base = 4;
        if (!done && i + j == s) {
            const int l = i - ftt_band_off(s, W);
            // q[i-1] is read beside the trace words, not after the move
            // they hold: the step then waits on one load, not two in a row
            const int qv = (i >= 1 && i <= L) ? min((int)qr[i - 1], 4) : 4;
            if ((unsigned)l < (unsigned)W) {
                const uint2 w = *(const uint2*)(
                    trow + (size_t)(s - 1) * words + (l >> 5) * 2);
                m = ((w.x >> (l & 31)) & 1) | (((w.y >> (l & 31)) & 1) << 1);
                if (m != 1) base = qv;
            } else {
                m = 0;
                base = 0;
            }
            i -= (m & 1) ^ 1;            // diag or left consumes q
            j -= ((m >> 1) & 1) ^ 1;     // diag or up consumes t
            done = (i | j) == 0;
        }
        byte |= (unsigned)m << (2 * (k & 3));
        if ((k & 3) == 3) {
            moves[(size_t)(k >> 2) * B + b] = (uint8_t)byte;
            byte = 0;
        }
        bases[(size_t)(s - 1) * B + b] = (int8_t)base;
    }
    if (S & 3) {
        for (int f = S & 3; f < 4; ++f) byte |= 3u << (2 * f);
        moves[(size_t)(S >> 2) * B + b] = (uint8_t)byte;
    }
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

// The block route: W any multiple of 32 up to 1024, L any.  ftt_tb_fwd_block
// takes ftt_tb_fwd's arguments with trace [B, 2L, W/16] int32;
// ftt_tb_bwd_block ftt_tb_bwd's, with moves [ceil(2L/4), B] uint8.
extern "C" int ftt_tb_fwd_block(const void* q, const void* t,
                                const void* qlen, const void* tlen, int B,
                                int L, int W, int end_bonus, void* ends,
                                void* trace, void* stream) {
    if (W % 32 || W < 32 || W > 1024) return (int)cudaErrorInvalidValue;
    const size_t smem = 3 * (size_t)(W + 4) * sizeof(int);
    ftt_tb_fwd_block_kernel<<<B, W, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
        (const int*)tlen, B, L, W, end_bonus, (int*)ends, (unsigned*)trace);
    return (int)cudaGetLastError();
}

extern "C" int ftt_tb_bwd_block(const void* trace, const void* q,
                                const void* ends, int B, int L, int W,
                                void* moves, void* bases, void* stream) {
    if (W % 32 || W < 32 || W > 1024) return (int)cudaErrorInvalidValue;
    const int threads = FTT_TB_BWD_BLOCK_THREADS;
    ftt_tb_bwd_block_kernel<<<(B + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(
        (const unsigned*)trace, (const int8_t*)q, (const int*)ends, B, L, W,
        (uint8_t*)moves, (int8_t*)bases);
    return (int)cudaGetLastError();
}
