// K1: batched banded extension (the overlap engine's extension step).
//
// Replaces falcon_tpu/ops/align_pallas.py `_kernel` (entry
// extend_batch_pallas); semantic reference falcon_tpu/ops/align_device.py
// extend_batch_device, plain twin falcon_tpu_torch/ops/align_device.py
// extend_batch.
//
// What bounds it on the H100: the int32 rate.  A cell of the recurrence is
// a compare, an add, two mins and the +1, with no reuse a tensor core could
// take; per batch the work is the sum over rows of the band cells of
// s = 1 .. min(qlen + tlen, 2L).  What costs is the step around that
// arithmetic: the neighbours' cells, the q and t bytes, and the edge rules.
//
// What the design does about it.  One kernel at every band K1 admits,
// ftt_extend_warp_kernel<C> with C = W/32 (1 .. 32): the warp-resident
// sweep of tb_sweep.cuh without its trace.  A warp holds a row's band in
// registers (C cells a lane), takes neighbours by shuffle, reads q and t
// from shared-memory rings filled a chunk ahead, has no barrier in the
// sweep, and runs interior steps without mask, forcing or scoring.  From
// C = 16 on it reads q and t as 32-bit words (tb_sweep.cuh says why).
// Rows of a launch differ in length (each stops at its own last boundary
// step), so the grid is sized to fill the card once and every warp takes
// its next row from a counter in device memory until none is left; the
// launch bounds keep 8 warps on a scheduler up to C = 8 and 4 above (the
// registers of 9-32 cells a lane: 69-128, no spills), which is what hides
// a step's dependent chain.  ops.align_cuda.kernel_for names the two forms
// (the warp kernel to W = 512, the wide one beyond).
//
// Chosen on an H100 (tools/tb_compare.py; ms at the extender's (16384,
// 1024) and (4096, 8192)) over a block of W threads a row with a barrier a
// step (W 96: 7.57 and 17.4 -> 2.14 and 4.36; W 1024: 47.9 and 147.8 ->
// 37.8 and 37.1), over K2's padded warp at W 96 (24 lanes of 4 cells:
// 2.60 and 5.15), and beyond W = 512 over segments of 8 or 16 cells a lane
// trading edge cells through shared memory (K2's block route): slower at
// every band and shape but W 1024 at (16384, 1024), where the segments
// skip the cells outside the DP and ran 6% faster (35.7 ms) and lost by
// 30% at (4096, 8192) (52.7 ms).
#include "tb_sweep.cuh"

#define FTT_EXT_WARPS 4        // warp kernel: warps (rows) in flight a block

template <int C>
__global__ void
__launch_bounds__(32 * FTT_EXT_WARPS, C <= 8 ? 8 : 4)
ftt_extend_warp_kernel(const int8_t* __restrict__ q,
                       const int8_t* __restrict__ t,
                       const int* __restrict__ qlen,
                       const int* __restrict__ tlen, int B, int L,
                       int end_bonus, int* __restrict__ ends,
                       int* __restrict__ next_row) {
    __shared__ __align__(8) unsigned char
        wsmem[FTT_EXT_WARPS][FTT_TB_WARP_SMEM(C)];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (;;) {
        int b = 0;
        if (lane == 0) b = atomicAdd(next_row, 1);
        b = __shfl_sync(FTT_TB_FULL, b, 0);
        if (b >= B) return;              // per warp; no block barrier
        ftt_tb_sweep<C, false>(q + (size_t)b * L, t + (size_t)b * L,
                               qlen[b], tlen[b], b, B, L, end_bonus, ends,
                               nullptr, wsmem[warp]);
        __syncwarp();                    // the rings change hands
    }
}

extern "C" const char* ftt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// As many blocks as the card holds at once, or as the rows need.
template <int C>
static int ftt_extend_warp_launch(const void* q, const void* t,
                                  const void* qlen, const void* tlen, int B,
                                  int L, int end_bonus, void* ends,
                                  void* next_row, cudaStream_t stream) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ftt_extend_warp_kernel<C>, 32 * FTT_EXT_WARPS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    const int need = (B + FTT_EXT_WARPS - 1) / FTT_EXT_WARPS;
    const int blocks = need < sms * per_sm ? need : sms * per_sm;
    ftt_extend_warp_kernel<C><<<blocks, 32 * FTT_EXT_WARPS, 0, stream>>>(
        (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
        (const int*)tlen, B, L, end_bonus, (int*)ends, (int*)next_row);
    return (int)cudaGetLastError();
}

// The instantiation for C = W / 32, C in 1 .. CMAX.
template <int CMAX>
static int ftt_extend_warp_at(int C, const void* q, const void* t,
                              const void* qlen, const void* tlen, int B,
                              int L, int end_bonus, void* ends,
                              void* next_row, cudaStream_t stream) {
    if (C == CMAX)
        return ftt_extend_warp_launch<CMAX>(q, t, qlen, tlen, B, L,
                                            end_bonus, ends, next_row,
                                            stream);
    if constexpr (CMAX > 1)
        return ftt_extend_warp_at<CMAX - 1>(C, q, t, qlen, tlen, B, L,
                                            end_bonus, ends, next_row,
                                            stream);
    return (int)cudaErrorInvalidValue;
}

// q, t: [B, L] int8; qlen, tlen: [B] int32; ends: [3, B] int32 (i, j, d);
// next_row: one int32, zero at the launch.  W any multiple of 32 up to
// 1024.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another W.
extern "C" int ftt_extend_warp(const void* q, const void* t,
                               const void* qlen, const void* tlen, int B,
                               int L, int W, int end_bonus, void* ends,
                               void* next_row, void* stream) {
    if (W % 32 || W < 32 || W > 1024) return (int)cudaErrorInvalidValue;
    return ftt_extend_warp_at<32>(W / 32, q, t, qlen, tlen, B, L, end_bonus,
                                  ends, next_row, (cudaStream_t)stream);
}
