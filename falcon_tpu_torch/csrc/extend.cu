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
// s = 1 .. min(qlen + tlen, 2L).  What costs is not that arithmetic but
// the step around it: with a block barrier per anti-diagonal, three
// shared-memory rows, q and t read per cell from device memory and the edge
// rules evaluated in every cell, a sweep runs at a quarter of the rate the
// warp kernel below reaches.
//
// What the design does about it.  Two kernels, chosen by W alone
// (ops.align_cuda.kernel_for):
// - W = 32, 64, 128, 256, 512: ftt_extend_warp_kernel, the warp-resident
//   sweep of tb_sweep.cuh without its trace.  A warp holds a row's band in
//   registers (W/32 cells a lane), takes neighbours by shuffle, reads q and
//   t from shared-memory rings filled a chunk ahead, has no barrier in the
//   sweep, and runs interior steps without mask, forcing or scoring.  Rows
//   of a launch differ in length (each stops at its own last boundary
//   step), so the grid is sized to fill the card once and every warp takes
//   its next row from a counter in device memory until none is left; the
//   launch bounds keep 8 warps on a scheduler (4 at W = 512, whose 16 cells
//   a lane need the registers), which is what hides a step's dependent
//   chain.
// - every other multiple of 32 up to 1024: ftt_extend_block_kernel
//   (band_dp.cuh), one block of W threads per row and a barrier per step.
//   It takes any W and is slower per cell.
#include "band_dp.cuh"
#include "tb_sweep.cuh"

#define FTT_EXT_WARPS 4        // warp kernel: warps (rows in flight) a block

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

__global__ void ftt_extend_block_kernel(const int8_t* __restrict__ q,
                                        const int8_t* __restrict__ t,
                                        const int* __restrict__ qlen,
                                        const int* __restrict__ tlen, int B,
                                        int L, int W, int end_bonus,
                                        int* __restrict__ ends) {
    ftt_band_dp(q, t, qlen, tlen, B, L, W, end_bonus, ends);
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

// q, t: [B, L] int8; qlen, tlen: [B] int32; ends: [3, B] int32 (i, j, d);
// next_row: one int32, zero at the launch.  W is 32, 64, 128, 256 or 512.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another W.
extern "C" int ftt_extend_warp(const void* q, const void* t,
                               const void* qlen, const void* tlen, int B,
                               int L, int W, int end_bonus, void* ends,
                               void* next_row, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (W) {
    case 32: return ftt_extend_warp_launch<1>(q, t, qlen, tlen, B, L,
                                              end_bonus, ends, next_row, st);
    case 64: return ftt_extend_warp_launch<2>(q, t, qlen, tlen, B, L,
                                              end_bonus, ends, next_row, st);
    case 128: return ftt_extend_warp_launch<4>(q, t, qlen, tlen, B, L,
                                               end_bonus, ends, next_row, st);
    case 256: return ftt_extend_warp_launch<8>(q, t, qlen, tlen, B, L,
                                               end_bonus, ends, next_row, st);
    case 512: return ftt_extend_warp_launch<16>(q, t, qlen, tlen, B, L,
                                                end_bonus, ends, next_row,
                                                st);
    }
    return (int)cudaErrorInvalidValue;
}

// The same arguments without the counter; W any multiple of 32 up to 1024.
extern "C" int ftt_extend_block(const void* q, const void* t,
                                const void* qlen, const void* tlen, int B,
                                int L, int W, int end_bonus, void* ends,
                                void* stream) {
    const size_t smem = 3 * (size_t)(W + 4) * sizeof(int);
    ftt_extend_block_kernel<<<B, W, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
        (const int*)tlen, B, L, W, end_bonus, (int*)ends);
    return (int)cudaGetLastError();
}
