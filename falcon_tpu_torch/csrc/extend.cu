// K1: batched banded extension (the overlap engine's extension step).
//
// Replaces falcon_tpu/ops/align_pallas.py `_kernel` (entry
// extend_batch_pallas); semantic reference falcon_tpu/ops/align_device.py
// extend_batch_device, plain twin falcon_tpu_torch/ops/align_device.py
// extend_batch.  The DP itself is band_dp.cuh.
//
// What bounds it on the H100: integer issue.  Each cell is ~15 int32
// min/add/compare/select operations on shared-memory operands, with no
// reuse a tensor core could take; per batch the work is
// sum over rows of (qlen + tlen) * W cells.
//
// What the design does about it: one block of W threads per row keeps
// every operand of a step in shared memory (three anti-diagonal rows,
// one barrier per step) and in registers (the per-lane best cell), so
// device memory sees only the q/t characters and three ints per row.
// Each row stops at its own last boundary step, so rows of a batch never
// pay for a longer neighbour the way a 256-row Pallas tile did.  Warp-
// resident bands with shuffles, staged q/t windows and int16 carries are
// later work.
#include "band_dp.cuh"

__global__ void ftt_extend_kernel(const int8_t* __restrict__ q,
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

// q, t: [B, L] int8; qlen, tlen: [B] int32; ends: [3, B] int32 (i, j, d).
// Returns cudaGetLastError() after the launch.
extern "C" int ftt_extend(const void* q, const void* t, const void* qlen,
                          const void* tlen, int B, int L, int W,
                          int end_bonus, void* ends, void* stream) {
    const size_t smem = 3 * (size_t)(W + 4) * sizeof(int);
    ftt_extend_kernel<<<B, W, smem, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)t, (const int*)qlen,
        (const int*)tlen, B, L, W, end_bonus, (int*)ends);
    return (int)cudaGetLastError();
}
