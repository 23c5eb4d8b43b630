// Pointer chase: the latency of one dependent read, from shared memory and
// from device memory.  Not on any path of the port: chip_smoke.py runs it
// to put measured latencies under the chain floors it prints for the
// kernels that are one dependent chain (K3, K5, K6).
//
// One thread follows i = next[i] from i = start for `steps` loads and
// reports the SM clocks the loop took.  With n_shared > 0 the first n_shared entries are
// copied into shared memory first (they must point below n_shared) and the
// chase runs there; otherwise it runs in device memory through ld.global.cg
// (no L1), and the caller lays `next` out, and moves `start` between
// runs, so that no load finds its line in L2.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void ftt_chase_kernel(const int* __restrict__ next, int n_shared,
                                 int start, int steps,
                                 int* __restrict__ out,
                                 long long* __restrict__ clocks) {
    extern __shared__ int sm[];
    int i = start;
    long long c0, c1;
    if (n_shared) {
        for (int k = 0; k < n_shared; ++k) sm[k] = next[k];
        __syncthreads();
        c0 = clock64();
        for (int s = 0; s < steps; ++s) i = sm[i];
        c1 = clock64();
    } else {
        c0 = clock64();
        for (int s = 0; s < steps; ++s) i = __ldcg(next + i);
        c1 = clock64();
    }
    *out = i;                            // keeps the chain alive
    *clocks = c1 - c0;
}

// next: int32 [n]; out: one int32; clocks: one int64.  n_shared * 4 bytes
// of shared memory (at most 48 KB).  Returns cudaGetLastError().
extern "C" int ftt_chase(const void* next, int n_shared, int start,
                         int steps, void* out, void* clocks, void* stream) {
    ftt_chase_kernel<<<1, 1, (size_t)n_shared * sizeof(int),
                       (cudaStream_t)stream>>>(
        (const int*)next, n_shared, start, steps, (int*)out,
        (long long*)clocks);
    return (int)cudaGetLastError();
}
