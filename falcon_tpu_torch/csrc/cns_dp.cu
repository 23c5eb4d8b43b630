// K4 + K5 + K6: the device-DP consensus (tag accumulation, forward scan,
// backtrack walk) for one DP batch of G seed groups padded to T columns.
//
// K4 ftt_tags_kernel replaces falcon_tpu/ops/cns_dp.py
// accumulate_tags_planes (with _column_tags_planes); K5
// ftt_cns_scan_kernel its consensus_scan (the sequential within-t chain);
// K6 ftt_cns_walk_kernel its backtrack + compact_emit, equivalently
// backtrack_walk with no step cap.  Plain twins:
// falcon_tpu_torch/ops/cns_dp.py.  None of the three was a Pallas kernel;
// on the TPU they are XLA scans and cumsums.
//
// Counts are uint16 in the flat [L0 | Ld | dump] buffer of falcon_tpu
// (msa_size).  CUDA has no 16-bit integer atomicAdd, so K4 adds 1 << 16*h
// to the aligned 32-bit word holding the count; a count stays below 2^16
// (it is bounded by one group's alignments), so no carry crosses halves.
// Tags of dead rows and out-of-range columns are dropped: the dump slot
// stays 0.
//
// What bounds them on the H100, and what the design does about it:
// - K4 is a scan along each row's column stream (running counts, a
//   first-bad latch, the last kept column) plus one scattered atomic per
//   kept column.  One warp per row takes 32 columns a step; ballots,
//   popcounts and shuffles stand in for the cumsum/cummax of the JAX
//   decode, and the carries between steps stay in registers.  A first pass
//   counts the row's columns for the keep gate.  The move and base streams
//   are [., B]: a warp reads bytes B apart, so the reads are sector-bound;
//   the four rows of a block share those sectors through L1/L2.  Integer
//   atomics make the counts independent of order, hence bit-equal run to
//   run.
// - K5 is latency-bound: T dependent steps, each a chain of D - 1
//   dependent levels of 5 x 6 max/argmax, per group.  One warp per group;
//   the step's 470 counts are loaded into registers one step ahead and
//   staged through shared memory, so the loads overlap the previous
//   step's chain; lanes 0-4 each own one base through the chain.  With
//   G = 100-400 groups a batch, most SMs stay idle: packing more groups
//   (or several batches) onto the card is later work.
// - K6 is latency-bound: each step reads the pred code that the previous
//   step pointed at.  One thread per group; the walk needs no step cap,
//   since every step either emits, moves down a delta level (at most D a
//   column) or moves to t - 1.  Prefetching bp along the likely path is
//   later work.
//
// Every score is a multiple of 0.5 far below 2^23, so float32 adds are
// exact; a class with no link is skipped, where the twin's NEG candidate
// never wins; the halving is __fmul_rn so that it cannot be contracted.
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int NPC0 = 16;
constexpr int NPCD = 6;
constexpr int DMAX = 16;   // delta fits the 4-bit field of the latch
constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_WARPS = 4;
// 32-bit words of one step's counts: 5*NPC0/2 + (DMAX-1)*5*NPCD/2 = 265
constexpr int SCAN_WORDS = 5 * NPC0 / 2 + (DMAX - 1) * 5 * NPCD / 2;
constexpr int SCAN_PER_LANE = (SCAN_WORDS + 31) / 32;
}  // namespace

// ---------------------------------------------------------------- K4 ----
// One warp per row b.  Column k (START->END order) is stream index
// S - 1 - k of the END->START packed moves.
__global__ void ftt_tags_kernel(uint16_t* __restrict__ msa,
                                const uint8_t* __restrict__ mvp,
                                const int8_t* __restrict__ basep,
                                const int* __restrict__ bd,
                                const int* __restrict__ gidx,
                                const int* __restrict__ s2, int B, int P,
                                int G, int T, int D, float max_diff) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= B) return;                       // the whole warp leaves
    const int g = gidx[b];
    if (g < 0 || g >= G) return;
    const int S = 4 * P;
    int n = 0;                                // ncols: non-inactive moves
    for (int p = lane; p < P; p += 32) {
        const int x = mvp[(size_t)p * B + b];
        n += ((x & 3) != 3) + (((x >> 2) & 3) != 3) +
             (((x >> 4) & 3) != 3) + ((x >> 6) != 3);
    }
    for (int o = 16; o; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
    if (!(n > 500 && (float)bd[b] < __fmul_rn(max_diff, (float)n))) return;

    unsigned int* words = reinterpret_cast<unsigned int*>(msa);
    const long long l0sz = (long long)G * T * 5 * NPC0;
    const unsigned lt = (1u << lane) - 1u;
    const unsigned le = lt | (1u << lane);
    const int tpos0 = s2[b] - 1;
    int cq = 0;          // q-consuming columns so far
    int nadv = 0;        // t-advancing columns so far
    int cq_at_adv = 0;   // cq at the last t-advancing column
    int prev = -1;       // (k << 7 | delta << 3 | base) of the last kept
    for (int k0 = 0; k0 < S; k0 += 32) {
        const int k = k0 + lane;
        int m = 3, base = 4;
        if (k < S) {
            const int i = S - 1 - k;
            m = (mvp[(size_t)(i >> 2) * B + b] >> (2 * (i & 3))) & 3;
            base = basep[(size_t)k * B + b];
        }
        const bool valid = m != 3;
        const bool adv = m == 0 || m == 1;
        const unsigned bq = __ballot_sync(FULL, m == 0 || m == 2);
        const unsigned ba = __ballot_sync(FULL, adv);
        const int cq_k = cq + __popc(bq & le);
        const int tpos = tpos0 + nadv + __popc(ba & le);
        const unsigned ba_le = ba & le;
        const int cq_src = __shfl_sync(FULL, cq_k,
                                       ba_le ? 31 - __clz(ba_le) : 0);
        const int delta = adv ? 0 : cq_k - (ba_le ? cq_src : cq_at_adv);
        const unsigned bb =
            __ballot_sync(FULL, valid && (delta >= D || tpos < 0));
        const bool ok = valid && !(bb & le);
        const int enc = ok ? (k << 7) | (delta << 3) | base : -1;
        const unsigned bo = __ballot_sync(FULL, ok);
        const unsigned bo_lt = bo & lt;
        const int enc_src = __shfl_sync(FULL, enc,
                                        bo_lt ? 31 - __clz(bo_lt) : 0);
        const int pv = bo_lt ? enc_src : prev;
        if (ok && tpos < T) {                 // ok implies tpos >= 0
            const bool pe = pv >= 0;
            const int pbase = pv & 7;
            const long long gT = (long long)g * T + tpos;
            long long idx;
            if (adv) {
                const int pc0 = pe ? min((pv >> 3) & 15, 2) * 5 + pbase
                                   : NPC0 - 1;
                idx = gT * (5 * NPC0) + base * NPC0 + pc0;
            } else {
                const int pcd = pe ? pbase : NPCD - 1;
                idx = l0sz + (gT * (D - 1) + (delta - 1)) * (5 * NPCD) +
                      base * NPCD + pcd;
            }
            atomicAdd(words + (idx >> 1), 1u << (16 * (int)(idx & 1)));
        }
        cq += __popc(bq);
        nadv += __popc(ba);
        if (ba) cq_at_adv = __shfl_sync(FULL, cq_k, 31 - __clz(ba));
        if (bo) prev = __shfl_sync(FULL, enc, 31 - __clz(bo));
        if (bb) break;       // every later column of the row is dropped
    }
}

// ---------------------------------------------------------------- K5 ----
struct ScanWarp {
    unsigned int cw[SCAN_PER_LANE * 32];   // this step's counts
    float S[2][DMAX * 5];                  // S_prev / S_cur, [d][b]
    float s2p[5];
    int a2[5];
};

// Word w of step t's counts: L0 row (w < 40), then Ld row.
__device__ __forceinline__ void ftt_scan_load(const unsigned int* words,
                                              long long w0, long long wd,
                                              int nw, int lane,
                                              unsigned int* pre) {
#pragma unroll
    for (int j = 0; j < SCAN_PER_LANE; ++j) {
        const int w = lane + 32 * j;
        const int n0 = 5 * NPC0 / 2;
        if (w < nw) pre[j] = w < n0 ? words[w0 + w] : words[wd + w - n0];
    }
}

__global__ void ftt_cns_scan_kernel(const uint16_t* __restrict__ msa, int G,
                                    int T, int D, uint8_t* __restrict__ bp,
                                    int* __restrict__ cov,
                                    float* __restrict__ gb_s,
                                    int* __restrict__ gb_t,
                                    int* __restrict__ gb_d,
                                    int* __restrict__ gb_b) {
    __shared__ ScanWarp sw[SCAN_WARPS];
    const int lane = threadIdx.x & 31;
    const int g = blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
    if (g >= G) return;
    ScanWarp& w = sw[threadIdx.x >> 5];
    const unsigned int* words = reinterpret_cast<const unsigned int*>(msa);
    const int nld = (D - 1) * 5 * NPCD;                   // Ld counts a step
    const int nw = (5 * NPC0 + nld) / 2;
    const long long l0w = (long long)g * T * (5 * NPC0 / 2);
    const long long ldw = (long long)G * T * (5 * NPC0 / 2) +
                          (long long)g * T * (nld / 2);
    const uint16_t* c0 = reinterpret_cast<const uint16_t*>(w.cw);
    const uint16_t* cd = c0 + 5 * NPC0;
    for (int i = lane; i < DMAX * 5; i += 32) w.S[0][i] = -1.0f;
    int cur = 1;
    float gbs = -1.0f;
    int gbt = 0, gbd = 0, gbb = 0;
    unsigned int pre[SCAN_PER_LANE];
    ftt_scan_load(words, l0w, ldw, nw, lane, pre);
    for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int j = 0; j < SCAN_PER_LANE; ++j)
            if (lane + 32 * j < nw) w.cw[lane + 32 * j] = pre[j];
        __syncwarp();
        if (t + 1 < T)
            ftt_scan_load(words, l0w + (long long)(t + 1) * (5 * NPC0 / 2),
                          ldw + (long long)(t + 1) * (nld / 2), nw, lane,
                          pre);
        // coverage: the step's 80 delta-0 counts
        int c = 0;
        for (int i = lane; i < 5 * NPC0 / 2; i += 32)
            c += (w.cw[i] & 0xffff) + (w.cw[i] >> 16);
        for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
        const float half = __fmul_rn(0.5f, (float)c);
        const float* Sp = w.S[cur ^ 1];
        float* Sc = w.S[cur];
        uint8_t* bpt = bp + ((size_t)t * G + g) * (D * 5);
        const int b = lane;
        if (b < 5) {   // best delta >= 2 predecessor of base b
            float best = Sp[2 * 5 + b];
            int a = 2;
            for (int d = 3; d < D; ++d) {
                const float v = Sp[d * 5 + b];
                if (v > best) { best = v; a = d; }
            }
            w.s2p[b] = best;
            w.a2[b] = a;
        }
        __syncwarp();
        if (b < 5) {   // delta 0: 16 pred classes
            float best = 0.0f;
            int arg = 0;
            bool ex = false;
#pragma unroll
            for (int k = 0; k < NPC0; ++k) {
                const int n = c0[b * NPC0 + k];
                if (n) {
                    const float p = k < 10 ? Sp[k]
                                  : (k < 15 ? w.s2p[k - 10] : 0.0f);
                    const float v = p + (float)n;
                    if (!ex || v > best) { best = v; arg = k; }
                    ex = true;
                }
            }
            Sc[b] = ex ? best - half : -1.0f;
            int code = 254;
            if (ex && arg != NPC0 - 1) {
                const int pb = arg % 5, cls = arg / 5;
                code = (cls < 2 ? cls : w.a2[pb]) * 5 + pb;
            }
            bpt[b] = (uint8_t)code;
        }
        for (int d = 1; d < D; ++d) {   // the within-t delta chain
            __syncwarp();
            if (b < 5) {
                const uint16_t* cn = cd + (d - 1) * 5 * NPCD + b * NPCD;
                float best = 0.0f;
                int arg = 0;
                bool ex = false;
#pragma unroll
                for (int k = 0; k < NPCD; ++k) {
                    const int n = cn[k];
                    if (n) {
                        const float p = k < 5 ? Sc[(d - 1) * 5 + k] : 0.0f;
                        const float v = p + (float)n;
                        if (!ex || v > best) { best = v; arg = k; }
                        ex = true;
                    }
                }
                Sc[d * 5 + b] = ex ? best - half : -1.0f;
                bpt[d * 5 + b] =
                    (uint8_t)(ex && arg != NPCD - 1 ? 128 + arg : 255);
            }
        }
        __syncwarp();
        // flat [D*5] first argmax, then the strict > update of the best
        float mv = __int_as_float(0xff800000);   // -inf
        int mi = DMAX * 5;
        for (int i = lane; i < D * 5; i += 32) {
            const float v = Sc[i];
            if (v > mv) { mv = v; mi = i; }
        }
        for (int o = 16; o; o >>= 1) {
            const float ov = __shfl_xor_sync(FULL, mv, o);
            const int oi = __shfl_xor_sync(FULL, mi, o);
            if (ov > mv || (ov == mv && oi < mi)) { mv = ov; mi = oi; }
        }
        if (mv > gbs) { gbs = mv; gbt = t; gbd = mi / 5; gbb = mi % 5; }
        if (lane == 0) cov[(size_t)g * T + t] = c;
        cur ^= 1;
        __syncwarp();
    }
    if (lane == 0) {
        gb_s[g] = gbs;
        gb_t[g] = gbt;
        gb_d[g] = gbd;
        gb_b[g] = gbb;
    }
}

// ---------------------------------------------------------------- K6 ----
__global__ void ftt_cns_walk_kernel(const uint8_t* __restrict__ bp,
                                    const int* __restrict__ cov,
                                    const float* __restrict__ gb_s,
                                    const int* __restrict__ gb_t,
                                    const int* __restrict__ gb_d,
                                    const int* __restrict__ gb_b,
                                    int min_cov, int G, int T, int D,
                                    uint8_t* __restrict__ out,
                                    int* __restrict__ counts) {
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= G) return;
    const int cap = 2 * T;
    uint8_t* row = out + (size_t)g * cap;
    int t = gb_t[g], d = gb_d[g], b = gb_b[g], ck = b, n = 0;
    bool done = gb_s[g] == -1.0f;
    while (!done) {
        const int code = bp[((size_t)t * G + g) * (D * 5) + d * 5 + b];
        if (code >= 250) break;               // the path's start
        if (ck != 4 && n < cap)
            row[n++] = (uint8_t)(ck + (cov[(size_t)g * T + t] <= min_cov
                                       ? 5 : 0));
        if (code < 128) {                     // jump to (t-1, pd, pb)
            b = code % 5;
            d = code / 5;
            --t;
        } else {                              // stay at (t, d-1, pb)
            b = code - 128;
            --d;
        }
        ck = b;
        done = t < 0 || n >= cap;
    }
    counts[g] = n;
}

// msa: flat uint16 [msa_size(G, T, D)], 4-byte aligned; mvp [P, B] uint8;
// basep [4P, B] int8; bd, gidx, s2 [B] int32.  Returns cudaGetLastError().
extern "C" int ftt_tags(void* msa, const void* mvp, const void* basep,
                        const void* bd, const void* gidx, const void* s2,
                        int B, int P, int G, int T, int D, float max_diff,
                        void* stream) {
    const int rows = 4;   // warps (rows) a block
    ftt_tags_kernel<<<(B + rows - 1) / rows, 32 * rows, 0,
                      (cudaStream_t)stream>>>(
        (uint16_t*)msa, (const uint8_t*)mvp, (const int8_t*)basep,
        (const int*)bd, (const int*)gidx, (const int*)s2, B, P, G, T, D,
        max_diff);
    return (int)cudaGetLastError();
}

// bp [T, G, D*5] uint8; cov [G, T] int32; gb_s [G] float; gb_t/d/b [G].
extern "C" int ftt_cns_scan(const void* msa, int G, int T, int D, void* bp,
                            void* cov, void* gb_s, void* gb_t, void* gb_d,
                            void* gb_b, void* stream) {
    ftt_cns_scan_kernel<<<(G + SCAN_WARPS - 1) / SCAN_WARPS,
                          32 * SCAN_WARPS, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)msa, G, T, D, (uint8_t*)bp, (int*)cov,
        (float*)gb_s, (int*)gb_t, (int*)gb_d, (int*)gb_b);
    return (int)cudaGetLastError();
}

// out [G, 2T] uint8 (zeroed by the caller), counts [G] int32.
extern "C" int ftt_cns_walk(const void* bp, const void* cov,
                            const void* gb_s, const void* gb_t,
                            const void* gb_d, const void* gb_b, int min_cov,
                            int G, int T, int D, void* out, void* counts,
                            void* stream) {
    const int threads = 128;
    ftt_cns_walk_kernel<<<(G + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)bp, (const int*)cov, (const float*)gb_s,
        (const int*)gb_t, (const int*)gb_d, (const int*)gb_b, min_cov, G, T,
        D, (uint8_t*)out, (int*)counts);
    return (int)cudaGetLastError();
}
