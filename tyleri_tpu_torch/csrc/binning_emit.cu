// Binning's entry emit: the pre-sort entry list, every dense slot and every
// spill cover of the first sort's order, as one (tile << 16 | zmin) key and
// one triangle id a row, written in one pass.
//
// Replaces no TPU kernel: tyleri_tpu/ops/binning.py is plain XLA.  The port
// ran the same emit eagerly (ops/binning.py's plain emit, now this kernel's
// twin, taken for CPU tensors): the dense slots' unpack, five levels of
// unpack, 31 cover bodies of a dozen ops each and three concatenations of
// 32 pieces, about 500 launches a binned pass whatever the table's size,
// each reading and writing the level's int64 rows.  On a 1M-triangle frame
// that was 8-10 ms of host dispatch with the card idle; on a 28M-triangle
// frame, ~5 ms of concatenation copies and more of int64 elementwise
// passes on the card.
//
// What it computes.  The wrapper (ops/binning.py::emit_segments) lays the
// list out on the host from the plan's integers, in the twin's order: the
// dense segment (cover 0: the first vcap rows of the order), then each
// spill level's covers c in [lo, hi], a segment of the level's cap rows
// each, then the pad up to entry_cap (cover -1).  Row i of a segment
// copies row i of the sorted key and opA: live at cover c when its key is
// not the dead key and its spill count is at least c, at tile
// (ty + c / tw) * grid_w + tx + c % tw; a row not live gets the ntiles
// sentinel and keeps its zmin, a pad row gets the sentinel and zmin 0.  The
// triangle id is the key's low 32 bits, clamped to T - 1 (a dead row's
// all-ones id gathers the last row, as the twin's clamp leaves it); a pad
// row's is 0.  The same pass counts the dense and spill rows placed: a warp
// reduction, a block's sum in shared memory, one atomic a block.
//
// Bound: bytes.  Each segment reads its rows of key and opA (16 B a row;
// the covers of a level re-read the level's prefix, mostly from the L2)
// and every row of the list is written once (16 B).  On the 28M-triangle
// frame that is ~1.2 GB, ~0.4 ms at 3.35 TB/s.  One thread a row,
// neighbouring threads on neighbouring rows, so every load and store is
// coalesced; a grid-stride loop over a fixed grid keeps the atomics to two
// a block.  The segment table (at most 34 entries) is a kernel argument,
// copied to shared memory by static indices, and each row finds its
// segment by a binary search there.
//
// Integer arithmetic only: the kernel's key and id arrays are equal to the
// twin's position by position, and its counts to the twin's sums
// (tests/test_torch_binning_emit_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EMIT_THREADS = 256;
constexpr int EMIT_MAX_BLOCKS = 2048;  // the grid-stride loop's grid
constexpr int EMIT_MAX_SEGS = 34;      // dense, 31 covers at K = 32, the pad
constexpr long long DEAD_KEY = (1LL << 42) - 1;  // ops/binning.py's
constexpr int TRI_BITS = 32;

struct Segments {
    long long start[EMIT_MAX_SEGS + 1];  // each segment's first row; the
                                         // last entry is the list's length
    int cover[EMIT_MAX_SEGS];            // 0 dense, c >= 1 spill, -1 pad
};

__global__ void __launch_bounds__(EMIT_THREADS)
binning_emit_kernel(const long long* __restrict__ key,
                    const long long* __restrict__ opA, Segments segs,
                    int nseg, int grid_w, int ntiles, long long tri_max,
                    long long* __restrict__ key2,
                    long long* __restrict__ tri,
                    unsigned long long* __restrict__ placed) {
    __shared__ long long s_start[EMIT_MAX_SEGS + 1];
    __shared__ int s_cover[EMIT_MAX_SEGS];
    __shared__ unsigned long long s_sum[2][EMIT_THREADS / 32];
    if (threadIdx.x == 0) {
        // static indices: the argument is read in place, never copied to
        // local memory
#pragma unroll
        for (int s = 0; s <= EMIT_MAX_SEGS; ++s) s_start[s] = segs.start[s];
#pragma unroll
        for (int s = 0; s < EMIT_MAX_SEGS; ++s) s_cover[s] = segs.cover[s];
    }
    __syncthreads();
    const long long total = s_start[nseg];
    const long long sentinel = (long long)ntiles << 16;
    unsigned dense = 0, spill = 0;
    for (long long r = (long long)blockIdx.x * EMIT_THREADS + threadIdx.x;
         r < total; r += (long long)gridDim.x * EMIT_THREADS) {
        // the segment holding row r: the last one starting at or before it
        int lo = 0, hi = nseg - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_start[mid] <= r) lo = mid; else hi = mid - 1;
        }
        const int c = s_cover[lo];
        long long k2 = sentinel, t = min(0LL, tri_max);
        if (c >= 0) {
            const long long i = r - s_start[lo];
            const long long k = key[i], a = opA[i];
            const int scount = 31 - (int)((k >> (TRI_BITS + 5)) & 0x1F);
            const int tw = (int)((k >> TRI_BITS) & 0x1F) + 1;
            const bool live = k != DEAD_KEY && scount >= c;
            const int q = c / tw;
            const long long ty = (a >> 8) & 0xFF, tx = a & 0xFF;
            const long long tile = live
                ? (ty + q) * grid_w + tx + (c - q * tw) : (long long)ntiles;
            const long long zq = min(max(a >> 16, 0LL), 65535LL);
            k2 = (tile << 16) | zq;
            t = min(k & ((1LL << TRI_BITS) - 1), tri_max);
            if (c == 0) dense += live; else spill += live;
        }
        key2[r] = k2;
        tri[r] = t;
    }
    dense = __reduce_add_sync(0xffffffffu, dense);
    spill = __reduce_add_sync(0xffffffffu, spill);
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
        s_sum[0][warp] = dense;
        s_sum[1][warp] = spill;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
        unsigned long long n = 0;
#pragma unroll
        for (int w = 0; w < EMIT_THREADS / 32; ++w) n += s_sum[threadIdx.x][w];
        if (n) atomicAdd(placed + threadIdx.x, n);
    }
}

}  // namespace

// key, opA: the first sort's key and the permuted opA (int64, nkey rows);
// seg_start (nseg + 1 entries), seg_cover (nseg): the segment table on the
// host; key2, tri: the list's rows (int64, seg_start[nseg] each); placed:
// two int64 counts (dense, spill), zeroed by the caller.
extern "C" int ty_binning_emit(
    const long long* key, const long long* opA, long long nkey,
    const long long* seg_start, const int* seg_cover, int nseg,
    int grid_w, int ntiles, long long tri_max,
    long long* key2, long long* tri, unsigned long long* placed,
    void* stream) {
    if (nseg < 0 || nseg > EMIT_MAX_SEGS || grid_w < 1 || ntiles < 1)
        return (int)cudaErrorInvalidValue;
    Segments segs{};
    for (int s = 0; s < nseg; ++s) {
        const long long rows = seg_start[s + 1] - seg_start[s];
        if (rows < 0 || (seg_cover[s] >= 0 && rows > nkey)
            || seg_cover[s] < -1 || seg_cover[s] > 31)
            return (int)cudaErrorInvalidValue;
        segs.start[s] = seg_start[s];
        segs.cover[s] = seg_cover[s];
    }
    // the entries past nseg repeat the end: a search never lands there
    for (int s = nseg; s <= EMIT_MAX_SEGS; ++s)
        segs.start[s] = seg_start[nseg];
    const long long total = seg_start[nseg];
    if (total <= 0) return (int)cudaGetLastError();
    const long long blocks = (total + EMIT_THREADS - 1) / EMIT_THREADS;
    const int grid =
        (int)(blocks < EMIT_MAX_BLOCKS ? blocks : EMIT_MAX_BLOCKS);
    binning_emit_kernel<<<grid, EMIT_THREADS, 0, (cudaStream_t)stream>>>(
        key, opA, segs, nseg, grid_w, ntiles, tri_max, key2, tri, placed);
    return (int)cudaGetLastError();
}
