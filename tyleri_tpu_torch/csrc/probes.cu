// The probe kernels of the JAX package's measurement tools, rewritten for
// Hopper.  Each is a stripped or isolated piece of the frame path that the
// tools time on their own; each wrapper is in tyleri_tpu_torch/tools/ beside
// its plain PyTorch version, and every kernel is bit-equal to it on the card.
//
// P4  gather_rows      replaces tools/exp_binning.py: gather_kernel
//     out[j] = table[ids[j]] and, per chunk of 1024 ids, the sum of
//     table[id, 0] in id order.  The TPU kernel streamed each row through
//     an 8-deep DMA ring and kept only the last chunk's sum; here a block
//     owns a chunk, each thread moves 16 bytes at a time (a warp moves four
//     128-byte rows per instruction, so every 32-byte sector it touches is
//     used), and one thread sums the chunk's channel-0 values from shared
//     memory in id order, so the sums equal the sequential f32 sum exactly.
//     Bound: bytes (the distinct rows read, the rows written, the ids).
//
// P7  fixed_grid       replaces tools/exp_fixed_grid.py: _kernel
//     K3's per-block fixed cost with no entries: read the depth block of
//     `rows` x 128 pixels (zero past the frame), its max (a shared-memory
//     reduction), then write `nouts` maps: map 0 the depth plus 1 where the
//     max exceeds 2, maps 1 and 6 i32 -1, the rest f32 0.  Bound: bytes
//     (the depth read once, the maps written once): K3's floor of stores.
//     The first port (256 threads a block, 4-byte accesses addressed by a
//     division, the depth read twice under the max, the map count and type
//     tested a pixel) reached 45.9 % of it; here a warp runs along a block
//     row in 16-byte loads and stores (1920 = 15 x 128: only the rows past
//     the frame need a guard), 8 rows a warp, the depth held in
//     registers from its one read to its store, one barrier for the max,
//     and the constant maps stored as their bits, the map loop outside
//     the pixels'.
//
// P6  fixed_cost       replaces tools/exp_fixedcost.py: _kernel
//     K3's empty-segment chunk loop: per 16x16 tile, state = depth (zero
//     past the frame) and n_out - 1 zero maps; for each of the tile's
//     chunks, counted from the chunk-aligned base below its start, the
//     chunk is staged in shared memory and table[base, 0] is added to every
//     map.  Like the TPU probe, every chunk re-reads the same base rows.
//     The TPU probe's [E, 24] -> [E, 128] lane pad has no counterpart.
//     Bound: bytes (the depth and tile starts read once, the maps written
//     once, one value a distinct base).  The first port (a CTA a tile, 256
//     threads of one pixel, 4-byte accesses, the tile from a division, the
//     chunk copied by 256 threads' scalar loads) reached 40.5 % of it on
//     empty segments; here the store side is P7's (a 16 x 128 block a CTA,
//     8 rows a thread, 16-byte depth loads and stores, the map loop outside
//     the pixels', the zero maps as their bits) and each trip's chunk is
//     one bulk copy (TMA) on an mbarrier, issued by one thread that walks
//     the CTA's trips two chunk slots deep: 81-82 % (PERF.md; one tile a
//     CTA ran 6 % slower).
//     fill             replaces tools/exp_fixedcost.py: probe_launch's k
//     fills a (grid_h * tile_h) x (grid_w * tile_w) grid with 1.0, one
//     block per tile, as the TPU probe's grid steps, so its five shapes
//     keep pricing per-launch, per-block and per-pixel cost (the caller
//     adds the scalar, as the TPU probe's jit does outside its kernel).
//     Bound: bytes (the grid written once).  The first port gave a 16x128
//     tile 1024 threads of two 4-byte stores, each address from a division
//     and a modulo, and lost to torch.ones' 16-byte stores; here a warp
//     runs along a row in 16-byte stores and FILL_ROWS warps down the rows,
//     each thread several float4s and no division, with scalar stores at a
//     row's ends where tile_w % 4 != 0 or the pointer is not 16-byte
//     aligned.
//
// P1  pipe_cost<LEVEL, NOUT, TW, RPT>  replaces tools/exp_pipecost.py:
//     _kernel.  K3's empty-floor stages over the 1088 x 1920 frame, 16x16
//     tiles, `tpb` tile rows per CTA: level 0 writes map i = i; level 1
//     adds the pixel-centre iotas, the 1920x1080 scissor mask and a 7-map
//     state; level 2 adds the tile's chunk loop, double-buffered in shared
//     memory, adding c0 * xf * (1/(i+1)) + yf * 0 + (outside the scissor)
//     to map i per chunk, c0 the chunk's first scalar.  Bound: bytes (the
//     maps written once, the tile starts and each chunk's first scalar
//     read once); the staged windows (64 x C floats a chunk) are what the
//     probe prices on top of it, and set a floor of their own.  The first
//     port (a CTA a tile, 256 threads of one pixel, 4-byte stores with the
//     map loop inside the pixel, each window copied by 256 threads'
//     cp.async) reached 42.9 % of the bound with one chunk a tile.  Here
//     the stores are 16-byte and evict-first, the map loop outside the
//     pixels', constants as bits, one tile a CTA (P7's 16 x 128 block wrote
//     seven maps 6-7 % slower; one map, which stays in the L2 across a CUDA
//     graph's calls, goes 1.8x faster in it, so one map takes it), and each
//     window is one bulk copy (TMA) into one of the tile's two slots,
//     issued by one thread a tile: 88-90 % of the bound without windows,
//     43 % with one a tile, whose 50.1 MB of windows beside 58.5 MB of maps
//     the card moves at the rate of a plain copy (PERF.md).
//
// P5  transpose_rows   replaces tools/exp_mosaic_probe.py: transpose_kernel
//     [24, N] -> [N, 24] f32.  A block stages 256 columns of all 24 rows in
//     shared memory (reads coalesced along N), then writes its 256 x 24
//     output rows as one contiguous run (writes coalesced), the tile's row
//     stride padded to 257 so neither side conflicts on a bank.  Bound:
//     bytes (N * 24 * 4 read and written once).  Left for a redesign: 16-byte
//     stores, and whether a producer should emit [N, 24] directly.
//     field_compute    replaces tools/exp_mosaic_probe.py: compute_kernel
//     out[n, c] = x[c % 16, n] * 2 + c for x [16, N] (the tool's [16,
//     N / 128, 128]), row-major [N, 24]: the same staging, 16 rows in and 24
//     values out per column.  Bound: bytes (16 N and 24 N floats).
//
// Numerics: built with -fmad=false (no contraction), so each expression is
// rounded as the plain versions round it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FRAME_W = 1920, FRAME_H = 1080;

// ---------------------------------------------------------------- P4

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_CHUNK = 1024;  // ids per block, the TPU kernel's step

template <int V>  // 16-byte vectors per row
__global__ void gather_rows_kernel(const int* __restrict__ ids,
                                   const float4* __restrict__ table, int T,
                                   int E, float4* __restrict__ out,
                                   float* __restrict__ sums) {
    __shared__ int sid[GATHER_CHUNK];
    __shared__ float v0[GATHER_CHUNK];
    const int base = blockIdx.x * GATHER_CHUNK;
    const int n = min(GATHER_CHUNK, E - base);
    for (int j = threadIdx.x; j < n; j += blockDim.x) sid[j] = ids[base + j];
    __syncthreads();
#pragma unroll 4
    for (int e = threadIdx.x; e < n * V; e += blockDim.x) {
        const int j = e / V, q = e - j * V;
        const int id = sid[j];
        // an id outside [0, T) gathers a zero row (the plain version raises)
        const float4 v = (unsigned)id < (unsigned)T
            ? table[(size_t)id * V + q] : make_float4(0.f, 0.f, 0.f, 0.f);
        out[(size_t)(base + j) * V + q] = v;
        if (q == 0) v0[j] = v.x;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = 0.0f;
        for (int j = 0; j < n; ++j) s = s + v0[j];
        sums[blockIdx.x] = s;
    }
}

// ---------------------------------------------------------------- P7

constexpr int GRID_TILE_W = 128;  // the TPU block's width, kept: the max
                                  // is over rows x 128 pixels
constexpr int GRID_VEC = GRID_TILE_W / 4;  // a block row's float4s: a warp
// RPT block rows a warp (rows w, w + W, ...: W = ceil(rows / RPT) warps a
// CTA, at most 32): 8 ran fastest of 1, 2, 4, 8 and 16 at rows 16 to 128
// (PERF.md)
constexpr int FIXED_RPT = 8;
constexpr int FIXED_WARPS = 32;
constexpr int FIXED_MAX_ROWS = FIXED_RPT * FIXED_WARPS;

struct Maps {
    void* m[7];
};

// One CTA a block of `rows` x 128 pixels: a warp along a row, lane l on
// pixels 4l .. 4l + 3, warp w on rows w, w + W, ... (W = blockDim.y).  The
// depth is read once, as float4, and held in registers; under ZMAX the
// block's max takes one barrier.  Every map is written in 16-byte stores;
// maps 1 .. nouts - 1 are constants (i32 -1 for maps 1 and 6, f32 0),
// stored as their bits, the map loop outside the pixels'.
template <bool ZMAX>
__global__ void __launch_bounds__(32 * FIXED_WARPS)
fixed_grid_kernel(const float4* __restrict__ depth, int rows, int nouts,
                  Maps maps) {
    __shared__ float red[FIXED_WARPS];
    constexpr int PAD_VEC = FRAME_W / 4;  // 1920 = 15 x 128: no column pad
    const int nw = blockDim.y, w = threadIdx.y;
    const int x4 = blockIdx.x * GRID_VEC + threadIdx.x;
    const int y0 = blockIdx.y * rows;
    constexpr int RPT = FIXED_RPT;
    float4 z[RPT];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = w + i * nw, y = y0 + r;
        // rows past the frame are the zero pad, part of the block's max
        z[i] = r < rows && y < FRAME_H ? depth[(size_t)y * PAD_VEC + x4]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        if (ZMAX && r < rows)
            m = fmaxf(m, fmaxf(fmaxf(z[i].x, z[i].y), fmaxf(z[i].z, z[i].w)));
    }
    if constexpr (ZMAX) {
        for (int off = 16; off > 0; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (threadIdx.x == 0) red[w] = m;
        __syncthreads();
        m = red[0];
        for (int i = 1; i < nw; ++i) m = fmaxf(m, red[i]);
        const float add = m > 2.0f ? 1.0f : 0.0f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            z[i].x = z[i].x + add;
            z[i].y = z[i].y + add;
            z[i].z = z[i].z + add;
            z[i].w = z[i].w + add;
        }
    }
    float4* m0 = static_cast<float4*>(maps.m[0]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = w + i * nw;
        if (r < rows) m0[(size_t)(y0 + r) * PAD_VEC + x4] = z[i];
    }
#pragma unroll
    for (int k = 1; k < 7; ++k) {
        if (k >= nouts) break;  // uniform
        const int bits = k == 1 || k == 6 ? -1 : 0;  // i32 -1, f32 0
        const int4 v = make_int4(bits, bits, bits, bits);
        int4* mk = static_cast<int4*>(maps.m[k]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int r = w + i * nw;
            if (r < rows) mk[(size_t)(y0 + r) * PAD_VEC + x4] = v;
        }
    }
}

// ---------------------------------------------------- P6 and P1: the floor

// Both probes write [1088, 1920] f32 maps (68 x 120 tiles of 16x16, as K3)
// in 16-byte stores: a CTA is TW tiles wide and 16 rows tall, thread i on
// float4 column i % (4 TW) of that block (pixels 4c .. 4c + 3, all in tile
// c / 4) and rows i / (4 TW) + k NR, k < RPT (NR = 16 / RPT rows at a
// time); no tile index takes a division.  TW = 8 is P7's 16 x 128 block, a
// warp along a row, RPT 8; TW = 1 one tile a CTA, 64 threads of one float4
// a row.  Each kernel takes the form that ran fastest on the card (PERF.md
// has what the others lost).
constexpr int TILE = 16;
constexpr int FLOOR_H = 1088;                  // 68 tile rows: 1080 + pad
constexpr int FLOOR_GRID_W = FRAME_W / TILE;   // 120 tiles a row
constexpr int FLOOR_VEC = FRAME_W / 4;         // a frame row's float4s
constexpr int COST_TILES = 8;  // P6: P7's block (one tile a CTA: 6 % slower)
// P1's constant maps: one map (8.4 MB, which the 20 calls of a CUDA graph
// find in the L2) goes fastest in few, large CTAs, 8 tiles a CTA; more maps
// are bound by the memory's writes and go fastest one tile a CTA, as does
// level 2 (one row a thread: 28 floats of state)
constexpr int pipe_tiles(int nout) { return nout == 1 ? 8 : 1; }
// rows a thread where a pixel holds no loop state: P7's 8 in its block,
// one float4 a thread in a tile
constexpr int floor_rpt(int tw) { return tw == 1 ? 1 : 8; }
static_assert(FLOOR_GRID_W % COST_TILES == 0
              && FLOOR_GRID_W % pipe_tiles(1) == 0, "whole tiles a CTA");

template <int TW, int RPT>
struct Floor {
    static constexpr int COLS = 4 * TW, NR = TILE / RPT, THREADS = COLS * NR;
};

// Hopper's 1-D bulk copy (TMA) into shared memory, completed on an mbarrier
// of one arrival: the issuing thread arrives expecting the copy's bytes,
// and the bytes' landing completes the phase.  Sizes are multiples of 16
// bytes, both addresses 16-byte aligned (the wrappers check).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bar)) : "memory");
}

// makes this thread's barrier inits visible to the copies and the CTA
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// orders the generic reads of a buffer (this thread's, or the CTA's before
// a barrier) before the next bulk copy overwrites it
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// EVICT_FIRST marks the source lines L2 evict-first (P1: each window is
// read once); P6's bases are shared by neighbouring tiles and copy faster
// without the hint (PERF.md)
template <bool EVICT_FIRST>
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
    const unsigned b = smem_addr(bar);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(b), "r"(bytes) : "memory");
    if constexpr (EVICT_FIRST) {
        uint64_t policy;
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                     : "=l"(policy));
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
            ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b), "l"(policy)
            : "memory");
    } else {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
    }
}

// waits for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned b = smem_addr(bar);
    unsigned done;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(b), "r"(parity) : "memory");
    } while (!done);
}

// ---------------------------------------------------------------- P6

constexpr int FIXED_CHUNK = 128;  // the TPU probe's chunk rows

// tile t's trips, counted from the chunk-aligned base below its start
__device__ __forceinline__ int base_trips(const int* __restrict__ tile_start,
                                          int t, int& base) {
    const int start = tile_start[t], end = tile_start[t + 1];
    base = start - start % FIXED_CHUNK;
    return end > start ? (end - base + FIXED_CHUNK - 1) / FIXED_CHUNK : 0;
}

// Map 0 starts as the depth (zero past row 1080), maps 1 .. n_out - 1 as
// zero; each of a tile's chunks, counted from the 128-aligned base below
// its start, stages min(128, E - base) rows at that base (the segments lie
// in the table) and adds table[base, 0].  One thread walks the CTA's tiles
// and their trips in turn, trip g of the CTA in chunk slot g % COST_SLOTS,
// COST_SLOTS - 1 copies ahead of the one it reads; every pixel then adds
// its tile's value once a trip, in order.  The slots are reserved on the
// empty path too: two cost it nothing measurable (PERF.md).
constexpr int COST_RPT = floor_rpt(COST_TILES);
constexpr int COST_SLOTS = 2;
using CostFloor = Floor<COST_TILES, COST_RPT>;

__global__ void __launch_bounds__(CostFloor::THREADS)
fixed_cost_kernel(const int* __restrict__ tile_start,
                  const float* __restrict__ table, int E, int C,
                  const float4* __restrict__ depth, int n_out, Maps maps) {
    using G = CostFloor;
    constexpr int TW = COST_TILES, RPT = COST_RPT;
    extern __shared__ __align__(128) float ebuf[];  // [slots][min(128, E), C]
    __shared__ __align__(8) uint64_t bar[COST_SLOTS];
    __shared__ float cval[TW];
    const int col = threadIdx.x % G::COLS, row = threadIdx.x / G::COLS;
    const int t0 = blockIdx.y * FLOOR_GRID_W + blockIdx.x * TW;
    const int x4 = blockIdx.x * G::COLS + col;
    const int y0 = blockIdx.y * TILE + row;
    float4 z[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int y = y0 + i * G::NR;
        z[i] = y < FRAME_H ? depth[(size_t)y * FLOOR_VEC + x4]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    int base;
    const int n = base_trips(tile_start, t0 + (col >> 2), base);
    float c = 0.0f;
    if (__syncthreads_or(n > 0)) {  // uniform: no tile has a chunk
        if (threadIdx.x == 0) {
            for (int i = 0; i < COST_SLOTS; ++i) mbar_init(&bar[i]);
            fence_barrier_init();
            const int slot = min(FIXED_CHUNK, E) * C;
            // the next trip to copy: tile ij's trip ik, at base ib
            int ij = 0, ik = 0, ib, in = base_trips(tile_start, t0, ib);
            int issued = 0;
            auto issue = [&]() {
                while (ij < TW && ik == in) {
                    if (++ij < TW) in = base_trips(tile_start, t0 + ij, ib);
                    ik = 0;
                }
                if (ij == TW) return;
                const int i = issued % COST_SLOTS;
                fence_proxy_async();  // this thread's read of the slot
                bulk_copy<false>(ebuf + i * slot, table + (size_t)ib * C,
                                 min(FIXED_CHUNK, E - ib) * C * 4u, &bar[i]);
                ++issued;
                ++ik;
            };
            for (int i = 0; i < COST_SLOTS; ++i) issue();
            int g = 0;
            for (int j = 0; j < TW; ++j) {
                int b;
                const int nj = base_trips(tile_start, t0 + j, b);
                float v = 0.0f;
                for (int k = 0; k < nj; ++k, ++g) {
                    const int i = g % COST_SLOTS;
                    mbar_wait(&bar[i], (g / COST_SLOTS) & 1);
                    v = ebuf[i * slot];
                    issue();  // into the slot just read
                }
                cval[j] = v;
            }
        }
        __syncthreads();
        c = cval[col >> 2];
    }
    float s = 0.0f;  // maps 1 .. n_out - 1: the same value over the tile
    for (int k = 0; k < n; ++k) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            z[i].x = z[i].x + c;
            z[i].y = z[i].y + c;
            z[i].z = z[i].z + c;
            z[i].w = z[i].w + c;
        }
        s = s + c;
    }
    float4* m0 = static_cast<float4*>(maps.m[0]);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
        m0[(size_t)(y0 + i * G::NR) * FLOOR_VEC + x4] = z[i];
    const float4 sv = make_float4(s, s, s, s);  // +0.0's bits when empty
#pragma unroll
    for (int m = 1; m < 7; ++m) {
        if (m >= n_out) break;  // uniform
        float4* mm = static_cast<float4*>(maps.m[m]);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
            mm[(size_t)(y0 + i * G::NR) * FLOOR_VEC + x4] = sv;
    }
}

constexpr int FILL_ROWS = 4;  // warps a CTA (chosen on the card, PERF.md)

// A CTA a tile: a warp along a row's 16-byte columns, FILL_ROWS warps down
// the rows.  VEC: every tile row starts 16-byte aligned (tile_w % 4 == 0 and
// an aligned pointer), so a row is float4 stores alone; otherwise each row
// takes scalar stores up to its first 16-byte boundary, float4 stores, and
// scalar stores for the rest.
template <bool VEC>
__global__ void __launch_bounds__(32 * FILL_ROWS)
fill_kernel(float* __restrict__ out, int tile_h, int tile_w, int width) {
    const float4 one = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    float* tile = out + (size_t)blockIdx.y * tile_h * width
                  + (size_t)blockIdx.x * tile_w;
    const int lane = threadIdx.x;
    for (int r = threadIdx.y; r < tile_h; r += blockDim.y) {
        float* row = tile + (size_t)r * width;
        int head = 0, n4 = tile_w >> 2;
        if constexpr (!VEC) {
            head = min((int)((16 - (reinterpret_cast<uintptr_t>(row) & 15))
                             & 15) >> 2, tile_w);
            n4 = (tile_w - head) >> 2;
            const int tail = tile_w - head - 4 * n4;
            if (lane < head) row[lane] = 1.0f;
            if (lane < tail) row[head + 4 * n4 + lane] = 1.0f;
        }
        float4* v = reinterpret_cast<float4*>(row + head);
        for (int c = lane; c < n4; c += 32) v[c] = one;
    }
}

// ---------------------------------------------------------------- P1

constexpr int PIPE_CHUNK = 64;  // the port's K3 chunk rows
// a level-2 CTA puts up to 16 of its tile rows side by side: the parent's
// tpb = 4 ran as fast as its tpb = 1 on four times the threads of a
// walking CTA (PERF.md)
constexpr int PIPE_ROW_LANES = 16;

// tile t's chunk count, and its segment's start
__device__ __forceinline__ int window_trips(const int* __restrict__ tile_start,
                                            int t, int& start) {
    start = tile_start[t];
    const int end = tile_start[t + 1];
    return end > start ? (end - start + PIPE_CHUNK - 1) / PIPE_CHUNK : 0;
}

// copies the tile's trip k (its lane's g-th) into slot g & 1, rows
// min(start + k 64, e_cap - 64); the fence orders the CTA's reads of that
// slot, which a barrier has closed, before the copy overwrites it
__device__ __forceinline__ void issue_window(
        float* tbuf, uint64_t* bars, int g, int start, int k,
        const float* __restrict__ entries, int e_cap, int C) {
    const int slot = PIPE_CHUNK * C;
    const int r0 = min(start + k * PIPE_CHUNK, e_cap - PIPE_CHUNK);
    fence_proxy_async();
    bulk_copy<true>(tbuf + (g & 1) * slot, entries + (size_t)r0 * C,
              (unsigned)slot * 4u, &bars[g & 1]);
}

template <int TW, int RPT>
constexpr int pipe_lanes() {
    constexpr int most = 1024 / Floor<TW, RPT>::THREADS;
    return PIPE_ROW_LANES < most ? PIPE_ROW_LANES : most;
}

// Levels 0 and 1 store map m = m as its bits (level 1's iotas, scissor mask
// and state are dead, as they were on the TPU's stores).  Level 2 runs each
// tile's chunk loop, one tile a CTA lane (TW = 1, one row of state a
// thread): the lane's row-0 thread issues the tile's windows as bulk
// copies into two slots, the first two when the row starts and trip k + 1
// once every thread is past trip k - 1; a trip waits for its copy and adds
// ((c0 xf) / (m + 1) + yf 0) + (outside the scissor) to map m, c0 the
// window's first scalar.  One barrier a trip, taken by every thread while
// any lane has a trip left, frees the slot the trip before read.  Lane l
// (blockDim.x = 64 x lanes) takes the CTA's tile rows l, l + lanes, ...
// Stores are evict-first.  At most 64 registers a thread (1,024 threads a
// CTA; 7 maps x 4 pixels of state).
template <int LEVEL, int NOUT, int TW, int RPT>
__global__ void __launch_bounds__(Floor<TW, RPT>::THREADS
                                  * pipe_lanes<TW, RPT>())
pipe_cost_kernel(const int* __restrict__ tile_start,
                 const float* __restrict__ entries, int e_cap, int C,
                 int tpb, Maps maps) {
    using G = Floor<TW, RPT>;
    const int col = threadIdx.x % G::COLS;
    const int row = threadIdx.x / G::COLS % G::NR;
    const int x4 = blockIdx.x * G::COLS + col;
    const int lanes = blockDim.x / G::THREADS;
    const int lane = threadIdx.x / G::THREADS;
    if constexpr (LEVEL < 2) {
        for (int ts = lane; ts < tpb; ts += lanes) {
            const int y0 = (blockIdx.y * tpb + ts) * TILE + row;
#pragma unroll
            for (int m = 0; m < NOUT; ++m) {
                const int bits = __float_as_int((float)m);
                const int4 v = make_int4(bits, bits, bits, bits);
#pragma unroll
                for (int i = 0; i < RPT; ++i)
                    __stcs(static_cast<int4*>(maps.m[m])
                               + (size_t)(y0 + i * G::NR) * FLOOR_VEC + x4,
                           v);
            }
        }
    } else {
        static_assert(TW == 1 && RPT == 1,
                      "level 2: one tile a lane, one row of state a thread");
        extern __shared__ __align__(128) float pbuf[];  // [lanes][2][64, C]
        __shared__ __align__(8) uint64_t full[PIPE_ROW_LANES][2];
        const bool issuer = threadIdx.x % G::THREADS == 0;
        const int slot = PIPE_CHUNK * C;
        float* tbuf = pbuf + (size_t)lane * 2 * slot;
        uint64_t* bars = full[lane];
        if (issuer) {  // no thread waits on a barrier before the first
            mbar_init(&bars[0]);  // __syncthreads_or below
            mbar_init(&bars[1]);
            fence_barrier_init();
        }
        int g = 0;  // the lane's trips in its earlier rows
        // every lane takes every barrier: rows past tpb take no trip and
        // store nothing
        for (int r = 0; r * lanes < tpb; ++r) {
            const int ts = lane + r * lanes;
            const int y = (blockIdx.y * tpb + ts) * TILE + row;
            int start = 0;
            const int n = ts < tpb
                ? window_trips(tile_start,
                               (blockIdx.y * tpb + ts) * FLOOR_GRID_W
                               + blockIdx.x, start)
                : 0;
            // every thread is past the rows before (their last barrier)
            if (issuer)
                for (int k = 0; k < min(n, 2); ++k)
                    issue_window(tbuf, bars, g + k, start, k, entries, e_cap,
                                 C);
            const float yf = (float)y + 0.5f;
            float xf[4], outside[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const int x = 4 * x4 + p;
                xf[p] = (float)x + 0.5f;
                outside[p] = x >= 0 && x < FRAME_W && y >= 0 && y < FRAME_H
                    ? 0.0f : 1.0f;
            }
            float st[7][4];
#pragma unroll
            for (int m = 0; m < 7; ++m)
#pragma unroll
                for (int p = 0; p < 4; ++p) st[m][p] = (float)m;
            for (int k = 0; __syncthreads_or(k < n); ++k) {
                if (issuer && k >= 1 && k + 1 < n)  // trip k - 1's slot
                    issue_window(tbuf, bars, g + k + 1, start, k + 1,
                                 entries, e_cap, C);
                if (k < n) {
                    mbar_wait(&bars[(g + k) & 1], ((g + k) >> 1) & 1);
                    const float c0 = tbuf[((g + k) & 1) * slot];
#pragma unroll
                    for (int m = 0; m < 7; ++m) {
                        const float rm = 1.0f / (float)(m + 1);
#pragma unroll
                        for (int p = 0; p < 4; ++p)
                            st[m][p] = ((st[m][p] + (c0 * xf[p]) * rm)
                                        + yf * 0.0f) + outside[p];
                    }
                }
            }
            if (ts >= tpb) continue;
            g += n;
            const size_t o = (size_t)y * FLOOR_VEC + x4;
#pragma unroll
            for (int m = 0; m < NOUT; ++m)
                __stcs(static_cast<float4*>(maps.m[m]) + o,
                       make_float4(st[m][0], st[m][1], st[m][2], st[m][3]));
        }
    }
}

template <int LEVEL>
cudaError_t launch_pipe(int nout, int grid_h, size_t smem, cudaStream_t st,
                        const int* tile_start, const float* entries,
                        int e_cap, int C, int tpb, Maps maps) {
#define TY_PIPE(N)                                                          \
    case N: {                                                               \
        constexpr int TW = LEVEL == 2 ? 1 : pipe_tiles(N);                  \
        constexpr int RPT = LEVEL == 2 ? 1 : floor_rpt(TW);                 \
        const dim3 grid(FLOOR_GRID_W / TW, grid_h / tpb);                   \
        /* smem: a lane's windows (level 2); 4 KB kept for the barriers */  \
        const int lanes = min(min(tpb, pipe_lanes<TW, RPT>()),              \
                              smem ? max(1, (int)((232448 - 4096) / smem))  \
                                   : 1024);                                 \
        auto kern = pipe_cost_kernel<LEVEL, N, TW, RPT>;                    \
        const cudaError_t err = cudaFuncSetAttribute(                       \
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize,              \
            (int)(smem * lanes));                                           \
        if (err != cudaSuccess) return err;                                 \
        kern<<<grid, Floor<TW, RPT>::THREADS * lanes, smem * lanes, st>>>(  \
            tile_start, entries, e_cap, C, tpb, maps);                      \
        break;                                                              \
    }
    switch (nout) {
        TY_PIPE(1) TY_PIPE(2) TY_PIPE(3) TY_PIPE(4) TY_PIPE(5) TY_PIPE(6)
        TY_PIPE(7)
        default: return cudaErrorInvalidValue;
    }
#undef TY_PIPE
    return cudaSuccess;
}

// ---------------------------------------------------------------- P5

constexpr int T_COLS = 256;        // columns (output rows) per block
constexpr int T_STRIDE = T_COLS + 1;
constexpr int T_THREADS = 256;

// ROWS input rows of x [ROWS, N]; out [N, 24] with
// out[n, c] = COMPUTE ? x[c % 16, n] * 2 + c : x[c, n] (ROWS == 24)
template <int ROWS, bool COMPUTE>
__global__ void rows_to_cols_kernel(const float* __restrict__ x, int N,
                                    float* __restrict__ out) {
    __shared__ float tile[ROWS * T_STRIDE];
    const int n0 = blockIdx.x * T_COLS;
    const int ncols = min(T_COLS, N - n0);
    for (int e = threadIdx.x; e < ROWS * T_COLS; e += blockDim.x) {
        const int r = e / T_COLS, j = e - r * T_COLS;
        if (j < ncols) tile[r * T_STRIDE + j] = x[(size_t)r * N + n0 + j];
    }
    __syncthreads();
    float* dst = out + (size_t)n0 * 24;
    for (int e = threadIdx.x; e < ncols * 24; e += blockDim.x) {
        const int j = e / 24, c = e - j * 24;
        if constexpr (COMPUTE)
            dst[e] = tile[(c % 16) * T_STRIDE + j] * 2.0f + (float)c;
        else
            dst[e] = tile[c * T_STRIDE + j];
    }
}

}  // namespace

extern "C" int ty_transpose_rows(const float* x, int N, int compute,
                                 float* out, void* stream) {
    if (N <= 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + T_COLS - 1) / T_COLS), block(T_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    if (compute)
        rows_to_cols_kernel<16, true><<<grid, block, 0, st>>>(x, N, out);
    else
        rows_to_cols_kernel<24, false><<<grid, block, 0, st>>>(x, N, out);
    return (int)cudaGetLastError();
}

extern "C" int ty_gather_rows(const int* ids, const float* table, int T,
                              int C, int E, float* out, float* sums,
                              void* stream) {
    if (E > 0) {
        const dim3 grid((E + GATHER_CHUNK - 1) / GATHER_CHUNK),
            block(GATHER_THREADS);
        cudaStream_t st = (cudaStream_t)stream;
        const float4* t4 = reinterpret_cast<const float4*>(table);
        float4* o4 = reinterpret_cast<float4*>(out);
        if (C == 24)
            gather_rows_kernel<6><<<grid, block, 0, st>>>(ids, t4, T, E, o4,
                                                         sums);
        else if (C == 32)
            gather_rows_kernel<8><<<grid, block, 0, st>>>(ids, t4, T, E, o4,
                                                         sums);
        else
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int ty_fixed_grid(const float* depth, int rows, int nouts,
                             int zmax, void* m0, void* m1, void* m2, void* m3,
                             void* m4, void* m5, void* m6, void* stream) {
    if (rows <= 0 || rows > FIXED_MAX_ROWS || nouts < 1 || nouts > 7)
        return (int)cudaErrorInvalidValue;
    const Maps maps{{m0, m1, m2, m3, m4, m5, m6}};
    if ((reinterpret_cast<uintptr_t>(depth) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    for (int i = 0; i < nouts; ++i)
        if ((reinterpret_cast<uintptr_t>(maps.m[i]) & 15) != 0)
            return (int)cudaErrorMisalignedAddress;
    const dim3 grid(FRAME_W / GRID_TILE_W, (FRAME_H + rows - 1) / rows),
        block(32, (rows + FIXED_RPT - 1) / FIXED_RPT);
    const float4* d4 = reinterpret_cast<const float4*>(depth);
    cudaStream_t st = (cudaStream_t)stream;
    if (zmax)
        fixed_grid_kernel<true><<<grid, block, 0, st>>>(d4, rows, nouts, maps);
    else
        fixed_grid_kernel<false><<<grid, block, 0, st>>>(d4, rows, nouts,
                                                         maps);
    return (int)cudaGetLastError();
}

static bool misaligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

extern "C" int ty_fixed_cost(const int* tile_start, const float* table,
                             int E, int C, const float* depth0, int n_out,
                             void* m0, void* m1, void* m2, void* m3, void* m4,
                             void* m5, void* m6, void* stream) {
    if (n_out < 1 || n_out > 7 || E <= 0 || C <= 0 || C % 4)
        return (int)cudaErrorInvalidValue;
    const Maps maps{{m0, m1, m2, m3, m4, m5, m6}};
    bool bad = misaligned16(table) || misaligned16(depth0);
    for (int i = 0; i < n_out; ++i) bad = bad || misaligned16(maps.m[i]);
    if (bad) return (int)cudaErrorMisalignedAddress;
    auto kern = fixed_cost_kernel;
    // the static barrier and values count beside it: always raise the cap
    const size_t smem =
        (size_t)COST_SLOTS * min(FIXED_CHUNK, E) * C * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(FLOOR_GRID_W / COST_TILES, FLOOR_H / TILE);
    kern<<<grid, CostFloor::THREADS, smem, (cudaStream_t)stream>>>(
        tile_start, table, E, C, reinterpret_cast<const float4*>(depth0),
        n_out, maps);
    return (int)cudaGetLastError();
}

extern "C" int ty_fill(float* out, int grid_h, int grid_w, int tile_h,
                       int tile_w, void* stream) {
    if (grid_h <= 0 || grid_w <= 0 || tile_h <= 0 || tile_w <= 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(grid_w, grid_h), block(32, min(tile_h, FILL_ROWS));
    const int width = grid_w * tile_w;
    if (tile_w % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0)
        fill_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
            out, tile_h, tile_w, width);
    else
        fill_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
            out, tile_h, tile_w, width);
    return (int)cudaGetLastError();
}

extern "C" int ty_pipe_cost(const int* tile_start, const float* entries,
                            int e_cap, int C, int level, int nout, int tpb,
                            void* m0, void* m1, void* m2, void* m3, void* m4,
                            void* m5, void* m6, void* stream) {
    constexpr int grid_h = FLOOR_H / TILE;
    if (tpb <= 0 || grid_h % tpb || C <= 0 || C % 4 || e_cap < PIPE_CHUNK
        || nout < 1 || nout > 7)
        return (int)cudaErrorInvalidValue;
    const Maps maps{{m0, m1, m2, m3, m4, m5, m6}};
    bool bad = misaligned16(entries);
    for (int i = 0; i < nout; ++i) bad = bad || misaligned16(maps.m[i]);
    if (bad) return (int)cudaErrorMisalignedAddress;
    const size_t smem = level == 2  // a lane's windows
        ? (size_t)2 * PIPE_CHUNK * C * sizeof(float) : 0;
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (level == 0)
        err = launch_pipe<0>(nout, grid_h, smem, st, tile_start, entries,
                             e_cap, C, tpb, maps);
    else if (level == 1)
        err = launch_pipe<1>(nout, grid_h, smem, st, tile_start, entries,
                             e_cap, C, tpb, maps);
    else if (level == 2)
        err = launch_pipe<2>(nout, grid_h, smem, st, tile_start, entries,
                             e_cap, C, tpb, maps);
    else
        return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
