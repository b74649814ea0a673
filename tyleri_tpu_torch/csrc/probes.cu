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
// P1  pipe_cost<LEVEL, NOUT>  replaces tools/exp_pipecost.py: _kernel
//     K3's empty-floor stages over the 1088 x 1920 frame, 16x16 tiles, `tpb`
//     tile rows per block: level 0 writes map i = i; level 1 adds the
//     pixel-centre iotas, the 1920x1080 scissor mask and a 7-map state;
//     level 2 adds the tile's chunk loop, double-buffered in shared memory
//     with cp.async, adding c0 * xf * (1/(i+1)) + yf * 0 + (outside the
//     scissor) to map i per chunk, c0 the chunk's first scalar.
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

// ---------------------------------------------------------------- P6

constexpr int TILE = 16;  // 16x16 tiles, one pixel a thread, as K3
constexpr int FIXED_CHUNK = 128;  // the TPU probe's chunk rows

__global__ void fixed_cost_kernel(const int* __restrict__ tile_start,
                                  const float* __restrict__ table, int E,
                                  int C, const float* __restrict__ depth0,
                                  int grid_w, int pad_w, int n_out,
                                  Maps maps) {
    extern __shared__ float ebuf[];  // [FIXED_CHUNK, C]
    const int t = blockIdx.x;
    const int gx = t % grid_w, gy = t / grid_w;
    const int x = gx * TILE + threadIdx.x % TILE;
    const int y = gy * TILE + threadIdx.x / TILE;
    const int start = tile_start[t], end = tile_start[t + 1];
    const int base = start - start % FIXED_CHUNK;
    const int nchunks =
        end > start ? (end - base + FIXED_CHUNK - 1) / FIXED_CHUNK : 0;
    float s0 = (y < FRAME_H && x < FRAME_W) ? depth0[(size_t)y * FRAME_W + x]
                                            : 0.0f;
    float s = 0.0f;  // maps 1.. hold the same value
    for (int k = 0; k < nchunks; ++k) {
        // the TPU probe copies the chunk at `base` on every trip
        const int n = min(FIXED_CHUNK, E - base) * C;
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x)
            ebuf[i] = table[(size_t)base * C + i];
        __syncthreads();
        const float c = ebuf[0];
        s0 = s0 + c;
        s = s + c;
    }
    const size_t o = (size_t)y * pad_w + x;
    static_cast<float*>(maps.m[0])[o] = s0;
    for (int i = 1; i < n_out; ++i) static_cast<float*>(maps.m[i])[o] = s;
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

constexpr int PIPE_W = 1920, PIPE_H = 1088;  // the probe's 68 x 15 grid of
                                             // 16 x 128 blocks
constexpr int PIPE_GRID_W = PIPE_W / TILE;
constexpr int PIPE_CHUNK = 64;  // the port's K3 chunk rows

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

template <int LEVEL, int NOUT>
__global__ void pipe_cost_kernel(const int* __restrict__ tile_start,
                                 const float* __restrict__ entries, int e_cap,
                                 int C, int tpb, Maps maps) {
    constexpr int chunk = PIPE_CHUNK;
    extern __shared__ __align__(16) float pbuf[];  // [2][chunk, C]
    const int gx = blockIdx.x;
    const int lx = threadIdx.x % TILE, ly = threadIdx.x / TILE;
    const int nvec = chunk * C / 4;
    for (int ts = 0; ts < tpb; ++ts) {
        const int gy = blockIdx.y * tpb + ts;
        const int x = gx * TILE + lx, y = gy * TILE + ly;
        float st[7];
#pragma unroll
        for (int i = 0; i < 7; ++i) st[i] = (float)i;
        if constexpr (LEVEL == 2) {
            const int t = gy * PIPE_GRID_W + gx;
            const int start = tile_start[t], end = tile_start[t + 1];
            const int nchunks = end > start ? (end - start + chunk - 1) / chunk
                                            : 0;
            const float xf = (float)x + 0.5f, yf = (float)y + 0.5f;
            const bool in_sc = x >= 0 && x < FRAME_W && y >= 0 && y < FRAME_H;
            auto issue = [&](int k) {
                const int row = min(start + k * chunk, e_cap - chunk);
                const float* src = entries + (size_t)row * C;
                float* dst = pbuf + (k & 1) * chunk * C;
                for (int v = threadIdx.x; v < nvec; v += blockDim.x)
                    cp_async16(dst + 4 * v, src + 4 * v);
                asm volatile("cp.async.commit_group;\n" ::);
            };
            if (nchunks > 0) issue(0);
            for (int k = 0; k < nchunks; ++k) {
                if (k + 1 < nchunks) {
                    issue(k + 1);
                    asm volatile("cp.async.wait_group 1;\n" ::);
                } else {
                    asm volatile("cp.async.wait_group 0;\n" ::);
                }
                __syncthreads();
                const float c0 = pbuf[(k & 1) * chunk * C];
#pragma unroll
                for (int i = 0; i < 7; ++i) {
                    const float r = 1.0f / (float)(i + 1);
                    st[i] = ((st[i] + (c0 * xf) * r) + yf * 0.0f)
                            + (in_sc ? 0.0f : 1.0f);
                }
                __syncthreads();  // the buffer is refilled two trips on
            }
        }
        const size_t o = (size_t)y * PIPE_W + x;
#pragma unroll
        for (int i = 0; i < NOUT; ++i) static_cast<float*>(maps.m[i])[o] = st[i];
    }
}

template <int LEVEL>
cudaError_t launch_pipe(int nout, dim3 grid, dim3 block, size_t smem,
                        cudaStream_t st, const int* tile_start,
                        const float* entries, int e_cap, int C, int tpb,
                        Maps maps) {
#define TY_PIPE(N)                                                          \
    case N:                                                                 \
        if (smem > 48 * 1024)                                               \
            cudaFuncSetAttribute(pipe_cost_kernel<LEVEL, N>,                \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                 (int)smem);                                \
        pipe_cost_kernel<LEVEL, N><<<grid, block, smem, st>>>(              \
            tile_start, entries, e_cap, C, tpb, maps);                      \
        break;
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

extern "C" int ty_fixed_cost(const int* tile_start, const float* table,
                             int E, int C, const float* depth0, int n_out,
                             void* m0, void* m1, void* m2, void* m3, void* m4,
                             void* m5, void* m6, void* stream) {
    if (n_out < 1 || n_out > 7) return (int)cudaErrorInvalidValue;
    const int grid_w = (FRAME_W + TILE - 1) / TILE;
    const int grid_h = (FRAME_H + TILE - 1) / TILE;
    const size_t smem = (size_t)FIXED_CHUNK * C * sizeof(float);
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(fixed_cost_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    const Maps maps{{m0, m1, m2, m3, m4, m5, m6}};
    fixed_cost_kernel<<<grid_w * grid_h, TILE * TILE, smem,
                        (cudaStream_t)stream>>>(
        tile_start, table, E, C, depth0, grid_w, grid_w * TILE, n_out, maps);
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
    const int grid_h = PIPE_H / TILE;
    if (tpb <= 0 || grid_h % tpb || C % 4 || e_cap < PIPE_CHUNK)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(PIPE_GRID_W, grid_h / tpb), block(TILE * TILE);
    const size_t smem =
        level == 2 ? 2 * (size_t)PIPE_CHUNK * C * sizeof(float) : 0;
    const Maps maps{{m0, m1, m2, m3, m4, m5, m6}};
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (level == 0)
        err = launch_pipe<0>(nout, grid, block, smem, st, tile_start, entries,
                             e_cap, C, tpb, maps);
    else if (level == 1)
        err = launch_pipe<1>(nout, grid, block, smem, st, tile_start, entries,
                             e_cap, C, tpb, maps);
    else if (level == 2)
        err = launch_pipe<2>(nout, grid, block, smem, st, tile_start, entries,
                             e_cap, C, tpb, maps);
    else
        return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
