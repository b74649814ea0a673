// P3: K3's resolve by tile shape, chunk size and ablation, and on a table
// packed five entries a row, rewritten for Hopper.
//
// Replaces tools/exp_visibility.py: _variant_kernel (run_variant) and
// _packed_kernel (run_packed).  One template,
//   variant_kernel<PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S, PACKED>,
// over the settings that change what is computed; the TPU-only knobs
// (dynroll, cond_dma alone, exit_while) give the same maps and take the
// instance of the setting they leave (tyleri_tpu_torch/tools/
// exp_visibility.py says which).  Only the instances the tool's variants
// use are compiled (TY_VARIANTS below).
//
// A CTA resolves one tile of 128 x tile_h pixels.  The tile's segment of
// the table streams through shared memory in chunks of `span` entries
// counted from the chunk-aligned base below its start (the TPU kernel's
// base and its clamp min(base + k * span, cap - span), which may resolve an
// entry twice).  Entries run in groups of UNROLL, as the TPU kernel's
// unrolled loop; an entry outside [start, end) is skipped (the packed
// path's loop is its own, below).  The kernel reads no broad list: the TPU
// probes leave theirs unread.
//
//   LEX     the production compare: zq < z, or zq == z and order >= the
//           pixel's order; without it zq <= z, and the order still written;
//   EXIT    0 none; 1 the early exit: chunk k runs only if its first live
//           entry's CH_ZMIN / 65535 <= the tile's max depth after chunk
//           k - 1; 2 (lag2) the max after chunk k - 2;
//   STRIP   only depth and owner move (the timing ablation);
//   HOIST   every entry reads chunk row 0's coefficients, with its own id;
//   E2S     e2 as a stored 3-coefficient plane (channels 6..8) in place of
//           e2 = (|2A| - e0) - e1;
//   PACKED  the table is pack5's [rows, 128]: five 24-channel entries a
//           row, windows of 26 rows (130 entries) from the row of start / 5;
//           the production resolve (LEX, e2 derived).
//
// nres[t] counts the live entries tile t resolved, the work of its bound.
//
// Bound: per (entry, pixel) pair 29 f32 operations with the lex compare
// (27 without, 2 more with E2S), at the CUDA cores' instruction rate, over
// the live entries resolved; the bytes (the rows resolved, the depth read
// once, 7 maps written once) are below it.  The first port (a thread for
// tile_h / 2 rows, 256 threads, tiles in raster order) reached 42.8 % of it
// on sponza at 128 x 16: at tile_h 16 a tile's entries ran through 256
// threads and the longest tiles ran alone at the end, 22 scalar loads and
// 3 products c0 * x were paid an entry and pixel group, a chunk took three
// barriers under EXIT, and tile_h 64 spilled.  The design is K3's
// (visibility.cu):
//
//   * pixels a thread apart from the tile height: a thread owns PPT pixels
//     of one column (rows g, g + G, ... of the tile, G = threads / 128),
//     PPT the smallest of MIN_PPT and up whose CTA fits MAX_THREADS: 512
//     threads at tile_h 8, 1024 at 16, PPT 4 at 32 and 8 at 64.
//     tools/exp_visibility.py's p3_launch gives the wrapper the same
//     geometry, and the C entry point rejects any other;
//   * the tiles launch longest segment first (tile_order.cuh, launched by
//     the same C call), in buckets that grow with the tile's area;
//   * an entry's coverage and depth coefficients are read with 16-byte
//     shared-memory loads (rows are 96 B, 16-byte aligned; packed rows of
//     512 B hold entries at 96-byte steps), and each plane's c0 * x is
//     computed once an entry for the column (the same product, so the
//     same bits as at every pixel);
//   * a two-slot chunk ring filled with 16-byte cp.async: chunk k + 1 loads
//     while chunk k resolves.  A chunk loads only the rows the tile reads
//     (its rows up to the segment's end);
//   * one barrier a chunk: it publishes the landed chunk, frees the other
//     slot for the next prefetch and, under EXIT, publishes each warp's
//     depth max (a shuffle within the warp) through a three-slot shared
//     array, the slot of chunk k read at chunks k + 1 and k + 2 (lag2) and
//     written again only after chunk k + 3's barrier.
//
// A thread of a 1024-thread CTA has 64 registers, and at PPT 4 its pixels'
// state (7 fields and a row centre a pixel) takes half of them.  So the
// loop holds little else: the attributes, order and texture of an entry
// are read by scalar loads where a pixel passes (rarely); the tile and its
// segment are read back from shared memory where a chunk or the epilogue
// needs them; a pixel outside the scissor gets a NaN row centre (its planes
// are NaN, so no entry covers it) in place of a flag.  At PPT 8 the state
// alone exceeds 64 registers; the instance spills (PERF.md records how
// much).
//
// The packed path (P3b) takes the same geometry, ring and exit, and its
// own staging and entry loop, built on what the TPU kernel was built on: a
// window starts on a row (start - start % 5, and cap and the 130-entry
// span are multiples of 5), so every entry's place in its row is static.
// The generic loop, taken before, paid an entry an offset by
// division ((j / 5) * 128 + (j % 5) * 24) and a live test, and staged the
// 8 pad lanes of every row: 13-17 % more a pair than the unpacked resolve.
// Here a window stages each row's 120 live floats (30 16-byte copies, at
// the table's 128-float row stride), and the loop walks its rows with a
// row pointer: the five entries of a row at static offsets 0, 24, 48, 72
// and 96 floats, the first and last rows (where the dead lead and tail
// entries are) peeled and looped over their live entries alone.  A
// window unpacked to [130, 24] in shared memory, the loop P3a's without
// its live test, was the slower in every turn (PERF.md).
//
// Numerics: built with -fmad=false and rintf (round half to even, as
// torch.round), so the maps are bit-equal to variant_reference and
// packed_reference on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_order.cuh"

namespace {

constexpr int NC = 24;
constexpr int CH_E0 = 0, CH_E1 = 3, CH_TWOA = 6, CH_Z = 9, CH_INVW = 12;
constexpr int CH_UW = 15, CH_VW = 18, CH_META = 21, CH_ORDER = 22, CH_ZMIN = 23;
constexpr int META_TEX_BITS = 18;
constexpr int META_TEX_MASK = (1 << META_TEX_BITS) - 1;
constexpr int TILE_W = 128;
// the geometry of tools/exp_visibility.py's p3_launch: PPT =
// max(MIN_PPT, ceil(TILE_W * tile_h / MAX_THREADS)) rows of one column a
// thread, TILE_W * tile_h / PPT threads
constexpr int MIN_PPT = 2;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
// the tile order's bucket at tile_h 8: 8 rows, twice as wide a step up
constexpr int ORDER_SHIFT_TH8 = 3;
// pack5's table: PACK entries of NC floats a row of PACK_ROW floats (the
// last 8 lanes pad); a packed row's live floats are PACK_VEC 16-byte vectors
constexpr int PACK = 5, PACK_ROW = 128, PACK_VEC = PACK * NC / 4;

struct Params {
    const int* tile_start;  // [ntiles + 1]
    const float* table;     // [E, 24], or packed [rows, 128]; 16-B aligned
    int cap;                // entries the table holds (5 a packed row)
    int span;               // entries a chunk (window) holds
    const float* depth0;    // [fb_h, fb_w]
    int fb_w, fb_h, grid_w;
    int scx, scy, scw, sch;
    int* owner; float* z; float* order; float* uw; float* vw; float* iw;
    int* tex;               // [grid_h * tile_h, grid_w * 128]
    int* nres;              // [ntiles]
    const int* tile_order;  // [ntiles] the tiles, longest segment first
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// channels 4q .. 4q + 3 of a shared row into c[], by one 16-byte load
__device__ __forceinline__ void load4(const float* row, int q, float* c) {
    const float4 v = reinterpret_cast<const float4*>(row)[q];
    c[4 * q] = v.x;
    c[4 * q + 1] = v.y;
    c[4 * q + 2] = v.z;
    c[4 * q + 3] = v.w;
}

// the max of v over the warp (the CTA is whole warps)
__device__ __forceinline__ float warp_max(float v) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

template <int PPT, int UNROLL, bool LEX, int EXIT, bool STRIP, bool HOIST,
          bool E2S, bool PACKED>
__global__ void __launch_bounds__(MAX_THREADS)
variant_kernel(Params p) {
    extern __shared__ __align__(16) float sbuf[];  // [2][span, NC]
    // each warp's depth max after chunk k in slot k % 3; before chunk 0
    // (chunks -1 and -2) in slots 2 and 1
    __shared__ float red[3][MAX_WARPS];
    // the tile and its segment (tile, start, end, chunk-aligned base), read
    // back where a chunk or the epilogue needs them, so that across the
    // entry loop a thread's registers hold its pixels' state and little
    // else (64 registers a thread at 1024 threads)
    __shared__ int seg[4];
    const volatile int* vseg = seg;
    const int span = p.span;
    const int buf_floats = PACKED ? span / PACK * PACK_ROW : span * NC;
    const int groups = blockDim.x / TILE_W;  // G: row groups of the tile
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const float inv_q = 1.0f / 65535.0f;

    auto chunk_at = [&](int k, int base) {
        return min(base + k * span, p.cap - span);
    };
    auto issue = [&](int k, int s, int n) {  // entries s .. s + n into slot k & 1
        float* dst = sbuf + (k & 1) * buf_floats;
        if constexpr (PACKED) {
            // s is a row's first entry: the rows up to entry s + n, at
            // their table stride, each row's PACK_VEC live vectors and not
            // its pad lanes
            const float* src = p.table + (size_t)(s / PACK) * PACK_ROW;
            const int nvec = (n + PACK - 1) / PACK * PACK_VEC;
            for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
                const int r = v / PACK_VEC;
                const int o = r * PACK_ROW + 4 * (v - r * PACK_VEC);
                cp_async16(dst + o, src + o);
            }
        } else {
            const float* src = p.table + (size_t)s * NC;
            for (int v = threadIdx.x; v < n * (NC / 4); v += blockDim.x)
                cp_async16(dst + 4 * v, src + 4 * v);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };

    float zb[PPT], ob[PPT], uwb[PPT], vwb[PPT], iwb[PPT], yf[PPT];
    int own[PPT], texb[PPT];
    float xf;
    int nchunks;
    {
        const int t = p.tile_order[blockIdx.x];
        const int x = t % p.grid_w * TILE_W + (threadIdx.x & (TILE_W - 1));
        const int y0 = t / p.grid_w * groups * PPT + threadIdx.x / TILE_W;
        const bool x_in = x >= p.scx && x < p.scx + p.scw;
        xf = (float)x + 0.5f;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
            const int y = y0 + i * groups;
            // a pixel outside the scissor gets a NaN row centre: its planes
            // are NaN, so no entry covers it
            yf[i] = x_in && y >= p.scy && y < p.scy + p.sch
                        ? (float)y + 0.5f : __int_as_float(0x7fffffff);
            zb[i] = (x < p.fb_w && y < p.fb_h)
                        ? p.depth0[(size_t)y * p.fb_w + x] : -INFINITY;
            ob[i] = -1.0f; uwb[i] = 0.0f; vwb[i] = 0.0f; iwb[i] = 1.0f;
            own[i] = -1; texb[i] = 0;
        }
        const int start = p.tile_start[t], end = p.tile_start[t + 1];
        const int base = start - start % (PACKED ? PACK : span);
        nchunks = end > start ? (end - base + span - 1) / span : 0;
        if (threadIdx.x == 0) {
            seg[0] = t; seg[1] = start; seg[2] = end; seg[3] = base;
        }
        const int s0 = chunk_at(0, base);
        if (nchunks > 0) issue(0, s0, min(end - s0, span));
    }
    // the tile's max depth, each warp's in red[slot]
    auto publish_max = [&](int slot) {
        float m = zb[0];
#pragma unroll
        for (int i = 1; i < PPT; ++i) m = fmaxf(m, zb[i]);
        m = warp_max(m);
        if (lane == 0) red[slot][warp] = m;
    };
    auto tile_max = [&](int slot) {
        float m = red[slot][0];
        for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[slot][w]);
        return m;
    };

    // one entry against the thread's PPT pixels
    auto resolve = [&](const float* row, int eid) {
        float c[NC];
        load4(row, 0, c);  // e0, e1's a
        load4(row, 1, c);  // e1's b, c; |2A| or e2's a, b
        load4(row, 2, c);  // e2's c; z
        load4(row, 5, c);  // vw's c, meta, order, zmin
        const int tl = (int)c[CH_META] >> META_TEX_BITS;
        const float ord = c[CH_ORDER];
        const float e0x = c[CH_E0] * xf, e1x = c[CH_E1] * xf;
        const float e2x = E2S ? c[CH_TWOA] * xf : 0.0f;
        const float zx = c[CH_Z] * xf;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
            const float y = yf[i];
            const float e0 = (e0x + c[CH_E0 + 1] * y) + c[CH_E0 + 2];
            const float e1 = (e1x + c[CH_E1 + 1] * y) + c[CH_E1 + 2];
            const float e2 = E2S ? (e2x + c[CH_TWOA + 1] * y) + c[CH_TWOA + 2]
                                 : (c[CH_TWOA] - e0) - e1;
            const bool cov = (e0 > 0.0f || (e0 == 0.0f && (tl & 1)))
                             && (e1 > 0.0f || (e1 == 0.0f && (tl & 2)))
                             && (e2 > 0.0f || (e2 == 0.0f && (tl & 4)));
            const float zv = (zx + c[CH_Z + 1] * y) + c[CH_Z + 2];
            const float zc = fminf(fmaxf(zv, 0.0f), 1.0f);
            const float zq = rintf(zc * 65535.0f) * (1.0f / 65535.0f);
            const bool frag = cov && zv == zc;
            const bool pass = LEX
                ? frag && (zq < zb[i] || (zq == zb[i] && ord >= ob[i]))
                : frag && zq <= zb[i];
            if (pass) {
                zb[i] = zq;
                own[i] = eid;
                if constexpr (!STRIP) {
                    // a pixel passes at few of its entries: the attributes
                    // come from scalar loads here, not from registers held
                    // across the pixels
                    ob[i] = LEX ? ord : row[CH_ORDER];
                    uwb[i] = (row[CH_UW] * xf + row[CH_UW + 1] * y)
                             + row[CH_UW + 2];
                    vwb[i] = (row[CH_VW] * xf + row[CH_VW + 1] * y)
                             + row[CH_VW + 2];
                    iwb[i] = (row[CH_INVW] * xf + row[CH_INVW + 1] * y)
                             + row[CH_INVW + 2];
                    texb[i] = (int)row[CH_META] & META_TEX_MASK;
                }
            }
        }
    };

    if constexpr (EXIT > 0) {
        publish_max(1);
        publish_max(2);
    }
    int k = 0;
    for (; k < nchunks; ++k) {
        cp_async_wait_all();
        // chunk k has landed for every thread; every thread is done with
        // chunk k - 1's slot and has published its warp's max after it
        __syncthreads();
        const int s = chunk_at(k, vseg[3]);
        const float* buf = sbuf + (k & 1) * buf_floats;
        // the chunk's live rows: [jlo, jhi)
        const int jlo = max(vseg[1] - s, 0), jhi = min(vseg[2] - s, span);
        if constexpr (EXIT > 0) {
            // uniform: a shared value against the tile's max after chunk
            // k - EXIT
            const int ej = PACKED ? jlo / PACK * PACK_ROW + jlo % PACK * NC
                                  : jlo * NC;
            if (buf[ej + CH_ZMIN] * inv_q
                > tile_max((k + 3 - EXIT) % 3))
                break;
        }
        if (k + 1 < nchunks) {
            const int s1 = chunk_at(k + 1, vseg[3]);
            issue(k + 1, s1, min(vseg[2] - s1, span));  // up to the end
        }
        if constexpr (PACKED) {
            // rows r0 .. r1 of the window hold [jlo, jhi): the first and
            // the last row, where the dead lead and tail entries are, loop
            // over their live entries; each row between resolves its PACK
            // entries at static offsets from the row pointer, untested
            const int r0 = jlo / PACK, r1 = (jhi - 1) / PACK;
            {
                const float* row = buf + r0 * PACK_ROW;
                const int hi = r0 == r1 ? jhi - r0 * PACK : PACK;
#pragma unroll 1
                for (int u = jlo - r0 * PACK; u < hi; ++u)
                    resolve(row + u * NC, s + r0 * PACK + u);
            }
            for (int r = r0 + 1; r < r1; ++r) {
                const float* row = buf + r * PACK_ROW;
#pragma unroll
                for (int u = 0; u < PACK; ++u)
                    resolve(row + u * NC, s + r * PACK + u);
            }
            if (r1 > r0) {
                const float* row = buf + r1 * PACK_ROW;
#pragma unroll 1
                for (int u = 0; u < jhi - r1 * PACK; ++u)
                    resolve(row + u * NC, s + r1 * PACK + u);
            }
        } else {
            for (int j0 = jlo - jlo % UNROLL; j0 < jhi; j0 += UNROLL) {
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const int j = j0 + u;
                    if (j < jlo || j >= jhi) continue;  // uniform
                    resolve(buf + (HOIST ? 0 : j) * NC, s + j);
                }
            }
        }
        if constexpr (EXIT > 0) publish_max(k % 3);
    }
    cp_async_wait_all();  // a prefetch past the exit
    if (nchunks == 0) __syncthreads();  // (uniform) publishes seg

    const int t = vseg[0];
    if (threadIdx.x == 0) {  // the live rows of the k chunks resolved
        int resolved = 0;
        for (int kk = 0; kk < k; ++kk) {
            const int s = chunk_at(kk, vseg[3]);
            resolved += min(vseg[2] - s, span) - max(vseg[1] - s, 0);
        }
        p.nres[t] = resolved;
    }
    const int pad_w = p.grid_w * TILE_W;
    const size_t o0 =
        (size_t)(t / p.grid_w * groups * PPT + threadIdx.x / TILE_W) * pad_w
        + t % p.grid_w * TILE_W + (threadIdx.x & (TILE_W - 1));
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const size_t o = o0 + (size_t)i * groups * pad_w;
        p.owner[o] = own[i];
        p.z[o] = zb[i];
        p.order[o] = ob[i];
        p.uw[o] = uwb[i];
        p.vw[o] = vwb[i];
        p.iw[o] = iwb[i];
        p.tex[o] = texb[i];
    }
}

// the instances the tool's variants use:
// (PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S, PACKED)
#define TY_VARIANTS(X)                                  \
    X(2, 4, false, 0, false, false, false, false)       \
    X(4, 4, false, 0, false, false, false, false)       \
    X(8, 4, false, 0, false, false, false, false)       \
    X(2, 8, false, 0, false, false, false, false)       \
    X(2, 2, false, 0, false, false, false, false)       \
    X(4, 8, false, 0, false, false, false, false)       \
    X(4, 2, false, 0, false, false, false, false)       \
    X(2, 4, true, 0, false, false, false, false)        \
    X(2, 4, true, 1, false, false, false, false)        \
    X(2, 4, true, 2, false, false, false, false)        \
    X(2, 4, true, 1, false, false, true, false)         \
    X(2, 4, false, 0, true, false, false, false)        \
    X(2, 4, false, 0, false, true, false, false)        \
    X(2, 4, false, 0, true, true, false, false)         \
    X(4, 4, false, 0, false, true, false, false)        \
    X(2, 5, true, 0, false, false, false, true)         \
    X(2, 5, true, 1, false, false, false, true)         \
    X(2, 5, true, 2, false, false, false, true)

template <int PPT, int UNROLL, bool LEX, int EXIT, bool STRIP, bool HOIST,
          bool E2S, bool PACKED>
cudaError_t launch(const Params& p, int ntiles, int threads, size_t smem,
                   cudaStream_t st) {
    auto kern = variant_kernel<PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S,
                               PACKED>;
    if (smem > 32 * 1024) {  // with the static part, past the default 48 KB
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kern<<<ntiles, threads, smem, st>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ty_probe_visibility(
    const int* tile_start, const float* table, int cap, int span,
    const float* depth0, int fb_w, int fb_h, int grid_w, int grid_h,
    int scx, int scy, int scw, int sch, int tile_h, int threads, int ppt,
    int unroll, int lex, int exit_mode, int strip, int hoist, int e2s,
    int packed, int* owner, float* z, float* order, float* uw, float* vw,
    float* iw, int* tex, int* nres, int* tile_order, void* stream) {
    if (span <= 0 || cap < span || grid_w * grid_h <= 0)
        return (int)cudaErrorInvalidValue;
    // the geometry of p3_launch: PPT rows of one column a thread
    if (tile_h <= 0 || tile_h % ppt != 0
        || ppt != max(MIN_PPT, (TILE_W * tile_h + MAX_THREADS - 1)
                                   / MAX_THREADS)
        || threads * ppt != TILE_W * tile_h)
        return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(table) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    const Params p{tile_start, table, cap, span, depth0, fb_w, fb_h, grid_w,
                   scx, scy, scw, sch, owner, z, order, uw, vw, iw, tex,
                   nres, tile_order};
    const int buf_floats = packed ? span / PACK * PACK_ROW : span * NC;
    const size_t smem = 2 * (size_t)buf_floats * sizeof(float);
    const int ntiles = grid_w * grid_h;
    cudaStream_t st = (cudaStream_t)stream;
    // buckets of 8 rows at tile_h 8, twice as wide at each doubling
    int shift = ORDER_SHIFT_TH8;
    for (int h = 8; h < tile_h; h *= 2) ++shift;
    const cudaError_t err =
        tile_order::launch(tile_start, ntiles, shift, tile_order, st);
    if (err != cudaSuccess) return (int)err;
#define TY_MATCH(PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S, PACKED)        \
    if (ppt == PPT && unroll == UNROLL && (lex != 0) == LEX                \
        && exit_mode == EXIT && (strip != 0) == STRIP                      \
        && (hoist != 0) == HOIST && (e2s != 0) == E2S                      \
        && (packed != 0) == PACKED)                                        \
        return (int)launch<PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S,       \
                           PACKED>(p, ntiles, threads, smem, st);
    TY_VARIANTS(TY_MATCH)
#undef TY_MATCH
    return (int)cudaErrorInvalidValue;  // no such instance
}
