// K3: per-tile visibility resolve over the binned entry table.
//
// Replaces tyleri_tpu/ops/raster_pallas.py: _visibility_kernel, launched by
// rasterize_visibility_pallas, in its three variants, one template
// instance each (the TPU scheduling variants give the same outputs and have
// no counterpart here):
//   base    <false, false>  the winner per pixel;
//   peel2   <true,  false>  also layer 2, the depth-record holder just
//                           before the winner drew (the two-layer blend);
//   counts  <false, true>   also nvis, the narrow entries resolved per tile
//                           before the early exit.
//
// What it computes: one CTA per screen tile.  The tile's segment
// [tile_start[t], tile_start[t+1]) of the zmin-sorted entry table runs front
// to back in chunks of `chunk` rows (24 f32 = 96 B each).  Before chunk k
// resolves, its first row's CH_ZMIN * (1/65535) is compared with the tile's
// deepest depth after chunk k - 1 (of layer 2 under peel2), and the tile
// stops there if it lies beyond.  CH_ZMIN bounds the triangle's corner
// depths less the plane's f32 evaluation error (setup.py::_zmin_quantized),
// so the exit skips only rows that cannot pass wherever the f32 z plane
// stays above it; on nearly degenerate triangles it may not (ROADMAP R7,
// ops/visibility.py), as in the TPU kernel.  The broad (huge-triangle) list
// is scanned last with a tile-box test.
//
// Bound: operations.  Per (entry, pixel) pair 29 f32 operations (35 under
// peel2), each one instruction, over the entries the exit lets through: at
// sponza 1080p ~0.12 ms at 33.5 T instructions/s, against ~0.06 ms of bytes.
// The one-pixel-a-thread kernel this replaces reached 30 % of it: every
// pair reloaded its coefficients from shared memory, each chunk was loaded
// while the whole CTA waited, a chunk took four barriers, and the tiles
// with the longest segments often started last and ran alone at the end.
// What the design does about it:
//
//   * two pixels a thread: a thread owns PPT pixels of one column (rows g
//     and g + G of the tile, G = tile_h / PPT), so each coefficient read
//     from shared memory serves PPT pixels, and each plane's c0 * x is
//     computed once an entry for the column (the same product, so the same
//     bits as at every pixel).  PPT is one constant for the three
//     instances: at 4 (64 threads a 16x16 tile) and 8 a tile's entries run
//     through fewer threads and the longest tiles set the launch's time;
//     at 1 each pair costs more loads (PERF.md).  ops/raster_cuda.py's
//     k3_launch gives the same geometry to the wrapper;
//   * the tiles launch longest segment first: tile_order_kernel
//     (tile_order.cuh), launched just before, sorts them by segment length
//     in buckets of 8 rows, so the long tiles overlap the many short ones;
//   * a two-slot chunk ring in shared memory, filled with 16-byte cp.async:
//     chunk k + 1 loads while chunk k resolves.  A chunk prefetched past the
//     exit is dropped, never resolved; its load is the price, at most one
//     chunk a tile;
//   * one barrier a chunk: it publishes the landed chunk, frees the other
//     slot for the next prefetch, and publishes each warp's depth maximum
//     (a shuffle within the warp; the warps' values go through a
//     double-buffered shared array, so no second barrier).  A tile of one
//     warp or less takes the shuffle alone.
//
// peel2 keeps a second 7-field state per pixel and applies the three
// layer-2 rules of raster_pallas.py:262-291 in resolve(); counts adds each
// chunk's row count as it passes the exit test.  Both are `if constexpr`
// branches, so the base instance carries neither.
//
// Numerics: built with -fmad=false, rintf (round half to even, as
// jnp.round), and the float top-left compares, so the maps are bit-equal to
// rasterize_visibility_stream_reference (ops/visibility.py) on the card.
// CH_ORDER carries an int32 draw order as its bit pattern (setup.py::
// encode_order): read with __float_as_int and compared as an integer, so
// orders past 2^24 stay apart (and small ones, denormal as floats, survive
// a flush to zero); the order maps take it rounded to f32, as the plain
// version's conversion does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_order.cuh"

namespace {

constexpr int NC = 24;  // channels per entry row
constexpr int CH_E0 = 0, CH_E1 = 3, CH_TWOA = 6, CH_Z = 9, CH_INVW = 12;
constexpr int CH_UW = 15, CH_VW = 18, CH_META = 21, CH_ORDER = 22, CH_ZMIN = 23;
constexpr int META_TEX_BITS = 18;
constexpr int META_TEX_MASK = (1 << META_TEX_BITS) - 1;
constexpr int MAX_WARPS = 32;
// pixels a thread, every instance (ops/raster_cuda.py: K3_PPT)
constexpr int PPT = 2;
// the tile order (tile_order.cuh): segment lengths in buckets of 8 rows
constexpr int ORDER_SHIFT = 3;

struct Params {
    const int* tile_start;     // [ntiles + 1]
    const float* entries;      // [E, 24] sorted by (tile, zmin), 16-B aligned
    const float* broad_ch;     // [B, 24]
    const int* broad_tiles;    // [B, 4] (tx0, ty0, tx1, ty1)
    const int* nbroad;         // [1] live broad rows (device scalar)
    int B;
    const float* depth0;       // [fb_h, fb_w]
    int fb_w, fb_h, tile_w, tile_h, grid_w, grid_h;
    int scx, scy, scw, sch;
    int owner_base, chunk, le, d16;
    int* owner; float* z; float* order; float* uw; float* vw; float* iw; int* tex;
    // layer 2 (peel2 only)
    int* owner2; float* z2; float* order2; float* uw2; float* vw2; float* iw2;
    int* tex2;
    int* nvis;                 // [ntiles] (counts only)
    const int* tile_order;     // [ntiles] the tiles, longest segment first
};

struct Layer {
    float zbuf, uw, vw, iw;
    int obuf, owner, tex;   // obuf: the owner's draw order, -1 none
};

// A thread's pixels: PPT rows of one column.
struct Column {
    float xf;          // the column's pixel center
    float yf[PPT];
    bool live[PPT];    // inside the framebuffer and the scissor
    Layer l1[PPT], l2[PPT];  // l2 is live in the peel2 instance only
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c[row] * x + c[row + 1] * y + c[row + 2], with c[row] * x given
__device__ __forceinline__ float plane_cx(const float* c, int row, float cx,
                                          float y) {
    return (cx + c[row + 1] * y) + c[row + 2];
}

__device__ __forceinline__ float plane(const float* c, int row, float x,
                                       float y) {
    return (c[row] * x + c[row + 1] * y) + c[row + 2];
}

// One entry against the thread's PPT pixels (raster_pallas.py
// resolve_half, pixel by pixel).
template <bool PEEL2>
__device__ __forceinline__ void resolve(const float* c, int eid, Column& col,
                                        bool le, bool d16) {
    const int meta = (int)c[CH_META];
    const int tl = meta >> META_TEX_BITS;
    const int ord = __float_as_int(c[CH_ORDER]);
    const float twoa = c[CH_TWOA];
    const float e0x = c[CH_E0] * col.xf;
    const float e1x = c[CH_E1] * col.xf;
    const float zx = c[CH_Z] * col.xf;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const float yf = col.yf[i];
        const float e0 = plane_cx(c, CH_E0, e0x, yf);
        const float e1 = plane_cx(c, CH_E1, e1x, yf);
        const float e2 = (twoa - e0) - e1;
        const bool cov = (e0 > 0.0f || (e0 == 0.0f && (tl & 1)))
                         && (e1 > 0.0f || (e1 == 0.0f && (tl & 2)))
                         && (e2 > 0.0f || (e2 == 0.0f && (tl & 4)));
        const float zv = plane_cx(c, CH_Z, zx, yf);
        const float zc = fminf(fmaxf(zv, 0.0f), 1.0f);
        const float zq = d16 ? rintf(zc * 65535.0f) * (1.0f / 65535.0f) : zc;
        const bool frag = cov && zv == zc && col.live[i];
        Layer& a = col.l1[i];
        const bool pass = frag && (zq < a.zbuf
                                   || (zq == a.zbuf && (le ? ord >= a.obuf
                                                           : ord < a.obuf)));
        if constexpr (PEEL2) {
            // layer 2 = the record holder just before the winner drew:
            //  * a losing fragment enters it only if drawn before the winner;
            //  * a new winner demotes the old one if drawn after it;
            //    otherwise layer 2 stays while drawn before the new winner,
            //    else it becomes a record gate at the old winner (owner -1).
            Layer& b = col.l2[i];
            const bool beats2 = frag && !pass && ord < a.obuf
                && (zq < b.zbuf || (zq == b.zbuf && (le ? ord >= b.obuf
                                                        : ord < b.obuf)));
            const bool demote = pass && a.obuf < ord;
            const bool inval = pass && !demote && !(b.obuf < ord);
            if (demote || inval) {
                b = a;
                if (inval) b.owner = -1;
            } else if (beats2) {
                b.zbuf = zq;
                b.owner = eid;
                b.obuf = ord;
                b.uw = plane(c, CH_UW, col.xf, yf);
                b.vw = plane(c, CH_VW, col.xf, yf);
                b.iw = plane(c, CH_INVW, col.xf, yf);
                b.tex = meta & META_TEX_MASK;
            }
        }
        if (pass) {
            a.zbuf = zq;
            a.owner = eid;
            a.obuf = ord;
            a.uw = plane(c, CH_UW, col.xf, yf);
            a.vw = plane(c, CH_VW, col.xf, yf);
            a.iw = plane(c, CH_INVW, col.xf, yf);
            a.tex = meta & META_TEX_MASK;
        }
    }
}

// The max of v over a warp's threads (a tile of fewer than 32 threads is
// one partial warp of a power-of-two size).
__device__ __forceinline__ float warp_max(float v) {
    const int n = min((int)blockDim.x, 32);
    const unsigned mask = n == 32 ? 0xffffffffu : (1u << n) - 1u;
    for (int off = n >> 1; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(mask, v, off));
    return v;
}

// The exit threshold: the deepest depth of the layer the exit reads.
template <bool PEEL2>
__device__ __forceinline__ float column_max(const Column& col) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < PPT; ++i)
        m = fmaxf(m, PEEL2 ? col.l2[i].zbuf : col.l1[i].zbuf);
    return m;
}

template <bool PEEL2, bool COUNTS>
__global__ void visibility_kernel(Params p) {
    extern __shared__ __align__(16) float ring[];  // [2][chunk][24]
    // each warp's depth max; slot (k & 1) after chunk k, slot 1 before chunk 0
    __shared__ float red[2][MAX_WARPS];
    const int t = p.tile_order[blockIdx.x];
    const int gx = t % p.grid_w, gy = t / p.grid_w;
    const int groups = blockDim.x / p.tile_w;   // G: row groups of the tile
    const int x = gx * p.tile_w + threadIdx.x % p.tile_w;
    const int y0 = gy * p.tile_h + threadIdx.x / p.tile_w;
    const bool le = p.le != 0, d16 = p.d16 != 0;
    const bool x_in = x < p.fb_w;
    const bool x_live = x >= p.scx && x < p.scx + p.scw;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = (blockDim.x + 31) >> 5;

    Column col;
    col.xf = (float)x + 0.5f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const int y = y0 + i * groups;
        const bool inside = x_in && y < p.fb_h;
        col.yf[i] = (float)y + 0.5f;
        col.live[i] = inside && x_live && y >= p.scy && y < p.scy + p.sch;
        Layer& a = col.l1[i];
        a.zbuf = inside ? p.depth0[(size_t)y * p.fb_w + x] : -INFINITY;
        a.obuf = -1;
        a.owner = -1;
        a.uw = 0.0f; a.vw = 0.0f; a.iw = 1.0f;
        a.tex = 0;
        if constexpr (PEEL2) col.l2[i] = a;
    }

    // ---- narrow entries: the tile's segment, front to back ----
    const int start = p.tile_start[t], end = p.tile_start[t + 1];
    const int chunk = p.chunk;
    const int nchunks = end > start ? (end - start + chunk - 1) / chunk : 0;
    const float inv_q = 1.0f / 65535.0f;
    auto issue = [&](int k) {  // chunk k into slot k & 1
        const int s = start + k * chunk;
        const int nvec = min(chunk, end - s) * (NC / 4);
        float* dst = ring + (k & 1) * chunk * NC;
        const float* src = p.entries + (size_t)s * NC;
        for (int v = threadIdx.x; v < nvec; v += blockDim.x)
            cp_async16(dst + 4 * v, src + 4 * v);
        cp_async_commit();
    };

    float wmax = warp_max(column_max<PEEL2>(col));
    if (nwarps > 1 && lane == 0) red[1][warp] = wmax;
    if (nchunks > 0) issue(0);
    int visited = 0;
    for (int k = 0; k < nchunks; ++k) {
        cp_async_wait_all();
        // chunk k has landed for every thread; every thread is done with
        // chunk k - 1's slot and has published its warp's max after it
        __syncthreads();
        float thresh = wmax;
        if (nwarps > 1) {
            const float* r = red[(k + 1) & 1];
            thresh = r[0];
            for (int w = 1; w < nwarps; ++w) thresh = fmaxf(thresh, r[w]);
        }
        const float* buf = ring + (k & 1) * chunk * NC;
        // uniform exit test: a shared value against the tile-wide threshold
        if (buf[CH_ZMIN] * inv_q > thresh) break;
        if (k + 1 < nchunks) issue(k + 1);
        const int s = start + k * chunk;
        const int n = min(chunk, end - s);
        if constexpr (COUNTS) visited += n;
        for (int j = 0; j < n; ++j)
            resolve<PEEL2>(buf + j * NC, s + j, col, le, d16);
        wmax = warp_max(column_max<PEEL2>(col));
        if (nwarps > 1 && lane == 0) red[k & 1][warp] = wmax;
    }
    cp_async_wait_all();  // a chunk prefetched past the exit
    if constexpr (COUNTS) {
        if (threadIdx.x == 0) p.nvis[t] = visited;
    }

    // ---- broad entries: every tile scans the list with a bbox test ----
    const int nb = min(p.nbroad[0], p.B);
    for (int j = 0; j < nb; ++j) {
        const int* bb = p.broad_tiles + 4 * j;
        if (gx >= bb[0] && gx <= bb[2] && gy >= bb[1] && gy <= bb[3])
            resolve<PEEL2>(p.broad_ch + (size_t)j * NC, p.owner_base + j, col,
                           le, d16);
    }

#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const int y = y0 + i * groups;
        if (!x_in || y >= p.fb_h) continue;
        const size_t o = (size_t)y * p.fb_w + x;
        const Layer& a = col.l1[i];
        p.owner[o] = a.owner;
        p.z[o] = a.zbuf;
        p.order[o] = __int2float_rn(a.obuf);
        p.uw[o] = a.uw;
        p.vw[o] = a.vw;
        p.iw[o] = a.iw;
        p.tex[o] = a.tex;
        if constexpr (PEEL2) {
            const Layer& b = col.l2[i];
            p.owner2[o] = b.owner;
            p.z2[o] = b.zbuf;
            p.order2[o] = __int2float_rn(b.obuf);
            p.uw2[o] = b.uw;
            p.vw2[o] = b.vw;
            p.iw2[o] = b.iw;
            p.tex2[o] = b.tex;
        }
    }
}

template <bool PEEL2, bool COUNTS>
cudaError_t launch(const Params& p, int ntiles, int threads, cudaStream_t st) {
    auto kern = visibility_kernel<PEEL2, COUNTS>;
    const size_t smem = 2 * (size_t)p.chunk * NC * sizeof(float);
    if (smem > 32 * 1024) {  // with the static part, past the default 48 KB
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kern<<<ntiles, threads, smem, st>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ty_rasterize_visibility(
    const int* tile_start, const float* entries, const float* broad_ch,
    const int* broad_tiles, const int* nbroad, int B, const float* depth0,
    int fb_w, int fb_h, int tile_w, int tile_h, int grid_w, int grid_h,
    int scx, int scy, int scw, int sch,
    int owner_base, int chunk, int le, int d16, int threads, int ppt,
    int* owner, float* z, float* order, float* uw, float* vw, float* iw,
    int* tex,
    int* owner2, float* z2, float* order2, float* uw2, float* vw2, float* iw2,
    int* tex2, int* nvis, int* tile_order, void* stream) {
    // layer-2 maps select the peel2 instance, nvis the counts instance
    Params p{tile_start, entries, broad_ch, broad_tiles, nbroad, B, depth0,
             fb_w, fb_h, tile_w, tile_h, grid_w, grid_h, scx, scy, scw, sch,
             owner_base, chunk, le, d16, owner, z, order, uw, vw, iw, tex,
             owner2, z2, order2, uw2, vw2, iw2, tex2, nvis, tile_order};
    if (owner2 != nullptr && nvis != nullptr) return (int)cudaErrorInvalidValue;
    // the geometry of ops/raster_cuda.py::k3_launch: PPT rows of one column
    // a thread, whole warps or one partial warp of a power-of-two size
    if (chunk <= 0 || tile_w <= 0 || ppt != PPT || threads <= 0
        || tile_h % ppt != 0 || threads * ppt != tile_w * tile_h
        || threads > 32 * MAX_WARPS
        || (threads >= 32 ? threads % 32 : threads & (threads - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(entries) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    const int ntiles = grid_w * grid_h;
    if (ntiles <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err =
        tile_order::launch(tile_start, ntiles, ORDER_SHIFT, tile_order, st);
    if (err != cudaSuccess) return (int)err;
    if (owner2 != nullptr) return (int)launch<true, false>(p, ntiles, threads, st);
    if (nvis != nullptr) return (int)launch<false, true>(p, ntiles, threads, st);
    return (int)launch<false, false>(p, ntiles, threads, st);
}
