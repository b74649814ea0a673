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
// One CTA per screen tile, one pixel per thread.  The tile's segment
// [tile_start[t], tile_start[t+1]) of the zmin-sorted entry table streams
// through shared memory in chunks of `chunk` rows (24 f32 = 96 B each);
// every thread then walks the chunk's rows, reading coefficients as
// shared-memory broadcasts.  After each chunk a block-wide max of the
// tile's depth gives `thresh`; the next chunk runs only if its first row's
// CH_ZMIN * (1/65535) <= thresh.  CH_ZMIN bounds the triangle's corner
// depths less the plane's f32 evaluation error (setup.py::_zmin_quantized),
// so the exit skips only rows that cannot pass wherever the f32 z plane
// stays above it; on nearly degenerate triangles it may not (see
// ops/visibility.py), as in the TPU kernel.  The broad (huge-triangle)
// list is scanned last with a tile-bbox test.
//
// Bound: latency and occupancy.  The work is ~30 flops per pixel-entry and
// the exit skips the back of deep tiles' segments, so the kernel waits on
// the chunk loads and the per-chunk barrier + reduction.  The design keeps
// the per-entry loop free of global loads and of barriers, lets several
// 256-thread CTAs share an SM to hide the loads, and skips the loads of
// chunks past the exit.
//
// peel2 keeps a second 7-field state per pixel in registers and applies the
// three layer-2 rules of raster_pallas.py:262-291 in resolve(); its exit
// threshold is the block max of the layer-2 depth (z2 >= z1, and an entry
// beyond every z2 can change neither layer).  counts adds each chunk's row
// count as it passes the exit test.  Both are `if constexpr` branches, so
// the base instance carries neither the second state nor the counter.
//
// Numerics: built with -fmad=false, rintf (round half to even, as
// jnp.round), and the float top-left compares, so the maps are bit-equal to
// rasterize_visibility_stream_reference (ops/visibility.py) on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NC = 24;  // channels per entry row
constexpr int CH_E0 = 0, CH_E1 = 3, CH_TWOA = 6, CH_Z = 9, CH_INVW = 12;
constexpr int CH_UW = 15, CH_VW = 18, CH_META = 21, CH_ORDER = 22, CH_ZMIN = 23;
constexpr int META_TEX_BITS = 18;
constexpr int META_TEX_MASK = (1 << META_TEX_BITS) - 1;

struct Params {
    const int* tile_start;     // [ntiles + 1]
    const float* entries;      // [E, 24] sorted by (tile, zmin)
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
};

struct Layer {
    float zbuf, obuf, uw, vw, iw;
    int owner, tex;
};

struct Pixel {
    float xf, yf;
    bool live;  // inside the framebuffer and the scissor
    Layer l1, l2;  // l2 is live in the peel2 instance only
};

__device__ __forceinline__ float plane(const float* c, int row, float x, float y) {
    return (c[row] * x + c[row + 1] * y) + c[row + 2];
}

// One entry against this thread's pixel (raster_pallas.py resolve_half).
template <bool PEEL2>
__device__ __forceinline__ void resolve(const float* c, int eid, Pixel& px,
                                        bool le, bool d16) {
    const int meta = (int)c[CH_META];
    const int tl = meta >> META_TEX_BITS;
    const float e0 = plane(c, CH_E0, px.xf, px.yf);
    const float e1 = plane(c, CH_E1, px.xf, px.yf);
    const float e2 = (c[CH_TWOA] - e0) - e1;
    const bool cov = (e0 > 0.0f || (e0 == 0.0f && (tl & 1)))
                     && (e1 > 0.0f || (e1 == 0.0f && (tl & 2)))
                     && (e2 > 0.0f || (e2 == 0.0f && (tl & 4)));
    const float zv = plane(c, CH_Z, px.xf, px.yf);
    const float zc = fminf(fmaxf(zv, 0.0f), 1.0f);
    const float zq = d16 ? rintf(zc * 65535.0f) * (1.0f / 65535.0f) : zc;
    const float ord = c[CH_ORDER];
    const bool frag = cov && zv == zc && px.live;
    Layer& a = px.l1;
    const bool pass = frag && (zq < a.zbuf
                               || (zq == a.zbuf && (le ? ord >= a.obuf
                                                       : ord < a.obuf)));
    if constexpr (PEEL2) {
        // layer 2 = the record holder just before the winner drew:
        //  * a losing fragment enters it only if drawn before the winner;
        //  * a new winner demotes the old one if drawn after it; otherwise
        //    layer 2 stays while drawn before the new winner, else it
        //    becomes a record gate at the old winner (owner -1).
        Layer& b = px.l2;
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
            b.uw = plane(c, CH_UW, px.xf, px.yf);
            b.vw = plane(c, CH_VW, px.xf, px.yf);
            b.iw = plane(c, CH_INVW, px.xf, px.yf);
            b.tex = meta & META_TEX_MASK;
        }
    }
    if (pass) {
        a.zbuf = zq;
        a.owner = eid;
        a.obuf = ord;
        a.uw = plane(c, CH_UW, px.xf, px.yf);
        a.vw = plane(c, CH_VW, px.xf, px.yf);
        a.iw = plane(c, CH_INVW, px.xf, px.yf);
        a.tex = meta & META_TEX_MASK;
    }
}

__device__ float block_max(float v, float* scratch) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nwarps = (blockDim.x + 31) >> 5;
    __syncthreads();  // scratch may still be read from the last call
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float m = scratch[0];
    for (int w = 1; w < nwarps; ++w) m = fmaxf(m, scratch[w]);
    return m;
}

template <bool PEEL2, bool COUNTS>
__global__ void visibility_kernel(Params p) {
    extern __shared__ float smem[];           // [chunk, 24]
    __shared__ float red[32];
    const int t = blockIdx.x;
    const int gx = t % p.grid_w, gy = t / p.grid_w;
    const int lx = threadIdx.x % p.tile_w, ly = threadIdx.x / p.tile_w;
    const int x = gx * p.tile_w + lx, y = gy * p.tile_h + ly;
    const bool inside = x < p.fb_w && y < p.fb_h;
    const bool le = p.le != 0, d16 = p.d16 != 0;

    Pixel px;
    px.xf = (float)x + 0.5f;
    px.yf = (float)y + 0.5f;
    px.live = inside && x >= p.scx && x < p.scx + p.scw
              && y >= p.scy && y < p.scy + p.sch;
    px.l1.zbuf = inside ? p.depth0[(size_t)y * p.fb_w + x] : -INFINITY;
    px.l1.obuf = -1.0f;
    px.l1.owner = -1;
    px.l1.uw = 0.0f; px.l1.vw = 0.0f; px.l1.iw = 1.0f;
    px.l1.tex = 0;
    if constexpr (PEEL2) px.l2 = px.l1;

    // ---- narrow entries: the tile's segment, front to back ----
    const int start = p.tile_start[t], end = p.tile_start[t + 1];
    float thresh = block_max(PEEL2 ? px.l2.zbuf : px.l1.zbuf, red);
    const float inv_q = 1.0f / 65535.0f;
    int visited = 0;
    for (int s = start; s < end; s += p.chunk) {
        const int n = min(p.chunk, end - s);
        __syncthreads();  // the previous chunk is fully consumed
        const float* src = p.entries + (size_t)s * NC;
        for (int i = threadIdx.x; i < n * NC; i += blockDim.x) smem[i] = src[i];
        __syncthreads();
        // uniform exit test: shared value against the block-wide thresh
        if (smem[CH_ZMIN] * inv_q > thresh) break;
        if constexpr (COUNTS) visited += n;
        for (int j = 0; j < n; ++j)
            resolve<PEEL2>(smem + j * NC, s + j, px, le, d16);
        thresh = block_max(PEEL2 ? px.l2.zbuf : px.l1.zbuf, red);
    }
    if constexpr (COUNTS) {
        if (threadIdx.x == 0) p.nvis[t] = visited;
    }

    // ---- broad entries: every tile scans the list with a bbox test ----
    const int nb = min(p.nbroad[0], p.B);
    for (int j = 0; j < nb; ++j) {
        const int* bb = p.broad_tiles + 4 * j;
        if (gx >= bb[0] && gx <= bb[2] && gy >= bb[1] && gy <= bb[3])
            resolve<PEEL2>(p.broad_ch + (size_t)j * NC, p.owner_base + j, px,
                           le, d16);
    }

    if (inside) {
        const size_t o = (size_t)y * p.fb_w + x;
        p.owner[o] = px.l1.owner;
        p.z[o] = px.l1.zbuf;
        p.order[o] = px.l1.obuf;
        p.uw[o] = px.l1.uw;
        p.vw[o] = px.l1.vw;
        p.iw[o] = px.l1.iw;
        p.tex[o] = px.l1.tex;
        if constexpr (PEEL2) {
            p.owner2[o] = px.l2.owner;
            p.z2[o] = px.l2.zbuf;
            p.order2[o] = px.l2.obuf;
            p.uw2[o] = px.l2.uw;
            p.vw2[o] = px.l2.vw;
            p.iw2[o] = px.l2.iw;
            p.tex2[o] = px.l2.tex;
        }
    }
}

}  // namespace

extern "C" int ty_rasterize_visibility(
    const int* tile_start, const float* entries, const float* broad_ch,
    const int* broad_tiles, const int* nbroad, int B, const float* depth0,
    int fb_w, int fb_h, int tile_w, int tile_h, int grid_w, int grid_h,
    int scx, int scy, int scw, int sch,
    int owner_base, int chunk, int le, int d16,
    int* owner, float* z, float* order, float* uw, float* vw, float* iw,
    int* tex,
    int* owner2, float* z2, float* order2, float* uw2, float* vw2, float* iw2,
    int* tex2, int* nvis, void* stream) {
    // layer-2 maps select the peel2 instance, nvis the counts instance
    Params p{tile_start, entries, broad_ch, broad_tiles, nbroad, B, depth0,
             fb_w, fb_h, tile_w, tile_h, grid_w, grid_h, scx, scy, scw, sch,
             owner_base, chunk, le, d16, owner, z, order, uw, vw, iw, tex,
             owner2, z2, order2, uw2, vw2, iw2, tex2, nvis};
    if (owner2 != nullptr && nvis != nullptr) return (int)cudaErrorInvalidValue;
    const int ntiles = grid_w * grid_h;
    if (ntiles > 0) {
        const size_t smem = (size_t)chunk * NC * sizeof(float);
        const dim3 grid(ntiles), block(tile_w * tile_h);
        cudaStream_t st = (cudaStream_t)stream;
        if (owner2 != nullptr)
            visibility_kernel<true, false><<<grid, block, smem, st>>>(p);
        else if (nvis != nullptr)
            visibility_kernel<false, true><<<grid, block, smem, st>>>(p);
        else
            visibility_kernel<false, false><<<grid, block, smem, st>>>(p);
    }
    return (int)cudaGetLastError();
}
