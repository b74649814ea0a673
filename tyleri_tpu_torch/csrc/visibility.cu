// K3: per-tile visibility resolve over the binned entry table.
//
// Replaces tyleri_tpu/ops/raster_pallas.py: _visibility_kernel, launched by
// rasterize_visibility_pallas (base variant: no peel2 carry, no visit
// counter; the TPU scheduling variants give the same outputs and have no
// counterpart here).
//
// One CTA per screen tile, one pixel per thread.  The tile's segment
// [tile_start[t], tile_start[t+1]) of the zmin-sorted entry table streams
// through shared memory in chunks of `chunk` rows (24 f32 = 96 B each);
// every thread then walks the chunk's rows, reading coefficients as
// shared-memory broadcasts.  After each chunk a block-wide max of the
// tile's depth gives `thresh`; the next chunk runs only if its first row's
// CH_ZMIN * (1/65535) <= thresh.  CH_ZMIN is a conservative bound
// (setup.py::_zmin_quantized), so the exit skips only rows that cannot pass
// the depth test anywhere in the tile: the result is exact.  The broad
// (huge-triangle) list is scanned last with a tile-bbox test.
//
// Bound: latency and occupancy.  The work is ~30 flops per pixel-entry and
// the exit skips the back of deep tiles' segments, so the kernel waits on
// the chunk loads and the per-chunk barrier + reduction.  The design keeps
// the per-entry loop free of global loads and of barriers, lets several
// 256-thread CTAs share an SM to hide the loads, and skips the loads of
// chunks past the exit.
//
// Numerics: built with -fmad=false, rintf (round half to even, as
// jnp.round), and the float top-left compares, so the maps are bit-equal to
// rasterize_visibility_reference (ops/visibility.py) on the card.

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
};

struct Pixel {
    float xf, yf;
    bool live;  // inside the framebuffer and the scissor
    float zbuf, obuf, uw, vw, iw;
    int owner, tex;
};

__device__ __forceinline__ float plane(const float* c, int row, float x, float y) {
    return (c[row] * x + c[row + 1] * y) + c[row + 2];
}

// One entry against this thread's pixel (raster_pallas.py resolve_half).
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
    const bool pass = frag && (zq < px.zbuf
                               || (zq == px.zbuf && (le ? ord >= px.obuf
                                                        : ord < px.obuf)));
    if (pass) {
        px.zbuf = zq;
        px.owner = eid;
        px.obuf = ord;
        px.uw = plane(c, CH_UW, px.xf, px.yf);
        px.vw = plane(c, CH_VW, px.xf, px.yf);
        px.iw = plane(c, CH_INVW, px.xf, px.yf);
        px.tex = meta & META_TEX_MASK;
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
    px.zbuf = inside ? p.depth0[(size_t)y * p.fb_w + x] : -INFINITY;
    px.obuf = -1.0f;
    px.owner = -1;
    px.uw = 0.0f; px.vw = 0.0f; px.iw = 1.0f;
    px.tex = 0;

    // ---- narrow entries: the tile's segment, front to back ----
    const int start = p.tile_start[t], end = p.tile_start[t + 1];
    float thresh = block_max(px.zbuf, red);
    const float inv_q = 1.0f / 65535.0f;
    for (int s = start; s < end; s += p.chunk) {
        const int n = min(p.chunk, end - s);
        __syncthreads();  // the previous chunk is fully consumed
        const float* src = p.entries + (size_t)s * NC;
        for (int i = threadIdx.x; i < n * NC; i += blockDim.x) smem[i] = src[i];
        __syncthreads();
        // uniform exit test: shared value against the block-wide thresh
        if (smem[CH_ZMIN] * inv_q > thresh) break;
        for (int j = 0; j < n; ++j) resolve(smem + j * NC, s + j, px, le, d16);
        thresh = block_max(px.zbuf, red);
    }

    // ---- broad entries: every tile scans the list with a bbox test ----
    const int nb = min(p.nbroad[0], p.B);
    for (int j = 0; j < nb; ++j) {
        const int* bb = p.broad_tiles + 4 * j;
        if (gx >= bb[0] && gx <= bb[2] && gy >= bb[1] && gy <= bb[3])
            resolve(p.broad_ch + (size_t)j * NC, p.owner_base + j, px, le, d16);
    }

    if (inside) {
        const size_t o = (size_t)y * p.fb_w + x;
        p.owner[o] = px.owner;
        p.z[o] = px.zbuf;
        p.order[o] = px.obuf;
        p.uw[o] = px.uw;
        p.vw[o] = px.vw;
        p.iw[o] = px.iw;
        p.tex[o] = px.tex;
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
    int* tex, void* stream) {
    Params p{tile_start, entries, broad_ch, broad_tiles, nbroad, B, depth0,
             fb_w, fb_h, tile_w, tile_h, grid_w, grid_h, scx, scy, scw, sch,
             owner_base, chunk, le, d16, owner, z, order, uw, vw, iw, tex};
    const int ntiles = grid_w * grid_h;
    if (ntiles > 0) {
        const size_t smem = (size_t)chunk * NC * sizeof(float);
        visibility_kernel<<<ntiles, tile_w * tile_h, smem,
                            (cudaStream_t)stream>>>(p);
    }
    return (int)cudaGetLastError();
}
