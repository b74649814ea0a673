// The exact-order rasterizer: triangles drawn one after another in table
// order, each fragment tested against the depth its predecessors left and
// blended over the color they left (the UI pass and exact mode).
//
// Replaces no TPU kernel: tyleri_tpu/ops/raster_exact.py is plain jnp, a
// loop over triangles and raster windows.  The port ran the same loop
// eagerly (ops/raster_exact.py, now the plain version of this kernel, taken
// for CPU tensors), a few dozen PyTorch operations a triangle and window:
// ~1.3 ms of host dispatch a triangle, ~370 ms a frame under a 256-triangle
// HUD, with the card idle.  This kernel is the whole loop in one launch.
//
// Bound: bytes.  Each touched pixel's color and depth are read once and
// written once (20 B each way); the triangles' rows (setup's 24 channels,
// the draw region, the vertex-color planes: 160 B each) are read by every
// tile, from the L2.  A 480x270 HUD panel is ~5.2 MB, a few
// microseconds at 3.35 TB/s.  On that HUD at 1080p the kernel takes ~0.02
// ms on an H100, ~8 % of the bound: each of the 8,160 tiles reads all 256
// draw regions (~33 MB from the L2) and the launch fills the rest.  That
// is ~0.1 % of the frame, so the cull stays one flat pass.
//
// What it computes: one CTA a TILE x TILE screen tile, one thread a pixel.
// The CTA walks the triangles in table order, THREADS at a time: each thread
// tests one triangle's draw region (below) against the tile, and a warp
// ballot with a prefix over the warps keeps the survivors in table order
// in shared memory.  Each thread then applies the survivors to its pixel,
// in that order, exactly as the plain loop's draw() does for that pixel:
// the planes as (A*x + B*y) + C at the pixel centre, e2 = (twoa - e0) - e1,
// coverage by each edge's top-left bit, 0 <= z <= 1, quantize_depth
// (rintf, half to even, and the division by 65535 that ops/depth.py
// writes), the depth compare, the division by inv_w with its zero guard,
// the solid colour or sample_bilinear's mirrored-repeat texel-quad fetch,
// the perspective-correct vertex colour, apply_blend with its clamp and
// write mask, and the depth write.  A pixel's color and depth are loaded
// once, at the first chunk with a survivor, held in registers and written
// back once; a tile no triangle reaches never touches the framebuffer.
// One thread applies its pixel's fragments in table order, so the result
// is the loop's by construction.
//
// Each triangle is read where setup left it: its channel row (the CH_*
// layout of ops/setup.py, the contract K3 reads too; CH_META's texture slot
// and top-left bits decoded here, the slot looked up in the texture
// tables), its draw region and, for the UI, its vertex-color planes; the
// wrapper packs nothing.  The draw region of a triangle is the set of
// pixels the loop visits for it: the union of its raster windows (which
// may reach past its pixel box by up to a window less one pixel), clipped
// to the scissor and the framebuffer; the wrapper computes it
// (ops/raster_exact.py::_draw_regions).  Culling by that region, not by
// the pixel box, keeps the kernel the loop's twin even where an f32 edge
// test would pass outside the box; tests/test_torch_raster_exact.py shows
// that on the golden scenes it never does.
//
// Numerics: built with -fmad=false and IEEE division, so every operation
// rounds as eager PyTorch's does on the CPU; D16 divides by 65535 as
// ops/depth.py writes it (ROADMAP R6).  The kernel is equal to the plain
// loop on CPU tensors, color and depth, at every pixel
// (tests/test_torch_raster_exact_cuda.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;    // one pixel a thread
constexpr int WARPS = THREADS / 32;

// a triangle's channel row (ops/setup.py: CH_*)
constexpr int NC = 24;
constexpr int CH_E0 = 0, CH_E1 = 3, CH_TWOA = 6, CH_Z = 9, CH_INVW = 12;
constexpr int CH_UW = 15, CH_VW = 18, CH_META = 21;
constexpr int META_TEX_BITS = 18;
constexpr int META_TEX_MASK = (1 << META_TEX_BITS) - 1;
constexpr int NVC = 12;     // vertex-color planes: (A, B, C) of 4 channels

// the orders of ops/raster_exact.py's codes (CompareOp, BlendFactor,
// BlendOp as pipeline/state.py lists them)
enum Compare { NEVER, LESS, EQUAL, LESS_OR_EQUAL, GREATER, NOT_EQUAL,
               GREATER_OR_EQUAL, ALWAYS };
enum Factor { ZERO, ONE, SRC_COLOR, ONE_MINUS_SRC_COLOR, DST_COLOR,
              ONE_MINUS_DST_COLOR, SRC_ALPHA, ONE_MINUS_SRC_ALPHA, DST_ALPHA,
              ONE_MINUS_DST_ALPHA };
enum Op { ADD, SUBTRACT, REVERSE_SUBTRACT, MIN, MAX };

struct Params {
    const float* channels;  // [T, NC]
    const int* regions;     // [T, 4]: x0, y0, x1, y1, ends exclusive
    const float* vc;        // [T, NVC], or null: no vertex color
    int T;
    const float* texels;    // [cap, 16] texel quads
    const int* tex_offset;  // [slots] each texture's first quad row
    const int* tex_width;   // [slots]
    const int* tex_height;  // [slots]
    int slots;
    float* color;           // [fb_h, fb_w, 4], in place
    float* depth;           // [fb_h, fb_w], in place
    int fb_w, fb_h;
    int compare, depth_write, d16;
    int blend, src_color, dst_color, color_op, src_alpha, dst_alpha, alpha_op;
    int write_mask;         // bit c: channel c is written
};

__device__ __forceinline__ float plane(const float* p, float x, float y) {
    return (p[0] * x + p[1] * y) + p[2];
}

__device__ __forceinline__ bool passes(int op, float zq, float d) {
    switch (op) {
        case LESS: return zq < d;
        case EQUAL: return zq == d;
        case LESS_OR_EQUAL: return zq <= d;
        case GREATER: return zq > d;
        case NOT_EQUAL: return zq != d;
        case GREATER_OR_EQUAL: return zq >= d;
        case ALWAYS: return true;
        default: return false;
    }
}

// torch.clamp(v, 0, 1): NaN passes
__device__ __forceinline__ float clamp01(float v) {
    v = v < 0.0f ? 0.0f : v;
    return v > 1.0f ? 1.0f : v;
}

// ops/blend.py::_factor for one channel: s, d the channel's source and
// destination, sa, da the alphas
__device__ __forceinline__ float factor(int f, float s, float d, float sa,
                                        float da) {
    switch (f) {
        case ZERO: return 0.0f;
        case ONE: return 1.0f;
        case SRC_COLOR: return s;
        case ONE_MINUS_SRC_COLOR: return 1.0f - s;
        case DST_COLOR: return d;
        case ONE_MINUS_DST_COLOR: return 1.0f - d;
        case SRC_ALPHA: return sa;
        case ONE_MINUS_SRC_ALPHA: return 1.0f - sa;
        case DST_ALPHA: return da;
        default: return 1.0f - da;      // ONE_MINUS_DST_ALPHA
    }
}

// torch.minimum / torch.maximum: NaN propagates
__device__ __forceinline__ float blend_op(int op, float a, float b) {
    switch (op) {
        case ADD: return a + b;
        case SUBTRACT: return a - b;
        case REVERSE_SUBTRACT: return b - a;
        case MIN: return (a != a || b != b) ? a + b : fminf(a, b);
        default: return (a != a || b != b) ? a + b : fmaxf(a, b);
    }
}

// ops/blend.py::apply_blend of src over dst, in place into dst
__device__ __forceinline__ void blend(const Params& p, const float src[4],
                                      float dst[4]) {
    float out[4];
    if (!p.blend) {
        for (int c = 0; c < 4; ++c) out[c] = src[c];
    } else {
        const float sa = src[3], da = dst[3];
        for (int c = 0; c < 4; ++c) {
            const bool alpha = c == 3;
            const int op = alpha ? p.alpha_op : p.color_op;
            if (op == MIN || op == MAX) {
                out[c] = blend_op(op, src[c], dst[c]);
            } else {
                const float fs = factor(alpha ? p.src_alpha : p.src_color,
                                        src[c], dst[c], sa, da);
                const float fd = factor(alpha ? p.dst_alpha : p.dst_color,
                                        src[c], dst[c], sa, da);
                out[c] = blend_op(op, src[c] * fs, dst[c] * fd);
            }
        }
    }
    for (int c = 0; c < 4; ++c)
        if (p.write_mask >> c & 1) dst[c] = clamp01(out[c]);
}

// ops/sampling.py::mirror_repeat
__device__ __forceinline__ long long mirror(long long i, long long n) {
    long long m = i % (2 * n);
    if (m < 0) m += 2 * n;
    return m >= n ? 2 * n - 1 - m : m;
}

// ops/sampling.py::sample_bilinear at one pixel: one texel-quad row
__device__ __forceinline__ void sample(const float* __restrict__ texels,
                                       long long off, long long w,
                                       long long h, float u, float v,
                                       float out[4]) {
    const float tu = u * (float)w - 0.5f;
    const float tv = v * (float)h - 0.5f;
    const float fu0 = floorf(tu), fv0 = floorf(tv);
    const float fu = tu - fu0, fv = tv - fv0;
    const long long iu0 = (long long)fu0, iv0 = (long long)fv0;
    const long long iu0m = mirror(iu0, w), iu1m = mirror(iu0 + 1, w);
    const long long iv0m = mirror(iv0, h), iv1m = mirror(iv0 + 1, h);
    const long long bx = iu0m < iu1m ? iu0m : iu1m;
    const long long by = iv0m < iv1m ? iv0m : iv1m;
    const float* q = texels + (off + by * w + bx) * 16;
    const float* r0 = iv0m != by ? q + 8 : q;
    const float* r1 = iv1m != by ? q + 8 : q;
    const int a0 = iu0m != bx ? 4 : 0, a1 = iu1m != bx ? 4 : 0;
    for (int c = 0; c < 4; ++c) {
        const float top = __ldg(r0 + a0 + c) * (1.0f - fu)
                          + __ldg(r0 + a1 + c) * fu;
        const float bot = __ldg(r1 + a0 + c) * (1.0f - fu)
                          + __ldg(r1 + a1 + c) * fu;
        out[c] = top * (1.0f - fv) + bot * fv;
    }
}

// one triangle's fragment at pixel centre (x, y), applied to (col, dep)
__device__ __forceinline__ void draw(const Params& p, int t, float x, float y,
                                     float col[4], float& dep) {
    const float* f = p.channels + (size_t)t * NC;
    const int meta = (int)__ldg(f + CH_META);
    const int tl = meta >> META_TEX_BITS;
    const float e0 = plane(f + CH_E0, x, y);
    const float e1 = plane(f + CH_E1, x, y);
    const float e2 = (__ldg(f + CH_TWOA) - e0) - e1;
    const bool cov = ((tl & 1) ? e0 >= 0.0f : e0 > 0.0f)
                     && ((tl & 2) ? e1 >= 0.0f : e1 > 0.0f)
                     && ((tl & 4) ? e2 >= 0.0f : e2 > 0.0f);
    if (!cov) return;
    const float z = plane(f + CH_Z, x, y);
    if (!(z >= 0.0f && z <= 1.0f)) return;     // so quantize's clamp is moot
    const float zq = p.d16 ? rintf(z * 65535.0f) / 65535.0f : z;
    if (!passes(p.compare, zq, dep)) return;
    const float inv_w = plane(f + CH_INVW, x, y);
    const float denom = inv_w == 0.0f ? 1.0f : inv_w;
    // the texture slot, clamped into the tables; a 1x1 texture is a solid
    // color, its one texel
    const int slot = min(max(meta & META_TEX_MASK, 0), p.slots - 1);
    const int tw = __ldg(p.tex_width + slot), th = __ldg(p.tex_height + slot);
    const long long off = __ldg(p.tex_offset + slot);
    float src[4];
    if (tw == 1 && th == 1) {
        for (int c = 0; c < 4; ++c) src[c] = __ldg(p.texels + off * 16 + c);
    } else {
        sample(p.texels, off, tw > 1 ? tw : 1, th > 1 ? th : 1,
               plane(f + CH_UW, x, y) / denom, plane(f + CH_VW, x, y) / denom,
               src);
    }
    if (p.vc != nullptr) {
        const float* v = p.vc + (size_t)t * NVC;
        for (int c = 0; c < 4; ++c)
            src[c] = src[c] * (plane(v + 3 * c, x, y) / denom);
    }
    blend(p, src, col);
    if (p.depth_write) dep = zq;
}

__global__ void __launch_bounds__(THREADS) raster_exact_kernel(Params p) {
    __shared__ int s_tri[THREADS];
    __shared__ int4 s_box[THREADS];
    __shared__ int s_warp[WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tx0 = blockIdx.x * TILE, ty0 = blockIdx.y * TILE;
    const int px = tx0 + tid % TILE, py = ty0 + tid / TILE;
    const bool inside = px < p.fb_w && py < p.fb_h;
    const float x = (float)px + 0.5f, y = (float)py + 0.5f;
    const size_t pix = (size_t)py * p.fb_w + px;
    float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dep = 0.0f;
    bool loaded = false;    // the same in every thread of the CTA
    for (int base = 0; base < p.T; base += THREADS) {
        // cull: the chunk's triangles whose draw region meets the tile,
        // kept in table order
        const int t = base + tid;
        int4 box = make_int4(0, 0, 0, 0);
        bool keep = false;
        if (t < p.T) {
            box = __ldg(reinterpret_cast<const int4*>(p.regions) + t);
            keep = box.x < box.z && box.y < box.w && box.x < tx0 + TILE
                   && tx0 < box.z && box.y < ty0 + TILE && ty0 < box.w;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) s_warp[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, kept = 0;
        for (int w = 0; w < WARPS; ++w) {
            const int n = s_warp[w];
            before += w < warp ? n : 0;
            kept += n;
        }
        if (keep) {
            const int at = before + __popc(ballot & ((1u << lane) - 1u));
            s_tri[at] = t;
            s_box[at] = box;
        }
        __syncthreads();
        // the next chunk writes s_tri and s_box only after its first
        // barrier, which every thread reaches after this chunk's draws
        if (kept == 0) continue;
        if (!loaded) {
            loaded = true;
            if (inside) {
                const float4 c = reinterpret_cast<const float4*>(p.color)[pix];
                col[0] = c.x; col[1] = c.y; col[2] = c.z; col[3] = c.w;
                dep = p.depth[pix];
            }
        }
        if (!inside) continue;
        for (int j = 0; j < kept; ++j) {
            const int4 b = s_box[j];
            if (px < b.x || px >= b.z || py < b.y || py >= b.w) continue;
            draw(p, s_tri[j], x, y, col, dep);
        }
    }
    if (loaded && inside) {
        reinterpret_cast<float4*>(p.color)[pix] =
            make_float4(col[0], col[1], col[2], col[3]);
        p.depth[pix] = dep;
    }
}

}  // namespace

extern "C" int ty_raster_exact(
    const float* channels, const int* regions, const float* vc, int T,
    const float* texels, const int* tex_offset, const int* tex_width,
    const int* tex_height, int slots,
    float* color, float* depth, int fb_w, int fb_h,
    int compare, int depth_write, int d16,
    int blend, int src_color, int dst_color, int color_op,
    int src_alpha, int dst_alpha, int alpha_op, int write_mask,
    void* stream) {
    if (T < 0 || slots <= 0 || fb_w < 0 || fb_h < 0 || compare < NEVER
        || compare > ALWAYS
        || src_color < ZERO || src_color > ONE_MINUS_DST_ALPHA
        || dst_color < ZERO || dst_color > ONE_MINUS_DST_ALPHA
        || src_alpha < ZERO || src_alpha > ONE_MINUS_DST_ALPHA
        || dst_alpha < ZERO || dst_alpha > ONE_MINUS_DST_ALPHA
        || color_op < ADD || color_op > MAX || alpha_op < ADD
        || alpha_op > MAX)
        return (int)cudaErrorInvalidValue;
    // 16-byte loads of the region and of a pixel's color
    if ((reinterpret_cast<uintptr_t>(regions) & 15) != 0
        || (reinterpret_cast<uintptr_t>(color) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    if (fb_w == 0 || fb_h == 0) return (int)cudaGetLastError();
    Params p{channels, regions, vc, T, texels, tex_offset, tex_width,
             tex_height, slots, color, depth, fb_w, fb_h,
             compare, depth_write, d16, blend, src_color, dst_color, color_op,
             src_alpha, dst_alpha, alpha_op, write_mask};
    const dim3 grid((fb_w + TILE - 1) / TILE, (fb_h + TILE - 1) / TILE);
    raster_exact_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
