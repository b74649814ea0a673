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
// A CTA resolves one tile of 128 x tile_h pixels (tile_h = 8, 16, 32 or 64)
// with 256 threads: a thread keeps PPT = tile_h / 2 pixels of one column
// (rows r, r + 2, ...), their 7-field state in registers (at tile_h 64
// that is 224 registers of state: the instance spills, and its time says
// what that costs).  The tile's segment of the table streams through
// shared memory in chunks of `span` entries counted from the chunk-aligned
// base below its start (the TPU kernel's base and its clamp
// min(base + k * span, cap - span), which may resolve an entry twice), two
// buffers filled with cp.async: the next chunk loads while this one
// resolves.  A chunk loads only the rows the tile reads (its rows up to the
// segment's end).  Entries run in groups of UNROLL, as the TPU kernel's
// unrolled loop; an entry outside [start, end) is skipped.  The kernel
// reads no broad list: the TPU probes leave theirs unread.
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
// once, 7 maps written once) are below it.  At tile_h 16 and sponza's
// table the operations take ~0.1 ms.  Left for the redesign: the per-entry
// shared-memory loads (22 a thread an entry, amortised over PPT pixels),
// the barrier and block max after every chunk under EXIT, and the
// registers at tile_h 64.
//
// Numerics: built with -fmad=false and rintf (round half to even, as
// torch.round), so the maps are bit-equal to variant_reference and
// packed_reference on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NC = 24;
constexpr int CH_E0 = 0, CH_E1 = 3, CH_TWOA = 6, CH_Z = 9, CH_INVW = 12;
constexpr int CH_UW = 15, CH_VW = 18, CH_META = 21, CH_ORDER = 22, CH_ZMIN = 23;
constexpr int META_TEX_BITS = 18;
constexpr int META_TEX_MASK = (1 << META_TEX_BITS) - 1;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int PACK = 5, PACK_ROW = 128, WIN_ROWS = 26;

struct Params {
    const int* tile_start;  // [ntiles + 1]
    const float* table;     // [E, 24], or packed [rows, 128]
    int cap;                // entries the table holds (5 rows a packed row)
    int span;               // entries a chunk (window) holds
    const float* depth0;    // [fb_h, fb_w]
    int fb_w, fb_h, grid_w;
    int scx, scy, scw, sch;
    int* owner; float* z; float* order; float* uw; float* vw; float* iw;
    int* tex;               // [grid_h * tile_h, grid_w * 128]
    int* nres;              // [ntiles]
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ float plane(const float* c, int row, float x,
                                       float y) {
    return (c[row] * x + c[row + 1] * y) + c[row + 2];
}

__device__ float block_max(float v, float* scratch) {
    for (int off = 16; off > 0; off >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // scratch may still be read from the last call
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    float m = scratch[0];
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, scratch[w]);
    return m;
}

// the smem offset of chunk entry j
template <bool PACKED>
__device__ __forceinline__ int entry_offset(int j) {
    if constexpr (PACKED) return (j / PACK) * PACK_ROW + (j % PACK) * NC;
    return j * NC;
}

template <int PPT, int UNROLL, bool LEX, int EXIT, bool STRIP, bool HOIST,
          bool E2S, bool PACKED>
__global__ void __launch_bounds__(THREADS)
variant_kernel(Params p) {
    extern __shared__ __align__(16) float sbuf[];  // [2][chunk rows]
    __shared__ float red[THREADS / 32];
    constexpr int TILE_H = 2 * PPT;
    const int span = p.span;
    const int buf_floats = PACKED ? WIN_ROWS * PACK_ROW : span * NC;
    const int t = blockIdx.x;
    const int gx = t % p.grid_w, gy = t / p.grid_w;
    const int pad_w = p.grid_w * TILE_W;
    const int x = gx * TILE_W + (threadIdx.x & (TILE_W - 1));
    const int y0 = gy * TILE_H + (threadIdx.x >> 7);
    const float xf = (float)x + 0.5f;
    const bool x_in = x >= p.scx && x < p.scx + p.scw;

    float zb[PPT], ob[PPT], uwb[PPT], vwb[PPT], iwb[PPT], yf[PPT];
    int own[PPT], texb[PPT];
    bool live_px[PPT];
    float zmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const int y = y0 + 2 * i;
        yf[i] = (float)y + 0.5f;
        live_px[i] = x_in && y >= p.scy && y < p.scy + p.sch;
        zb[i] = (x < p.fb_w && y < p.fb_h) ? p.depth0[(size_t)y * p.fb_w + x]
                                           : -INFINITY;
        zmax = fmaxf(zmax, zb[i]);
        ob[i] = -1.0f; uwb[i] = 0.0f; vwb[i] = 0.0f; iwb[i] = 1.0f;
        own[i] = -1; texb[i] = 0;
    }

    const int start = p.tile_start[t], end = p.tile_start[t + 1];
    const int align = PACKED ? PACK : span;
    const int base = start - start % align;
    const int nchunks = end > start ? (end - base + span - 1) / span : 0;
    float thresh = 0.0f, thresh1 = 0.0f;
    if constexpr (EXIT > 0) {
        thresh = block_max(zmax, red);
        thresh1 = thresh;
    }
    const float inv_q = 1.0f / 65535.0f;

    auto chunk_at = [&](int k) { return min(base + k * span, p.cap - span); };
    auto issue = [&](int k) {
        const int s = chunk_at(k);
        const int n = min(end - s, span);  // rows up to the segment's end
        float* dst = sbuf + (k & 1) * buf_floats;
        const float* src;
        int nvec;
        if constexpr (PACKED) {
            src = p.table + (size_t)(s / PACK) * PACK_ROW;
            nvec = (n + PACK - 1) / PACK * (PACK_ROW / 4);
        } else {
            src = p.table + (size_t)s * NC;
            nvec = n * (NC / 4);
        }
        for (int v = threadIdx.x; v < nvec; v += THREADS)
            cp_async16(dst + 4 * v, src + 4 * v);
        asm volatile("cp.async.commit_group;\n" ::);
    };

    int resolved = 0;
    if (nchunks > 0) issue(0);
    for (int k = 0; k < nchunks; ++k) {
        const int s = chunk_at(k);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();  // chunk k landed; chunk k - 1 is fully consumed
        const float* buf = sbuf + (k & 1) * buf_floats;
        const int idx0 = max(start - s, 0);
        if constexpr (EXIT > 0) {
            // uniform: a shared value against the block-wide threshold
            if (buf[entry_offset<PACKED>(idx0) + CH_ZMIN] * inv_q > thresh)
                break;
        }
        if (k + 1 < nchunks) issue(k + 1);
        const int nh = min(end - s, span);
        resolved += nh - idx0;
        for (int j0 = 0; j0 < nh; j0 += UNROLL) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int j = j0 + u;
                const int eid = s + j;
                if (eid < start || eid >= end) continue;  // uniform
                const float* c = buf + entry_offset<PACKED>(HOIST ? 0 : j);
                const int meta = (int)c[CH_META];
                const int tl = meta >> META_TEX_BITS;
                const float ord = c[CH_ORDER];
#pragma unroll
                for (int i = 0; i < PPT; ++i) {
                    const float e0 = plane(c, CH_E0, xf, yf[i]);
                    const float e1 = plane(c, CH_E1, xf, yf[i]);
                    const float e2 = E2S ? plane(c, CH_TWOA, xf, yf[i])
                                         : (c[CH_TWOA] - e0) - e1;
                    const bool cov =
                        (e0 > 0.0f || (e0 == 0.0f && (tl & 1)))
                        && (e1 > 0.0f || (e1 == 0.0f && (tl & 2)))
                        && (e2 > 0.0f || (e2 == 0.0f && (tl & 4)));
                    const float zv = plane(c, CH_Z, xf, yf[i]);
                    const float zc = fminf(fmaxf(zv, 0.0f), 1.0f);
                    const float zq = rintf(zc * 65535.0f) * (1.0f / 65535.0f);
                    const bool frag = cov && zv == zc && live_px[i];
                    const bool pass = LEX
                        ? frag && (zq < zb[i] || (zq == zb[i] && ord >= ob[i]))
                        : frag && zq <= zb[i];
                    if (pass) {
                        zb[i] = zq;
                        own[i] = eid;
                        if constexpr (!STRIP) {
                            ob[i] = ord;
                            uwb[i] = plane(c, CH_UW, xf, yf[i]);
                            vwb[i] = plane(c, CH_VW, xf, yf[i]);
                            iwb[i] = plane(c, CH_INVW, xf, yf[i]);
                            texb[i] = meta & META_TEX_MASK;
                        }
                    }
                }
            }
        }
        if constexpr (EXIT > 0) {
            float m = -INFINITY;
#pragma unroll
            for (int i = 0; i < PPT; ++i) m = fmaxf(m, zb[i]);
            m = block_max(m, red);
            if constexpr (EXIT == 2) {
                thresh = thresh1;
                thresh1 = m;
            } else {
                thresh = m;
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);  // a prefetch past the exit
    if (threadIdx.x == 0) p.nres[t] = resolved;

#pragma unroll
    for (int i = 0; i < PPT; ++i) {
        const size_t o = (size_t)(y0 + 2 * i) * pad_w + x;
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
    X(8, 4, false, 0, false, false, false, false)       \
    X(4, 4, false, 0, false, false, false, false)       \
    X(16, 4, false, 0, false, false, false, false)      \
    X(32, 4, false, 0, false, false, false, false)      \
    X(8, 8, false, 0, false, false, false, false)       \
    X(8, 2, false, 0, false, false, false, false)       \
    X(16, 8, false, 0, false, false, false, false)      \
    X(16, 2, false, 0, false, false, false, false)      \
    X(4, 8, false, 0, false, false, false, false)       \
    X(8, 4, true, 0, false, false, false, false)        \
    X(8, 4, true, 1, false, false, false, false)        \
    X(8, 4, true, 2, false, false, false, false)        \
    X(8, 4, true, 1, false, false, true, false)         \
    X(8, 4, false, 0, true, false, false, false)        \
    X(8, 4, false, 0, false, true, false, false)        \
    X(8, 4, false, 0, true, true, false, false)         \
    X(16, 4, false, 0, false, true, false, false)       \
    X(8, 5, true, 0, false, false, false, true)         \
    X(8, 5, true, 1, false, false, false, true)         \
    X(8, 5, true, 2, false, false, false, true)

template <int PPT, int UNROLL, bool LEX, int EXIT, bool STRIP, bool HOIST,
          bool E2S, bool PACKED>
cudaError_t launch(const Params& p, int ntiles, size_t smem,
                   cudaStream_t st) {
    auto kern = variant_kernel<PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S,
                               PACKED>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kern<<<ntiles, THREADS, smem, st>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int ty_probe_visibility(
    const int* tile_start, const float* table, int cap, int span,
    const float* depth0, int fb_w, int fb_h, int grid_w, int grid_h,
    int scx, int scy, int scw, int sch, int tile_h, int unroll, int lex,
    int exit_mode, int strip, int hoist, int e2s, int packed, int* owner,
    float* z, float* order, float* uw, float* vw, float* iw, int* tex,
    int* nres, void* stream) {
    if (span <= 0 || cap < span || grid_w * grid_h <= 0)
        return (int)cudaErrorInvalidValue;
    const Params p{tile_start, table, cap, span, depth0, fb_w, fb_h, grid_w,
                   scx, scy, scw, sch, owner, z, order, uw, vw, iw, tex,
                   nres};
    const int buf_floats = packed ? WIN_ROWS * PACK_ROW : span * NC;
    const size_t smem = 2 * (size_t)buf_floats * sizeof(float);
    const int ppt = tile_h / 2;
    cudaStream_t st = (cudaStream_t)stream;
#define TY_MATCH(PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S, PACKED)        \
    if (ppt == PPT && unroll == UNROLL && (lex != 0) == LEX                \
        && exit_mode == EXIT && (strip != 0) == STRIP                      \
        && (hoist != 0) == HOIST && (e2s != 0) == E2S                      \
        && (packed != 0) == PACKED)                                        \
        return (int)launch<PPT, UNROLL, LEX, EXIT, STRIP, HOIST, E2S,       \
                           PACKED>(p, grid_w * grid_h, smem, st);
    TY_VARIANTS(TY_MATCH)
#undef TY_MATCH
    return (int)cudaErrorInvalidValue;  // no such instance
}
