// K1+K2: fused vertex transform + near-plane cull + triangle setup.
//
// Replaces tyleri_tpu/ops/setup_pallas.py: _transform_kernel (K1) and
// _plane_kernel (K2), launched by fused_setup.  The TPU needed two kernels
// (a compile-time workaround) and a field-major corner table with a masked
// sweep over the draw table; here one kernel reads the row-major corner
// table and indexes mvps[draw] directly, with no draw cap.  A row is kept
// only where draw % mod_n == mod_i: the round-robin share of the draws that
// a device of a mesh's draws axis renders (setup_pallas.py's draw_kept);
// (1, 0) keeps every row.  One integer compare a row: no byte of the bound.
//
// Bound: bytes.  Per triangle 69 B are read (15 corner floats, draw, tex,
// valid) and 114 B written (24 channels, valid, crossed, the tile box):
// 0.2 GB at sponza's 1.1 M rows, 0.06 ms at 3.35 TB/s, against ~300 f32
// operations a triangle (0.01 ms).  So the design is about the rows' bytes:
//
//   * a CTA owns BLOCK consecutive triangles; their corner rows are one
//     contiguous run of BLOCK * 60 bytes, staged into shared memory with
//     16-byte loads (scalar loads where a view's base is not 16-byte
//     aligned), every warp reading whole sectors;
//   * each thread computes its triangle from shared memory and writes its
//     24 channels into a shared row padded to ROW_PAD words (24 would put
//     the k-th channel of 32 threads in 4 banks, an 8-way conflict; 25 is
//     odd, so 32 banks);
//   * the CTA writes the block's [n, 24] rows, one contiguous run, with
//     16-byte stores, and the tile box as int2 stores;
//   * the crossers are counted in the kernel: a warp ballot, its popcount,
//     one atomicAdd a warp into an i32 the wrapper zeroes;
//   * mvps goes through the read-only path (a frame's draws share a few
//     rows, which stay in L1), whatever the number of draws.
//
// Numerics: built with -fmad=false; every expression follows
// setup_pallas.py:110-319 operation by operation, so the kernel is
// bit-equal to fused_setup_reference (ops/setup_cuda.py) on the card.  In
// particular the transform order ((m0*x + m1*y) + m2*z) + m3 matches the
// re-transform of near-plane crossers in rendering/passes.py.  CH_ZMIN is
// setup.py::_zmin_quantized: the corner depths less the f32 evaluation
// error of the z plane; it does not bound a nearly degenerate triangle's
// plane (ROADMAP R7), and K3's early exit inherits that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_CHANNELS = 24;
constexpr int CH_TWOA = 6, CH_Z = 9, CH_INVW = 12, CH_UW = 15, CH_VW = 18;
constexpr int CH_META = 21, CH_ORDER = 22, CH_ZMIN = 23;
constexpr float W_EPS = 1e-6f;
constexpr float ZMIN_SLACK_Q = 66.0f;
constexpr float META_TEX_MASK = 262143.0f;   // (1 << 18) - 1
constexpr float META_SCALE = 262144.0f;      // 1 << 18
constexpr float INT_CLAMP = 1073741824.0f;   // 2^30

constexpr int BLOCK = 128;                   // triangles (and threads) a CTA
constexpr int CORNER_FLOATS = 15;            // 3 corners x (x, y, z, u, v)
constexpr int ROW_PAD = NUM_CHANNELS + 1;    // shared channel row, in words
constexpr int ROW_VEC = NUM_CHANNELS / 4;    // 16-byte vectors a channel row

struct Params {
    const float* corners;      // [T, 3, 5] pos xyz + uv per corner
    const int* tri_draw;       // [T]
    const int* tri_tex;        // [T]
    const uint8_t* tri_valid;  // [T]
    const float* mvps;         // [D, 16] row-major
    int T, D, cam_valid;
    int mod_n, mod_i;          // keep draws with draw % mod_n == mod_i
    float vx, vy, vw, vh, dmin, dmax;
    int scx, scy, scw, sch;
    int shift_x, shift_y, grid_w, grid_h;
    int cull;                  // 0 none, 1 back, 2 front, 3 both
    int ccw_front;
    float* channels;           // [T, 24], 16-byte aligned
    uint8_t* valid;            // [T]
    int2* tile_lo;             // [T] (tx0, ty0)
    int2* tile_hi;             // [T] (tx1, ty1)
    uint8_t* crossed;          // [T]
    int* crossings;            // [1], zeroed by the caller
};

__device__ __forceinline__ int to_int(float f) {
    // clamp first (as setup.py::float_to_int): NaN -> 0
    if (f != f) return 0;
    return (int)fminf(fmaxf(f, -INT_CLAMP), INT_CLAMP);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Triangle t from its corner row c (shared memory): its 24 channels into
// the shared row ch, its flags and tile box to device memory.  Returns
// whether it crosses the near plane.
__device__ __forceinline__ bool setup_triangle(const Params& p, int t,
                                               const float* c, float* ch) {
    const int draw = p.tri_draw[t];
    const bool table_valid = p.tri_valid[t] != 0;
    const bool draw_ok = draw >= 0 && draw < p.D;
    // the draw mask (a device's round-robin share of the draws on a mesh)
    // folds in before the crossing test, so a masked crosser is neither
    // flagged nor counted
    bool tri_valid = table_valid && p.cam_valid != 0 && draw_ok
                     && draw % p.mod_n == p.mod_i;

    // ---- K1: clip = MVP @ (pos, 1) per corner ----
    float m[16];
    const float* mv = p.mvps + (size_t)(draw_ok ? draw : 0) * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = draw_ok ? __ldg(mv + k) : 0.0f;
    float cl[3][4];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
        const float x = c[5 * v], y = c[5 * v + 1], z = c[5 * v + 2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            cl[v][j] = ((m[4 * j] * x + m[4 * j + 1] * y) + m[4 * j + 2] * z)
                       + m[4 * j + 3];
    }

    // near-plane cull + crossing flag (clip.py semantics)
    const int n_in = (cl[0][2] >= 0.0f) + (cl[1][2] >= 0.0f) + (cl[2][2] >= 0.0f);
    const bool crossed = tri_valid && n_in > 0 && n_in < 3;
    tri_valid = tri_valid && n_in == 3;

    // viewport transform with the safe substitution for w <= W_EPS
    const bool in_front = cl[0][3] > W_EPS && cl[1][3] > W_EPS && cl[2][3] > W_EPS;
    const float dspan = p.dmax - p.dmin;
    float sx[3], sy[3], sz[3], iw[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
        const float w = in_front ? cl[v][3] : 1.0f;
        const float inv_w = 1.0f / w;
        const float cx = in_front ? cl[v][0] : 1.0f;
        const float cy = in_front ? cl[v][1] : 1.0f;
        const float cz = in_front ? cl[v][2] : 1.0f;
        sx[v] = ((cx * inv_w) * 0.5f + 0.5f) * p.vw + p.vx;
        sy[v] = ((cy * inv_w) * 0.5f + 0.5f) * p.vh + p.vy;
        sz[v] = p.dmin + (cz * inv_w) * dspan;
        iw[v] = inv_w;
    }
    tri_valid = tri_valid && in_front;

    // ---- K2: signed doubled area + edge planes ----
    const float area2 = (sx[1] - sx[0]) * (sy[2] - sy[0])
                        - (sy[1] - sy[0]) * (sx[2] - sx[0]);
    const bool nondeg = area2 != 0.0f;
    const float sgn = area2 > 0.0f ? 1.0f : -1.0f;
    const float inv_abs_area2 = sgn / (nondeg ? area2 : 1.0f);

    float eA[3], eB[3], eC[3], tl[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
        const int a = (e + 1) % 3, b = (e + 2) % 3;
        const float dx = sx[b] - sx[a];
        const float dy = sy[b] - sy[a];
        eA[e] = (-dy) * sgn;
        eB[e] = dx * sgn;
        eC[e] = (sx[a] * dy - sy[a] * dx) * sgn;
        const float edx = dx * sgn, edy = dy * sgn;
        tl[e] = (edy < 0.0f || (edy == 0.0f && edx > 0.0f)) ? 1.0f : 0.0f;
    }
    ch[0] = eA[0]; ch[1] = eB[0]; ch[2] = eC[0];
    ch[3] = eA[1]; ch[4] = eB[1]; ch[5] = eC[1];
    ch[CH_TWOA] = area2 * sgn;
    ch[CH_TWOA + 1] = 0.0f;
    ch[CH_TWOA + 2] = 0.0f;

    float lamA[3], lamB[3], lamC[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
        lamA[e] = eA[e] * inv_abs_area2;
        lamB[e] = eB[e] * inv_abs_area2;
        lamC[e] = eC[e] * inv_abs_area2;
    }
    float uw[3], vwv[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
        uw[v] = c[5 * v + 3] * iw[v];
        vwv[v] = c[5 * v + 4] * iw[v];
    }
    const float* attrs[4] = {sz, iw, uw, vwv};
    const int rows[4] = {CH_Z, CH_INVW, CH_UW, CH_VW};
    float zA = 0.0f, zB = 0.0f, zC = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float* a = attrs[k];
        const float pA = (a[0] * lamA[0] + a[1] * lamA[1]) + a[2] * lamA[2];
        const float pB = (a[0] * lamB[0] + a[1] * lamB[1]) + a[2] * lamB[2];
        const float pC = (a[0] * lamC[0] + a[1] * lamC[1]) + a[2] * lamC[2];
        ch[rows[k]] = pA;
        ch[rows[k] + 1] = pB;
        ch[rows[k] + 2] = pC;
        if (k == 0) { zA = pA; zB = pB; zC = pC; }
    }

    // ---- tile bbox clamped to the scissor ----
    const int px0 = max(to_int(floorf(fminf(fminf(sx[0], sx[1]), sx[2]) - 0.5f)), p.scx);
    const int px1 = min(to_int(ceilf(fmaxf(fmaxf(sx[0], sx[1]), sx[2]) - 0.5f)),
                        p.scx + p.scw - 1);
    const int py0 = max(to_int(floorf(fminf(fminf(sy[0], sy[1]), sy[2]) - 0.5f)), p.scy);
    const int py1 = min(to_int(ceilf(fmaxf(fmaxf(sy[0], sy[1]), sy[2]) - 0.5f)),
                        p.scy + p.sch - 1);
    const int tx0 = clampi(px0 >> p.shift_x, 0, p.grid_w - 1);
    const int tx1 = clampi(px1 >> p.shift_x, 0, p.grid_w - 1);
    const int ty0 = clampi(py0 >> p.shift_y, 0, p.grid_h - 1);
    const int ty1 = clampi(py1 >> p.shift_y, 0, p.grid_h - 1);
    const bool on_screen = px0 <= px1 && py0 <= py1;

    bool valid = tri_valid && nondeg && on_screen;
    if (p.cull == 3) {
        valid = false;
    } else if (p.cull != 0) {
        const bool is_front = (area2 > 0.0f) == (p.ccw_front != 0);
        valid = valid && (p.cull == 1 ? is_front : !is_front);
    }

    // ---- conservative D16 z-min bound (setup.py::_zmin_quantized) ----
    const float zmin = fminf(fminf(sz[0], sz[1]), sz[2]);
    const float zmax = fmaxf(fmaxf(sz[0], sz[1]), sz[2]);
    const bool in_range = zmin >= 0.0f && zmax <= 1.0f;
    const float fbw = (fabsf(p.vx) + p.vw) + 128.0f;
    const float fbh = (fabsf(p.vy) + p.vh) + 128.0f;
    const float err = ((fabsf(zA) * fbw + fabsf(zB) * fbh) + fabsf(zC))
                      * (8.0f * 5.9604644775390625e-08f);  // 8 * 2^-24
    const bool zsafe = in_range && err * 65535.0f < ZMIN_SLACK_Q;
    const float zq = fminf(fmaxf(floorf(zmin * 65535.0f) - ZMIN_SLACK_Q, 0.0f), 65535.0f);
    ch[CH_ZMIN] = zsafe ? zq : 0.0f;

    // META: top-left bits above the texture slot; padding rows read tex -1
    const float tl_bits = (tl[0] + 2.0f * tl[1]) + 4.0f * tl[2];
    const float texf = table_valid ? (float)p.tri_tex[t] : -1.0f;
    ch[CH_META] = tl_bits * META_SCALE + floorf(fminf(fmaxf(texf, 0.0f), META_TEX_MASK));
    // the order's int32 bits (setup.py::encode_order): exact past 2^24
    ch[CH_ORDER] = __int_as_float(t);

    p.valid[t] = valid ? 1 : 0;
    p.crossed[t] = crossed ? 1 : 0;
    p.tile_lo[t] = make_int2(tx0, ty0);
    p.tile_hi[t] = make_int2(tx1, ty1);
    return crossed;
}

__global__ void __launch_bounds__(BLOCK) fused_setup_kernel(Params p) {
    __shared__ __align__(16) float s_corners[BLOCK * CORNER_FLOATS];
    __shared__ float s_rows[BLOCK * ROW_PAD];
    const int t0 = blockIdx.x * BLOCK;
    const int n = min(BLOCK, p.T - t0);   // the ragged last block
    const int tid = threadIdx.x;

    // stage the block's corner rows: n * 15 contiguous floats, which start
    // 16-byte aligned wherever the table does (BLOCK * 60 B is a multiple
    // of 16)
    const float* src = p.corners + (size_t)t0 * CORNER_FLOATS;
    const int nf = n * CORNER_FLOATS;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const float4* src4 = reinterpret_cast<const float4*>(src);
        float4* dst4 = reinterpret_cast<float4*>(s_corners);
        for (int v = tid; v < nf / 4; v += BLOCK) dst4[v] = __ldg(src4 + v);
        done = nf / 4 * 4;
    }
    for (int f = done + tid; f < nf; f += BLOCK) s_corners[f] = __ldg(src + f);
    __syncthreads();

    bool crossed = false;
    if (tid < n)
        crossed = setup_triangle(p, t0 + tid, s_corners + tid * CORNER_FLOATS,
                                 s_rows + tid * ROW_PAD);
    const unsigned ballot = __ballot_sync(0xffffffffu, crossed);
    if ((tid & 31) == 0 && ballot != 0) atomicAdd(p.crossings, __popc(ballot));
    __syncthreads();

    // the block's [n, 24] channel rows: one contiguous run, 16-byte stores
    float4* dst = reinterpret_cast<float4*>(p.channels + (size_t)t0 * NUM_CHANNELS);
    for (int v = tid; v < n * ROW_VEC; v += BLOCK) {
        const float* r = s_rows + (v / ROW_VEC) * ROW_PAD + (v % ROW_VEC) * 4;
        dst[v] = make_float4(r[0], r[1], r[2], r[3]);
    }
}

}  // namespace

extern "C" int ty_fused_setup(
    const float* corners, const int* tri_draw, const int* tri_tex,
    const uint8_t* tri_valid, const float* mvps,
    int T, int D, int cam_valid, int mod_n, int mod_i,
    float vx, float vy, float vw, float vh, float dmin, float dmax,
    int scx, int scy, int scw, int sch,
    int shift_x, int shift_y, int grid_w, int grid_h,
    int cull, int ccw_front,
    float* channels, uint8_t* valid, int* tile_lo, int* tile_hi,
    uint8_t* crossed, int* crossings, void* stream) {
    if ((reinterpret_cast<uintptr_t>(channels) & 15) != 0
        || (reinterpret_cast<uintptr_t>(tile_lo) & 7) != 0
        || (reinterpret_cast<uintptr_t>(tile_hi) & 7) != 0)
        return (int)cudaErrorMisalignedAddress;
    if (mod_n < 1 || mod_i < 0 || mod_i >= mod_n)
        return (int)cudaErrorInvalidValue;
    Params p{corners, tri_draw, tri_tex, tri_valid, mvps, T, D, cam_valid,
             mod_n, mod_i, vx, vy, vw, vh, dmin, dmax, scx, scy, scw, sch,
             shift_x, shift_y, grid_w, grid_h, cull, ccw_front,
             channels, valid, reinterpret_cast<int2*>(tile_lo),
             reinterpret_cast<int2*>(tile_hi), crossed, crossings};
    if (T > 0) {
        const int blocks = (T + BLOCK - 1) / BLOCK;
        fused_setup_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(p);
    }
    return (int)cudaGetLastError();
}
