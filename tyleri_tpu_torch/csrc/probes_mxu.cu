// P2: K3's plane evaluation as matrix products, on the tensor cores.
//
// Replaces tools/exp_mxu.py: _mxu_kernel (run_mxu).  Per tile of
// 128 x tile_h pixels (PX = 128 * tile_h, a power of two) and per chunk of
// `chunk` table rows at min(start + k * chunk, cap - chunk) (no live mask:
// the rows of the next tile take part, as in the probe), the planes
//     ev_p[entry, px] = sum_k lhs[entry, k] * rhs_p[k, px]
// with rhs_p zero except rows 3p..3p+2 = (x + 0.5, y + 0.5, 1), K = 32
// lanes of the table; split: K = 64 bf16 lanes against the exact bf16
// split of the coordinates (15 rows a plane: x hi/lo x3, y hi/lo x3, 1 x3).
// The products run as mma.sync, pixels in M and entries in N (the same
// sums as the probe's [chunk, K] @ [K, nplanes * PX]):
//   MODE 0 "highest": 3xTF32, m16n8k8: a = big + small, each rounded to
//          TF32; small*big + big*small + big*big into f32 (the card's
//          cheapest product accurate to f32);
//   MODE 1 "default": both operands rounded to bf16 (nearest even),
//          m16n8k16, f32 sums: the TPU's single bf16 pass;
//   MODE 2 split: bf16 lanes 0..63 against the split coordinates.
// The probe's fat flag (one product with the planes along N, or one a
// plane) is the same work here.
//
// On the CUDA cores, per (pixel, entry) pair, by `stage`:
//   0 bare: the min over planes, then over entries, added to acc;
//   1 ew:   coverage, depth range and D16 rounding; acc += the min masked
//           depth (3e38 where no fragment) + min(order) * 1e-9;
//   2 red:  the chunk's winner, min z then max order then max row, and
//           `attr` 1 the sums over every tied winner of planes 4..6 and the
//           texture slot, 2 of coefficient lanes 12..20 and the slot;
//           merged into the carried winner (a later chunk wins ties of
//           order); `exit_cross` gates each chunk on row 0's lane 23 *
//           1e-30 against min(max depth, 3e38), which ends the tile.
// Each thread keeps a running winner for its two pixels of an m-tile over
// the chunk's entries, then the four lanes of a row group merge; the
// carried per-pixel state sits in shared memory.
//
// Bound: the tensor cores at the rate of the products' non-zero rows, 3 of
// a plane's 32 (split 15 of 64): 2 * chunk * 3 * nplanes * PX a chunk;
// "highest" at a third of 495 TFLOP/s, bf16 at 989; or the CUDA-core work
// per pair.  The products as the probe formulates them, zero rows
// included, are ~10x (split ~4x) that.  Left for the redesign: wgmma from
// shared memory, the zero rows, the operands' shared-memory loads (bank
// conflicts on the bf16 pairs), and the per-pair post-processing.
//
// Numerics: every product of the exact-input tables is exact, so the
// kernel equals mxu_reference bit for bit there whatever the order of the
// sums; on other inputs the planes differ by the rounding of the sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_W = 128;
constexpr float BIG = 3.0e38f;
constexpr int MAX_ATTR = 10;

struct Params {
    const int* tile_start;   // [ntiles + 1]
    const float* entries;    // [cap, row_stride]
    int cap, row_stride, chunk, grid_w, tile_h;
    int stage, attr, exit_cross;
    float* out;              // [grid, 8, PX]
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
    big = tf32(x);
    small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The right-hand side at row k for one pixel: (x, y, 1) at rows 3p..3p+2 of
// plane p; split, the bf16 parts at rows 15p..15p+14.
struct Coord {
    float xf, yf, xhi, xlo, yhi, ylo;
};

__device__ __forceinline__ Coord coord(float xf, float yf) {
    Coord c;
    c.xf = xf;
    c.yf = yf;
    c.xhi = __bfloat162float(__float2bfloat16_rn(xf * 0.0625f)) * 16.0f;
    c.xlo = xf - c.xhi;
    c.yhi = __bfloat162float(__float2bfloat16_rn(yf * 0.0625f)) * 16.0f;
    c.ylo = yf - c.yhi;
    return c;
}

template <int MODE>
__device__ __forceinline__ float rhs(const Coord& c, int k, int p) {
    if constexpr (MODE == 2) {
        const int rr = k - 15 * p;
        if (rr < 0 || rr >= 15) return 0.0f;
        if (rr < 6) return (rr & 1) ? c.xlo : c.xhi;
        if (rr < 12) return (rr & 1) ? c.ylo : c.yhi;
        return 1.0f;
    } else {
        const int rr = k - 3 * p;
        return rr == 0 ? c.xf : rr == 1 ? c.yf : rr == 2 ? 1.0f : 0.0f;
    }
}

// A running chunk winner of one pixel (stage 2), or its running min
struct Best {
    float z, o;
    int i;
    float s[MAX_ATTR];
};

__device__ __forceinline__ void best_init(Best& b) {
    b.z = BIG;
    b.o = -BIG;
    b.i = -1;
#pragma unroll
    for (int a = 0; a < MAX_ATTR; ++a) b.s[a] = 0.0f;
}

// fold candidate (z, o, i, vals) into b: min z, then max order; a tie of
// both keeps the larger row and adds the sums
__device__ __forceinline__ void best_take(Best& b, float z, float o, int i,
                                          const float* v, int nattr) {
    if (z < b.z || (z == b.z && o > b.o)) {
        b.z = z;
        b.o = o;
        b.i = i;
#pragma unroll
        for (int a = 0; a < MAX_ATTR; ++a)  // 0 + v: a sum, so -0 is +0
            b.s[a] = a < nattr ? 0.0f + v[a] : 0.0f;
    } else if (z == b.z && o == b.o) {
        b.i = max(b.i, i);
#pragma unroll
        for (int a = 0; a < MAX_ATTR; ++a)
            if (a < nattr) b.s[a] = b.s[a] + v[a];
    }
}

__device__ __forceinline__ void best_merge_lanes(Best& b, int nattr) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        float v[MAX_ATTR];
        const float z = __shfl_xor_sync(0xffffffffu, b.z, off);
        const float o = __shfl_xor_sync(0xffffffffu, b.o, off);
        const int i = __shfl_xor_sync(0xffffffffu, b.i, off);
#pragma unroll
        for (int a = 0; a < MAX_ATTR; ++a)
            v[a] = __shfl_xor_sync(0xffffffffu, b.s[a], off);
        if (z < BIG) best_take(b, z, o, i, v, nattr);
    }
}

template <int MODE, int NPLANES>
__global__ void __launch_bounds__(THREADS) mxu_kernel(Params p) {
    constexpr int K = MODE == 2 ? 64 : 32;
    constexpr int LS = K + 4;   // shared row stride (floats)
    constexpr int KSTEP = MODE == 0 ? 8 : 16;
    extern __shared__ __align__(16) float smem[];
    __shared__ float red[THREADS / 32];
    const int chunk = p.chunk;
    const int PX = TILE_W * p.tile_h;
    const int nattr = p.stage == 2 ? (p.attr == 2 ? 10 : p.attr == 1 ? 4 : 0)
                                   : 0;
    float* lhs = smem;                               // [2][chunk][LS]
    float* st = smem + 2 * chunk * LS;               // [NS][PX]
    float* s_acc = st;                               // acc
    float* s_z = st + PX;                            // stage 2: z, o, owner
    float* s_o = st + 2 * PX;
    int* s_own = reinterpret_cast<int*>(st + 3 * PX);
    float* s_attr = st + 4 * PX;                     // [nattr][PX]

    const int t = blockIdx.x;
    const int gx = t % p.grid_w, gy = t / p.grid_w;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;

    for (int px = threadIdx.x; px < PX; px += THREADS) {
        s_acc[px] = 0.0f;
        if (p.stage == 2) {
            s_z[px] = BIG;
            s_o[px] = -BIG;
            s_own[px] = -1;
            for (int a = 0; a < nattr; ++a) s_attr[a * PX + px] = 0.0f;
        }
    }

    const int start = p.tile_start[t], end = p.tile_start[t + 1];
    const int nchunks = end > start ? (end - start + chunk - 1) / chunk : 0;
    auto chunk_at = [&](int k) { return min(start + k * chunk, p.cap - chunk); };
    auto issue = [&](int k) {
        const float* src = p.entries + (size_t)chunk_at(k) * p.row_stride;
        float* dst = lhs + (k & 1) * chunk * LS;
        for (int v = threadIdx.x; v < chunk * (K / 4); v += THREADS) {
            const int r = v / (K / 4), q = v - r * (K / 4);
            cp_async16(dst + r * LS + 4 * q, src + (size_t)r * p.row_stride
                                                 + 4 * q);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };

    float thresh = BIG;
    if (nchunks > 0) issue(0);
    for (int k = 0; k < nchunks; ++k) {
        const int s = chunk_at(k);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();  // chunk k landed; chunk k - 1 fully consumed
        const float* L = lhs + (k & 1) * chunk * LS;
        if (p.exit_cross && !(L[23] * 1e-30f <= thresh)) break;  // uniform
        if (k + 1 < nchunks) issue(k + 1);
        float omin = 0.0f;
        if (p.stage == 1) {
            omin = L[22];
            for (int e = 1; e < chunk; ++e) omin = fminf(omin, L[e * LS + 22]);
        }

        for (int m0 = warp * 16; m0 < PX; m0 += (THREADS / 32) * 16) {
            const int pa = m0 + g, pb = m0 + g + 8;
            const Coord ca = coord(
                (float)(gx * TILE_W + (pa & (TILE_W - 1))) + 0.5f,
                (float)(gy * p.tile_h + pa / TILE_W) + 0.5f);
            const Coord cb = coord(
                (float)(gx * TILE_W + (pb & (TILE_W - 1))) + 0.5f,
                (float)(gy * p.tile_h + pb / TILE_W) + 0.5f);
            Best ba, bb;   // stage 2: running winners; else .z the min
            best_init(ba);
            best_init(bb);
            for (int e0 = 0; e0 < chunk; e0 += 8) {
                float c[NPLANES][4];
#pragma unroll
                for (int pl = 0; pl < NPLANES; ++pl) {
                    c[pl][0] = c[pl][1] = c[pl][2] = c[pl][3] = 0.0f;
#pragma unroll
                    for (int kb = 0; kb < K; kb += KSTEP) {
                        const float* brow = L + (e0 + g) * LS + kb;
                        if constexpr (MODE == 0) {
                            uint32_t ab[4], as[4], bbg[2], bsm[2];
                            split_tf32(rhs<MODE>(ca, kb + tq, pl), ab[0], as[0]);
                            split_tf32(rhs<MODE>(cb, kb + tq, pl), ab[1], as[1]);
                            split_tf32(rhs<MODE>(ca, kb + tq + 4, pl), ab[2],
                                       as[2]);
                            split_tf32(rhs<MODE>(cb, kb + tq + 4, pl), ab[3],
                                       as[3]);
                            split_tf32(brow[tq], bbg[0], bsm[0]);
                            split_tf32(brow[tq + 4], bbg[1], bsm[1]);
                            mma_tf32(c[pl], as[0], as[1], as[2], as[3], bbg[0],
                                     bbg[1]);
                            mma_tf32(c[pl], ab[0], ab[1], ab[2], ab[3], bsm[0],
                                     bsm[1]);
                            mma_tf32(c[pl], ab[0], ab[1], ab[2], ab[3], bbg[0],
                                     bbg[1]);
                        } else {
                            const int k0 = kb + 2 * tq;
                            mma_bf16(c[pl],
                                     bf16x2(rhs<MODE>(ca, k0, pl),
                                            rhs<MODE>(ca, k0 + 1, pl)),
                                     bf16x2(rhs<MODE>(cb, k0, pl),
                                            rhs<MODE>(cb, k0 + 1, pl)),
                                     bf16x2(rhs<MODE>(ca, k0 + 8, pl),
                                            rhs<MODE>(ca, k0 + 9, pl)),
                                     bf16x2(rhs<MODE>(cb, k0 + 8, pl),
                                            rhs<MODE>(cb, k0 + 9, pl)),
                                     bf16x2(brow[2 * tq], brow[2 * tq + 1]),
                                     bf16x2(brow[2 * tq + 8],
                                            brow[2 * tq + 9]));
                        }
                    }
                }
                // c[pl][r]: pixel (r < 2 ? pa : pb), entry e0 + 2 tq + (r & 1)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    Best& b = r < 2 ? ba : bb;
                    const int e = e0 + 2 * tq + (r & 1);
                    if (p.stage == 0) {
                        float v = c[0][r];
#pragma unroll
                        for (int pl = 1; pl < NPLANES; ++pl) v = fminf(v, c[pl][r]);
                        b.z = fminf(b.z, v);
                        continue;
                    }
                    const float* ct = L + e * LS;
                    const int meta = (int)ct[21];
                    const int tl = meta >> 18;
                    const float e0v = c[0][r], e1v = c[1][r], e2v = c[2][r];
                    const float zv = c[3][r];
                    const bool cov =
                        (e0v > 0.0f || (e0v == 0.0f && (tl & 1)))
                        && (e1v > 0.0f || (e1v == 0.0f && (tl & 2)))
                        && (e2v > 0.0f || (e2v == 0.0f && (tl & 4)));
                    const float zc = fminf(fmaxf(zv, 0.0f), 1.0f);
                    const float zq = rintf(zc * 65535.0f) * (1.0f / 65535.0f);
                    const bool frag = cov && zv == zc;
                    if (p.stage == 1) {
                        b.z = fminf(b.z, frag ? zq : BIG);
                        continue;
                    }
                    if (!frag) continue;
                    float v[MAX_ATTR];
                    if (p.attr == 1) {
#pragma unroll
                        for (int a = 0; a < 3; ++a)
                            v[a] = c[NPLANES > 4 ? 4 + a : 0][r];
                        v[3] = (float)(meta & ((1 << 18) - 1));
                    } else if (p.attr == 2) {
#pragma unroll
                        for (int a = 0; a < 9; ++a) v[a] = ct[12 + a];
                        v[9] = (float)(meta & ((1 << 18) - 1));
                    }
                    best_take(b, zq, ct[22], s + e, v, nattr);
                }
            }
            // the four lanes of a row group hold the same two pixels
            if (p.stage == 2) {
                best_merge_lanes(ba, nattr);
                best_merge_lanes(bb, nattr);
            } else {
#pragma unroll
                for (int off = 1; off <= 2; off <<= 1) {
                    ba.z = fminf(ba.z, __shfl_xor_sync(0xffffffffu, ba.z, off));
                    bb.z = fminf(bb.z, __shfl_xor_sync(0xffffffffu, bb.z, off));
                }
            }
            if (tq == 0) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const Best& b = h ? bb : ba;
                    const int px = h ? pb : pa;
                    if (p.stage == 0) {
                        s_acc[px] = s_acc[px] + b.z;
                    } else if (p.stage == 1) {
                        s_acc[px] = (s_acc[px] + b.z) + omin * 1e-9f;
                    } else {
                        const bool beats = b.z < s_z[px]
                            || (b.z == s_z[px] && b.o >= s_o[px]);
                        if (beats && b.z < BIG) {
                            s_z[px] = b.z;
                            s_o[px] = b.o;
                            s_own[px] = b.i;
                            for (int a = 0; a < nattr; ++a)
                                s_attr[a * PX + px] = b.s[a];
                        }
                    }
                }
            }
        }
        if (p.exit_cross && p.stage == 2) {  // else the threshold stays
            __syncthreads();  // every pixel's depth is merged
            float m = -INFINITY;
            for (int px = threadIdx.x; px < PX; px += THREADS)
                m = fmaxf(m, s_z[px]);
            for (int off = 16; off > 0; off >>= 1)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
            if (lane == 0) red[warp] = m;
            __syncthreads();
            m = red[0];
            for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
            thresh = fminf(m, thresh);
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    float* out = p.out + (size_t)t * 8 * PX;
    for (int px = threadIdx.x; px < PX; px += THREADS) {
        const float xf = (float)(gx * TILE_W + (px & (TILE_W - 1))) + 0.5f;
        const float yf = (float)(gy * p.tile_h + px / TILE_W) + 0.5f;
        float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (p.stage == 2 && p.attr == 1) {
            for (int a = 0; a < 4; ++a) a4[a] = s_attr[a * PX + px];
        } else if (p.stage == 2 && p.attr == 2) {
            const float* at = s_attr + px;
            auto pl = [&](int a) {
                return (at[a * PX] * xf + at[(a + 1) * PX] * yf)
                       + at[(a + 2) * PX];
            };
            a4[0] = pl(3);   // u/w from lanes 15..17
            a4[1] = pl(6);   // v/w from lanes 18..20
            a4[2] = pl(0);   // 1/w from lanes 12..14
            a4[3] = at[9 * PX];
        }
        const bool red2 = p.stage == 2;
        out[0 * PX + px] = red2 ? s_z[px] : BIG;
        out[1 * PX + px] = red2 ? s_o[px] : -BIG;
        out[2 * PX + px] = red2 ? (float)s_own[px] : -1.0f;
        for (int a = 0; a < 4; ++a) out[(3 + a) * PX + px] = a4[a];
        out[7 * PX + px] = s_acc[px];
    }
}

template <int MODE, int NPLANES>
cudaError_t launch(const Params& p, int grid, size_t smem, cudaStream_t st) {
    auto kern = mxu_kernel<MODE, NPLANES>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kern<<<grid, THREADS, smem, st>>>(p);
    return cudaGetLastError();
}

}  // namespace

// shared memory a block of the kernel needs (0: more than a block has)
extern "C" long long ty_probe_mxu_smem(int mode, int chunk, int tile_h,
                                       int stage, int attr) {
    const int K = mode == 2 ? 64 : 32;
    const int nattr = stage == 2 ? (attr == 2 ? 10 : attr == 1 ? 4 : 0) : 0;
    const long long px = (long long)TILE_W * tile_h;
    const long long bytes = 4 * (2LL * chunk * (K + 4)
                                 + px * (stage == 2 ? 4 + nattr : 1));
    return bytes <= 227 * 1024 ? bytes : 0;
}

extern "C" int ty_probe_mxu(const int* tile_start, const float* entries,
                            int cap, int row_stride, int chunk, int grid,
                            int grid_w, int tile_h, int mode, int nplanes,
                            int stage, int attr, int exit_cross, float* out,
                            void* stream) {
    const long long smem = ty_probe_mxu_smem(mode, chunk, tile_h, stage, attr);
    if (smem == 0 || chunk <= 0 || chunk % 8 || cap < chunk || grid <= 0
        || (tile_h & (tile_h - 1)) || row_stride % 4
        || (stage > 0 && nplanes < 4) || (stage == 2 && attr == 1 && nplanes < 7))
        return (int)cudaErrorInvalidValue;
    const Params p{tile_start, entries, cap, row_stride, chunk, grid_w, tile_h,
                   stage, attr, exit_cross, out};
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 0 && nplanes == 4) return (int)launch<0, 4>(p, grid, smem, st);
    if (mode == 0 && nplanes == 7) return (int)launch<0, 7>(p, grid, smem, st);
    if (mode == 1 && nplanes == 4) return (int)launch<1, 4>(p, grid, smem, st);
    if (mode == 1 && nplanes == 7) return (int)launch<1, 7>(p, grid, smem, st);
    if (mode == 2 && nplanes == 4) return (int)launch<2, 4>(p, grid, smem, st);
    return (int)cudaErrorInvalidValue;
}
