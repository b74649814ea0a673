// P2: K3's plane evaluation as matrix products, on the tensor cores (wgmma).
//
// Replaces tools/exp_mxu.py: _mxu_kernel (run_mxu).  Per tile of
// 128 x tile_h pixels (PX = 128 * tile_h, a power of two) and per chunk of
// `chunk` table rows at min(start + k * chunk, cap - chunk) (no live mask:
// the rows of the next tile take part, as in the probe), the planes
//     ev_p[entry, px] = lane[3p] * (x + 0.5) + lane[3p + 1] * (y + 0.5)
//                       + lane[3p + 2]
// (split: the 15 bf16 lanes 15p..15p+14 against the exact bf16 split of
// the coordinates, x hi/lo x3, y hi/lo x3, 1 x3).  The probe multiplies
// [chunk, K] by [K, nplanes * PX] with K = 32 (split 64), all but 3 (15)
// rows of each plane's right-hand side zero; here each plane is one packed
// k-block that holds only its own rows:
//   MODE 0 "highest": 3xTF32 in one TF32 k8 product.  A pixel's row is
//          (xb, yb, 1, xs, ys, xb, yb, 1), the column of (entry, plane)
//          (ab, bb, cb, ab, bb, as, bs, cs): b the TF32 rounding
//          (cvt.rna), s the TF32 rounding of the remainder; the product sums
//          big*big + small*big + big*small, small*small dropped;
//   MODE 1 "default": both operands rounded to bf16 (nearest even), one
//          bf16 k16 product on (bf x, bf y, 1, 0...) against
//          (bf a, bf b, bf c, 0...): the TPU's single bf16 pass;
//   MODE 2 split: one bf16 k16 product a plane, 15 rows and a zero row.
// The lanes that met only zero rows (K beyond 3 * nplanes, split 60..63)
// are not read: on a finite table the sums are the same.  The probe's fat
// flag (one product with the planes along N, or one a plane) is the same
// work here.
//
// Layout.  Four warpgroups a block; pixels along M, 64 a warpgroup's
// m-tile, whose A fragments a thread builds once from its pixels'
// coordinates and keeps in registers for every plane and entry of the
// chunk; entries x planes along N, 16 entries a product at 4 planes
// (m64n64), 8 at 7 (m64n56), ordered so that a thread's accumulators hold
// every plane of the same (pixel, entry): column 8 (h * NPLANES + p) + c is
// plane p of entry 8h + c.  A cp.async ring brings chunk k + 1's lanes
// while chunk k is in the products; once a chunk, the block converts its
// lanes into the staged B ([entries / 8 * nplanes] groups of 8 rows, each
// row 32 bytes of K, the two 16-byte core matrices of a group 128 bytes
// apart, no swizzle) and its (meta, order) pairs, so no lane is converted
// in the loop.  Two sets of accumulators: a warpgroup's next product runs
// while its CUDA cores run the epilogue of the one before, and a set is
// read only while the other set's product is in flight (else ptxas
// serializes the products).  The stage and the attributes are template
// parameters, so each variant's epilogue is straight-line code.
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
// Bound: the tensor cores at the packed products' rate, 2 * 8 * nplanes
// TF32 flops a pair at 495 TFLOP/s ("highest"), 2 * 3 (split 15) * nplanes
// bf16 flops at 989; or the CUDA-core work per pair, which bounds every
// stage-1 and stage-2 variant and "default".  What holds it back now is
// latency, not either unit's rate: with 16 warps an SM (registers: two
// accumulator sets) a warpgroup waits on its product's latency, and the
// epilogue's dependent compares, more than the units are busy.  More
// products in flight need fewer registers a product.
//
// Numerics: every product of the exact-input tables is exact, so the
// kernel equals mxu_reference bit for bit there whatever the order of the
// sums; on other inputs the planes differ by the rounding of the sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;   // four warpgroups
constexpr int TILE_W = 128;
constexpr int MT = 64;         // pixels of an m-tile
constexpr float BIG = 3.0e38f;

// lanes of a row the kernel reads (the planes', 12..20, meta 21, order 22,
// the exit's 23; split 0..59) and their shared row stride in floats
__host__ __device__ constexpr int lanes_read(int mode) {
    return mode == 2 ? 60 : 24;
}
__host__ __device__ constexpr int lane_stride(int mode) {
    return mode == 2 ? 68 : 28;
}
// entries of a product: 16 at 4 planes (m64n64), 8 at 7 (m64n56), so that
// two sets of accumulators leave a thread of a 512-thread block within its
// 128 registers
__host__ __device__ constexpr int group_of(int nplanes) {
    return nplanes == 4 ? 16 : 8;
}

struct Params {
    const int* tile_start;   // [ntiles + 1]
    const float* entries;    // [cap, row_stride]
    int cap, row_stride, chunk, grid_w, tile_h;
    int exit_cross;
    float* out;              // [grid, 8, PX]
};

// the shared memory of a block, in bytes from its start
struct Smem {
    long long b, mo, raw, st, red, total;
};

__host__ __device__ inline Smem smem_layout(int mode, int nplanes, int chunk,
                                            int tile_h, int stage, int attr) {
    const int nattr = stage == 2 ? (attr == 2 ? 10 : attr == 1 ? 4 : 0) : 0;
    const int group = group_of(nplanes);
    const long long groups = (chunk + group - 1) / group;
    Smem s;
    s.b = 0;                                      // staged B
    s.mo = groups * group * nplanes * 32;         // (meta, order) a row
    s.raw = s.mo + 8LL * chunk;                   // [2][chunk][stride] f32
    s.st = s.raw + 4LL * 2 * chunk * lane_stride(mode);
    s.red = s.st + 4LL * TILE_W * tile_h * (stage == 2 ? 4 + nattr : 1);
    s.total = s.red + 4 * (THREADS / 32);
    return s;
}

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

// B by descriptor: K-major, no swizzle; the two core matrices (8 rows of
// 16 bytes) along K 128 bytes apart, the groups of 8 rows along N 256 apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
           | ((uint64_t)(256 >> 4) << 32);
}

// the products, D = A B (D's old value not read): m64 x n(16 * nplanes)
// x k8 TF32 or k16 bf16, A in registers
__device__ __forceinline__ void wgmma_tf32_n56(
    float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
}

__device__ __forceinline__ void wgmma_bf16_n56(
    float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27}, "
        "{%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
}

__device__ __forceinline__ void wgmma_tf32_n64(
    float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
}

__device__ __forceinline__ void wgmma_bf16_n64(
    float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
}

__device__ __forceinline__ void wgmma_tf32_n112(
    float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
}

__device__ __forceinline__ void wgmma_bf16_n112(
    float* d, const uint32_t* a, uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
}

template <int MODE, int N>
__device__ __forceinline__ void product(float* d, const uint32_t* a,
                                        uint64_t desc) {
    if constexpr (MODE == 0 && N == 56) wgmma_tf32_n56(d, a, desc);
    if constexpr (MODE == 0 && N == 64) wgmma_tf32_n64(d, a, desc);
    if constexpr (MODE == 0 && N == 112) wgmma_tf32_n112(d, a, desc);
    if constexpr (MODE != 0 && N == 56) wgmma_bf16_n56(d, a, desc);
    if constexpr (MODE != 0 && N == 64) wgmma_bf16_n64(d, a, desc);
    if constexpr (MODE != 0 && N == 112) wgmma_bf16_n112(d, a, desc);
}

// keeps the compiler from moving accesses of a product's registers across
// the asynchronous window between its issue and its wait
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// one product into accumulators d (NACC a thread: the product's N / 2)
template <int MODE, int NACC>
__device__ __forceinline__ void issue_product(float (&d)[NACC],
                                              const uint32_t* a,
                                              uint64_t desc) {
    hold(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    product<MODE, 2 * NACC>(d, a, desc);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wait_products() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
                 : "memory");
}

// A fragment of a pixel row at k (tq and tq + 4 for TF32, pairs 2tq and
// 2tq + 8 for bf16): see the note for the rows
template <int MODE>
__device__ __forceinline__ void a_row(float xf, float yf, int tq,
                                      uint32_t& lo, uint32_t& hi) {
    if constexpr (MODE == 0) {
        uint32_t xb, xs, yb, ys;
        split_tf32(xf, xb, xs);
        split_tf32(yf, yb, ys);
        const uint32_t one = __float_as_uint(1.0f);
        // k = tq: xb yb 1 xs; k = tq + 4: ys xb yb 1
        lo = tq == 0 ? xb : tq == 1 ? yb : tq == 2 ? one : xs;
        hi = tq == 0 ? ys : tq == 1 ? xb : tq == 2 ? yb : one;
    } else if constexpr (MODE == 1) {
        lo = tq == 0 ? bf16x2(xf, yf) : tq == 1 ? bf16x2(1.0f, 0.0f) : 0u;
        hi = 0u;
    } else {
        const float xhi =
            __bfloat162float(__float2bfloat16_rn(xf * 0.0625f)) * 16.0f;
        const float yhi =
            __bfloat162float(__float2bfloat16_rn(yf * 0.0625f)) * 16.0f;
        const uint32_t xp = bf16x2(xhi, xf - xhi), yp = bf16x2(yhi, yf - yhi);
        // k = 2tq, 2tq + 1: x x x y; k = 2tq + 8, 2tq + 9: y y (1, 1) (1, 0)
        lo = tq < 3 ? xp : yp;
        hi = tq < 2 ? yp : tq == 2 ? bf16x2(1.0f, 1.0f) : bf16x2(1.0f, 0.0f);
    }
}

// chunk's rows -> staged B (core-matrix order) and (meta, order) pairs
template <int MODE, int NPLANES>
__device__ __forceinline__ void stage_chunk(const float* L, uint4* sb,
                                            float2* mo, int chunk) {
    constexpr int LS = lane_stride(MODE);
    for (int i = threadIdx.x; i < chunk * NPLANES; i += THREADS) {
        const int grp = i >> 3, c = i & 7;     // group of 8 rows, row in it
        const int e8 = grp / NPLANES, pl = grp - e8 * NPLANES;
        const float* row = L + (8 * e8 + c) * LS;
        uint4 lo, hi;   // k 0..3 and 4..7 (TF32), 0..7 and 8..15 (bf16)
        if constexpr (MODE == 0) {
            uint32_t ab, as, bb, bs, cb, cs;
            split_tf32(row[3 * pl], ab, as);
            split_tf32(row[3 * pl + 1], bb, bs);
            split_tf32(row[3 * pl + 2], cb, cs);
            lo = make_uint4(ab, bb, cb, ab);
            hi = make_uint4(bb, as, bs, cs);
        } else if constexpr (MODE == 1) {
            lo = make_uint4(bf16x2(row[3 * pl], row[3 * pl + 1]),
                            bf16x2(row[3 * pl + 2], 0.0f), 0u, 0u);
            hi = make_uint4(0u, 0u, 0u, 0u);
        } else {
            const float* r = row + 15 * pl;
            lo = make_uint4(bf16x2(r[0], r[1]), bf16x2(r[2], r[3]),
                            bf16x2(r[4], r[5]), bf16x2(r[6], r[7]));
            hi = make_uint4(bf16x2(r[8], r[9]), bf16x2(r[10], r[11]),
                            bf16x2(r[12], r[13]), bf16x2(r[14], 0.0f));
        }
        sb[16 * grp + c] = lo;
        sb[16 * grp + 8 + c] = hi;
    }
    for (int e = threadIdx.x; e < chunk; e += THREADS)
        mo[e] = make_float2(L[e * LS + 21], L[e * LS + 22]);
}

// A running chunk winner of one pixel (stage 2) with NATTR sums, or its
// running min (.z)
template <int NATTR>
struct Best {
    float z, o;
    int i;
    float s[NATTR > 0 ? NATTR : 1];
};

template <int NATTR>
__device__ __forceinline__ void best_init(Best<NATTR>& b) {
    b.z = BIG;
    b.o = -BIG;
    b.i = -1;
#pragma unroll
    for (int a = 0; a < NATTR; ++a) b.s[a] = 0.0f;
}

// fold candidate (z, o, i, vals) into b: min z, then max order; a tie of
// both keeps the larger row and adds the sums
template <int NATTR>
__device__ __forceinline__ void best_take(Best<NATTR>& b, float z, float o,
                                          int i, const float* v) {
    if (z < b.z || (z == b.z && o > b.o)) {
        b.z = z;
        b.o = o;
        b.i = i;
#pragma unroll
        for (int a = 0; a < NATTR; ++a) b.s[a] = 0.0f + v[a];  // -0 is +0
    } else if (z == b.z && o == b.o) {
        b.i = max(b.i, i);
#pragma unroll
        for (int a = 0; a < NATTR; ++a) b.s[a] = b.s[a] + v[a];
    }
}

template <int NATTR>
__device__ __forceinline__ void best_merge_lanes(Best<NATTR>& b) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        float v[NATTR > 0 ? NATTR : 1];
        const float z = __shfl_xor_sync(0xffffffffu, b.z, off);
        const float o = __shfl_xor_sync(0xffffffffu, b.o, off);
        const int i = __shfl_xor_sync(0xffffffffu, b.i, off);
#pragma unroll
        for (int a = 0; a < NATTR; ++a)
            v[a] = __shfl_xor_sync(0xffffffffu, b.s[a], off);
        if (z < BIG) best_take(b, z, o, i, v);
    }
}

__host__ __device__ constexpr int nattr_of(int stage, int attr) {
    return stage == 2 ? (attr == 2 ? 10 : attr == 1 ? 4 : 0) : 0;
}

// The epilogue of one product: this thread's entries e0 + 8h + 2tq + j
// (h, j = 0, 1) at its two pixels r (0: row g, 1: row g + 8);
// d[4 (h * NPLANES + p) + 2r + j] is plane p of that pair.  Coverage is
// e > 0, or e == 0 on a top-left edge: e > t with t = -(the least
// denormal) on such an edge, else 0; the depth plane is a fragment where
// 0 <= z <= 1 (z == clamp(z, 0, 1)).
template <int MODE, int NPLANES, int STAGE, int ATTR, int N>
__device__ __forceinline__ void take_product(
    const float (&d)[N], int e0, int chunk, int row0, const float2* mo,
    const float* L, int tq, Best<nattr_of(STAGE, ATTR)>& ba,
    Best<nattr_of(STAGE, ATTR)>& bb) {
    constexpr int LS = lane_stride(MODE);
    constexpr int NATTR = nattr_of(STAGE, ATTR);
    constexpr int H = group_of(NPLANES) / 8;   // halves of 8 entries
    const bool h1 = e0 + 8 < chunk;   // else a chunk of 16k + 8 rows
    auto pl = [&](int h, int j, int r, int q) {
        return d[4 * (h * NPLANES + q) + 2 * r + j];
    };
    if constexpr (STAGE == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float m[2 * H];   // (h, j): the min over planes, as a tree
#pragma unroll
            for (int hj = 0; hj < 2 * H; ++hj) {
                const int h = hj >> 1, j = hj & 1;
                float v[NPLANES];
#pragma unroll
                for (int q = 0; q < NPLANES; ++q) v[q] = pl(h, j, r, q);
#pragma unroll
                for (int w = 1; w < NPLANES; w *= 2)
#pragma unroll
                    for (int q = 0; q + w < NPLANES; q += 2 * w)
                        v[q] = fminf(v[q], v[q + w]);
                m[hj] = v[0];
            }
            float v = fminf(m[0], m[1]);
            if constexpr (H == 2) v = fminf(v, h1 ? fminf(m[2], m[3]) : BIG);
            Best<NATTR>& b = r ? bb : ba;
            b.z = fminf(b.z, v);
        }
        return;
    }
    const float tmin = -__int_as_float(1);
    float t[2 * H][3];
    int meta[2 * H];
#pragma unroll
    for (int hj = 0; hj < 2 * H; ++hj) {
        const int h = hj >> 1, j = hj & 1;
        meta[hj] = (int)mo[e0 + 8 * h + 2 * tq + j].x;
        const int tl = meta[hj] >> 18;
#pragma unroll
        for (int q = 0; q < 3; ++q) t[hj][q] = (tl >> q) & 1 ? tmin : 0.0f;
    }
    unsigned frags = 0;   // bit 2 hj + r: pair (h, j) at pixel r
#pragma unroll
    for (int hj = 0; hj < 2 * H; ++hj) {
        const int h = hj >> 1, j = hj & 1;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float zv = pl(h, j, r, 3);
            const bool frag = pl(h, j, r, 0) > t[hj][0]
                              && pl(h, j, r, 1) > t[hj][1]
                              && pl(h, j, r, 2) > t[hj][2] && zv >= 0.0f
                              && zv <= 1.0f && (h == 0 || h1);
            if constexpr (STAGE == 1) {
                const float zq = rintf(zv * 65535.0f) * (1.0f / 65535.0f);
                Best<NATTR>& b = r ? bb : ba;
                b.z = fminf(b.z, frag ? zq : BIG);
            } else {
                frags |= (unsigned)frag << (2 * hj + r);
            }
        }
    }
    if constexpr (STAGE == 2) {
        if (!frags) return;
#pragma unroll
        for (int hj = 0; hj < 2 * H; ++hj) {
            const int h = hj >> 1, j = hj & 1;
            const int e = e0 + 8 * h + 2 * tq + j;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                if (!((frags >> (2 * hj + r)) & 1)) continue;
                Best<NATTR>& b = r ? bb : ba;
                const float zq =
                    rintf(pl(h, j, r, 3) * 65535.0f) * (1.0f / 65535.0f);
                const float o = mo[e].y;
                if (!(zq < b.z || (zq == b.z && o >= b.o))) continue;
                float v[NATTR > 0 ? NATTR : 1];
                if constexpr (ATTR == 1) {
#pragma unroll
                    for (int a = 0; a < 3; ++a) v[a] = pl(h, j, r, 4 + a);
                    v[3] = (float)(meta[hj] & ((1 << 18) - 1));
                } else if constexpr (ATTR == 2) {
#pragma unroll
                    for (int a = 0; a < 9; ++a) v[a] = L[e * LS + 12 + a];
                    v[9] = (float)(meta[hj] & ((1 << 18) - 1));
                }
                best_take(b, zq, o, row0 + e, v);
            }
        }
    }
}

template <int MODE, int NPLANES, int STAGE, int ATTR>
__global__ void __launch_bounds__(THREADS) mxu_kernel(Params p) {
    constexpr int LANES = lanes_read(MODE);
    constexpr int LS = lane_stride(MODE);
    constexpr int NATTR = nattr_of(STAGE, ATTR);
    constexpr int GROUP = group_of(NPLANES);
    constexpr int NACC = GROUP / 2 * NPLANES;   // accumulators of a product
    // a product's B, in the descriptor's 16-byte units
    constexpr uint64_t DESC_STEP = GROUP / 8 * NPLANES * 256 >> 4;
    extern __shared__ __align__(128) unsigned char smem[];
    const int chunk = p.chunk;
    const int PX = TILE_W * p.tile_h;
    const int ngroups = (chunk + GROUP - 1) / GROUP;
    const Smem lay = smem_layout(MODE, NPLANES, chunk, p.tile_h, STAGE, ATTR);
    uint4* sb = reinterpret_cast<uint4*>(smem + lay.b);
    float2* mo = reinterpret_cast<float2*>(smem + lay.mo);
    float* raw = reinterpret_cast<float*>(smem + lay.raw);
    float* st = reinterpret_cast<float*>(smem + lay.st);
    float* red = reinterpret_cast<float*>(smem + lay.red);
    float* s_acc = st;                               // acc
    float* s_z = st + PX;                            // stage 2: z, o, owner
    float* s_o = st + 2 * PX;
    int* s_own = reinterpret_cast<int*>(st + 3 * PX);
    float* s_attr = st + 4 * PX;                     // [NATTR][PX]
    const uint64_t desc0 = b_desc((uint32_t)__cvta_generic_to_shared(sb));

    const int t = blockIdx.x;
    const int gx = t % p.grid_w, gy = t / p.grid_w;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wg = threadIdx.x >> 7;
    const int g = lane >> 2, tq = lane & 3;

    for (int px = threadIdx.x; px < PX; px += THREADS) {
        s_acc[px] = 0.0f;
        if constexpr (STAGE == 2) {
            s_z[px] = BIG;
            s_o[px] = -BIG;
            s_own[px] = -1;
#pragma unroll
            for (int a = 0; a < NATTR; ++a) s_attr[a * PX + px] = 0.0f;
        }
    }

    const int start = p.tile_start[t], end = p.tile_start[t + 1];
    const int nchunks = end > start ? (end - start + chunk - 1) / chunk : 0;
    auto chunk_at = [&](int k) { return min(start + k * chunk, p.cap - chunk); };
    auto issue = [&](int k) {
        const float* src = p.entries + (size_t)chunk_at(k) * p.row_stride;
        float* dst = raw + (k & 1) * chunk * LS;
        for (int v = threadIdx.x; v < chunk * (LANES / 4); v += THREADS) {
            const int r = v / (LANES / 4), q = v - r * (LANES / 4);
            cp_async16(dst + r * LS + 4 * q, src + (size_t)r * p.row_stride
                                                 + 4 * q);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };

    float c0[NACC], c1[NACC];   // two products' accumulators
#pragma unroll
    for (int i = 0; i < NACC; ++i) c0[i] = c1[i] = 0.0f;
    float thresh = BIG;
    if (nchunks > 0) issue(0);
    for (int k = 0; k < nchunks; ++k) {
        const int s = chunk_at(k);
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();  // chunk k landed; chunk k - 1 fully consumed
        const float* L = raw + (k & 1) * chunk * LS;
        if (p.exit_cross && !(L[23] * 1e-30f <= thresh)) break;  // uniform
        if (k + 1 < nchunks) issue(k + 1);
        stage_chunk<MODE, NPLANES>(L, sb, mo, chunk);
        // the staged B is read by the tensor cores' (async) proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        float omin = 0.0f;
        if constexpr (STAGE == 1) {
            omin = mo[0].y;
            for (int e = 1; e < chunk; ++e) omin = fminf(omin, mo[e].y);
        }

        for (int mt = wg; mt < PX / MT; mt += THREADS / 128) {
            const int pa = mt * MT + 16 * (warp & 3) + g, pb = pa + 8;
            uint32_t a[4];   // (pa, k lo), (pb, k lo), (pa, k hi), (pb, k hi)
            a_row<MODE>((float)(gx * TILE_W + (pa & (TILE_W - 1))) + 0.5f,
                        (float)(gy * p.tile_h + pa / TILE_W) + 0.5f, tq,
                        a[0], a[2]);
            a_row<MODE>((float)(gx * TILE_W + (pb & (TILE_W - 1))) + 0.5f,
                        (float)(gy * p.tile_h + pb / TILE_W) + 0.5f, tq,
                        a[1], a[3]);
            Best<NATTR> ba, bb;   // stage 2: running winners; else .z the min
            best_init(ba);
            best_init(bb);
            // one product in flight while the epilogue of the one before
            // runs: a product's registers are read only while the other
            // set's product is in flight.  The last step issues the last
            // product again (its sums unread), so that every step issues
            // one.
            const int last = ngroups - 1;
            issue_product<MODE>(c0, a, desc0);
            for (int q = 0; q < ngroups; q += 2) {
                wait_products<0>();
                hold(c0);
                issue_product<MODE>(
                    c1, a, desc0 + min(q + 1, last) * DESC_STEP);
                take_product<MODE, NPLANES, STAGE, ATTR>(
                    c0, GROUP * q, chunk, s, mo, L, tq, ba, bb);
                wait_products<0>();
                hold(c1);
                issue_product<MODE>(
                    c0, a, desc0 + min(q + 2, last) * DESC_STEP);
                if (q + 1 < ngroups)
                    take_product<MODE, NPLANES, STAGE, ATTR>(
                        c1, GROUP * (q + 1), chunk, s, mo, L, tq, ba, bb);
            }
            wait_products<0>();
            hold(c0);
            // the four lanes of a row group hold the same two pixels
            if constexpr (STAGE == 2) {
                best_merge_lanes(ba);
                best_merge_lanes(bb);
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
                    const Best<NATTR>& b = h ? bb : ba;
                    const int px = h ? pb : pa;
                    if constexpr (STAGE == 0) {
                        s_acc[px] = s_acc[px] + b.z;
                    } else if constexpr (STAGE == 1) {
                        s_acc[px] = (s_acc[px] + b.z) + omin * 1e-9f;
                    } else {
                        const bool beats = b.z < s_z[px]
                            || (b.z == s_z[px] && b.o >= s_o[px]);
                        if (beats && b.z < BIG) {
                            s_z[px] = b.z;
                            s_o[px] = b.o;
                            s_own[px] = b.i;
#pragma unroll
                            for (int a = 0; a < NATTR; ++a)
                                s_attr[a * PX + px] = b.s[a];
                        }
                    }
                }
            }
        }
        if constexpr (STAGE == 2) {  // else the threshold stays
            if (p.exit_cross) {
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
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    float* out = p.out + (size_t)t * 8 * PX;
    for (int px = threadIdx.x; px < PX; px += THREADS) {
        const float xf = (float)(gx * TILE_W + (px & (TILE_W - 1))) + 0.5f;
        const float yf = (float)(gy * p.tile_h + px / TILE_W) + 0.5f;
        float a4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (STAGE == 2 && ATTR == 1) {
            for (int a = 0; a < 4; ++a) a4[a] = s_attr[a * PX + px];
        } else if constexpr (STAGE == 2 && ATTR == 2) {
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
        constexpr bool RED = STAGE == 2;
        out[0 * PX + px] = RED ? s_z[px] : BIG;
        out[1 * PX + px] = RED ? s_o[px] : -BIG;
        out[2 * PX + px] = RED ? (float)s_own[px] : -1.0f;
        for (int a = 0; a < 4; ++a) out[(3 + a) * PX + px] = a4[a];
        out[7 * PX + px] = s_acc[px];
    }
}

template <int MODE, int NPLANES, int STAGE, int ATTR>
cudaError_t launch(const Params& p, int grid, size_t smem, cudaStream_t st) {
    auto kern = mxu_kernel<MODE, NPLANES, STAGE, ATTR>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kern<<<grid, THREADS, smem, st>>>(p);
    return cudaGetLastError();
}

template <int MODE, int NPLANES>
cudaError_t launch_stage(const Params& p, int stage, int attr, int grid,
                         size_t smem, cudaStream_t st) {
    if (stage == 0) return launch<MODE, NPLANES, 0, 0>(p, grid, smem, st);
    if (stage == 1) return launch<MODE, NPLANES, 1, 0>(p, grid, smem, st);
    if (attr == 0) return launch<MODE, NPLANES, 2, 0>(p, grid, smem, st);
    if (attr == 2) return launch<MODE, NPLANES, 2, 2>(p, grid, smem, st);
    if constexpr (NPLANES >= 7)
        return launch<MODE, NPLANES, 2, 1>(p, grid, smem, st);
    return cudaErrorInvalidValue;
}

}  // namespace

// shared memory a block of the kernel needs (0: more than a block has)
extern "C" long long ty_probe_mxu_smem(int mode, int nplanes, int chunk,
                                       int tile_h, int stage, int attr) {
    const long long bytes =
        smem_layout(mode, nplanes, chunk, tile_h, stage, attr).total;
    return bytes <= 227 * 1024 ? bytes : 0;
}

extern "C" int ty_probe_mxu(const int* tile_start, const float* entries,
                            int cap, int row_stride, int chunk, int grid,
                            int grid_w, int tile_h, int mode, int nplanes,
                            int stage, int attr, int exit_cross, float* out,
                            void* stream) {
    const long long smem =
        ty_probe_mxu_smem(mode, nplanes, chunk, tile_h, stage, attr);
    if (smem == 0 || chunk <= 0 || chunk % 8 || cap < chunk || grid <= 0
        || tile_h < 1 || (tile_h & (tile_h - 1)) || row_stride % 4
        || row_stride < lanes_read(mode) || stage < 0 || stage > 2
        || attr < 0 || attr > 2 || (stage > 0 && nplanes < 4)
        || (stage == 2 && attr == 1 && nplanes < 7))
        return (int)cudaErrorInvalidValue;
    const Params p{tile_start, entries, cap, row_stride, chunk, grid_w, tile_h,
                   exit_cross, out};
    cudaStream_t st = (cudaStream_t)stream;
    if (mode == 0 && nplanes == 4)
        return (int)launch_stage<0, 4>(p, stage, attr, grid, smem, st);
    if (mode == 0 && nplanes == 7)
        return (int)launch_stage<0, 7>(p, stage, attr, grid, smem, st);
    if (mode == 1 && nplanes == 4)
        return (int)launch_stage<1, 4>(p, stage, attr, grid, smem, st);
    if (mode == 1 && nplanes == 7)
        return (int)launch_stage<1, 7>(p, stage, attr, grid, smem, st);
    if (mode == 2 && nplanes == 4)
        return (int)launch_stage<2, 4>(p, stage, attr, grid, smem, st);
    return (int)cudaErrorInvalidValue;
}
