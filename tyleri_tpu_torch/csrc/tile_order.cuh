// The tiles of a launch in descending order of segment length, so that the
// longest tiles start first and do not run alone at the end of the launch.
// Launched just before the kernel that reads the order, in the same C call,
// by K3 (visibility.cu) and the P3 probe (probes_visibility.cu).
//
// A counting sort on segment lengths in buckets of 2^shift rows, the last
// bucket open; ties in any order.  One CTA of ORDER_THREADS threads.  Each
// source that includes this header compiles its own copy (an unnamed
// namespace: the objects link into one library).

#pragma once

#include <cuda_runtime.h>

namespace tile_order {
namespace {

constexpr int ORDER_THREADS = 1024;
constexpr int ORDER_BUCKETS = 512;

__global__ void __launch_bounds__(ORDER_THREADS)
tile_order_kernel(const int* tile_start, int ntiles, int shift, int* order) {
    __shared__ int count[ORDER_BUCKETS];
    auto bucket = [&](int t) {
        return min((tile_start[t + 1] - tile_start[t]) >> shift,
                   ORDER_BUCKETS - 1);
    };
    for (int b = threadIdx.x; b < ORDER_BUCKETS; b += blockDim.x) count[b] = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
        atomicAdd(&count[bucket(t)], 1);
    __syncthreads();
    if (threadIdx.x < 32) {
        // each bucket's first slot: the tiles of every longer bucket; lane l
        // scans 16 buckets from the top, then the lanes' sums are scanned
        constexpr int PER = ORDER_BUCKETS / 32;
        const int lane = threadIdx.x;
        int sum = 0;
        for (int i = 0; i < PER; ++i)
            sum += count[ORDER_BUCKETS - 1 - (lane * PER + i)];
        int incl = sum;
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
        }
        int run = incl - sum;
        for (int i = 0; i < PER; ++i) {
            const int b = ORDER_BUCKETS - 1 - (lane * PER + i);
            const int c = count[b];
            count[b] = run;
            run += c;
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
        order[atomicAdd(&count[bucket(t)], 1)] = t;
}

// Launches the sort of `ntiles` tiles into order[ntiles] on `st`.
cudaError_t launch(const int* tile_start, int ntiles, int shift, int* order,
                   cudaStream_t st) {
    tile_order_kernel<<<1, ORDER_THREADS, 0, st>>>(tile_start, ntiles, shift,
                                                   order);
    return cudaGetLastError();
}

}  // namespace
}  // namespace tile_order
