// tyleri_tpu_torch native host runtime: the port's copy of
// tyleri_tpu/native/host_runtime.cpp.
//
// C++ implementations of the host-side components that are native in the
// reference's stack (the tyleri-gpu-utils crate, see SURVEY §2 row E2):
//
//  * BlockBasedAllocator — first-fit free-list suballocator with batch
//    (par_allocate) reservation, mirroring
//    the reference's usage at src/resource/mod.rs:152-153 and the python
//    fallback in tyleri_tpu_torch/resource/arenas.py (same observable
//    behavior, asserted equal by tests/test_torch_vendored.py)
//  * PNG encode — the presentation-engine hot path for headless present
//    (zlib-backed, much faster than the pure-python encoder)
//  * FramePacer — FIFO/vsync presentation clock
//    (ref: swapchain.rs:46-51 mandates FIFO; the pacer sleeps until the
//    next refresh slot)
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- allocator

struct Block {
  uint64_t offset;
  uint64_t size;
};

struct TyAllocator {
  std::vector<Block> free_list;  // sorted by offset, adjacent-merged
  uint64_t capacity;
  std::mutex mu;
};

static void merge_locked(TyAllocator* a) {
  auto& fl = a->free_list;
  fl.erase(std::remove_if(fl.begin(), fl.end(),
                          [](const Block& b) { return b.size == 0; }),
           fl.end());
  std::sort(fl.begin(), fl.end(),
            [](const Block& x, const Block& y) { return x.offset < y.offset; });
  std::vector<Block> merged;
  for (const Block& b : fl) {
    if (!merged.empty() &&
        merged.back().offset + merged.back().size == b.offset) {
      merged.back().size += b.size;
    } else {
      merged.push_back(b);
    }
  }
  fl = std::move(merged);
}

TyAllocator* ty_allocator_create(uint64_t capacity) {
  auto* a = new TyAllocator();
  a->capacity = capacity;
  a->free_list.push_back({0, capacity});
  return a;
}

void ty_allocator_destroy(TyAllocator* a) { delete a; }

// returns offset, or UINT64_MAX when exhausted
uint64_t ty_allocator_allocate(TyAllocator* a, uint64_t size) {
  if (size == 0) return UINT64_MAX;
  std::lock_guard<std::mutex> lock(a->mu);
  for (size_t i = 0; i < a->free_list.size(); ++i) {
    Block& b = a->free_list[i];
    if (b.size >= size) {
      uint64_t off = b.offset;
      if (b.size == size) {
        a->free_list.erase(a->free_list.begin() + i);
      } else {
        b.offset += size;
        b.size -= size;
      }
      return off;
    }
  }
  return UINT64_MAX;
}

// batch allocation: one contiguous reservation carved into n slices
// (the par_allocate pattern, ref: src/resource/mod.rs:152-153).
// Returns 0 on success and fills offsets[n]; 1 on exhaustion.
int ty_allocator_par_allocate(TyAllocator* a, const uint64_t* sizes,
                              uint64_t n, uint64_t total_hint,
                              uint64_t* offsets) {
  uint64_t total = 0;
  for (uint64_t i = 0; i < n; ++i) total += sizes[i];
  uint64_t reserve = std::max(total, total_hint);
  uint64_t base = ty_allocator_allocate(a, reserve);
  if (base == UINT64_MAX) return 1;
  uint64_t off = base;
  for (uint64_t i = 0; i < n; ++i) {
    offsets[i] = off;
    off += sizes[i];
  }
  if (off < base + reserve) {
    std::lock_guard<std::mutex> lock(a->mu);
    a->free_list.push_back({off, base + reserve - off});
    merge_locked(a);
  }
  return 0;
}

void ty_allocator_free(TyAllocator* a, uint64_t offset, uint64_t size) {
  std::lock_guard<std::mutex> lock(a->mu);
  a->free_list.push_back({offset, size});
  merge_locked(a);
}

void ty_allocator_grow(TyAllocator* a, uint64_t new_capacity) {
  std::lock_guard<std::mutex> lock(a->mu);
  if (new_capacity <= a->capacity) return;
  a->free_list.push_back({a->capacity, new_capacity - a->capacity});
  a->capacity = new_capacity;
  merge_locked(a);
}

uint64_t ty_allocator_capacity(TyAllocator* a) { return a->capacity; }

// largest free block (diagnostics / fragmentation metric)
uint64_t ty_allocator_largest_free(TyAllocator* a) {
  std::lock_guard<std::mutex> lock(a->mu);
  uint64_t best = 0;
  for (const Block& b : a->free_list) best = std::max(best, b.size);
  return best;
}

// ---------------------------------------------------------------- png

static void put_be32(std::vector<unsigned char>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

static void put_chunk(std::vector<unsigned char>& out, const char tag[4],
                      const unsigned char* data, uint32_t len) {
  put_be32(out, len);
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, 4 + len);
  put_be32(out, crc);
}

// Encode rgba u8 [h, w, 4] to PNG. Returns number of bytes written to `out`
// (caller provides out_cap bytes; returns 0 if too small or on error).
uint64_t ty_png_encode(const unsigned char* rgba, uint32_t width,
                       uint32_t height, unsigned char* out,
                       uint64_t out_cap) {
  const uint32_t stride = width * 4;
  std::vector<unsigned char> raw;
  raw.reserve((stride + 1) * height);
  for (uint32_t y = 0; y < height; ++y) {
    raw.push_back(0);  // filter: none
    raw.insert(raw.end(), rgba + (size_t)y * stride,
               rgba + (size_t)y * stride + stride);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<unsigned char> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return 0;

  std::vector<unsigned char> png;
  static const unsigned char magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                         0x1a, '\n'};
  png.insert(png.end(), magic, magic + 8);
  unsigned char ihdr[13];
  ihdr[0] = (width >> 24) & 0xff;
  ihdr[1] = (width >> 16) & 0xff;
  ihdr[2] = (width >> 8) & 0xff;
  ihdr[3] = width & 0xff;
  ihdr[4] = (height >> 24) & 0xff;
  ihdr[5] = (height >> 16) & 0xff;
  ihdr[6] = (height >> 8) & 0xff;
  ihdr[7] = height & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 6;   // color type RGBA
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", comp.data(), (uint32_t)comp_cap);
  put_chunk(png, "IEND", nullptr, 0);

  if (png.size() > out_cap) return 0;
  std::memcpy(out, png.data(), png.size());
  return png.size();
}

// ---------------------------------------------------------------- pacer

struct TyFramePacer {
  double interval_s;
  std::chrono::steady_clock::time_point next;
};

TyFramePacer* ty_pacer_create(double refresh_hz) {
  auto* p = new TyFramePacer();
  p->interval_s = refresh_hz > 0 ? 1.0 / refresh_hz : 0.0;
  p->next = std::chrono::steady_clock::now();
  return p;
}

void ty_pacer_destroy(TyFramePacer* p) { delete p; }

// Block until the next vsync slot (FIFO present). Returns the number of
// whole refresh intervals missed (0 = on time).
uint32_t ty_pacer_wait(TyFramePacer* p) {
  using namespace std::chrono;
  if (p->interval_s <= 0) return 0;
  auto now = steady_clock::now();
  auto interval = duration_cast<steady_clock::duration>(
      duration<double>(p->interval_s));
  uint32_t missed = 0;
  while (p->next + interval < now) {
    p->next += interval;
    ++missed;
  }
  p->next += interval;
  if (p->next > now) std::this_thread::sleep_until(p->next);
  return missed;
}

}  // extern "C"
