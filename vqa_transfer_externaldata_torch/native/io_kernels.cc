// Host-side IO library of the port's input pipeline: multi-threaded row
// gathers over memory-mapped feature stores (``data/features.py``'s raw
// directories), with an optional fused f16 -> f32 widen, so a [B, N, C]
// batch is materialized from the deduplicated on-disk store in parallel
// threads with the GIL released.
//
// Plain C ABI (``vqa_io_abi_version`` 1) loaded with ctypes by
// ``vqa_transfer_externaldata_torch/data/native.py``, which builds it with
// g++ at first use. Host code: no device work here.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// f16 (IEEE half) -> f32, scalar decode; auto-vectorizes under -O3.
inline float half_to_float(uint16_t h) {
  uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: normalize
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((127 - 15 - shift + 1) << 23) | (mant << 13);
    }
  } else if (exp == 0x1Fu) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

template <typename Fn>
void parallel_rows(int64_t n, int threads, Fn fn) {
  if (threads <= 1 || n < 4) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Gather `n` rows of `row_elems` f16 values from `base` at `idx` into `out`
// (still f16). Rows are copied in parallel.
void gather_rows_f16(const uint16_t* base, int64_t row_elems,
                     const int32_t* idx, int64_t n, uint16_t* out,
                     int threads) {
  parallel_rows(n, threads, [&](int64_t i) {
    std::memcpy(out + i * row_elems, base + idx[i] * row_elems,
                sizeof(uint16_t) * row_elems);
  });
}

// Fused gather + f16 -> f32 widen.
void gather_rows_f16_to_f32(const uint16_t* base, int64_t row_elems,
                            const int32_t* idx, int64_t n, float* out,
                            int threads) {
  parallel_rows(n, threads, [&](int64_t i) {
    const uint16_t* src = base + idx[i] * row_elems;
    float* dst = out + i * row_elems;
    for (int64_t j = 0; j < row_elems; ++j) dst[j] = half_to_float(src[j]);
  });
}

// Gather f32 rows (pool5 vectors).
void gather_rows_f32(const float* base, int64_t row_elems,
                     const int32_t* idx, int64_t n, float* out,
                     int threads) {
  parallel_rows(n, threads, [&](int64_t i) {
    std::memcpy(out + i * row_elems, base + idx[i] * row_elems,
                sizeof(float) * row_elems);
  });
}

int vqa_io_abi_version() { return 1; }

}  // extern "C"
