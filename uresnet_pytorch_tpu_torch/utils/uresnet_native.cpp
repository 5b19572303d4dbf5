// Native host-side data backend for uresnet_pytorch_tpu_torch: a copy of
// the reference's csrc/uresnet_native.cpp.
//
// Plays the role the reference delegates to native code on the host side
// (LArCV2's C++ event decoding + SparseConvNet's C++ input preprocessing,
// SURVEY.md §2.15, §2.11 IO rules): turning raw event arrays into the
// fixed-capacity padded device blobs, and voxel-key encoding/dedup, at
// memcpy speed — keeping the single-core host from starving the TPU
// (SURVEY.md §7 hard part 6).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Built on demand by uresnet_pytorch_tpu_torch/utils/native.py; collate
// has a NumPy path with identical results (iotools/io_base.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Pack integer voxel coords into sortable int64 keys (batch-free, matches
// ops/coords.py semantics; INT64 max = invalid).
void upt_encode_keys(int64_t n, int32_t dim, int32_t bits,
                     const int32_t* coords, int64_t* out_keys) {
  const int64_t kSentinel = INT64_MAX;
  const int32_t size = 1 << bits;
  for (int64_t i = 0; i < n; ++i) {
    int64_t key = 0;
    bool ok = true;
    for (int32_t d = 0; d < dim; ++d) {
      int32_t c = coords[i * dim + d];
      if (c < 0 || c >= size) { ok = false; break; }
      key = (key << bits) | c;
    }
    out_keys[i] = ok ? key : kSentinel;
  }
}

// Collate concatenated (CSR) event arrays into padded blob buffers.
//
//   coords   (total, dim) i32     values (total,) f32
//   labels   (total,) f32 or null weights (total,) f32 or null
//   splits   (batch+1,) i64       event e = [splits[e], splits[e+1])
// Outputs are zero-filled fixed-capacity buffers:
//   out_coords (B, V, dim) i32, out_values (B, V) f32,
//   out_label (B, V) i32, out_weight (B, V) f32, out_n (B,) i32.
// Returns the number of truncated events (rows beyond capacity dropped).
int32_t upt_collate(int32_t batch, int64_t capacity, int32_t dim,
                    const int32_t* coords, const float* values,
                    const float* labels, const float* weights,
                    const int64_t* splits,
                    int32_t* out_coords, float* out_values,
                    int32_t* out_label, float* out_weight,
                    int32_t* out_n) {
  std::memset(out_coords, 0, sizeof(int32_t) * batch * capacity * dim);
  std::memset(out_values, 0, sizeof(float) * batch * capacity);
  if (labels) std::memset(out_label, 0, sizeof(int32_t) * batch * capacity);
  if (weights) std::memset(out_weight, 0, sizeof(float) * batch * capacity);
  int32_t truncated = 0;
  for (int32_t b = 0; b < batch; ++b) {
    const int64_t s = splits[b];
    int64_t n = splits[b + 1] - s;
    if (n > capacity) { n = capacity; ++truncated; }
    std::memcpy(out_coords + b * capacity * dim, coords + s * dim,
                sizeof(int32_t) * n * dim);
    std::memcpy(out_values + b * capacity, values + s, sizeof(float) * n);
    if (labels) {
      for (int64_t i = 0; i < n; ++i)
        out_label[b * capacity + i] = static_cast<int32_t>(labels[s + i]);
    }
    if (weights) {
      std::memcpy(out_weight + b * capacity, weights + s, sizeof(float) * n);
    }
    out_n[b] = static_cast<int32_t>(n);
  }
  return truncated;
}

// Sort + dedupe voxels on the host (used by file converters and the loader
// when an input format may contain duplicate coordinates; device-side dedup
// in ops/sparse_graph.py stays authoritative for training).
// merge_mode: 0=sum, 1=mean, 2=max, 3=last. Returns unique count.
int64_t upt_dedup(int64_t n, int32_t dim, int32_t bits, int32_t merge_mode,
                  const int32_t* coords, const float* values,
                  int32_t* out_coords, float* out_values) {
  std::vector<int64_t> keys(n);
  upt_encode_keys(n, dim, bits, coords, keys.data());
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return keys[a] < keys[b]; });
  int64_t m = -1;
  int64_t count = 0;
  int64_t prev = INT64_MIN;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t i = order[j];
    if (keys[i] == INT64_MAX) break;  // invalid rows sort last
    const float v = values[i];
    if (keys[i] != prev) {
      prev = keys[i];
      ++m;
      count = 0;
      std::memcpy(out_coords + m * dim, coords + i * dim,
                  sizeof(int32_t) * dim);
      out_values[m] = v;
      count = 1;
    } else {
      switch (merge_mode) {
        case 0: out_values[m] += v; break;
        case 1: out_values[m] = (out_values[m] * count + v) / (count + 1);
                ++count; break;
        case 2: out_values[m] = std::max(out_values[m], v); break;
        case 3: out_values[m] = v; break;
      }
    }
  }
  return m + 1;
}

}  // extern "C"
