// Kernel A: row gather between tile grids, for Hopper (sm_90a).
//
//   out[b, i, :] = ok[b, i] ? src[b, idx[b, i], :] : 0
//
// Replaces the TPU kernel uresnet_pytorch_tpu/ops/pallas/windowed_gather.py
// gather_forward (_kernel): there, rows move as block one-hot MXU matmuls
// against DMA'd source windows, plus an exact correction list for the rows
// outside the windows, because a TPU has no cheap indexed row load. Hopper
// has one, so this kernel reads each source row directly: no windows, no
// correction list, exact for any index pattern.
//
// What bounds it on an H100: HBM bandwidth (it moves bytes and computes
// nothing; rows are 2 B to a few hundred B). Design: one warp per output
// row, lanes striding over the row in the widest vector (16 B when the row
// and both base addresses allow it) so each warp issues coalesced loads
// and stores; the row's ok/idx are read once per lane from L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps, 8 output rows per block

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ src, const int* __restrict__ idx,
                   const uint8_t* __restrict__ ok, V* __restrict__ out,
                   long long rows, int N, int S, int nvec) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  V* o = out + r * nvec;
  const int s = idx[r];
  if (ok[r] && s >= 0 && s < S) {
    const V* in = src + ((r / N) * S + s) * (long long)nvec;
    for (int i = lane; i < nvec; i += 32) o[i] = in[i];
  } else {
    const V zero{};
    for (int i = lane; i < nvec; i += 32) o[i] = zero;
  }
}

template <typename V>
int launch(const void* src, const void* idx, const void* ok, void* out, int B,
           int N, int S, long long row_bytes, cudaStream_t stream) {
  const long long rows = (long long)B * N;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  gather_rows_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const V*)src, (const int*)idx, (const uint8_t*)ok, (V*)out, rows, N, S,
      (int)(row_bytes / sizeof(V)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vec_bytes must divide row_bytes and both base addresses: 16, 8, 4, 2 or 1.
// Returns a cudaError_t (0 = launched).
int gather_rows(const void* src, const void* idx, const void* ok, void* out,
                int B, int N, int S, long long row_bytes, int vec_bytes,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16: return launch<uint4>(src, idx, ok, out, B, N, S, row_bytes, st);
    case 8: return launch<uint2>(src, idx, ok, out, B, N, S, row_bytes, st);
    case 4: return launch<uint32_t>(src, idx, ok, out, B, N, S, row_bytes, st);
    case 2: return launch<uint16_t>(src, idx, ok, out, B, N, S, row_bytes, st);
    case 1: return launch<uint8_t>(src, idx, ok, out, B, N, S, row_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
