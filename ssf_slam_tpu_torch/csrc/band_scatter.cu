// Banded regroup, banded scatter-add and banded scatter softmax-sum.
//
// Replaces the Pallas TPU kernels
//   ssf_slam_tpu/ops/banded.py::banded_regroup (_regroup_kernel_body)
//   ssf_slam_tpu/ops/banded.py::banded_scatter_add
//       (_scatter_add_kernel_body with with_softmax_aug=False)
//   ssf_slam_tpu/ops/banded.py::banded_scatter_softmax_sum
//       (_scatter_add_kernel_body with with_softmax_aug=True)
//
// What they compute, for row (n, j) of idx [B, N, k] whose query tile
// t = n / 256 owns the band [base, base + wb), base = b0[t] * wblk:
//   regroup: out[n, j, :] = feats[idx[n, j], :] when idx lies in the band,
//            else zeros (the TPU kernel's one-hot has no matching column)
//   scatter-add: out[idx[n, j], :] += f32(v[n, j, :]) for in-band rows: the
//            segment sum of every grouping VJP. A bf16 value is exact in
//            float32, as the TPU kernel's bf16 one-hot products are
//            (banded.py:693-696); the sum is float32. The caller zero-fills
//            out [B, n_out, C] float32
//   scatter: out[idx[n, j], :C] += rnd(v[n, j, :] * e), out[idx, C] += rnd(e)
//            with e = exp(w_shift[n, j]) and rnd the bf16 round trip when
//            the values are bf16 (the TPU kernel rounds its matmul operands
//            to bf16, banded.py:656) and the identity for float32; rows out
//            of the band add nothing. The caller zero-fills out [B, n_out,
//            C + 1] float32 and divides by the last column.
//
// What bounds them on the H100: all three are pure data movement. At the main
// path's level 0 (N = 8192, k = 16, C = 64, bf16) regroup writes 16.8 MB;
// scatter reads 16.8 MB of values and issues 8.5 M float32 atomic adds into
// a 2.1 MB output that stays in L2. Bytes bound regroup; the scatter (and
// the scatter-add, the same without the exp) is bound by L2 atomic
// throughput, which neither the device-memory nor the FLOP bound counts.
//
// Design: one warp per (n, j) row, lanes over channels, so reads, writes and
// atomics are coalesced along C. The TPU kernels keep the output resident
// in VMEM and scatter with transposed one-hot MXU matmuls, a layout trick
// for a machine without atomics; here the scatter is float32 atomics into
// device memory (L2-resident at these sizes). Atomic order varies from run
// to run, so the scatter's sums match a sequential sum only to rounding.
#include "banded_common.cuh"

template <typename T>
__global__ void regroup_kernel(const int* __restrict__ idx,
                               const T* __restrict__ feats,
                               const int* __restrict__ b0, int B, int N, int M,
                               int C, int k, int wblk, int n_blocks,
                               T* __restrict__ out) {
  const size_t row =
      (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)B * N * k) return;
  const int b = (int)(row / ((size_t)N * k));
  const int n = (int)((row / k) % N);
  const int base = band_base(b0, b, n, N / QUERY_TILE, wblk);
  const int i = idx[row];
  const bool in_band = i >= base && i < base + wblk * n_blocks;
  T* dst = out + row * C;
  if (in_band) {
    const T* src = feats + ((size_t)b * M + i) * C;
    for (int c = lane; c < C; c += 32) dst[c] = src[c];
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = from_f32<T>(0.0f);
  }
}

template <typename T>
__global__ void scatter_softmax_sum_kernel(
    const int* __restrict__ idx, const T* __restrict__ vals,
    const float* __restrict__ w_shift, const int* __restrict__ b0, int B,
    int N, int C, int k, int n_out, int wblk, int n_blocks,
    float* __restrict__ out) {
  const size_t row =
      (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)B * N * k) return;
  const int b = (int)(row / ((size_t)N * k));
  const int n = (int)((row / k) % N);
  const int base = band_base(b0, b, n, N / QUERY_TILE, wblk);
  const int i = idx[row];
  if (i < base || i >= base + wblk * n_blocks) return;
  const float e = expf(w_shift[row]);
  const T* v = vals + row * C;
  float* o = out + ((size_t)b * n_out + i) * (C + 1);
  for (int c = lane; c < C; c += 32)
    atomicAdd(o + c, round_to<T>(__fmul_rn(to_f32(v[c]), e)));
  if (lane == 0) atomicAdd(o + C, round_to<T>(e));
}

template <typename T>
__global__ void scatter_add_kernel(const int* __restrict__ idx,
                                   const T* __restrict__ vals,
                                   const int* __restrict__ b0, int B, int N,
                                   int C, int k, int n_out, int wblk,
                                   int n_blocks, float* __restrict__ out) {
  const size_t row =
      (size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)B * N * k) return;
  const int b = (int)(row / ((size_t)N * k));
  const int n = (int)((row / k) % N);
  const int base = band_base(b0, b, n, N / QUERY_TILE, wblk);
  const int i = idx[row];
  if (i < base || i >= base + wblk * n_blocks || i >= n_out) return;
  const T* v = vals + row * C;
  float* o = out + ((size_t)b * n_out + i) * C;
  for (int c = lane; c < C; c += 32) atomicAdd(o + c, to_f32(v[c]));
}

static const int kRowsPerBlock = 8;  // 8 warps of 32 lanes

extern "C" {

// idx [B, N, k] i32, feats [B, M, C], b0 [B, N / 256] i32
// -> out [B, N, k, C] in the feats type. Returns a cudaError_t code.
int ssf_regroup(const void* idx, const void* feats, const void* b0, int B,
                int N, int M, int C, int k, int wblk, int n_blocks,
                int feats_bf16, void* out, void* stream) {
  if (N % QUERY_TILE != 0) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * N * k;
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (feats_bf16)
    regroup_kernel<__nv_bfloat16><<<grid, 32 * kRowsPerBlock, 0, s>>>(
        (const int*)idx, (const __nv_bfloat16*)feats, (const int*)b0, B, N, M,
        C, k, wblk, n_blocks, (__nv_bfloat16*)out);
  else
    regroup_kernel<float><<<grid, 32 * kRowsPerBlock, 0, s>>>(
        (const int*)idx, (const float*)feats, (const int*)b0, B, N, M, C, k,
        wblk, n_blocks, (float*)out);
  return (int)cudaGetLastError();
}

// idx [B, N, k] i32, vals [B, N, k, C] (f32 or bf16), b0 [B, N / 256] i32;
// out [B, n_out, C] f32, zero-filled by the caller
int ssf_scatter_add(const void* idx, const void* vals, const void* b0, int B,
                    int N, int C, int k, int n_out, int wblk, int n_blocks,
                    int vals_bf16, void* out, void* stream) {
  if (N % QUERY_TILE != 0) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * N * k;
  if (rows == 0) return 0;
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (vals_bf16)
    scatter_add_kernel<__nv_bfloat16><<<grid, 32 * kRowsPerBlock, 0, s>>>(
        (const int*)idx, (const __nv_bfloat16*)vals, (const int*)b0, B, N, C,
        k, n_out, wblk, n_blocks, (float*)out);
  else
    scatter_add_kernel<float><<<grid, 32 * kRowsPerBlock, 0, s>>>(
        (const int*)idx, (const float*)vals, (const int*)b0, B, N, C, k,
        n_out, wblk, n_blocks, (float*)out);
  return (int)cudaGetLastError();
}

// idx [B, N, k] i32, vals [B, N, k, C], w_shift [B, N, k] f32,
// b0 [B, N / 256] i32; out [B, n_out, C + 1] f32, zero-filled by the caller
int ssf_scatter_softmax_sum(const void* idx, const void* vals,
                            const void* w_shift, const void* b0, int B, int N,
                            int C, int k, int n_out, int wblk, int n_blocks,
                            int vals_bf16, void* out, void* stream) {
  if (N % QUERY_TILE != 0) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * N * k;
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (vals_bf16)
    scatter_softmax_sum_kernel<__nv_bfloat16>
        <<<grid, 32 * kRowsPerBlock, 0, s>>>(
            (const int*)idx, (const __nv_bfloat16*)vals,
            (const float*)w_shift, (const int*)b0, B, N, C, k, n_out, wblk,
            n_blocks, (float*)out);
  else
    scatter_softmax_sum_kernel<float><<<grid, 32 * kRowsPerBlock, 0, s>>>(
        (const int*)idx, (const float*)vals, (const float*)w_shift,
        (const int*)b0, B, N, C, k, n_out, wblk, n_blocks, (float*)out);
  return (int)cudaGetLastError();
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
