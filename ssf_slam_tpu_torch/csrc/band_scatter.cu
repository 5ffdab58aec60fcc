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
// a 2.1 MB output that stays in L2. Bytes bound regroup; the scatter is
// bound by L2 atomic throughput, which neither the device-memory nor the
// FLOP bound counts. The scatter-add (the same without the exp) sums in
// shared memory first, below, and adds about five times fewer floats into
// device memory.
//
// Design: regroup and scatter run one warp per (n, j) row, lanes over
// channels, so reads, writes and atomics are coalesced along C. The TPU
// kernels keep the output resident in VMEM and scatter with transposed
// one-hot MXU matmuls, a layout trick for a machine without atomics; here
// the scatter is float32 atomics into device memory (L2-resident at these
// sizes). Atomic order varies from run to run, so the scatter's sums match a
// sequential sum only to rounding.
//
// The scatter-add keeps the TPU kernel's resident output in a smaller form:
// a block takes one query tile t (or a part of its 256 queries) and one
// slice of at most 32 channels, and sums the tile's in-band rows into its
// band [base, base + wblk * n_blocks) held in shared memory (float32
// shared-memory atomics, one channel a lane). A warp reads 32 indices at
// once, ballots the in-band ones and loads up to 8 value rows before it adds
// them, so that the loads are in flight together; the value rows are read
// once, in order, the slices of one row by neighbouring blocks. The block
// then adds the band's nonzero sums into device memory with float32 atomics:
// one atomic for each (band row the tile reaches, channel) in place of one
// for each (n, j, channel), about five times fewer at the main path's
// shapes. The caller still zero-fills out.
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

// Scatter-add block geometry: kScatterWarps warps, one channel a lane, and a
// band accumulator of at most kScatterSmem bytes, so two blocks fit an SM.
static const int kScatterWarps = 16;
static const int kScatterSmem = 768 * 32 * 4;
static const int kScatterBatch = 8;  // value rows loaded before they are added

// Grid (slices * parts * tiles, B): blockIdx.x = (t * parts + p) * slices + s.
// Block (t, p, s) of batch row b sums rows [p * 256 / parts, (p + 1) * 256 /
// parts) of query tile t, channels [s * W, min(s * W + W, C)), into its
// band held in shared memory, then adds the band into out.
template <typename T>
__global__ void __launch_bounds__(32 * kScatterWarps, 2)
    scatter_add_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                       const int* __restrict__ b0, int N, int C, int k,
                       int n_out, int wblk, int n_blocks, int W, int parts,
                       float* __restrict__ out) {
  extern __shared__ float acc[];  // [wblk * n_blocks][W]
  const int slices = (C + W - 1) / W;
  const int s = blockIdx.x % slices;
  const int p = (blockIdx.x / slices) % parts;
  const int t = blockIdx.x / (slices * parts);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = s * W;
  const int w = min(W, C - c0);
  const int base = band_base(b0, b, t * QUERY_TILE, N / QUERY_TILE, wblk);
  const int rows = min(wblk * n_blocks, n_out - base);  // band rows kept
  if (rows <= 0) return;
  for (int x = threadIdx.x; x < rows * W; x += blockDim.x) acc[x] = 0.0f;
  __syncthreads();

  const int per = QUERY_TILE / parts * k;  // entries of this block
  const size_t e0 = ((size_t)b * N + t * QUERY_TILE) * k + (size_t)p * per;
  const T* v = vals + e0 * C + c0 + lane;
  for (int e = warp * 32; e < per; e += 32 * kScatterWarps) {
    int r = -1;
    if (e + lane < per) {
      const int i = idx[e0 + e + lane];
      if (i >= base && i - base < rows) r = i - base;
    }
    unsigned hits = __ballot_sync(0xffffffffu, r >= 0);
    while (hits) {  // warp-uniform: up to kScatterBatch hits, loads first
      int src[kScatterBatch], dst[kScatterBatch];
      float got[kScatterBatch];
#pragma unroll
      for (int u = 0; u < kScatterBatch; ++u) {
        src[u] = hits ? __ffs(hits) - 1 : -1;
        hits &= hits - 1;
      }
#pragma unroll
      for (int u = 0; u < kScatterBatch; ++u)
        dst[u] = __shfl_sync(0xffffffffu, r, src[u] < 0 ? 0 : src[u]);
#pragma unroll
      for (int u = 0; u < kScatterBatch; ++u)
        got[u] = src[u] >= 0 && lane < w
                     ? to_f32(v[(size_t)(e + src[u]) * C])
                     : 0.0f;
#pragma unroll
      for (int u = 0; u < kScatterBatch; ++u)
        if (src[u] >= 0 && lane < w)
          atomicAdd(acc + dst[u] * W + lane, got[u]);
    }
  }
  __syncthreads();

  float* o = out + ((size_t)b * n_out + base) * C + c0;
  for (int x = threadIdx.x; x < rows * W; x += blockDim.x) {
    const int r = x / W, c = x - r * W;
    const float a = acc[x];
    if (c < w && a != 0.0f) atomicAdd(o + (size_t)r * C + c, a);
  }
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
  if ((size_t)B * N * k * C == 0 || n_out <= 0) return 0;
  // channel slices: as few as one channel a lane allows, fewer channels a
  // slice only where the band would not fit the accumulator
  const int band = wblk * n_blocks;
  const int max_w = min(32, kScatterSmem / (band * 4));
  if (max_w < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  int slices = (C + max_w - 1) / max_w;
  const int W = (C + slices - 1) / slices;
  slices = (C + W - 1) / W;
  // split each query tile into parts until the grid has a block an SM
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = N / QUERY_TILE;
  int parts = 1;
  while (parts < 8 && (size_t)tiles * parts * slices * B < (size_t)sms)
    parts *= 2;
  const size_t smem = (size_t)band * W * sizeof(float);
  const dim3 grid((unsigned)(tiles * parts * slices), (unsigned)B);
  const int threads = 32 * kScatterWarps;
  cudaStream_t s = (cudaStream_t)stream;
  // the attribute is set on every call: it belongs to the current device
  if (vals_bf16) {
    err = cudaFuncSetAttribute(scatter_add_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    scatter_add_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        (const int*)idx, (const __nv_bfloat16*)vals, (const int*)b0, N, C, k,
        n_out, wblk, n_blocks, W, parts, (float*)out);
  } else {
    err = cudaFuncSetAttribute(scatter_add_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    scatter_add_kernel<float><<<grid, threads, smem, s>>>(
        (const int*)idx, (const float*)vals, (const int*)b0, N, C, k, n_out,
        wblk, n_blocks, W, parts, (float*)out);
  }
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
