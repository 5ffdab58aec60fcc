// Dual-softmax patch attention (the cost volume's cross attention alone).
//
// Replaces the Pallas TPU kernel
//   ssf_slam_tpu/ops/attention.py::attention_fused (_attention_pallas_2d)
//
// What it computes, per query point n with q = q_feat[n], k = k_feat[n]
// (each [K, C] in the feature type T, read as float32):
//   S[i][j]  = sum_c q[i][c] k[j][c]                          (float32)
//   W[i][j]  = softmax_i(S)[i][j] * softmax_j(S)[i][j]        (float32)
//              (s1 normalises over the q-row index i, s2 over j); W is
//              NOT rounded to T, unlike the fused cost attention's
//   q'[i][c] = rnd(q[i][c] + sum_j W[i][j] k[j][c])
//   k'[j][c] = rnd(k[j][c] + sum_i W[i][j] q[i][c])
// with the sums in float32 and rnd one rounding to T (identity for
// float32): the Pallas body's rounding points, not attention_xla's, which
// rounds each product sum to T before the add.
//
// Work per point: 3 K*K*C multiply-adds (S, q', k'), 2 K*K exps; bytes: the
// two [K, C] inputs read and the two outputs written once. At the
// [8192, 16, 64] bf16 shape that is 0.8 GFLOP against 67 MB: bytes bound
// it on the H100 (20 us at 3.35 TB/s against 12 us at the 67 TFLOP/s
// float32 CUDA-core peak, data-sheet rates).
//
// Design (simple and right first): one warp per query point, several per
// block. Each warp stages its point's q and k tiles into padded float32
// shared rows (coalesced over channels), lanes own entries of S and W and
// then channels of q' and k', so every output store is coalesced and no
// lane reads what another lane writes between the warp barriers.
#include "banded_common.cuh"

namespace {

struct Tiles {
  int k, c, warps;
  __host__ __device__ int ld() const { return c + 1; }
  __host__ __device__ int per_warp() const {
    return 2 * k * ld() + k * (k + 1) + 4 * k;
  }
  __host__ __device__ size_t bytes() const {
    return (size_t)warps * per_warp() * sizeof(float);
  }
};

template <typename T>
__global__ void attention_kernel(const T* __restrict__ q_feat,
                                 const T* __restrict__ k_feat, int rows,
                                 Tiles t, T* __restrict__ q_att,
                                 T* __restrict__ k_att) {
  extern __shared__ float smem[];
  const int K = t.k, C = t.c, LD = t.ld();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * t.warps + warp;
  if (n >= rows) return;
  float* q = smem + warp * t.per_warp();  // [K][C + 1]
  float* kk = q + K * LD;                 // [K][C + 1]
  float* S = kk + K * LD;                 // [K][K + 1], then W in place
  float* cmax = S + K * (K + 1);          // column (over i) max and sum
  float* csum = cmax + K;
  float* rmax = csum + K;                 // row (over j) max and sum
  float* rsum = rmax + K;

  const size_t base = (size_t)n * K * C;
  for (int e = lane; e < K * C; e += 32) {
    const int i = e / C, c = e - i * C;
    q[i * LD + c] = to_f32(q_feat[base + e]);
    kk[i * LD + c] = to_f32(k_feat[base + e]);
  }
  __syncwarp();

  for (int e = lane; e < K * K; e += 32) {
    const int i = e / K, j = e - i * K;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(q[i * LD + c], kk[j * LD + c], acc);
    S[i * (K + 1) + j] = acc;
  }
  __syncwarp();
  if (lane < K) {
    const int j = lane;
    float m = S[j];
    for (int i = 1; i < K; ++i) m = fmaxf(m, S[i * (K + 1) + j]);
    float sum = 0.0f;
    for (int i = 0; i < K; ++i) sum += expf(S[i * (K + 1) + j] - m);
    cmax[j] = m;
    csum[j] = sum;
    const int i = lane;
    float mr = S[i * (K + 1)];
    for (int jj = 1; jj < K; ++jj) mr = fmaxf(mr, S[i * (K + 1) + jj]);
    float sr = 0.0f;
    for (int jj = 0; jj < K; ++jj) sr += expf(S[i * (K + 1) + jj] - mr);
    rmax[i] = mr;
    rsum[i] = sr;
  }
  __syncwarp();
  for (int e = lane; e < K * K; e += 32) {
    const int i = e / K, j = e - i * K;
    const float v = S[i * (K + 1) + j];
    const float s1 = expf(v - cmax[j]) / csum[j];
    const float s2 = expf(v - rmax[i]) / rsum[i];
    S[i * (K + 1) + j] = s1 * s2;
  }
  __syncwarp();

  T* qo = q_att + base;
  T* ko = k_att + base;
  for (int c = lane; c < C; c += 32) {
    for (int i = 0; i < K; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < K; ++j)
        acc = fmaf(S[i * (K + 1) + j], kk[j * LD + c], acc);
      qo[(size_t)i * C + c] = from_f32<T>(q[i * LD + c] + acc);
    }
    for (int j = 0; j < K; ++j) {
      float acc = 0.0f;
      for (int i = 0; i < K; ++i)
        acc = fmaf(S[i * (K + 1) + j], q[i * LD + c], acc);
      ko[(size_t)j * C + c] = from_f32<T>(kk[j * LD + c] + acc);
    }
  }
}

template <typename T>
int launch(const void* q_feat, const void* k_feat, int rows, int K, int C,
           void* q_att, void* k_att, cudaStream_t stream) {
  Tiles t{K, C, 8};
  const size_t limit = 200 * 1024;
  while (t.warps > 1 && t.bytes() > limit) --t.warps;
  if (t.bytes() > limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)t.bytes());
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + t.warps - 1) / t.warps);
  attention_kernel<T><<<grid, 32 * t.warps, t.bytes(), stream>>>(
      (const T*)q_feat, (const T*)k_feat, rows, t, (T*)q_att, (T*)k_att);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_feat, k_feat [rows, K, C] (float32 or bf16, one type)
// -> q_att, k_att [rows, K, C] in that type. Returns a cudaError_t code.
int ssf_attention(const void* q_feat, const void* k_feat, int rows, int K,
                  int C, int feats_bf16, void* q_att, void* k_att,
                  void* stream) {
  if (K < 1 || K > 32 || C < 1 || C > 512) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (feats_bf16)
    return launch<__nv_bfloat16>(q_feat, k_feat, rows, K, C, q_att, k_att, s);
  return launch<float>(q_feat, k_feat, rows, K, C, q_att, k_att, s);
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
