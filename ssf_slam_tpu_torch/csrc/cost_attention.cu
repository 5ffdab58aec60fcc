// Fused cost-volume attention chain: dual-softmax patch attention, the
// BN-folded 3-layer weightnet on both attended patches, and the
// softmax-over-K forward aggregation.
//
// Replaces the Pallas TPU kernel
//   ssf_slam_tpu/ops/attention.py::cost_attention_fused (_cost_attention_2d)
//
// What it computes, per query point n with q = q_feat[n], k = k_feat[n],
// qc = q_cost[n] (each [K, C] in the feature type T) and the folded
// weightnet W1 [C, C], b1, W2 [C, C2], b2, W3 [C2], b3 (float32, the
// weights rounded to T on staging as the Pallas body casts them):
//   S[i][j]  = sum_c q[i][c] k[j][c]                       (float32)
//   W[i][j]  = rnd(softmax_i(S)[i][j] * softmax_j(S)[i][j])
//              (s1 normalises over the q-row index i, s2 over j)
//   q'[i][c] = rnd(q[i][c] + sum_j W[i][j] k[j][c])
//   k'[j][c] = rnd(k[j][c] + sum_i W[i][j] q[i][c])
//   wn(x)    = relu(rnd(relu(x W1 + b1)) W2 + b2) rounded, . W3 + b3
//   w_k[n][j]   = wn(k'[j])                              (float32 out)
//   cost_fwd[n] = sum_i softmax_i(wn(q'[i])) qc[i]      (float32, -> T)
// where rnd rounds to T (identity for float32). These are the Pallas
// body's roundings, not those of the XLA reference (cost_attention_xla).
//
// Work per point at the main path's shape (K = 16, C = 64, C2 = 32):
// S, q' and k' are 3 x K*K*C multiply-adds and the weightnet
// 2K x (C*C + C*C2 + C2), plus K*C for the aggregation: 247,808
// multiply-adds = 0.496 MFLOP per point, 4.06 GFLOP at N = 8192; the
// bytes are the three [N, K, C] inputs once, the weights and the outputs
// (52 MB in bf16).
//
// Design (simple and right first; tensor cores, TMA and pipelining are
// later work): one warp per query point, several points per block. The
// folded weightnet is staged once per block in shared memory; each warp
// reads its point's q and k tiles coalesced over channels into padded
// float32 shared rows. Lanes own channels for q'/k' (so q' goes to its own
// buffer and k' overwrites k in place without cross-lane hazards), own
// entries of S and W, and own output units of the weightnet layers; the
// final logit is a warp reduction. All products accumulate in float32 on
// CUDA cores.
#include "banded_common.cuh"

namespace {

struct Smem {
  int k, c, c2, warps;
  // the block's shared floats: weights (as T), biases, then per warp
  // q, k, q' [K][C + 1], S [K][K + 1], column/row stats, logits, hidden
  __host__ __device__ int ld() const { return c + 1; }
  __host__ __device__ int tile() const { return k * ld(); }
  __host__ __device__ int per_warp() const {
    return 3 * tile() + k * (k + 1) + 4 * k + k + c;
  }
  __host__ __device__ int biases() const { return c + c2 + 1; }
};

template <typename T>
size_t smem_bytes(const Smem& s) {
  size_t w = (size_t)(s.c * s.c + s.c * s.c2 + s.c2) * sizeof(T);
  w = (w + 15) & ~(size_t)15;
  return w + (size_t)(s.biases() + s.warps * s.per_warp()) * sizeof(float);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void cost_attention_kernel(
    const T* __restrict__ q_feat, const T* __restrict__ k_feat,
    const T* __restrict__ q_cost, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, int rows, Smem s, T* __restrict__ cost_fwd,
    float* __restrict__ w_k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = s.k, C = s.c, C2 = s.c2, LD = s.ld();
  T* sw1 = reinterpret_cast<T*>(smem_raw);
  T* sw2 = sw1 + C * C;
  T* sw3 = sw2 + C * C2;
  size_t wbytes = (size_t)(C * C + C * C2 + C2) * sizeof(T);
  wbytes = (wbytes + 15) & ~(size_t)15;
  float* sb1 = reinterpret_cast<float*>(smem_raw + wbytes);
  float* sb2 = sb1 + C;
  float* sb3 = sb2 + C2;

  // stage the weightnet once per block, rounded to the feature type
  for (int i = threadIdx.x; i < C * C; i += blockDim.x)
    sw1[i] = from_f32<T>(w1[i]);
  for (int i = threadIdx.x; i < C * C2; i += blockDim.x)
    sw2[i] = from_f32<T>(w2[i]);
  for (int i = threadIdx.x; i < C2; i += blockDim.x) {
    sw3[i] = from_f32<T>(w3[i]);
    sb2[i] = b2[i];
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) sb1[i] = b1[i];
  if (threadIdx.x == 0) sb3[0] = b3[0];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * s.warps + warp;
  if (n >= rows) return;
  float* q = sb3 + 1 + warp * s.per_warp();
  float* kk = q + s.tile();
  float* qa = kk + s.tile();
  float* S = qa + s.tile();           // [K][K + 1], then W in place
  float* cmax = S + K * (K + 1);      // column (over i) max and sum
  float* csum = cmax + K;
  float* rmax = csum + K;             // row (over j) max and sum
  float* rsum = rmax + K;
  float* logit = rsum + K;            // w_q logits [K]
  float* hid = logit + K;             // one hidden row [C]

  const size_t base = (size_t)n * K * C;
  for (int e = lane; e < K * C; e += 32) {
    const int i = e / C, c = e - i * C;
    q[i * LD + c] = to_f32(q_feat[base + e]);
    kk[i * LD + c] = to_f32(k_feat[base + e]);
  }
  __syncwarp();

  // S = q k^T
  for (int e = lane; e < K * K; e += 32) {
    const int i = e / K, j = e - i * K;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = fmaf(q[i * LD + c], kk[j * LD + c], acc);
    S[i * (K + 1) + j] = acc;
  }
  __syncwarp();
  // dual-softmax statistics: columns normalise over i, rows over j
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
    S[i * (K + 1) + j] = round_to<T>(s1 * s2);
  }
  __syncwarp();

  // q' = rnd(q + W k) into its own buffer, then k' = rnd(k + W^T q) in
  // place: every lane touches only its own channels
  for (int c = lane; c < C; c += 32) {
    for (int i = 0; i < K; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < K; ++j)
        acc = fmaf(S[i * (K + 1) + j], kk[j * LD + c], acc);
      qa[i * LD + c] = round_to<T>(q[i * LD + c] + acc);
    }
    for (int j = 0; j < K; ++j) {
      float acc = 0.0f;
      for (int i = 0; i < K; ++i)
        acc = fmaf(S[i * (K + 1) + j], q[i * LD + c], acc);
      kk[j * LD + c] = round_to<T>(kk[j * LD + c] + acc);
    }
  }
  __syncwarp();

  // the weightnet on the 2K attended rows: q' rows give w_q, k' rows w_k
  for (int r = 0; r < 2 * K; ++r) {
    const float* x = (r < K ? qa : kk) + (r % K) * LD;
    for (int o = lane; o < C; o += 32) {
      float acc = 0.0f;
      for (int c = 0; c < C; ++c)
        acc = fmaf(x[c], to_f32(sw1[c * C + o]), acc);
      hid[o] = round_to<T>(fmaxf(acc + sb1[o], 0.0f));
    }
    __syncwarp();
    float part = 0.0f;
    for (int o2 = lane; o2 < C2; o2 += 32) {
      float acc = 0.0f;
      for (int o = 0; o < C; ++o)
        acc = fmaf(hid[o], to_f32(sw2[o * C2 + o2]), acc);
      const float h2 = round_to<T>(fmaxf(acc + sb2[o2], 0.0f));
      part = fmaf(h2, to_f32(sw3[o2]), part);
    }
    const float out = warp_sum(part) + sb3[0];
    if (lane == 0) {
      if (r < K)
        logit[r] = out;
      else
        w_k[(size_t)n * K + (r - K)] = out;
    }
    __syncwarp();
  }

  // cost_fwd = sum_i softmax_i(w_q)[i] q_cost[i], in float32
  float m = logit[0];
  for (int i = 1; i < K; ++i) m = fmaxf(m, logit[i]);
  float sum = 0.0f;
  for (int i = 0; i < K; ++i) sum += expf(logit[i] - m);
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
    for (int i = 0; i < K; ++i) {
      const float wt = expf(logit[i] - m) / sum;
      acc = fmaf(wt, to_f32(q_cost[base + (size_t)i * C + c]), acc);
    }
    cost_fwd[(size_t)n * C + c] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* q_feat, const void* k_feat, const void* q_cost,
           const float* w1, const float* b1, const float* w2, const float* b2,
           const float* w3, const float* b3, int rows, int K, int C, int C2,
           void* cost_fwd, float* w_k, cudaStream_t stream) {
  Smem s{K, C, C2, 4};
  const size_t limit = 200 * 1024;
  while (s.warps > 1 && smem_bytes<T>(s) > limit) --s.warps;
  const size_t bytes = smem_bytes<T>(s);
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cost_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + s.warps - 1) / s.warps);
  cost_attention_kernel<T><<<grid, 32 * s.warps, bytes, stream>>>(
      (const T*)q_feat, (const T*)k_feat, (const T*)q_cost, w1, b1, w2, b2,
      w3, b3, rows, s, (T*)cost_fwd, w_k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q_feat, k_feat, q_cost [rows, K, C] (float32 or bf16, all one type);
// w1 [C, C], b1 [C], w2 [C, C2], b2 [C2], w3 [C2], b3 [1] float32
// -> cost_fwd [rows, C] in the feature type, w_k [rows, K] float32.
// Returns a cudaError_t code.
int ssf_cost_attention(const void* q_feat, const void* k_feat,
                       const void* q_cost, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* w3,
                       const void* b3, int rows, int K, int C, int C2,
                       int feats_bf16, void* cost_fwd, void* w_k,
                       void* stream) {
  if (K < 1 || K > 32 || C < 1 || C > 128 || C2 < 1 || C2 > 128)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (feats_bf16)
    return launch<__nv_bfloat16>(
        q_feat, k_feat, q_cost, (const float*)w1, (const float*)b1,
        (const float*)w2, (const float*)b2, (const float*)w3,
        (const float*)b3, rows, K, C, C2, cost_fwd, (float*)w_k, s);
  return launch<float>(q_feat, k_feat, q_cost, (const float*)w1,
                       (const float*)b1, (const float*)w2, (const float*)b2,
                       (const float*)w3, (const float*)b3, rows, K, C, C2,
                       cost_fwd, (float*)w_k, s);
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
