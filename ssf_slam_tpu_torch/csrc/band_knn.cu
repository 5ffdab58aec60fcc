// Banded kNN: the top-k alone, with grouping, twin searches with grouping,
// and with inverse-distance interpolation.
//
// Replaces the Pallas TPU kernels
//   ssf_slam_tpu/ops/banded.py::banded_knn        (_knn_kernel_body)
//   ssf_slam_tpu/ops/banded.py::banded_knn_group  (_knn_group_kernel_body)
//   ssf_slam_tpu/ops/banded.py::banded_knn_group2 (_knn_group2_kernel_body)
//   ssf_slam_tpu/ops/banded.py::banded_knn_idw    (_knn_idw_kernel_body)
// All share one device routine, band_topk, for the band top-k.
//
// What it computes, per query n of tile t = n / 256 (Morton-sorted clouds):
//   band     = target rows [base, base + wb), base = b0[t] * wblk,
//              wb = wblk * n_blocks
//   d[p]     = fma(dz, dz, fma(dx, dx, dy*dy)) against band row p: the
//              roundings XLA gives _pairwise_band_dist's
//              ((0 + dx*dx) + dy*dy) + dz*dz (ops/banded.py::_band_dist),
//              written with explicit __fmul_rn / __fmaf_rn so that nvcc's
//              own contraction cannot change them; rows at or past n_valid
//              get 1e10
//   key[p]   = (bits(d[p]) & ~0x3FF) | p  -- the packed key of _topk_band
//   top-k    = the k smallest keys, ascending; ties in the truncated
//              distance break to the lower band position
//   sqdist   = the truncated distance bits(key) & ~0x3FF
//   idx      = base + (key & 0x3FF); slots whose distance is >= 5e9 repeat
//              the nearest idx
//   knn:       sqdist and idx only
//   knn_group: grouped[n, j, :] = feats[idx[n, j], :]  (an exact copy)
//   knn_group2: two searches (query_a in points_a, query_b in points_b)
//              under ONE plan, b0 made from (query_a, points_a), each
//              grouping the shared feats as knn_group does
//   knn_idw:   w_j = 1 / sqrt(max(d_j, 0) + eps^2), normalised over j;
//              out[n, :] = sum_j w_j * f32(feats[idx_j, :]) in slot order,
//              accumulated in float32 and rounded once to the feats type
//
// What bounds it on the H100: at the main-path shapes (8192 x 8192, k = 16,
// C = 99 float32) knn_group writes a 52 MB grouped tensor and reads 3 MB,
// against 50 MFLOP of distances: it is bound by bytes, and the output write
// is most of them. knn_idw writes only [N, C] and is bound by the
// per-thread selection (N * wb key compares with a k-deep insertion), which
// the device-memory and FLOP bounds do not count; so is knn, which writes
// only [N, k] distances and indices. knn_group2 is two knn_group's work.
//
// Design (right and simple first; no TMA or wgmma):
// - one block of 256 threads per query tile; the block stages the
//   wb <= 768 band points (<= 9 KB) in shared memory, and each thread keeps
//   its query's sorted top-k keys in a local array (k <= 32). A candidate
//   costs one compare against the current k-th key; only winners pay the
//   insertion;
// - the TPU kernel's one-hot MXU matmuls are layout tricks for a machine
//   without gathers. Here the block parks its 256 * k indices (and IDW
//   weights) in shared memory and copies rows directly: one warp per output
//   row, lanes over channels, so reads and writes are coalesced.
#include "banded_common.cuh"

// k smallest packed keys of one query against the shared-memory band,
// ascending in keys[0..k)
__device__ __forceinline__ void band_topk(float qx, float qy, float qz,
                                          const float* __restrict__ band,
                                          int wb, int base, int n_valid,
                                          int k, int* keys) {
  for (int j = 0; j < k; ++j) keys[j] = 0x7FFFFFFF;
  int worst = 0x7FFFFFFF;
  for (int p = 0; p < wb; ++p) {
    const float dx = __fsub_rn(qx, band[3 * p + 0]);
    const float dy = __fsub_rn(qy, band[3 * p + 1]);
    const float dz = __fsub_rn(qz, band[3 * p + 2]);
    float d = __fmul_rn(dy, dy);
    d = __fmaf_rn(dx, dx, d);
    d = __fmaf_rn(dz, dz, d);
    if (base + p >= n_valid) d = BIG_DIST;
    const int key = (__float_as_int(d) & ~POS_MASK) | p;
    if (key < worst) {
      int j = k - 1;
      while (j > 0 && keys[j - 1] > key) {
        keys[j] = keys[j - 1];
        --j;
      }
      keys[j] = key;
      worst = keys[k - 1];
    }
  }
}

// Stage the band, run the top-k for this thread's query, write sqdist and
// idx, and optionally park idx and the distances in shared memory. The
// band rows come from b0 of this block's tile whatever the points array;
// the caller __syncthreads() before reading `sidx` or restaging `band`.
__device__ __forceinline__ void tile_topk(
    const float* __restrict__ query, const float* __restrict__ points,
    const int* __restrict__ b0, int N, int M, int k, int wblk, int n_blocks,
    int n_valid, float* __restrict__ out_d, int* __restrict__ out_i,
    float* band, int* sidx, float* sd) {
  const int wb = wblk * n_blocks;
  const int b = blockIdx.y;
  const int n_tiles = N / QUERY_TILE;
  const int base = b0[b * n_tiles + blockIdx.x] * wblk;
  const float* pts = points + ((size_t)b * M + base) * 3;
  for (int i = threadIdx.x; i < wb * 3; i += blockDim.x) band[i] = pts[i];
  __syncthreads();

  const int n = blockIdx.x * QUERY_TILE + threadIdx.x;
  const float* q = query + ((size_t)b * N + n) * 3;
  int keys[MAX_K];
  band_topk(q[0], q[1], q[2], band, wb, base, n_valid, k, keys);

  const size_t o = ((size_t)b * N + n) * k;
  const int nearest = keys[0] & POS_MASK;
  for (int j = 0; j < k; ++j) {
    const float d = __int_as_float(keys[j] & ~POS_MASK);
    const int pos = d >= 0.5f * BIG_DIST ? nearest : (keys[j] & POS_MASK);
    out_d[o + j] = d;
    out_i[o + j] = base + pos;
    if (sidx != nullptr) sidx[threadIdx.x * k + j] = base + pos;
    if (sd != nullptr) sd[threadIdx.x * k + j] = d;
  }
}

__global__ void __launch_bounds__(QUERY_TILE)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           const int* __restrict__ b0, int N, int M, int k, int wblk,
           int n_blocks, int n_valid, float* __restrict__ out_d,
           int* __restrict__ out_i) {
  extern __shared__ float smem[];
  tile_topk(query, points, b0, N, M, k, wblk, n_blocks, n_valid, out_d, out_i,
            smem, nullptr, nullptr);
}

// copy the rows named by sidx[0 .. QUERY_TILE * k) of feats into this
// tile's grouped block: one warp per output row, lanes over channels
template <typename T>
__device__ __forceinline__ void tile_group(const T* __restrict__ feats,
                                           const int* sidx, int N, int M,
                                           int C, int k,
                                           T* __restrict__ grouped) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const T* fb = feats + (size_t)b * M * C;
  T* gb = grouped + ((size_t)b * N + (size_t)blockIdx.x * QUERY_TILE) * k * C;
  for (int r = warp; r < QUERY_TILE * k; r += n_warps) {
    const T* src = fb + (size_t)sidx[r] * C;
    T* dst = gb + (size_t)r * C;
    for (int c = lane; c < C; c += 32) dst[c] = src[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(QUERY_TILE)
knn_group_kernel(const float* __restrict__ query,
                 const float* __restrict__ points, const T* __restrict__ feats,
                 const int* __restrict__ b0, int N, int M, int C, int k,
                 int wblk, int n_blocks, int n_valid, float* __restrict__ out_d,
                 int* __restrict__ out_i, T* __restrict__ grouped) {
  extern __shared__ float smem[];
  float* band = smem;                                   // [wb * 3]
  int* sidx = (int*)(band + 3 * wblk * n_blocks);       // [256 * k]
  tile_topk(query, points, b0, N, M, k, wblk, n_blocks, n_valid, out_d, out_i,
            band, sidx, nullptr);
  __syncthreads();
  tile_group(feats, sidx, N, M, C, k, grouped);
}

template <typename T>
__global__ void __launch_bounds__(QUERY_TILE)
knn_group2_kernel(const float* __restrict__ query_a,
                  const float* __restrict__ query_b,
                  const float* __restrict__ points_a,
                  const float* __restrict__ points_b,
                  const T* __restrict__ feats, const int* __restrict__ b0,
                  int N, int M, int C, int k, int wblk, int n_blocks,
                  int n_valid, float* __restrict__ d_a, int* __restrict__ i_a,
                  T* __restrict__ g_a, float* __restrict__ d_b,
                  int* __restrict__ i_b, T* __restrict__ g_b) {
  extern __shared__ float smem[];
  float* band = smem;                                   // [wb * 3]
  int* sidx_a = (int*)(band + 3 * wblk * n_blocks);     // [256 * k]
  int* sidx_b = sidx_a + QUERY_TILE * k;                // [256 * k]
  tile_topk(query_a, points_a, b0, N, M, k, wblk, n_blocks, n_valid, d_a, i_a,
            band, sidx_a, nullptr);
  __syncthreads();  // every thread is done with points_a's band
  tile_topk(query_b, points_b, b0, N, M, k, wblk, n_blocks, n_valid, d_b, i_b,
            band, sidx_b, nullptr);
  __syncthreads();
  tile_group(feats, sidx_a, N, M, C, k, g_a);
  tile_group(feats, sidx_b, N, M, C, k, g_b);
}

template <typename T>
__global__ void __launch_bounds__(QUERY_TILE)
knn_idw_kernel(const float* __restrict__ query,
               const float* __restrict__ points, const T* __restrict__ feats,
               const int* __restrict__ b0, int N, int M, int C, int k,
               int wblk, int n_blocks, int n_valid, float eps2,
               T* __restrict__ out, float* __restrict__ out_d,
               int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* band = smem;                                   // [wb * 3]
  int* sidx = (int*)(band + 3 * wblk * n_blocks);       // [256 * k]
  float* sw = (float*)(sidx + QUERY_TILE * k);          // [256 * k]
  tile_topk(query, points, b0, N, M, k, wblk, n_blocks, n_valid, out_d, out_i,
            band, sidx, sw);

  // normalised inverse-distance weights of this thread's query
  float* w = sw + threadIdx.x * k;
  float s = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float dj = fmaxf(w[j], 0.0f);
    w[j] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(dj, eps2)));
    s = __fadd_rn(s, w[j]);
  }
  for (int j = 0; j < k; ++j) w[j] = __fdiv_rn(w[j], s);
  __syncthreads();

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const T* fb = feats + (size_t)b * M * C;
  T* ob = out + ((size_t)b * N + (size_t)blockIdx.x * QUERY_TILE) * C;
  for (int r = warp; r < QUERY_TILE; r += n_warps) {
    const int* ri = sidx + r * k;
    const float* rw = sw + r * k;
    for (int c = lane; c < C; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(rw[j], to_f32(fb[(size_t)ri[j] * C + c])));
      ob[(size_t)r * C + c] = from_f32<T>(acc);
    }
  }
}

static int check_shape(int N, int k, int wblk, int n_blocks) {
  if (N % QUERY_TILE != 0 || k < 1 || k > MAX_K || wblk * n_blocks > 1024)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
static int launch_group(const void* query, const void* points,
                        const void* feats, const void* b0, int B, int N, int M,
                        int C, int k, int wblk, int n_blocks, int n_valid,
                        void* out_d, void* out_i, void* grouped,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * 3 * wblk * n_blocks + sizeof(int) * QUERY_TILE * k;
  cudaError_t err = cudaFuncSetAttribute(
      knn_group_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / QUERY_TILE, B);
  knn_group_kernel<T><<<grid, QUERY_TILE, smem, stream>>>(
      (const float*)query, (const float*)points, (const T*)feats,
      (const int*)b0, N, M, C, k, wblk, n_blocks, n_valid, (float*)out_d,
      (int*)out_i, (T*)grouped);
  return (int)cudaGetLastError();
}

static int launch_knn(const void* query, const void* points, const void* b0,
                      int B, int N, int M, int k, int wblk, int n_blocks,
                      int n_valid, void* out_d, void* out_i,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * wblk * n_blocks;
  dim3 grid(N / QUERY_TILE, B);
  knn_kernel<<<grid, QUERY_TILE, smem, stream>>>(
      (const float*)query, (const float*)points, (const int*)b0, N, M, k,
      wblk, n_blocks, n_valid, (float*)out_d, (int*)out_i);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_group2(const void* qa, const void* qb, const void* pa,
                         const void* pb, const void* feats, const void* b0,
                         int B, int N, int M, int C, int k, int wblk,
                         int n_blocks, int n_valid, void* d_a, void* i_a,
                         void* g_a, void* d_b, void* i_b, void* g_b,
                         cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * 3 * wblk * n_blocks + sizeof(int) * 2 * QUERY_TILE * k;
  cudaError_t err = cudaFuncSetAttribute(
      knn_group2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / QUERY_TILE, B);
  knn_group2_kernel<T><<<grid, QUERY_TILE, smem, stream>>>(
      (const float*)qa, (const float*)qb, (const float*)pa, (const float*)pb,
      (const T*)feats, (const int*)b0, N, M, C, k, wblk, n_blocks, n_valid,
      (float*)d_a, (int*)i_a, (T*)g_a, (float*)d_b, (int*)i_b, (T*)g_b);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_idw(const void* query, const void* points, const void* feats,
                      const void* b0, int B, int N, int M, int C, int k,
                      int wblk, int n_blocks, int n_valid, float eps2,
                      void* out, void* out_d, void* out_i,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * wblk * n_blocks +
                      (sizeof(int) + sizeof(float)) * QUERY_TILE * k;
  cudaError_t err = cudaFuncSetAttribute(
      knn_idw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / QUERY_TILE, B);
  knn_idw_kernel<T><<<grid, QUERY_TILE, smem, stream>>>(
      (const float*)query, (const float*)points, (const T*)feats,
      (const int*)b0, N, M, C, k, wblk, n_blocks, n_valid, eps2, (T*)out,
      (float*)out_d, (int*)out_i);
  return (int)cudaGetLastError();
}

extern "C" {

// query [B, N, 3] f32, points [B, M, 3] f32, feats [B, M, C] (f32 or bf16),
// b0 [B, N / 256] i32 -> out_d [B, N, k] f32, out_i [B, N, k] i32,
// grouped [B, N, k, C] in the feats type. Returns a cudaError_t code.
int ssf_knn_group(const void* query, const void* points, const void* feats,
                  const void* b0, int B, int N, int M, int C, int k, int wblk,
                  int n_blocks, int n_valid, int feats_bf16, void* out_d,
                  void* out_i, void* grouped, void* stream) {
  int bad = check_shape(N, k, wblk, n_blocks);
  if (bad) return bad;
  if (feats_bf16)
    return launch_group<__nv_bfloat16>(query, points, feats, b0, B, N, M, C, k,
                                       wblk, n_blocks, n_valid, out_d, out_i,
                                       grouped, (cudaStream_t)stream);
  return launch_group<float>(query, points, feats, b0, B, N, M, C, k, wblk,
                             n_blocks, n_valid, out_d, out_i, grouped,
                             (cudaStream_t)stream);
}

// query [B, N, 3] f32, points [B, M, 3] f32, b0 [B, N / 256] i32
// -> out_d [B, N, k] f32, out_i [B, N, k] i32. Returns a cudaError_t code.
int ssf_knn(const void* query, const void* points, const void* b0, int B,
            int N, int M, int k, int wblk, int n_blocks, int n_valid,
            void* out_d, void* out_i, void* stream) {
  int bad = check_shape(N, k, wblk, n_blocks);
  if (bad) return bad;
  return launch_knn(query, points, b0, B, N, M, k, wblk, n_blocks, n_valid,
                    out_d, out_i, (cudaStream_t)stream);
}

// query_a, query_b [B, N, 3] f32, points_a, points_b [B, M, 3] f32 (rows
// aligned), feats [B, M, C], b0 [B, N / 256] i32 (the plan of query_a in
// points_a) -> (d, i, grouped) of each search, as ssf_knn_group's
int ssf_knn_group2(const void* query_a, const void* query_b,
                   const void* points_a, const void* points_b,
                   const void* feats, const void* b0, int B, int N, int M,
                   int C, int k, int wblk, int n_blocks, int n_valid,
                   int feats_bf16, void* d_a, void* i_a, void* g_a, void* d_b,
                   void* i_b, void* g_b, void* stream) {
  int bad = check_shape(N, k, wblk, n_blocks);
  if (bad) return bad;
  cudaStream_t s = (cudaStream_t)stream;
  if (feats_bf16)
    return launch_group2<__nv_bfloat16>(query_a, query_b, points_a, points_b,
                                        feats, b0, B, N, M, C, k, wblk,
                                        n_blocks, n_valid, d_a, i_a, g_a, d_b,
                                        i_b, g_b, s);
  return launch_group2<float>(query_a, query_b, points_a, points_b, feats, b0,
                              B, N, M, C, k, wblk, n_blocks, n_valid, d_a, i_a,
                              g_a, d_b, i_b, g_b, s);
}

// as ssf_knn_group, but out [B, N, C] = the IDW mix of the k neighbours'
// feats, in the feats type
int ssf_knn_idw(const void* query, const void* points, const void* feats,
                const void* b0, int B, int N, int M, int C, int k, int wblk,
                int n_blocks, int n_valid, float eps2, int feats_bf16,
                void* out, void* out_d, void* out_i, void* stream) {
  int bad = check_shape(N, k, wblk, n_blocks);
  if (bad) return bad;
  if (feats_bf16)
    return launch_idw<__nv_bfloat16>(query, points, feats, b0, B, N, M, C, k,
                                     wblk, n_blocks, n_valid, eps2, out, out_d,
                                     out_i, (cudaStream_t)stream);
  return launch_idw<float>(query, points, feats, b0, B, N, M, C, k, wblk,
                           n_blocks, n_valid, eps2, out, out_d, out_i,
                           (cudaStream_t)stream);
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
