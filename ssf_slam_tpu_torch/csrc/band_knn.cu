// Banded kNN: the top-k alone, with grouping, twin searches with grouping,
// and with inverse-distance interpolation.
//
// Replaces the Pallas TPU kernels
//   ssf_slam_tpu/ops/banded.py::banded_knn        (_knn_kernel_body)
//   ssf_slam_tpu/ops/banded.py::banded_knn_group  (_knn_group_kernel_body)
//   ssf_slam_tpu/ops/banded.py::banded_knn_group2 (_knn_group2_kernel_body)
//   ssf_slam_tpu/ops/banded.py::banded_knn_idw    (_knn_idw_kernel_body)
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
// knn_group and knn_idw (the main path's two): query-split selection.
// What bounds them on the H100: knn_group at level 0 (8192 x 8192, k = 16,
// C = 99 float32) writes a 52 MB grouped tensor and reads 3 MB, against 50
// MFLOP of distances: its bound is that write, 0.0168 ms at 3.35 TB/s.
// knn_idw writes only [N, C]; what bounds it is the selection, N * wb key
// compares and the top-k insertions, which the device-memory and FLOP
// bounds do not count. With one thread per query and one block per
// 256-query tile, both ran on the latency of one thread's serial walk over
// 768 candidates (its top-k in a local-memory array) on at most 32 of the
// 132 SMs, and the copy kept one 4-byte load in flight per lane. So:
// - the CUDA block is decoupled from the band tile: a block of 256 threads
//   takes Q = 256 / S queries of one tile and stages that tile's band
//   (<= 1024 points, 12 KB) in shared memory itself; blocks of one tile
//   re-read it from L2. The grid is (N / Q) x B, 512 blocks for knn_group
//   at level 0 (S = 16; default_split chooses S from the query count);
// - each query's band is split over S lanes: lane s scans positions
//   p = s (mod S) and keeps its own K best keys in registers (K a
//   compile-time capacity >= k, insertion by unrolled compare-and-swap, no
//   dynamic index: no stack frame). k rounds of a group minimum
//   (__reduce_min_sync for a warp, a shuffle butterfly below) merge the S
//   lists: the lane whose head won pops it. Keys are distinct within a band
//   (p < 1024 sits in the low bits), so the k smallest form a set, and the
//   merge returns exactly the ascending list of a serial scan, however the
//   band is split;
// - the grouping is a flat copy: the block's Q * k output rows are one
//   contiguous span, written in 16-byte vectors, each thread gathering 4
//   (float32) or 8 (bf16) elements before its store;
// - the IDW mix takes the block's Q output rows the same way, each thread's
//   k gathers in flight before its slot-order sum. Every lane of a query sees
//   the merged distances in slot order and sums the weights with the
//   roundings above, so the output bits do not depend on S either.
// knn and knn_group2 (entry points only) keep one thread per query and one
// block per tile (band_topk, tile_topk), and one warp per grouped row.
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
// idx, and optionally park idx in shared memory. The
// band rows come from b0 of this block's tile whatever the points array;
// the caller __syncthreads() before reading `sidx` or restaging `band`.
__device__ __forceinline__ void tile_topk(
    const float* __restrict__ query, const float* __restrict__ points,
    const int* __restrict__ b0, int N, int M, int k, int wblk, int n_blocks,
    int n_valid, float* __restrict__ out_d, int* __restrict__ out_i,
    float* band, int* sidx) {
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
  }
}

__global__ void __launch_bounds__(QUERY_TILE)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           const int* __restrict__ b0, int N, int M, int k, int wblk,
           int n_blocks, int n_valid, float* __restrict__ out_d,
           int* __restrict__ out_i) {
  extern __shared__ float smem[];
  tile_topk(query, points, b0, N, M, k, wblk, n_blocks, n_valid, out_d, out_i,
            smem, nullptr);
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
            band, sidx_a);
  __syncthreads();  // every thread is done with points_a's band
  tile_topk(query_b, points_b, b0, N, M, k, wblk, n_blocks, n_valid, d_b, i_b,
            band, sidx_b);
  __syncthreads();
  tile_group(feats, sidx_a, N, M, C, k, g_a);
  tile_group(feats, sidx_b, N, M, C, k, g_b);
}

// ---------------------------------------------------------------------------
// knn_group and knn_idw: the query-split selection
// ---------------------------------------------------------------------------

#define SPLIT_BLOCK 256  // threads of a knn_group / knn_idw block

struct SplitArgs {
  const float* query;   // [B, N, 3]
  const float* points;  // [B, M, 3]
  const void* feats;    // [B, M, C]
  const int* b0;        // [B, N / 256]
  int N, M, C, k, wblk, n_blocks, n_valid;
  float eps2;           // knn_idw only
  float* out_d;         // [B, N, k]
  int* out_i;           // [B, N, k]
  void* out;            // knn_group: grouped [B, N, k, C]; knn_idw: [B, N, C]
};

// the minimum of v over the S lanes of one query (S a power of two <= 32;
// a query's lanes are consecutive and aligned in the warp)
template <int S>
__device__ __forceinline__ int group_min(int v) {
  if constexpr (S == 32) {
    return __reduce_min_sync(0xFFFFFFFFu, v);
  } else {
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1)
      v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    return v;
  }
}

// Stage this block's band, then select the k smallest keys of each of its
// Q = SPLIT_BLOCK / S queries, S lanes to a query. On return (after a
// __syncthreads) sidx[q * k + j] and sd[q * k + j] hold query q's slot j
// (absolute row, truncated distance), and every lane holds in `wsum` its
// query's IDW weight sum (when IDW is set). Returns the block's base row.
template <int K, int S, bool IDW>
__device__ __forceinline__ int split_topk(const SplitArgs& a, float* band,
                                          int* sidx, float* sd, float* sw) {
  constexpr int Q = SPLIT_BLOCK / S;
  const int wb = a.wblk * a.n_blocks, k = a.k;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * Q;
  const int base = a.b0[b * (a.N / QUERY_TILE) + n0 / QUERY_TILE] * a.wblk;
  const float* pts = a.points + ((size_t)b * a.M + base) * 3;
  for (int i = threadIdx.x; i < wb * 3; i += SPLIT_BLOCK) band[i] = pts[i];
  __syncthreads();

  const int ql = threadIdx.x / S, s = threadIdx.x % S;
  const float* q = a.query + ((size_t)b * a.N + n0 + ql) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  int keys[K];
#pragma unroll
  for (int j = 0; j < K; ++j) keys[j] = 0x7FFFFFFF;
  for (int p = s; p < wb; p += S) {
    const float dx = __fsub_rn(qx, band[3 * p + 0]);
    const float dy = __fsub_rn(qy, band[3 * p + 1]);
    const float dz = __fsub_rn(qz, band[3 * p + 2]);
    float d = __fmul_rn(dy, dy);
    d = __fmaf_rn(dx, dx, d);
    d = __fmaf_rn(dz, dz, d);
    if (base + p >= a.n_valid) d = BIG_DIST;
    int key = (__float_as_int(d) & ~POS_MASK) | p;
    if (key < keys[K - 1]) {
      // sorted insertion: keep the smaller at each slot, carry the larger
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int lo = min(keys[j], key);
        key = max(keys[j], key);
        keys[j] = lo;
      }
    }
  }

  // merge: round r finds the query's r-th key; its lane pops it
  int nearest = 0;
  float wsum = 0.0f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    if (r >= k) break;
    const int m = group_min<S>(keys[0]);
    if (r == 0) nearest = m & POS_MASK;
    const float d = __int_as_float(m & ~POS_MASK);
    if constexpr (IDW) wsum = __fadd_rn(wsum, __fdiv_rn(
        1.0f, __fsqrt_rn(__fadd_rn(fmaxf(d, 0.0f), a.eps2))));
    if (r % S == s) {
      const int pos = d >= 0.5f * BIG_DIST ? nearest : (m & POS_MASK);
      sidx[ql * k + r] = base + pos;
      sd[ql * k + r] = d;
    }
    const bool won = keys[0] == m;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) keys[j] = won ? keys[j + 1] : keys[j];
    keys[K - 1] = won ? 0x7FFFFFFF : keys[K - 1];
  }
  if constexpr (IDW) {
    // normalised weights of this lane's slots, as the serial kernel: each
    // w_j again from d_j, over the slot-order sum
    for (int r = s; r < k; r += S) {
      const float w = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(
          fmaxf(sd[ql * k + r], 0.0f), a.eps2)));
      sw[ql * k + r] = __fdiv_rn(w, wsum);
    }
  }
  __syncthreads();

  // the block's Q * k distances and indices are one contiguous span
  const size_t o = ((size_t)b * a.N + n0) * k;
  for (int e = threadIdx.x; e < Q * k; e += SPLIT_BLOCK) {
    a.out_d[o + e] = sd[e];
    a.out_i[o + e] = sidx[e];
  }
  return n0;
}

// E: the element's bits (uint32_t for float32, uint16_t for bf16): the
// grouping is an exact copy
template <int K, int S, typename E>
__global__ void __launch_bounds__(SPLIT_BLOCK)
knn_group_kernel(const SplitArgs a) {
  constexpr int Q = SPLIT_BLOCK / S;
  constexpr int VEC = 16 / sizeof(E);
  extern __shared__ float smem[];
  const int k = a.k, C = a.C;
  float* band = smem;                                   // [wb * 3]
  int* sidx = (int*)(band + 3 * a.wblk * a.n_blocks);   // [Q * k]
  float* sd = (float*)(sidx + Q * k);                   // [Q * k]
  const int n0 = split_topk<K, S, false>(a, band, sidx, sd, nullptr);

  const int b = blockIdx.y;
  const E* fb = (const E*)a.feats + (size_t)b * a.M * C;
  E* gb = (E*)a.out + ((size_t)b * a.N + n0) * k * C;
  const int n_el = Q * k * C;
  if ((reinterpret_cast<uintptr_t>(gb) & 15) == 0 && n_el % VEC == 0) {
#pragma unroll 2
    for (int v = threadIdx.x; v < n_el / VEC; v += SPLIT_BLOCK) {
      int row = v * VEC / C, c = v * VEC - row * C;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const uint32_t x = fb[(size_t)sidx[row] * C + c];
        if constexpr (sizeof(E) == 4) w[i] = x;
        else w[i >> 1] |= x << (16 * (i & 1));
        if (++c == C) {
          c = 0;
          ++row;
        }
      }
      reinterpret_cast<uint4*>(gb)[v] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int e = threadIdx.x; e < n_el; e += SPLIT_BLOCK) {
      const int row = e / C;
      gb[e] = fb[(size_t)sidx[row] * C + (e - row * C)];
    }
  }
}

template <int K, int S, typename T>
__global__ void __launch_bounds__(SPLIT_BLOCK)
knn_idw_kernel(const SplitArgs a) {
  constexpr int Q = SPLIT_BLOCK / S;
  extern __shared__ float smem[];
  const int k = a.k, C = a.C;
  float* band = smem;                                   // [wb * 3]
  int* sidx = (int*)(band + 3 * a.wblk * a.n_blocks);   // [Q * k]
  float* sd = (float*)(sidx + Q * k);                   // [Q * k]
  float* sw = sd + Q * k;                               // [Q * k]
  const int n0 = split_topk<K, S, true>(a, band, sidx, sd, sw);

  // output elements of the block's Q rows, one contiguous span
  const int b = blockIdx.y;
  const T* fb = (const T*)a.feats + (size_t)b * a.M * C;
  T* ob = (T*)a.out + ((size_t)b * a.N + n0) * C;
  for (int e = threadIdx.x; e < Q * C; e += SPLIT_BLOCK) {
    const int row = e / C, c = e - row * C;
    const int* ri = sidx + row * k;
    const float* rw = sw + row * k;
    float f[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) f[j] = to_f32(fb[(size_t)ri[j] * C + c]);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) acc = __fadd_rn(acc, __fmul_rn(rw[j], f[j]));
    ob[e] = from_f32<T>(acc);
  }
}

// The fewest lanes per query (of 8, 16, 32) that still give the launch
// 4,096 warps (knn_group) or 2,048 (knn_idw, whose merge rounds each
// compute a weight in every lane): fewer lanes mean shorter merges, more
// lanes more parallel work where the queries are few. Measured on the
// H100 at the main path's shapes: 32 at 2,048 queries or fewer, 16
// (knn_group) or 8 (knn_idw) at 8,192, 8 at 4 x 8,192. A measurement build
// fixes S for every launch with -DSSF_KNN_SPLIT=8, 16 or 32; the outputs do
// not depend on it.
static int default_split(long queries, bool idw) {
  const long lanes = idw ? 65536 : 131072;
  for (int s = 8; s < 32; s *= 2)
    if (queries * s >= lanes) return s;
  return 32;
}

template <int K, int S, typename E, bool IDW>
static int launch_split_ks(const SplitArgs& a, int B, cudaStream_t stream) {
  constexpr int Q = SPLIT_BLOCK / S;
  const size_t smem = sizeof(float) * 3 * a.wblk * a.n_blocks +
                      sizeof(int) * Q * a.k * (IDW ? 3 : 2);
  dim3 grid(a.N / Q, B);
  if constexpr (IDW)
    knn_idw_kernel<K, S, E><<<grid, SPLIT_BLOCK, smem, stream>>>(a);
  else
    knn_group_kernel<K, S, E><<<grid, SPLIT_BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int K, typename E, bool IDW>
static int launch_split_k(const SplitArgs& a, int B, cudaStream_t stream) {
#ifdef SSF_KNN_SPLIT
  return launch_split_ks<K, SSF_KNN_SPLIT, E, IDW>(a, B, stream);
#else
  switch (default_split((long)B * a.N, IDW)) {
    case 8: return launch_split_ks<K, 8, E, IDW>(a, B, stream);
    case 16: return launch_split_ks<K, 16, E, IDW>(a, B, stream);
    default: return launch_split_ks<K, 32, E, IDW>(a, B, stream);
  }
#endif
}

// the smallest compiled capacity K >= k: 3, 5, 7 (the main path's IDW),
// 8, 16 (its groupings) or 32 (MAX_K)
template <typename E, bool IDW>
static int launch_split(const SplitArgs& a, int B, cudaStream_t stream) {
  if (a.k <= 3) return launch_split_k<3, E, IDW>(a, B, stream);
  if (a.k <= 5) return launch_split_k<5, E, IDW>(a, B, stream);
  if (a.k <= 7) return launch_split_k<7, E, IDW>(a, B, stream);
  if (a.k <= 8) return launch_split_k<8, E, IDW>(a, B, stream);
  if (a.k <= 16) return launch_split_k<16, E, IDW>(a, B, stream);
  return launch_split_k<32, E, IDW>(a, B, stream);
}

static int check_shape(int N, int k, int wblk, int n_blocks) {
  if (N % QUERY_TILE != 0 || k < 1 || k > MAX_K || wblk * n_blocks > 1024)
    return (int)cudaErrorInvalidValue;
  return 0;
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
  const SplitArgs a{(const float*)query, (const float*)points, feats,
                    (const int*)b0, N, M, C, k, wblk, n_blocks, n_valid, 0.0f,
                    (float*)out_d, (int*)out_i, grouped};
  if (feats_bf16)
    return launch_split<uint16_t, false>(a, B, (cudaStream_t)stream);
  return launch_split<uint32_t, false>(a, B, (cudaStream_t)stream);
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
  const SplitArgs a{(const float*)query, (const float*)points, feats,
                    (const int*)b0, N, M, C, k, wblk, n_blocks, n_valid, eps2,
                    (float*)out_d, (int*)out_i, out};
  if (feats_bf16)
    return launch_split<__nv_bfloat16, true>(a, B, (cudaStream_t)stream);
  return launch_split<float, true>(a, B, (cudaStream_t)stream);
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
