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
// it on the H100 (20 us at 3.35 TB/s; the products take about 1 us on the
// bf16 tensor cores, data-sheet rates).
//
// Two bodies; the caller names the one to run (ops/attention.py::
// attention_body), and neither gives way to the other.
//
// "mma" (bf16, K <= 32, C <= 128): attention_mma_kernel<KP, CP>, one warp
// per point on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulate):
// - shapes are padded in shared memory with zeros to KP = 16 or 32 rows
//   and CP = 32, 64 or 128 channels (template parameters); zero channels
//   add nothing to S, and padded rows and columns are masked out of both
//   softmaxes and of W;
// - S = q k^T: q is the A operand (ldmatrix), k the "col" B operand
//   straight from ldmatrix: 8 MMAs a point at K = 16, C = 64. The products
//   of bf16 values are exact in float32; only the order (and the tensor
//   cores' own way) of summing them differs from the plain version's;
// - the dual softmax runs on the accumulator fragments in registers: row
//   statistics with quad shuffles, column statistics with shuffles across
//   the eight row groups, each of the two exps of an element taken once;
// - W stays float32 as three bf16 planes, W0 = bf16(W), W1 = bf16(W - W0),
//   W2 = bf16(W - W0 - W1): each residual is exact in float32 and the
//   third plane holds what is left, so W0 + W1 + W2 = W wherever |W| >=
//   2^-110 (below that the last plane's bits fall under bf16's subnormal
//   step, 2^-133), and every product with a bf16 q or k is exact. One
//   float32 accumulator takes the planes smallest first;
// - q' = q + sum_p W_p k: the W_p fragments built from S's accumulators
//   are the A operands as they stand (FlashAttention's P V layout), k comes
//   in through ldmatrix.trans; k' = k + sum_p W_p^T q: the planes go once
//   to shared memory, from where ldmatrix.trans gives the A operands W_p^T.
//   3 x 8 MMAs each at C = 64;
// - q' rows are staged in shared memory and k' rows written over k in
//   place (each lane rewrites only what it alone read), then both leave as
//   16-byte coalesced stores: a point's q' and k' are contiguous blocks;
// - a persistent grid sized by occupancy, four warps a block: each warp
//   takes point after point with two input buffers, so that cp.async
//   16-byte copies bring the next point's q and k while this one computes.
//   Rows are padded by 8 elements (16 bytes), so that ldmatrix's eight row
//   addresses fall in distinct banks. Up to 16 warps an SM at the main
//   shape.
//
// "simt" (float32, and bf16 with C > 128): attention_kernel<T>, the first
// design, on the CUDA cores: one warp per query point, several per block.
// Each warp stages its point's q and k tiles into padded float32 shared
// rows (coalesced over channels), lanes own entries of S and W and then
// channels of q' and k', so every output store is coalesced and no lane
// reads what another lane writes between the warp barriers. It serves the
// float32 parity with the JAX package (TF32 tensor cores would change its
// results) and channel counts up to 512. (Keeping each exp in shared
// memory, so that it is taken once and not twice, measured 1.40x slower
// in float32 at [8192, 16, 64] on the H100; the body takes them twice.)
#include "banded_common.cuh"
#include "mma_common.cuh"

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
int launch_simt(const void* q_feat, const void* k_feat, int rows, int K,
                int C, void* q_att, void* k_att, cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// bf16: tensor cores, one point's chain in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// Shared memory of one warp: two input buffers (q, k), the q' rows and the
// three planes of W. bf16 rows are padded by 8 elements (16 bytes), so
// that ldmatrix's eight row addresses fall in distinct banks.
template <int KP, int CP>
struct AttnLayout {
  static constexpr int LDT = CP + 8;  // row stride of q, k, q'
  static constexpr int LDW = KP + 8;  // row stride of a plane of W
  static constexpr int TILE = KP * LDT;
  static constexpr int PLANE = KP * LDW;
  static constexpr int WARP_BYTES = (5 * TILE + 3 * PLANE) * 2;
  static_assert(WARP_BYTES % 16 == 0 && (TILE * 2) % 16 == 0 &&
                    (PLANE * 2) % 16 == 0,
                "16-byte aligned regions");
  static constexpr int WARPS = 4;  // a block
  static constexpr int BYTES = WARPS * WARP_BYTES;
  static_assert(BYTES <= 227 * 1024, "one block fits an SM");
  // 16-row points: 4 blocks (16 warps) an SM leave a thread 128 registers
  static constexpr int MIN_BLOCKS = KP == 16 ? 4 : 2;
};

template <int KP, int CP>
__global__ void __launch_bounds__(32 * AttnLayout<KP, CP>::WARPS,
                                  AttnLayout<KP, CP>::MIN_BLOCKS)
    attention_mma_kernel(const bf16* __restrict__ q_feat,
                         const bf16* __restrict__ k_feat, int rows, int K,
                         int C, int vec, bf16* __restrict__ q_att,
                         bf16* __restrict__ k_att) {
  using L = AttnLayout<KP, CP>;
  constexpr int LDT = L::LDT, LDW = L::LDW, TILE = L::TILE, PLANE = L::PLANE;
  constexpr int MT = KP / 16, NT = KP / 8, CT = CP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw + (size_t)warp * L::WARP_BYTES);
  bf16* stage = bufs + 4 * TILE;  // q' rows [KP][LDT]
  bf16* planes = stage + TILE;    // W_0, W_1, W_2, each [KP][LDW]
  // zero the input buffers once: the copies fill only the K x C corner
  for (int e = lane; e < 4 * TILE / 8; e += 32)
    reinterpret_cast<uint4*>(bufs)[e] = make_uint4(0, 0, 0, 0);
  __syncwarp();

  // one [K, C] tile between device memory and padded shared rows, in
  // 16-byte units where vec (C % 8 == 0 and 16-byte aligned tensors)
  const size_t tile_elems = (size_t)K * C;
  auto load = [&](bf16* dst, const bf16* src) {
    if (vec) {
      const int chunks = C >> 3;
      for (int e = lane; e < K * chunks; e += 32) {
        const int i = e / chunks;
        cp_async16(dst + i * LDT + 8 * (e - i * chunks), src + 8 * e);
      }
    } else {
      for (int e = lane; e < K * C; e += 32) {
        const int i = e / C;
        dst[i * LDT + e - i * C] = src[e];
      }
    }
  };
  auto store = [&](bf16* dst, const bf16* src) {
    if (vec) {
      const int chunks = C >> 3;
      for (int e = lane; e < K * chunks; e += 32) {
        const int i = e / chunks;
        *reinterpret_cast<uint4*>(dst + 8 * e) =
            *reinterpret_cast<const uint4*>(src + i * LDT +
                                            8 * (e - i * chunks));
      }
    } else {
      for (int e = lane; e < K * C; e += 32) {
        const int i = e / C;
        dst[e] = src[i * LDT + e - i * C];
      }
    }
  };

  // ldmatrix row / column offsets of a lane: a pair of "col" B operands
  // ([n][k] storage), which is also the transposed A operand (.trans of
  // [k][m] storage); an A operand ([m][k] storage), which is also a pair
  // of row-major B operands (.trans of [k][n] storage)
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
  const int trow = (lane & 7) + 8 * ((lane >> 3) & 1), tcol = 8 * (lane >> 4);

  const int stride = gridDim.x * L::WARPS;
  int n = blockIdx.x * L::WARPS + warp;
  if (n < rows) {
    load(bufs, q_feat + n * tile_elems);
    load(bufs + TILE, k_feat + n * tile_elems);
  }
  cp_async_commit();
#pragma unroll 1
  for (int it = 0; n < rows; n += stride, ++it) {
    const bf16* sq = bufs + (it & 1) * 2 * TILE;
    bf16* sk = bufs + (it & 1) * 2 * TILE + TILE;
    const int next = n + stride;
    if (next < rows) {  // the next point's copies fly while this one runs
      bf16* nq = bufs + ((it + 1) & 1) * 2 * TILE;
      load(nq, q_feat + next * tile_elems);
      load(nq + TILE, k_feat + next * tile_elems);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this point's q and k
    __syncwarp();

    // S = q k^T in m16n8 accumulator fragments: s[mt][nt][2h + e] is row
    // i = 16 mt + g + 8 h, column j = 8 nt + 2 t + e
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CT; ++cc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], sq + (16 * mt + trow) * LDT + 16 * cc + tcol);
#pragma unroll
      for (int jt = 0; jt < MT; ++jt) {
        uint32_t b[4];
        ldsm_x4(b, sk + (16 * jt + brow) * LDT + 16 * cc + bcol);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * jt], a[mt], b[0], b[1]);
          mma(s[mt][2 * jt + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // dual softmax: s1 over the rows i of each column, s2 over the
    // columns j of each row; padded rows and columns take no part
    float cmax[NT][2], rmax[MT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float m = -INFINITY;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (16 * mt + g + 8 * h < K) m = fmaxf(m, s[mt][nt][2 * h + e]);
        cmax[nt][e] = m;
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * nt + 2 * t + e < K) m = fmaxf(m, s[mt][nt][2 * h + e]);
        rmax[mt][h] = m;
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cmax[nt][e] = fmaxf(cmax[nt][e],
                              __shfl_xor_sync(0xffffffffu, cmax[nt][e], o));
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rmax[mt][h] = fmaxf(rmax[mt][h],
                              __shfl_xor_sync(0xffffffffu, rmax[mt][h], o));
    // e1 = exp(S - column max) in s, e2 = exp(S - row max) in e2s, each
    // once per element, and their sums
    float e2s[MT][NT][4];
    float csum[NT][2] = {}, rsum[MT][2] = {};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok =
                16 * mt + g + 8 * h < K && 8 * nt + 2 * t + e < K;
            const float v = s[mt][nt][2 * h + e];
            const float e1 = ok ? expf(v - cmax[nt][e]) : 0.0f;
            const float e2 = ok ? expf(v - rmax[mt][h]) : 0.0f;
            s[mt][nt][2 * h + e] = e1;
            e2s[mt][nt][2 * h + e] = e2;
            csum[nt][e] += e1;
            rsum[mt][h] += e2;
          }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          csum[nt][e] += __shfl_xor_sync(0xffffffffu, csum[nt][e], o);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rsum[mt][h] += __shfl_xor_sync(0xffffffffu, rsum[mt][h], o);

    // W = s1 s2 in float32, as three bf16 planes: aw[p] are the A
    // fragments of q' = W k (two n8 accumulator tiles make one k16 A
    // tile), and each plane goes to shared memory for W^T
    uint32_t aw[3][MT][MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok =
                16 * mt + g + 8 * h < K && 8 * nt + 2 * t + e < K;
            const float s1 = s[mt][nt][2 * h + e] / csum[nt][e];
            const float s2 = e2s[mt][nt][2 * h + e] / rsum[mt][h];
            w[e] = ok ? s1 * s2 : 0.0f;
          }
          const int at = (16 * mt + g + 8 * h) * LDW + 8 * nt + 2 * t;
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const uint32_t x = pack_bf16(w[0], w[1]);
            const float2 f = unpack_bf16(x);
            w[0] -= f.x;  // exact: the residual of a rounding to bf16
            w[1] -= f.y;
            aw[p][mt][nt >> 1][2 * (nt & 1) + h] = x;
            *reinterpret_cast<uint32_t*>(planes + p * PLANE + at) = x;
          }
        }

    // q' = rnd(q + sum_p W_p k), 16 rows at a time, the smallest plane
    // first, into the stage
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        uint32_t b[MT][4];
#pragma unroll
        for (int kk = 0; kk < MT; ++kk)
          ldsm_x4_t(b[kk], sk + (16 * kk + trow) * LDT + 16 * cc + tcol);
        float acc[2][4] = {};
#pragma unroll
        for (int p = 2; p >= 0; --p)
#pragma unroll
          for (int kk = 0; kk < MT; ++kk) {
            mma(acc[0], aw[p][mt][kk], b[kk][0], b[kk][1]);
            mma(acc[1], aw[p][mt][kk], b[kk][2], b[kk][3]);
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = (16 * mt + g + 8 * h) * LDT + 16 * cc + 8 * nt +
                           2 * t;
            const float2 v = load_bf16x2(sq + at);
            *reinterpret_cast<uint32_t*>(stage + at) = pack_bf16(
                v.x + acc[nt][2 * h], v.y + acc[nt][2 * h + 1]);
          }
      }
    __syncwarp();  // the planes are in shared memory; k is read by q'

    // k' = rnd(k + sum_p W_p^T q), 16 rows j at a time, over k in place
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[3][MT][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int kk = 0; kk < MT; ++kk)
          ldsm_x4_t(a[p][kk], planes + p * PLANE + (16 * kk + brow) * LDW +
                                  16 * mt + bcol);
#pragma unroll
      for (int cc = 0; cc < CT; ++cc) {
        uint32_t b[MT][4];
#pragma unroll
        for (int kk = 0; kk < MT; ++kk)
          ldsm_x4_t(b[kk], sq + (16 * kk + trow) * LDT + 16 * cc + tcol);
        float acc[2][4] = {};
#pragma unroll
        for (int p = 2; p >= 0; --p)
#pragma unroll
          for (int kk = 0; kk < MT; ++kk) {
            mma(acc[0], a[p][kk], b[kk][0], b[kk][1]);
            mma(acc[1], a[p][kk], b[kk][2], b[kk][3]);
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = (16 * mt + g + 8 * h) * LDT + 16 * cc + 8 * nt +
                           2 * t;
            const float2 v = load_bf16x2(sk + at);
            *reinterpret_cast<uint32_t*>(sk + at) = pack_bf16(
                v.x + acc[nt][2 * h], v.y + acc[nt][2 * h + 1]);
          }
      }
    }
    __syncwarp();  // q' in the stage, k' in the buffer
    store(q_att + n * tile_elems, stage);
    store(k_att + n * tile_elems, sk);
    __syncwarp();  // the buffer is refilled two points on
  }
}

template <int KP, int CP>
int launch_mma(const void* q_feat, const void* k_feat, int rows, int K, int C,
               void* q_att, void* k_att, cudaStream_t stream) {
  using L = AttnLayout<KP, CP>;
  auto kernel = attention_mma_kernel<KP, CP>;
  // the attribute and the occupancy belong to the current device: set and
  // found on every call, not cached
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * L::WARPS, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid_max = per_sm * sms;
  const int blocks = (rows + L::WARPS - 1) / L::WARPS;
  const int grid = blocks < grid_max ? blocks : grid_max;
  // 16-byte copies need 16-byte rows: C % 8 == 0 and aligned tensors
  const uintptr_t ptrs = (uintptr_t)q_feat | (uintptr_t)k_feat |
                         (uintptr_t)q_att | (uintptr_t)k_att;
  const int vec = C % 8 == 0 && ptrs % 16 == 0;
  kernel<<<grid, 32 * L::WARPS, L::BYTES, stream>>>(
      (const bf16*)q_feat, (const bf16*)k_feat, rows, K, C, vec,
      (bf16*)q_att, (bf16*)k_att);
  return (int)cudaGetLastError();
}

// K <= 32, C <= 128 rounded up to the kernel's instances
int launch_bf16_mma(const void* q_feat, const void* k_feat, int rows, int K,
                    int C, void* q_att, void* k_att, cudaStream_t stream) {
#define SSF_MMA(KP, CP) \
  return launch_mma<KP, CP>(q_feat, k_feat, rows, K, C, q_att, k_att, stream)
  if (K <= 16) {
    if (C <= 32) SSF_MMA(16, 32);
    if (C <= 64) SSF_MMA(16, 64);
    SSF_MMA(16, 128);
  }
  if (C <= 32) SSF_MMA(32, 32);
  if (C <= 64) SSF_MMA(32, 64);
  SSF_MMA(32, 128);
#undef SSF_MMA
}

}  // namespace

extern "C" {

// q_feat, k_feat [rows, K, C] (float32 or bf16, one type)
// -> q_att, k_att [rows, K, C] in that type. body: 0 the CUDA-core body
// (either type, K <= 32, C <= 512), 1 the tensor-core body (bf16, K <= 32,
// C <= 128); a body that does not take the call returns
// cudaErrorInvalidValue. Returns a cudaError_t code.
int ssf_attention(const void* q_feat, const void* k_feat, int rows, int K,
                  int C, int feats_bf16, int body, void* q_att, void* k_att,
                  void* stream) {
  if (K < 1 || K > 32 || C < 1 || C > 512 || body < 0 || body > 1 ||
      (body == 1 && (!feats_bf16 || C > 128)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (body == 1)
    return launch_bf16_mma(q_feat, k_feat, rows, K, C, q_att, k_att, s);
  if (feats_bf16)
    return launch_simt<__nv_bfloat16>(q_feat, k_feat, rows, K, C, q_att,
                                      k_att, s);
  return launch_simt<float>(q_feat, k_feat, rows, K, C, q_att, k_att, s);
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
