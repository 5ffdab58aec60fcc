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
// (50 MB in bf16). On the H100 the bytes bound it (0.015 ms at 3.35 TB/s;
// the products take 0.004 ms on the bf16 tensor cores).
//
// bf16 (the main path): cost_attention_kernel, one warp per point, the
// products on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulate; wgmma wants 64-row tiles, one point has 16 or 32 rows):
// - shapes are padded in shared memory with zeros to KP = 16 or 32 rows
//   and CP, C2P channels (32, 64 or 128 and 16 to 128 at 16 rows, 128 and
//   16 to 128 at 32 rows; template parameters); padded
//   rows and columns are masked out of both softmaxes and the outputs;
// - the chain rounds to bf16 at K K + 2 K C + 2 K (C + C2) points a point,
//   and a rounding that falls the other way than the plain version's
//   cascades through the layers after it. So every rounded value is the
//   plain version's: S is summed in cuBLAS's order (one FMA after another
//   over c, on the CUDA cores; 1/15 of the products), the softmax sums in
//   torch.sum's orders, and of the tensor-core sums (q', k', both hidden
//   layers) the few that lie within a bound of a rounding boundary are
//   summed again in cuBLAS's order from shared memory, shared out over
//   the warp's lanes. The bound comes from a second product on the
//   magnitudes (sum |products|);
// - W = rnd(s1 s2) stays in registers as the A operand of
//   q' = rnd(q + W k) and goes once to shared memory, from where
//   ldmatrix.trans gives the A operand W^T of k' = rnd(k + W^T q);
// - one point's chain stays in registers: the accumulator fragments of
//   q' (k'), rounded, are the A fragments of the weightnet's first layer,
//   each 16-unit slice of that layer's output (bias, ReLU, rounded) the A
//   fragment of the second layer, whose output meets W3 in a lane-local
//   dot product and a quad shuffle. Rounded rows also go to shared
//   memory, for the recomputations. W1^T and W2^T sit in shared memory
//   once per block, rounded to bf16, as "col" B operands;
// - a persistent grid sized by occupancy: each warp takes point after
//   point; cp.async brings its q and k, then q_cost while the chain runs;
//   up to 16 warps an SM, one block sharing the weightnet, keep the card
//   busy while a warp waits for its copies; w_k and cost_fwd leave as one
//   coalesced store each. Each exp is taken once.
// The float32 instance (cost_attention_f32_kernel) is the first design,
// on CUDA cores: one warp per point, lanes over channels and hidden
// units, sequential float32 FMAs. It serves the float32 parity against
// the JAX package; TF32 tensor cores would change its results.
#include "banded_common.cuh"
#include "mma_common.cuh"

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
__global__ void cost_attention_f32_kernel(
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
      cost_attention_f32_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((rows + s.warps - 1) / s.warps);
  cost_attention_f32_kernel<T><<<grid, 32 * s.warps, bytes, stream>>>(
      (const T*)q_feat, (const T*)k_feat, (const T*)q_cost, w1, b1, w2, b2,
      w3, b3, rows, s, (T*)cost_fwd, w_k);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, one point's chain in registers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory of one block: the weightnet once, then per warp the
// point's q, k and q_cost, the attention matrix W, the rounded rows of
// the tile in flight (q' or k', then the first hidden layer) and three
// K-vectors (w_q logits, w_k logits, softmax weights). bf16 rows are
// padded by 8 elements (16 bytes), so that ldmatrix's eight row addresses
// fall in distinct banks. A block has as many warps (up to CAP) as fit in
// the SM's shared memory beside one copy of the weightnet: 16 at the main
// path's shape. A second buffer per warp, to copy the next point while
// this one computes, would leave room for 12.
template <int KP, int CP, int C2P>
struct MmaLayout {
  static constexpr int LDT = CP + 8;  // row stride of q, k, q_cost, W1^T, W2^T
  static constexpr int LDW = KP + 8;  // row stride of W
  static constexpr int TILE = KP * LDT;
  static constexpr int CH2 = C2P < 32 ? C2P : 32;  // layer-2 units a pass
  // xbuf (bf16 elements) holds a 16-row tile of q' (k'), then the lanes'
  // CH2 / 2 float32 layer-2 values each
  static constexpr int XBUF = 16 * LDT > 32 * CH2 ? 16 * LDT : 32 * CH2;
  static constexpr int WEIGHT_BYTES =
      (CP + C2P) * LDT * 2 + (CP + 2 * C2P + 4) * 4;
  static constexpr int WARP_BYTES =
      (3 * TILE + KP * LDW + XBUF + 16 * LDT) * 2 + 3 * KP * 4;
  static_assert(WEIGHT_BYTES % 16 == 0 && WARP_BYTES % 16 == 0,
                "16-byte aligned regions");
  static constexpr int SMEM_LIMIT = 227 * 1024;
  static constexpr int FIT = (SMEM_LIMIT - WEIGHT_BYTES) / WARP_BYTES;
  // 16 warps leave a thread 128 registers, which the 16-row instances up
  // to 64 channels need; ptxas spills the others at more than 4 warps
  static constexpr int CAP = KP == 16 && CP <= 64 ? 16 : 4;
  static constexpr int WARPS = FIT < CAP ? FIT : CAP;
  static_assert(WARPS >= 1, "one warp fits");
  static constexpr int BYTES = WEIGHT_BYTES + WARPS * WARP_BYTES;
};

// The rounding points of the chain, as functions of a float32 sum v: y =
// v + add rounded to bf16, after a ReLU where relu is set, monotonic in
// v. How far a tensor-core sum may lie from the plain version's: each
// float32 addition of a sum of exact products errs by at most half an ulp
// of its partial sum, below 2^-24 sum |products|; over 16 to 128 products
// the errors add up like a random walk, to about 2^-25 sum |products|
// apart between the two orders, so a margin d = 2^-22 sum |products|
// leaves several standard deviations (the worst case, every error at its
// bound and of one sign, is (n - 1) 2^-24 sum |products|); 2^-22 |y| more
// covers the rounding of y and y +- d. For a pair (y0, y1) with sums of
// |products| (m0, m1): bit e is set where a sum within the margin could
// round the other way (the ends y -+ d round apart).
// The recheck of the sums near a bf16 rounding boundary (the magnitude
// products, unsettled() and share_out). A measurement build with
// -DSSF_CA_NO_RECHECK leaves it out, so that chip_smoke.py can time what it
// costs; the shipped library always has it.
#ifdef SSF_CA_NO_RECHECK
constexpr bool kRecheck = false;
#else
constexpr bool kRecheck = true;
#endif

__device__ __forceinline__ unsigned unsettled(float y0, float y1, float m0,
                                              float m1, bool relu) {
  if constexpr (!kRecheck) return 0;
  const float s0 = m0 + fabsf(y0), s1 = m1 + fabsf(y1);
  float l0 = fmaf(-0x1p-22f, s0, y0), l1 = fmaf(-0x1p-22f, s1, y1);
  float h0 = fmaf(0x1p-22f, s0, y0), h1 = fmaf(0x1p-22f, s1, y1);
  if (relu) {
    l0 = fmaxf(l0, 0.0f);
    l1 = fmaxf(l1, 0.0f);
    h0 = fmaxf(h0, 0.0f);
    h1 = fmaxf(h1, 0.0f);
  }
  const uint32_t x = pack_bf16(l0, l1) ^ pack_bf16(h0, h1);
  return ((x & 0xffffu) != 0) | ((x >> 16) != 0) << 1;
}

// sum_m a[m sa] b[m sb] in the plain version's order: one float32 FMA
// after another, m ascending (cuBLAS's order for these products)
__device__ __forceinline__ float seq_dot(const bf16* a, int sa, const bf16* b,
                                         int sb, int n) {
  float acc = 0.0f;
#pragma unroll 8
  for (int m = 0; m < n; ++m)
    acc = fmaf(__bfloat162float(a[m * sa]), __bfloat162float(b[m * sb]), acc);
  return acc;
}

__device__ __forceinline__ uint32_t abs_bf16x2(uint32_t x) {
  return x & 0x7fff7fffu;
}

// d += a |b|: the sums of |products| that bound how far the plain
// version's sums can lie (a >= 0 or |a| given)
__device__ __forceinline__ void mma_mag(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  if constexpr (kRecheck) mma(d, a, abs_bf16x2(b0), abs_bf16x2(b1));
}

// The set bits of every lane's mask, shared out over the warp's lanes:
// fn(owner lane, bit) runs once for each, each lane taking every 32nd in
// lane order. All lanes call it.
template <typename F>
__device__ __forceinline__ void share_out(unsigned long long mask, int lane,
                                          F fn) {
  const int mine = __popcll(mask);
  int incl = mine;  // inclusive prefix of the counts over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  for (int base = 0; base < total; base += 32) {
    const int j = base + lane;
    int owner = 0;  // the lanes whose prefix is <= j
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      if (__shfl_sync(0xffffffffu, incl, owner + w - 1) <= j) owner += w;
    owner = min(owner, 31);
    const int first = __shfl_sync(0xffffffffu, incl - mine, owner);
    const unsigned lo = __shfl_sync(0xffffffffu, (unsigned)mask, owner);
    const unsigned hi = __shfl_sync(0xffffffffu, (unsigned)(mask >> 32), owner);
    if (j < total) {
      unsigned long long m = ((unsigned long long)hi << 32) | lo;
      for (int r = j - first; r > 0; --r) m &= m - 1;
      fn(owner, __ffsll(m) - 1);
    }
  }
}

template <int KP, int CP, int C2P>
__global__ void __launch_bounds__(32 * MmaLayout<KP, CP, C2P>::WARPS)
    cost_attention_kernel(
    const bf16* __restrict__ q_feat, const bf16* __restrict__ k_feat,
    const bf16* __restrict__ q_cost, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const float* __restrict__ b3, int rows, int K, int C, int C2,
    int async_copy, bf16* __restrict__ cost_fwd, float* __restrict__ w_k) {
  using L = MmaLayout<KP, CP, C2P>;
  constexpr int LDT = L::LDT, LDW = L::LDW, TILE = L::TILE, CH2 = L::CH2;
  constexpr int MT = KP / 16;  // 16-row tiles of a point
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w1t = reinterpret_cast<bf16*>(smem_raw);  // [CP][LDT]: W1^T
  bf16* w2t = w1t + CP * LDT;                      // [C2P][LDT]: W2^T
  float* sb1 = reinterpret_cast<float*>(w2t + C2P * LDT);
  float* sb2 = sb1 + CP;
  float* sw3 = sb2 + C2P;  // W3 rounded to bf16
  float* sb3 = sw3 + C2P;

  // the weightnet, transposed, rounded to bf16 and padded with zeros;
  // global reads run along W's rows
  for (int e = threadIdx.x; e < CP * CP; e += blockDim.x) {
    const int c = e / CP, o = e - c * CP;
    w1t[o * LDT + c] =
        __float2bfloat16_rn(c < C && o < C ? w1[c * C + o] : 0.0f);
  }
  for (int e = threadIdx.x; e < CP * C2P; e += blockDim.x) {
    const int o = e / C2P, o2 = e - o * C2P;
    w2t[o2 * LDT + o] =
        __float2bfloat16_rn(o < C && o2 < C2 ? w2[o * C2 + o2] : 0.0f);
  }
  for (int o = threadIdx.x; o < CP; o += blockDim.x)
    sb1[o] = o < C ? b1[o] : 0.0f;
  for (int o = threadIdx.x; o < C2P; o += blockDim.x) {
    sb2[o] = o < C2 ? b2[o] : 0.0f;
    sw3[o] = o < C2 ? round_to<bf16>(w3[o]) : 0.0f;
  }
  if (threadIdx.x == 0) sb3[0] = b3[0];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* mine =
      smem_raw + L::WEIGHT_BYTES + (size_t)warp * L::WARP_BYTES;
  bf16* sq_ = reinterpret_cast<bf16*>(mine);  // q [TILE]
  bf16* sk_ = sq_ + TILE;                      // k [TILE]
  bf16* sqc = sk_ + TILE;                      // q_cost [TILE]
  bf16* sw = sqc + TILE;                      // W [KP][LDW]
  bf16* xbuf = sw + KP * LDW;                 // q' / k' tile [16][LDT]
  bf16* hbuf = xbuf + L::XBUF;                // hidden tile [16][LDT]
  float* lq = reinterpret_cast<float*>(hbuf + 16 * LDT);  // w_q logits
  float* lk = lq + KP;                                     // w_k logits
  float* wt = lk + KP;                                     // softmax of w_q
  // zero the tiles once: the copies fill only the K x C corner
  for (int e = lane; e < 3 * TILE / 8; e += 32)
    reinterpret_cast<uint4*>(sq_)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const size_t tile_elems = (size_t)K * C;
  auto load = [&](bf16* dst, const bf16* src) {  // one [K, C] tile
    if (async_copy) {  // C % 8 == 0 and 16-byte aligned rows
      const int chunks = C / 8;
      for (int e = lane; e < K * chunks; e += 32) {
        const int i = e / chunks, ch = e - i * chunks;
        cp_async16(dst + i * LDT + 8 * ch, src + i * C + 8 * ch);
      }
    } else {
      for (int e = lane; e < K * C; e += 32) {
        const int i = e / C;
        dst[i * LDT + e - i * C] = src[e];
      }
    }
  };


  // ldmatrix row / column offsets of a lane: a pair of "col" B operands
  // ([n][k] storage), which is also the transposed A operand (.trans of
  // [k][m] storage); a pair of row-major B operands (.trans of [k][n])
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
  const int trow = (lane & 7) + 8 * ((lane >> 3) & 1), tcol = 8 * (lane >> 4);

  const int stride = gridDim.x * (blockDim.x >> 5);
  int n = blockIdx.x * (blockDim.x >> 5) + warp;
  for (; n < rows; n += stride) {
    load(sq_, q_feat + n * tile_elems);
    load(sk_, k_feat + n * tile_elems);
    cp_async_commit();
    load(sqc, q_cost + n * tile_elems);  // needed only at the end
    cp_async_commit();
    cp_async_wait<1>();  // q and k
    __syncwarp();
    const bf16* sq = sq_;
    const bf16* sk = sk_;

    // S = q k^T in the plain version's order (one FMA after another over
    // c), in the layout of m16n8 accumulator fragments: s[mt][nt][2h + e]
    // is row i = 16 mt + g + 8 h, column j = 8 nt + 2 t + e
    float s[MT][KP / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < KP / 8; ++nt)
        s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < CP; c += 2) {
      float2 qv[MT][2], kv[KP / 8][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          qv[mt][h] = load_bf16x2(sq + (16 * mt + g + 8 * h) * LDT + c);
#pragma unroll
      for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          kv[nt][e] = load_bf16x2(sk + (8 * nt + 2 * t + e) * LDT + c);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& a = s[mt][nt][2 * h + e];
              a = fmaf(qv[mt][h].x, kv[nt][e].x, a);
              a = fmaf(qv[mt][h].y, kv[nt][e].y, a);
            }
    }

    // dual softmax: s1 over the rows i of each column, s2 over the
    // columns j of each row; padded rows and columns take no part
    float cmax[KP / 8][2], rmax[MT][2];
#pragma unroll
    for (int nt = 0; nt < KP / 8; ++nt)
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
        for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * nt + 2 * t + e < K) m = fmaxf(m, s[mt][nt][2 * h + e]);
        rmax[mt][h] = m;
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int nt = 0; nt < KP / 8; ++nt)
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
    // once per element
    float e2s[MT][KP / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok =
                16 * mt + g + 8 * h < K && 8 * nt + 2 * t + e < K;
            const float v = s[mt][nt][2 * h + e];
            s[mt][nt][2 * h + e] = ok ? expf(v - cmax[nt][e]) : 0.0f;
            e2s[mt][nt][2 * h + e] = ok ? expf(v - rmax[mt][h]) : 0.0f;
          }
    // the sums in torch.sum's orders, so that W comes out as the plain
    // version's: over i (a column) four accumulators of i mod 4, combined
    // in turn; over j (a row) a halving tree over 32 (padded with zeros)
    float csum[KP / 8][2], rsum[MT][2];
#pragma unroll
    for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < KP; ++i)
          acc[i % 4] += __shfl_sync(0xffffffffu,
                                    s[i / 16][nt][2 * ((i / 8) & 1) + e],
                                    (i % 8) * 4 + t);
        csum[nt][e] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
      }
    // (lane t holds j = 2 t + e and 8 + 2 t + e (and 16 +, 24 +); a step
    // j + w with w = 4, 2 is the lane t + w / 2, and both lanes of a pair
    // add the same two numbers)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float u[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          if constexpr (KP == 32)
            u[e] = (e2s[mt][0][i] + e2s[mt][2][i]) +
                   (e2s[mt][1][i] + e2s[mt][3][i]);
          else
            u[e] = e2s[mt][0][i] + e2s[mt][1][i];
          u[e] += __shfl_xor_sync(0xffffffffu, u[e], 2);
          u[e] += __shfl_xor_sync(0xffffffffu, u[e], 1);
        }
        rsum[mt][h] = u[0] + u[1];
      }
    // W = rnd(s1 s2): A fragments aw of q' = W k, and W in shared memory
    uint32_t aw[MT][KP / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < KP / 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float w[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s1 = s[mt][nt][2 * h + e] / csum[nt][e];
            const float s2 = e2s[mt][nt][2 * h + e] / rsum[mt][h];
            const bool ok =
                16 * mt + g + 8 * h < K && 8 * nt + 2 * t + e < K;
            w[e] = ok ? s1 * s2 : 0.0f;
          }
          const uint32_t p = pack_bf16(w[0], w[1]);
          aw[mt][nt >> 1][2 * (nt & 1) + h] = p;
          *reinterpret_cast<uint32_t*>(sw + (16 * mt + g + 8 * h) * LDW +
                                       8 * nt + 2 * t) = p;
        }
    __syncwarp();

    // q' = rnd(q + W k) rows, then k' = rnd(k + W^T q) rows, 16 at a
    // time, each through the weightnet. Every rounded sum comes from the
    // tensor cores; one that lies within the margin of unsettled() of a
    // rounding boundary is summed again in the plain version's order
    // (seq_dot), from the operands in shared memory, by a lane of the warp
    // (share_out).
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      const bf16* self = side ? sk : sq;   // the rows added to
      const bf16* other = side ? sq : sk;  // the rows attended
      float* logits = side ? lk : lq;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        __syncwarp();  // the previous tile's recomputations are done
        uint32_t a[KP / 16][4];
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk) {
          if (side) {
            ldsm_x4_t(a[kk], sw + (16 * kk + brow) * LDW + 16 * mt + bcol);
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) a[kk][r] = aw[mt][kk][r];
          }
        }
        // q' (k'): W >= 0, so sum |products| is W |k| (W |q|)
        uint32_t x[CP / 16][4];
        unsigned long long redo = 0;  // bit 8 cc + 4 nt + 2 h + e
#pragma unroll
        for (int cc = 0; cc < CP / 16; ++cc) {
          float acc[2][4] = {}, mag[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < KP / 16; ++kk) {
            uint32_t b[4];
            ldsm_x4_t(b, other + (16 * kk + trow) * LDT + 16 * cc + tcol);
            mma(acc[0], a[kk], b[0], b[1]);
            mma(acc[1], a[kk], b[2], b[3]);
            mma_mag(mag[0], a[kk], b[0], b[1]);
            mma_mag(mag[1], a[kk], b[2], b[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = g + 8 * h, c = 16 * cc + 8 * nt + 2 * t;
              const float2 v = load_bf16x2(self + (16 * mt + r) * LDT + c);
              const float y0 = v.x + acc[nt][2 * h];
              const float y1 = v.y + acc[nt][2 * h + 1];
              redo |= (unsigned long long)unsettled(
                          y0, y1, mag[nt][2 * h], mag[nt][2 * h + 1], false)
                      << (8 * cc + 4 * nt + 2 * h);
              x[cc][2 * nt + h] = pack_bf16(y0, y1);
              *reinterpret_cast<uint32_t*>(xbuf + r * LDT + c) =
                  x[cc][2 * nt + h];
            }
        }
        __syncwarp();
        share_out(redo, lane, [&](int owner, int bit) {
          const int r = (owner >> 2) + 8 * ((bit >> 1) & 1);
          const int c = 16 * (bit >> 3) + 8 * ((bit >> 2) & 1) +
                        2 * (owner & 3) + (bit & 1);
          const int row = 16 * mt + r;
          const float sum =
              side ? seq_dot(sw + row, LDW, other + c, LDT, KP)
                   : seq_dot(sw + row * LDW, 1, other + c, LDT, KP);
          xbuf[r * LDT + c] = __float2bfloat16_rn(
              __bfloat162float(self[row * LDT + c]) + sum);
        });
        __syncwarp();
        if (redo) {
#pragma unroll
          for (int cc = 0; cc < CP / 16; ++cc)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                x[cc][2 * nt + h] = *reinterpret_cast<const uint32_t*>(
                    xbuf + (g + 8 * h) * LDT + 16 * cc + 8 * nt + 2 * t);
        }
        __syncwarp();  // xbuf holds the tile's rounded rows

        // weightnet layer 1: h1 = rnd(relu(x W1 + b1)), 16 units at a
        // time, kept as the A fragments of layer 2 (and in hbuf)
        uint32_t a1[CP / 16][4], xa[CP / 16][4];
#pragma unroll
        for (int cc = 0; cc < CP / 16; ++cc)
#pragma unroll
          for (int r = 0; r < 4; ++r) xa[cc][r] = abs_bf16x2(x[cc][r]);
        redo = 0;  // bit 8 hc + 4 nt + 2 h + e
#pragma unroll
        for (int hc = 0; hc < CP / 16; ++hc) {
          float acc[2][4] = {}, mag[2][4] = {};
#pragma unroll
          for (int cc = 0; cc < CP / 16; ++cc) {
            uint32_t b[4];
            ldsm_x4(b, w1t + (16 * hc + brow) * LDT + 16 * cc + bcol);
            mma(acc[0], x[cc], b[0], b[1]);
            mma(acc[1], x[cc], b[2], b[3]);
            mma_mag(mag[0], xa[cc], b[0], b[1]);
            mma_mag(mag[1], xa[cc], b[2], b[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = 16 * hc + 8 * nt + 2 * t;
              const float y0 = acc[nt][2 * h] + sb1[o];
              const float y1 = acc[nt][2 * h + 1] + sb1[o + 1];
              redo |= (unsigned long long)unsettled(
                          y0, y1, mag[nt][2 * h], mag[nt][2 * h + 1], true)
                      << (8 * hc + 4 * nt + 2 * h);
              a1[hc][2 * nt + h] =
                  pack_bf16(fmaxf(y0, 0.0f), fmaxf(y1, 0.0f));
              *reinterpret_cast<uint32_t*>(hbuf + (g + 8 * h) * LDT + o) =
                  a1[hc][2 * nt + h];
            }
        }
        __syncwarp();
        share_out(redo, lane, [&](int owner, int bit) {
          const int r = (owner >> 2) + 8 * ((bit >> 1) & 1);
          const int o = 16 * (bit >> 3) + 8 * ((bit >> 2) & 1) +
                        2 * (owner & 3) + (bit & 1);
          const float sum = seq_dot(xbuf + r * LDT, 1, w1t + o * LDT, 1, CP);
          hbuf[r * LDT + o] = __float2bfloat16_rn(fmaxf(sum + sb1[o], 0.0f));
        });
        __syncwarp();
        if (redo) {
#pragma unroll
          for (int hc = 0; hc < CP / 16; ++hc)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                a1[hc][2 * nt + h] = *reinterpret_cast<const uint32_t*>(
                    hbuf + (g + 8 * h) * LDT + 16 * hc + 8 * nt + 2 * t);
        }
        __syncwarp();  // hbuf holds the tile's first hidden layer; xbuf
                       // is free for the lanes' layer-2 slots

        // weightnet layer 2, CH2 units a pass (h1 >= 0 is its own
        // magnitude), and its dot product with W3: each lane's part of the
        // logits of rows g and g + 8, then the quad's sum
        float part[2] = {0.0f, 0.0f};
        float* slots = reinterpret_cast<float*>(xbuf);  // CH2 / 2 a lane
        float* slot = slots + lane * (CH2 / 2);
#pragma unroll
        for (int p2 = 0; p2 < C2P / CH2; ++p2) {
          float acc[CH2 / 8][4] = {}, mag[CH2 / 8][4] = {};
#pragma unroll
          for (int hc = 0; hc < CP / 16; ++hc)
#pragma unroll
            for (int np = 0; np < CH2 / 16; ++np) {
              uint32_t b[4];
              ldsm_x4(b, w2t + (CH2 * p2 + 16 * np + brow) * LDT + 16 * hc +
                             bcol);
              mma(acc[2 * np], a1[hc], b[0], b[1]);
              mma(acc[2 * np + 1], a1[hc], b[2], b[3]);
              mma_mag(mag[2 * np], a1[hc], b[0], b[1]);
              mma_mag(mag[2 * np + 1], a1[hc], b[2], b[3]);
            }
          unsigned redo2 = 0;
#pragma unroll
          for (int nt = 0; nt < CH2 / 8; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int o = CH2 * p2 + 8 * nt + 2 * t;
              const float y0 = acc[nt][2 * h] + sb2[o];
              const float y1 = acc[nt][2 * h + 1] + sb2[o + 1];
              redo2 |= unsettled(y0, y1, mag[nt][2 * h], mag[nt][2 * h + 1],
                                 true)
                       << (4 * nt + 2 * h);
              acc[nt][2 * h] = round_to<bf16>(fmaxf(y0, 0.0f));
              acc[nt][2 * h + 1] = round_to<bf16>(fmaxf(y1, 0.0f));
            }
          if (redo2) {  // recomputed values come back through the slot
#pragma unroll
            for (int nt = 0; nt < CH2 / 8; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) slot[4 * nt + r] = acc[nt][r];
          }
          __syncwarp();
          share_out(redo2, lane, [&](int owner, int bit) {
            const int r = (owner >> 2) + 8 * ((bit >> 1) & 1);
            const int o =
                CH2 * p2 + 8 * (bit >> 2) + 2 * (owner & 3) + (bit & 1);
            const float sum = seq_dot(hbuf + r * LDT, 1, w2t + o * LDT, 1, CP);
            slots[owner * (CH2 / 2) + bit] =
                round_to<bf16>(fmaxf(sum + sb2[o], 0.0f));
          });
          __syncwarp();
          if (redo2) {
#pragma unroll
            for (int nt = 0; nt < CH2 / 8; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[nt][r] = slot[4 * nt + r];
          }
#pragma unroll
          for (int nt = 0; nt < CH2 / 8; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              part[r >> 1] = fmaf(acc[nt][r],
                                  sw3[CH2 * p2 + 8 * nt + 2 * t + (r & 1)],
                                  part[r >> 1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          part[h] += __shfl_xor_sync(0xffffffffu, part[h], 1);
          part[h] += __shfl_xor_sync(0xffffffffu, part[h], 2);
          if (t == 0) logits[16 * mt + g + 8 * h] = part[h] + sb3[0];
        }
      }
    }
    __syncwarp();

    // cost_fwd = sum_i softmax_i(w_q)[i] q_cost[i] in float32; w_k out
    cp_async_wait<0>();
    __syncwarp();
    const float l = lane < K ? lq[lane] : -INFINITY;
    const float m = warp_max(l);
    const float e = lane < K ? expf(l - m) : 0.0f;
    const float sum = warp_sum(e);
    if (lane < K) {
      wt[lane] = e / sum;
      w_k[(size_t)n * K + lane] = lk[lane];
    }
    __syncwarp();
    for (int c = 2 * lane; c < C; c += 64) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int i = 0; i < K; ++i) {
        const float2 v = load_bf16x2(sqc + i * LDT + c);
        a0 = fmaf(wt[i], v.x, a0);
        a1 = fmaf(wt[i], v.y, a1);
      }
      bf16* out = cost_fwd + (size_t)n * C + c;
      if ((C & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a0, a1);
      } else {
        out[0] = __float2bfloat16_rn(a0);
        if (c + 1 < C) out[1] = __float2bfloat16_rn(a1);
      }
    }
    __syncwarp();  // the tiles are refilled by the next iteration
  }
}

template <int KP, int CP, int C2P>
int launch_mma(const void* q_feat, const void* k_feat, const void* q_cost,
               const float* w1, const float* b1, const float* w2,
               const float* b2, const float* w3, const float* b3, int rows,
               int K, int C, int C2, void* cost_fwd, float* w_k,
               cudaStream_t stream) {
  using L = MmaLayout<KP, CP, C2P>;
  auto kernel = cost_attention_kernel<KP, CP, C2P>;
  const int warps = L::WARPS, bytes = L::BYTES;
  // the attribute and the occupancy belong to the current device: set and
  // found on every call (cheap beside the launch), not cached
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      32 * warps, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid_max = per_sm * sms;
  const int blocks = (rows + warps - 1) / warps;
  const int grid = blocks < grid_max ? blocks : grid_max;
  // cp.async needs 16-byte rows: C % 8 == 0 and aligned tensors
  const int async_copy =
      C % 8 == 0 &&
      ((uintptr_t)q_feat | (uintptr_t)k_feat | (uintptr_t)q_cost) % 16 == 0;
  kernel<<<grid, 32 * warps, bytes, stream>>>(
      (const bf16*)q_feat, (const bf16*)k_feat, (const bf16*)q_cost, w1, b1,
      w2, b2, w3, b3, rows, K, C, C2, async_copy, (bf16*)cost_fwd, w_k);
  return (int)cudaGetLastError();
}

template <int KP, int CP>
int launch_mma_c2(int C2, const void* q_feat, const void* k_feat,
                  const void* q_cost, const float* w1, const float* b1,
                  const float* w2, const float* b2, const float* w3,
                  const float* b3, int rows, int K, int C, void* cost_fwd,
                  float* w_k, cudaStream_t stream) {
#define SSF_MMA(C2P)                                                      \
  return launch_mma<KP, CP, C2P>(q_feat, k_feat, q_cost, w1, b1, w2, b2,  \
                                 w3, b3, rows, K, C, C2, cost_fwd, w_k,   \
                                 stream)
  if (C2 <= 16) SSF_MMA(16);
  if (C2 <= 32) SSF_MMA(32);
  if (C2 <= 64) SSF_MMA(64);
  SSF_MMA(128);
#undef SSF_MMA
}

// K <= 32, C <= 128, C2 <= 128 rounded up to the kernel's instances; a
// 32-row point takes 128 channels (at 32 and 64 ptxas spills its registers)
int launch_bf16(const void* q_feat, const void* k_feat, const void* q_cost,
                const float* w1, const float* b1, const float* w2,
                const float* b2, const float* w3, const float* b3, int rows,
                int K, int C, int C2, void* cost_fwd, float* w_k,
                cudaStream_t stream) {
#define SSF_MMA(KP, CP)                                                   \
  return launch_mma_c2<KP, CP>(C2, q_feat, k_feat, q_cost, w1, b1, w2, b2, \
                               w3, b3, rows, K, C, cost_fwd, w_k, stream)
  if (K <= 16) {
    if (C <= 32) SSF_MMA(16, 32);
    if (C <= 64) SSF_MMA(16, 64);
    SSF_MMA(16, 128);
  }
  SSF_MMA(32, 128);
#undef SSF_MMA
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
    return launch_bf16(q_feat, k_feat, q_cost, (const float*)w1,
                       (const float*)b1, (const float*)w2, (const float*)b2,
                       (const float*)w3, (const float*)b3, rows, K, C, C2,
                       cost_fwd, (float*)w_k, s);
  return launch<float>(q_feat, k_feat, q_cost, (const float*)w1,
                       (const float*)b1, (const float*)w2, (const float*)b2,
                       (const float*)w3, (const float*)b3, rows, K, C, C2,
                       cost_fwd, (float*)w_k, s);
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
