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
//   scatter softmax-sum: out[idx[n, j], :C] += rnd(v[n, j, :] * e),
//            out[idx, C] += rnd(e) with e = exp(w_shift[n, j]) and rnd the
//            bf16 round trip when the values are bf16 (the TPU kernel rounds
//            its matmul operands to bf16, banded.py:656) and the identity
//            for float32; rows out of the band add nothing. The caller
//            zero-fills out [B, n_out, C + 1] float32 and divides by the
//            last column.
//
// What bounds them on the H100: all three are pure data movement. At the main
// path's level 0 (N = 8192, k = 16, C = 64, bf16) regroup writes 16.8 MB and
// the softmax-sum reads 16.8 MB of values: bytes bound both (0.005-0.006
// ms at 3.35 TB/s). What the bound does not count is latency: each row
// waits on an index load before its value load, so a kernel reaches the
// bound only with many rows in flight.
//
// Regroup: a warp takes 32 consecutive rows of out (one chunk; a query tile
// holds 256 k rows, so a chunk never crosses a tile and the band is looked
// up once a chunk). Each lane reads one index (one coalesced load) and keeps
// its source row, or -1 out of band. The chunk is then copied in units of
// VW bytes (16 where the row width and the pointers allow, down to 2):
// unit x of the chunk (x = lane + 32 s) is unit x % nv of row x / nv, so
// every store instruction writes 32 neighbouring units of out. A lane
// issues the loads of up to kRegroupUnits units (their source rows by
// shuffle) before it stores them; out-of-band rows store zeros without a
// load. feats (1 MB at level 0) stays in L2.
//
// Scatter (both): the TPU kernel keeps its output resident in VMEM and
// scatters with transposed one-hot MXU matmuls. Here one templated body
// sums each query tile's entries by band row before anything reaches device
// memory: a block takes one part of a query tile (256 / parts queries) and
// one slice of at most 32 x CL value columns (the softmax-sum's last slice
// also sums column C, the e column). It counting-sorts the part's in-band
// entries by band row in shared memory (integer atomics; for the
// softmax-sum each hit's e = expf(w) is kept beside its key); then each
// warp takes a contiguous range of the sorted entries, loads kScatterBatch
// value rows at once (lane g: CL neighbouring channels, one load of VEC
// elements, where C and the pointer allow it; else channels g and g + 32,
// one element a load), adds them in registers and, where the row changes,
// adds the row's sums into device memory with float32 atomics: one for
// each (band row the part reaches, column, warp range it spans) in place
// of one for each (n, j, column). A band
// accumulator in shared memory with float32 shared-memory atomics, tried
// first, was slower: those atomics set its pace (PERF.md, §6). Atomic
// order varies from run to run, so the sums match a sequential sum only to
// rounding. The caller still zero-fills out.
#include "banded_common.cuh"

#define FULL_MASK 0xffffffffu

// ---------------------------------------------------------------------------
// regroup
// ---------------------------------------------------------------------------

template <int VW>
struct Unit;  // the type that moves VW bytes, and its zero
template <>
struct Unit<16> {
  typedef uint4 type;
  static __device__ __forceinline__ uint4 zero() {
    return make_uint4(0, 0, 0, 0);
  }
};
template <>
struct Unit<8> {
  typedef uint2 type;
  static __device__ __forceinline__ uint2 zero() { return make_uint2(0, 0); }
};
template <>
struct Unit<4> {
  typedef unsigned int type;
  static __device__ __forceinline__ unsigned int zero() { return 0u; }
};
template <>
struct Unit<2> {
  typedef unsigned short type;
  static __device__ __forceinline__ unsigned short zero() { return 0; }
};

static const int kRegroupWarps = 8;
static const int kRegroupUnits = 8;  // units a lane loads before it stores

// Block: kRegroupWarps warps, each taking chunks of 32 rows of out in turn.
// feats [B, M, nv units], out [B * N * k rows, nv units]; 0 bits is the zero
// of both element types.
template <int VW>
__global__ void __launch_bounds__(32 * kRegroupWarps)
    regroup_kernel(const int* __restrict__ idx,
                   const typename Unit<VW>::type* __restrict__ feats,
                   const int* __restrict__ b0, int N, int M, int k, int nv,
                   int wblk, int n_blocks, int chunks,
                   typename Unit<VW>::type* __restrict__ out) {
  typedef typename Unit<VW>::type U;
  const int lane = threadIdx.x & 31;
  const int per_tile = QUERY_TILE * k;  // rows of a query tile
  const int tiles = N / QUERY_TILE;
  const int band = wblk * n_blocks;
  // unit x = lane + 32 s of a chunk lies in row x / nv, at unit x % nv;
  // from s to s + 1, x grows by 32 = dq * nv + du
  const int q0 = lane / nv, u0 = lane - q0 * nv;
  const int dq = 32 / nv, du = 32 - dq * nv;
  for (int ch = blockIdx.x * kRegroupWarps + (threadIdx.x >> 5); ch < chunks;
       ch += gridDim.x * kRegroupWarps) {
    const int e0 = ch * 32;            // first row of out in the chunk
    const int bt = e0 / per_tile;      // b * tiles + t
    const int b = bt / tiles;
    const int base = b0[bt] * wblk;
    const int i = idx[e0 + lane];
    // in band, and inside the cloud (a band can reach past M: zeros there)
    const int src = i >= base && i - base < band && i < M ? b * M + i : -1;
    U* o = out + (size_t)e0 * nv + lane;
    int q = q0, u = u0;
    for (int s0 = 0; s0 < nv; s0 += kRegroupUnits) {
      U got[kRegroupUnits];
#pragma unroll
      for (int s = 0; s < kRegroupUnits; ++s) {
        got[s] = Unit<VW>::zero();
        if (s0 + s < nv) {  // warp-uniform
          const int r = __shfl_sync(FULL_MASK, src, q & 31);
          if (r >= 0) got[s] = __ldg(feats + (size_t)r * nv + u);
          u += du;
          q += dq;
          if (u >= nv) {
            u -= nv;
            ++q;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kRegroupUnits; ++s)
        if (s0 + s < nv) o[32 * (s0 + s)] = got[s];
    }
  }
}

// ---------------------------------------------------------------------------
// scatter-add and scatter softmax-sum: one body
// ---------------------------------------------------------------------------

static const int kScatterWarps = 16;
static const int kScatterBatch = 8;  // sorted entries loaded before adding
// elements a lane reads with one load where C and the values' pointer allow
// it (measurement builds set it with -DSSF_SCATTER_VEC=1 or 4); a lane
// takes max(2, VEC) neighbouring channels of a row
#ifndef SSF_SCATTER_VEC
#define SSF_SCATTER_VEC 2
#endif
static const int kScatterVec = SSF_SCATTER_VEC;

// VEC elements of T at p into 32-bit words (a bf16 alone sits in the high
// half of its word, so that its bits are its float32 value)
template <typename T, int VEC>
__device__ __forceinline__ void load_values(const T* p, unsigned* w) {
  constexpr int bytes = VEC * (int)sizeof(T);
  if constexpr (bytes == 2) {
    w[0] = (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16;
  } else if constexpr (bytes == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (bytes == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
    static_assert(bytes == 16, "loads of 2 to 16 bytes");
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  }
}

// element j (a compile-time index) of one load's words, as float32
template <typename T, int VEC>
__device__ __forceinline__ float value_at(const unsigned* w, int j) {
  if constexpr (sizeof(T) == 4 || VEC == 1) {
    return __uint_as_float(w[j]);
  } else {
    const unsigned x = w[j >> 1];
    return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// Exclusive prefix sums of a[0, n) in place, by every thread of the block;
// returns the total. wsum: 33 ints of shared memory.
__device__ int block_exclusive_scan(int* a, int n, int* wsum) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int sum = 0;
  for (int x = lo; x < hi; ++x) sum += a[x];
  int inc = sum;  // inclusive over the warp's lanes
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < (int)(blockDim.x >> 5) ? wsum[lane] : 0;
    int tot = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, tot, d);
      if (lane >= d) tot += y;
    }
    __syncwarp();
    wsum[lane] = tot - own;
    if (lane == 31) wsum[32] = tot;
  }
  __syncthreads();
  int run = wsum[warp] + inc - sum;
  for (int x = lo; x < hi; ++x) {
    const int c = a[x];
    a[x] = run;
    run += c;
  }
  const int total = wsum[32];
  __syncthreads();
  return total;
}

// Adds a lane's sums of one band row into out (row: the slice's first
// column; the lane's channels ch0 + j * dch below w), one atomic a nonzero
// sum, and the e column's sum where e_here.
template <int CL>
__device__ __forceinline__ void add_row(float* row, const float (&acc)[CL],
                                        int ch0, int dch, int w, bool e_here,
                                        float e_acc) {
#pragma unroll
  for (int j = 0; j < CL; ++j)
    if (ch0 + j * dch < w && acc[j] != 0.0f)
      atomicAdd(row + ch0 + j * dch, acc[j]);
  if (e_here && e_acc != 0.0f) atomicAdd(row + w, e_acc);
}

// Grid (slices * parts * tiles, B): blockIdx.x = (t * parts + p) * slices + s.
// Block (t, p, s) of batch row b takes entries [p * 256 / parts, (p + 1) *
// 256 / parts) of query tile t (times k) and value columns [s * W, min(s * W
// + W, C)) (with kAug, column C too in the last slice). It sorts the
// entries that lie in the tile's band (below n_out) by band row in shared
// memory (a count a row, prefix sums, a place a hit), then each warp sums a
// contiguous range of the sorted entries: kScatterBatch value rows loaded
// at once, added in registers (lane g: channels g + 32 j with loads of one
// element, else g * CL + j, j < CL), a row's
// sums added into out [B, n_out, C + kAug] with float32 atomics when the
// row changes. No float atomics in shared memory: they set the pace of the
// band accumulator this replaces (PERF.md, §6).
template <typename T, bool kAug, int VEC>
__global__ void __launch_bounds__(32 * kScatterWarps)
    scatter_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                   const float* __restrict__ w_shift,
                   const int* __restrict__ b0, int N, int C, int k, int n_out,
                   int wblk, int n_blocks, int W, int parts,
                   float* __restrict__ out) {
  constexpr int CL = VEC > 2 ? VEC : 2;  // channels a lane
  constexpr int kLoads = CL / VEC;        // loads a lane and row
  constexpr int kWords = VEC * (int)sizeof(T) >= 4 ? VEC * (int)sizeof(T) / 4
                                                   : 1;  // words a load
  extern __shared__ int smem[];
  __shared__ int wsum[33];
  const int slices = (C + W - 1) / W;
  const int s = blockIdx.x % slices;
  const int p = (blockIdx.x / slices) % parts;
  const int t = blockIdx.x / (slices * parts);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = s * W;
  const int w = min(W, C - c0);  // value columns of this slice
  const bool e_col = kAug && s == slices - 1;  // this slice sums column C
  const int base = band_base(b0, b, t * QUERY_TILE, N / QUERY_TILE, wblk);
  const int rows = min(wblk * n_blocks, n_out - base);  // band rows kept
  if (rows <= 0) return;
  const int per = QUERY_TILE / parts * k;  // entries of this block
  int* cnt = smem;                         // [rows]: counts, then cursors
  int* key = smem + rows;                  // [per]: row << 16 | entry
  float* ex = reinterpret_cast<float*>(key + per);  // [per]: e (kAug)
  const size_t e0 = ((size_t)b * N + t * QUERY_TILE) * k + (size_t)p * per;

  // sort the block's in-band entries by band row
  for (int x = threadIdx.x; x < rows; x += blockDim.x) cnt[x] = 0;
  __syncthreads();
  for (int x = threadIdx.x; x < per; x += blockDim.x) {
    const int r = idx[e0 + x] - base;
    if (r >= 0 && r < rows) atomicAdd(cnt + r, 1);
  }
  __syncthreads();
  const int hits = block_exclusive_scan(cnt, rows, wsum);
  for (int x = threadIdx.x; x < per; x += blockDim.x) {
    const int r = idx[e0 + x] - base;
    if (r >= 0 && r < rows) {
      const int at = atomicAdd(cnt + r, 1);
      key[at] = r << 16 | x;
      if (kAug) ex[at] = expf(w_shift[e0 + x]);
    }
  }
  __syncthreads();

  // each warp: a contiguous range of the sorted entries, summed row by row
  const int lo = (int)((long long)hits * warp / kScatterWarps);
  const int hi = (int)((long long)hits * (warp + 1) / kScatterWarps);
  const int c_out = C + (kAug ? 1 : 0);
  // the lane's channels: lane + 32 j with loads of one element (so that
  // each load and atomic instruction covers neighbouring columns), else
  // lane * CL + j
  const int ch0 = VEC == 1 ? lane : lane * CL, dch = VEC == 1 ? 32 : 1;
  const bool reads = ch0 < w;
  const T* v = vals + e0 * C + c0 + ch0;
  float* o = out + ((size_t)b * n_out + base) * c_out + c0;
  float acc[CL], e_acc = 0.0f;
#pragma unroll
  for (int j = 0; j < CL; ++j) acc[j] = 0.0f;
  int cur = -1;  // the band row acc holds
  for (int at = lo; at < hi; at += kScatterBatch) {
    int kk[kScatterBatch];
    unsigned words[kScatterBatch][kLoads * kWords];
#pragma unroll
    for (int u = 0; u < kScatterBatch; ++u)
      kk[u] = at + u < hi ? key[at + u] : -1;
#pragma unroll
    for (int u = 0; u < kScatterBatch; ++u)
      if (kk[u] >= 0 && reads) {
        const T* src = v + (size_t)(kk[u] & 0xffff) * C;
#pragma unroll
        for (int l = 0; l < kLoads; ++l) {
          if (VEC > 1 || ch0 + l * dch < w)
            load_values<T, VEC>(src + l * VEC * dch, words[u] + l * kWords);
          else
            words[u][l * kWords] = 0u;
        }
      }
#pragma unroll
    for (int u = 0; u < kScatterBatch; ++u) {
      if (kk[u] < 0) continue;  // warp-uniform
      const int row = kk[u] >> 16;
      if (row != cur) {  // warp-uniform: flush the finished row
        if (cur >= 0)
          add_row(o + (size_t)cur * c_out, acc, ch0, dch, w,
                  e_col && lane == 0, e_acc);
#pragma unroll
        for (int j = 0; j < CL; ++j) acc[j] = 0.0f;
        e_acc = 0.0f;
        cur = row;
      }
      const float e = kAug ? ex[at + u] : 1.0f;
      if (reads) {
#pragma unroll
        for (int l = 0; l < kLoads; ++l)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float x = value_at<T, VEC>(words[u] + l * kWords, j);
            if (kAug) x = round_to<T>(__fmul_rn(x, e));
            acc[l * VEC + j] += x;
          }
      }
      if (kAug) e_acc += round_to<T>(e);
    }
  }
  if (cur >= 0)
    add_row(o + (size_t)cur * c_out, acc, ch0, dch, w, e_col && lane == 0,
            e_acc);
}

// The geometry and launch of both scatters: channel slices (as few as the
// lanes allow, each a multiple of CL columns), tile parts (until the grid
// has two blocks an SM), shared memory (the counts, the sorted entries and,
// with kAug, their e) and, on every call, its attribute (it belongs to the
// current device).
template <typename T, bool kAug, int VEC>
static cudaError_t scatter_launch(const int* idx, const T* vals,
                                  const float* w_shift, const int* b0, int B,
                                  int N, int C, int k, int n_out, int wblk,
                                  int n_blocks, float* out, int sms,
                                  cudaStream_t stream) {
  constexpr int CL = VEC > 2 ? VEC : 2;
  const int band = wblk * n_blocks;
  if (band >= 1 << 15 || QUERY_TILE * k >= 1 << 16)
    return cudaErrorInvalidValue;  // row << 16 | entry keys
  const int slices0 = (C + 32 * CL - 1) / (32 * CL);
  int W = (C + slices0 - 1) / slices0;
  W += (CL - W % CL) % CL;
  const int slices = (C + W - 1) / W;
  const int tiles = N / QUERY_TILE;
  int parts = 1;
  while (parts < 8 && (size_t)tiles * parts * slices * B < 2 * (size_t)sms)
    parts *= 2;
  const int per = QUERY_TILE / parts * k;
  const size_t smem = (size_t)(band + per * (kAug ? 2 : 1)) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel<T, kAug, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(tiles * parts * slices), (unsigned)B);
  scatter_kernel<T, kAug, VEC><<<grid, 32 * kScatterWarps, smem, stream>>>(
      idx, vals, w_shift, b0, N, C, k, n_out, wblk, n_blocks, W, parts, out);
  return cudaGetLastError();
}

// Both scatters' entry: checks, the SM count, and the instance (loads of
// VEC elements where C and the values' pointer allow them, else of one).
template <bool kAug>
static int scatter(const void* idx, const void* vals, const void* w_shift,
                   const void* b0, int B, int N, int C, int k, int n_out,
                   int wblk, int n_blocks, int vals_bf16, void* out,
                   void* stream) {
  // the softmax sum's slices cover value columns and the e column with
  // them, so it needs C > 0
  if (N % QUERY_TILE != 0 || (kAug && C == 0))
    return (int)cudaErrorInvalidValue;
  if ((size_t)B * N * k * C == 0 || n_out <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t esize = vals_bf16 ? 2 : 4;
  const bool vec = C % kScatterVec == 0 &&
                   (size_t)vals % (kScatterVec * esize) == 0;
  const int* i = (const int*)idx;
  const float* ws = (const float*)w_shift;
  const int* bb = (const int*)b0;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (vals_bf16) {
    const __nv_bfloat16* v = (const __nv_bfloat16*)vals;
    err = vec ? scatter_launch<__nv_bfloat16, kAug, kScatterVec>(
                    i, v, ws, bb, B, N, C, k, n_out, wblk, n_blocks, o, sms, s)
              : scatter_launch<__nv_bfloat16, kAug, 1>(
                    i, v, ws, bb, B, N, C, k, n_out, wblk, n_blocks, o, sms, s);
  } else {
    const float* v = (const float*)vals;
    err = vec ? scatter_launch<float, kAug, kScatterVec>(
                    i, v, ws, bb, B, N, C, k, n_out, wblk, n_blocks, o, sms, s)
              : scatter_launch<float, kAug, 1>(
                    i, v, ws, bb, B, N, C, k, n_out, wblk, n_blocks, o, sms, s);
  }
  return (int)err;
}

extern "C" {

// idx [B, N, k] i32, feats [B, M, C], b0 [B, N / 256] i32
// -> out [B, N, k, C] in the feats type. Returns a cudaError_t code.
int ssf_regroup(const void* idx, const void* feats, const void* b0, int B,
                int N, int M, int C, int k, int wblk, int n_blocks,
                int feats_bf16, void* out, void* stream) {
  if (N % QUERY_TILE != 0) return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)B * N * k;
  if (rows == 0 || C == 0) return 0;
  if (rows > (size_t)1 << 30 || (size_t)B * M >= (size_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  // the widest unit (16 bytes down to one element) that divides a row and
  // both pointers' alignment
  const size_t esize = feats_bf16 ? 2 : 4;
  const size_t row_bytes = (size_t)C * esize;
  const size_t align = row_bytes | (size_t)feats | (size_t)out | 16;
  const int vw = (int)(align & (~align + 1));  // lowest set bit
  const int nv = (int)(row_bytes / vw);
  const int chunks = (int)(rows / 32);
  const unsigned grid =
      (unsigned)((chunks + kRegroupWarps - 1) / kRegroupWarps);
  const int threads = 32 * kRegroupWarps;
  cudaStream_t s = (cudaStream_t)stream;
  const int* i = (const int*)idx;
  const int* bb = (const int*)b0;
  switch (vw) {
    case 16:
      regroup_kernel<16><<<grid, threads, 0, s>>>(
          i, (const uint4*)feats, bb, N, M, k, nv, wblk, n_blocks, chunks,
          (uint4*)out);
      break;
    case 8:
      regroup_kernel<8><<<grid, threads, 0, s>>>(
          i, (const uint2*)feats, bb, N, M, k, nv, wblk, n_blocks, chunks,
          (uint2*)out);
      break;
    case 4:
      regroup_kernel<4><<<grid, threads, 0, s>>>(
          i, (const unsigned*)feats, bb, N, M, k, nv, wblk, n_blocks, chunks,
          (unsigned*)out);
      break;
    case 2:
      regroup_kernel<2><<<grid, threads, 0, s>>>(
          i, (const unsigned short*)feats, bb, N, M, k, nv, wblk, n_blocks,
          chunks, (unsigned short*)out);
      break;
    default:
      return (int)cudaErrorMisalignedAddress;
  }
  return (int)cudaGetLastError();
}

// idx [B, N, k] i32, vals [B, N, k, C] (f32 or bf16), b0 [B, N / 256] i32;
// out [B, n_out, C] f32, zero-filled by the caller
int ssf_scatter_add(const void* idx, const void* vals, const void* b0, int B,
                    int N, int C, int k, int n_out, int wblk, int n_blocks,
                    int vals_bf16, void* out, void* stream) {
  return scatter<false>(idx, vals, nullptr, b0, B, N, C, k, n_out, wblk,
                        n_blocks, vals_bf16, out, stream);
}

// idx [B, N, k] i32, vals [B, N, k, C], w_shift [B, N, k] f32,
// b0 [B, N / 256] i32; out [B, n_out, C + 1] f32, zero-filled by the caller
int ssf_scatter_softmax_sum(const void* idx, const void* vals,
                            const void* w_shift, const void* b0, int B, int N,
                            int C, int k, int n_out, int wblk, int n_blocks,
                            int vals_bf16, void* out, void* stream) {
  return scatter<true>(idx, vals, w_shift, b0, B, N, C, k, n_out, wblk,
                       n_blocks, vals_bf16, out, stream);
}

const char* ssf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
