// Squeeze-and-Excitation for Hopper, in f32: per image, global average pool
// over H*W, relu(pooled . w1^T), sigmoid(hidden . w2^T), then x * s per
// channel.
//
// Replaces the Pallas TPU kernel vqa_tpu/ops/se_kernel.py (_fused_se_flat,
// pl.pallas_call at :50), which holds one whole [HW, C] image in VMEM and
// reads it once.
//
// What bounds it: bytes. The least traffic is x read once and the output
// written once (the FCs are at most 2*C*C/r MACs per image). An image does
// not fit one block's shared memory (stage 1 at 224 px is 802,816 bytes per
// image against 232,448), so the design gives each image one thread-block
// cluster, which plays the part of the TPU kernel's VMEM:
//
// - One launch per call, grid B * n blocks, clusters of n. The cluster
//   splits the image by channels (block q owns the slice [q*cs, (q+1)*cs)
//   of every row, cs = ceil(C/n) rounded to a multiple of 4 where C is
//   one) or, where such slices would be narrower than 16 channels, by rows
//   (block q owns rows [q*HW/n, (q+1)*HW/n) of every channel).
// - Resident mode: each block copies its part of x into shared memory once
//   (16-byte cp.async where x is 16-byte aligned and C % 4 == 0, else
//   4-byte), sums it per channel and later rescales it from shared memory:
//   x is read from device memory once. Each thread sums and rescales
//   exactly what it copied, so the copies need no block barrier.
// - Streaming mode (keep_rows = 0; an image too large for the cluster's
//   shared memory, e.g. stage 1 at 448 px): the block sums its part while
//   reading it from device memory and reads it again to rescale. The kernel
//   takes any split of the rows between the two, so a plan may keep only
//   part of the rows to fit one more block on an SM (ops/se_kernel.py).
// - Exchanges between the blocks of a cluster are pushes: a block stores
//   into its peers' shared memory (DSMEM) and one cluster barrier publishes
//   the stores, so nothing waits on a remote load and no block touches
//   another's memory after the barrier. Split by rows, every block pushes
//   its [C] partial sums to every rank and then runs both (small) FCs whole.
//   Split by channels, a block's sums are already its channels' whole
//   pooled means; it forms their share of every hidden unit (its columns of
//   w1) and pushes the shares to every rank, and after the barrier forms
//   the scales of its own channels (its rows of w2), so each weight is read
//   once per image. Either way the kernel waits on one cluster barrier,
//   and sums over ranks are taken in rank order: the result does not
//   depend on scheduling; no atomics and no global scratch.
// - The weights a block uses are staged in shared memory with cp.async
//   while x loads. A dot product takes G lanes per row and a shuffle
//   reduction, G chosen by the host so that one pass covers the rows.
// - Per-launch constants come from the host in Params: with 8 warps per
//   block every dependent instruction is on the critical path, so a thread
//   starts with little index arithmetic.
// - Rescale and write with 16-byte stores where aligned.
//
// Pooling is sum then scale by 1/HW, as the TPU kernel does
// (se_kernel.py:34). w1 is fc1's nn.Linear weight [R, C] and w2 is fc2's
// [C, R]. The launch plan (cluster size, split, kept rows, shared-memory
// bytes) is computed by ops/se_kernel.py:se_plan and checked here against
// the same layout.
//
// bf16 form (vqa_se_bf16): x, the weights and the output in bf16, every
// sum, dot product and scale in f32, the output rounded once, as the TPU
// kernel upcasts its block (se_kernel.py:32-42) and casts once. It has its
// own kernel (se_bf16, below) on the f32 form's plan and layout in 2-byte
// elements (a block holds twice the rows; 16-byte copies carry 8 elements
// where C % 8 == 0, else single elements with plain loads: cp.async has no
// 2-byte size):
//
// - What bounds it: bytes for stage 1 (401 KB an image at 224 px), whose
//   blocks bring x in and write it out near the memory's rate; for the
//   smaller stages the fixed part of a launch: ~1.5 us of launch and
//   drain, then the block's sums, the cluster's exchange and the FCs,
//   during which no byte moves (tools/bf16_phases.py stamps each phase).
// - The exchange is Hopper's asynchronous one: each block's mbarrier
//   expects the bytes every rank will push to it, the pushes are st.async
//   stores counted on the receiver's mbarrier as they land, and a block
//   waits only for its own mbarrier. The f32 kernel's second cluster
//   barrier (publish, then read) is gone; on the H100 that took stage 1's
//   exchange from ~2,660 to ~1,530 SM cycles.
// - Tried and dropped, by measurement (PERF.md, PR 13): summing x in four
//   commit groups as they land (slower than one group for the rows and
//   one for the weights); one block per image, which bf16 allows up to
//   stage 2 (slower at every stage: one SM's bandwidth, and the whole FCs
//   in one block); staged weight rows padded against bank conflicts (no
//   gain); other cluster sizes (none more than 5% faster at any stage).
//   Not tried: staging the weights before griddepcontrol.wait under
//   programmatic dependent launch, since a caller's weights may be written
//   by the kernel just before (a cast) and the read would race it.

#include <cooperative_groups.h>

#include <atomic>
#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;   // above 8 needs the non-portable cluster size
constexpr int MAX_SMEM = 232448;  // dynamic shared memory one block may use
constexpr int MAX_WEIGHT_SMEM = 48 * 1024;  // staged weight slices, at most
constexpr unsigned FULL = 0xffffffffu;

constexpr int round16(int v) { return (v + 15) & ~15; }

// Shared-memory layout in bytes for C channels of esize-byte elements
// (4: f32, 2: bf16), R hidden units, clusters of n, keep_rows kept rows
// and the split (rows_mode: each block owns rows x all channels; else all
// rows x a channel slice of cs = ceil(C/n), rounded to a multiple of
// 16/esize where C is one); mirrored by ops/se_kernel.py:_smem_bytes. The
// weights the block's FCs take (w = cs columns of w1 and rows of w2) are
// staged, in the element type, when they fit MAX_WEIGHT_SMEM, else read
// from device memory. Every vector of sums, means and scales is f32. The
// bf16 form's layout starts with the 8-byte mbarrier of its exchange.
struct Layout {
  int cs, w, bar, xch, pooled, s, hidden, w1s, w2s, red, xs, total;
  bool staged;
  Layout(int C, int R, int n, int keep_rows, bool rows_mode, int esize) {
    const int per16 = 16 / esize;        // elements in 16 bytes
    cs = (C + n - 1) / n;
    if (C % per16 == 0) cs = (cs + per16 - 1) / per16 * per16;
    w = rows_mode ? C : cs;
    staged = 2LL * esize * R * w <= MAX_WEIGHT_SMEM;
    bar = 0;  // the bf16 form's exchange mbarrier
    xch = bar + (esize == 2 ? 16 : 0);  // f32 [n][C] sums (rows) or [n][R] shares (channels)
    pooled = xch + round16(4 * n * (rows_mode ? C : R));  // f32 [w]
    s = pooled + round16(4 * w);                          // f32 [w]
    hidden = s + round16(4 * w);                          // f32 [R]
    w1s = hidden + round16(4 * R);                        // [R][w]
    w2s = w1s + (staged ? round16(esize * R * w) : 0);    // [w][R]
    red = w2s + (staged ? round16(esize * R * w) : 0);    // f32 pooling scratch
    xs = red + round16(4 * (w > per16 * THREADS ? w : per16 * THREADS));
    total = xs + keep_rows * w * esize;  // [keep_rows][w]
  }
};

// log2 of the lanes per row of a dot product over `len` elements for
// `rows` rows: a power of two, no more than the elements, and few enough
// that one pass of the block covers the rows where it can.
int lanes_per_row_log2(int rows, int len) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < len && (2 << lg) * rows <= THREADS) ++lg;
  return lg;
}

struct Params {
  const void* x;   // [B, HW, C] of the element type
  const void* w1;  // [R, C]
  const void* w2;  // [C, R]
  void* out;       // [B, HW, C]
  int HW, C, R, n, cs, keep_rows, rows_mode;
  int lg1, lg2;  // log2 lanes per row of fc1 and fc2
  int staged;
  float inv_hw;
  int bar, xch, pooled, s, hidden, w1s, w2s, red, xs;  // Layout offsets in bytes
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// one element into shared memory: f32 by cp.async, bf16 by a plain load
// and store (cp.async has no 2-byte size)
__device__ __forceinline__ void copy1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *dst = *src;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Copy rows x len elements (source row stride lds, destination row stride
// ldd) into shared memory: 16 bytes at a time by cp.async where every row
// start and length allow it, else one element at a time.
template <typename E>
__device__ __forceinline__ void stage(E* dst, int ldd, const E* src, int lds, int rows, int len,
                                      int t) {
  constexpr int P = 16 / sizeof(E);  // elements in 16 bytes
  if (len % P == 0 && ldd % P == 0 && lds % P == 0 && aligned16(src) && aligned16(dst)) {
    const int v = len / P;
    for (int e = t; e < rows * v; e += THREADS) {
      const int r = e / v, k = P * (e - r * v);
      cp_async16(dst + r * ldd + k, src + static_cast<size_t>(r) * lds + k);
    }
  } else {
    for (int e = t; e < rows * len; e += THREADS) {
      const int r = e / len, k = e - r * len;
      copy1(dst + r * ldd + k, src + static_cast<size_t>(r) * lds + k);
    }
  }
}

// For rows [0, nrows): done(row, sum over k < len of a[k] * w[row * ldw + k],
// lane) on each of the row's 2^lg lanes, after a shuffle reduction that
// leaves the sum on all of them. a is f32; w f32 or bf16, read as f32.
template <typename W, typename Done>
__device__ __forceinline__ void row_dots(const float* a, const W* w, int ldw, int nrows,
                                         int len, int lg, int t, Done done) {
  const int G = 1 << lg, lane = t & 31;
  const int sub = lane >> lg, gl = lane & (G - 1);
  for (int base = (t >> 5) << (5 - lg); base < nrows; base += WARPS << (5 - lg)) {
    const int row = base + sub;
    float v = 0.f;
    if (row < nrows) {
      const W* wr = w + static_cast<size_t>(row) * ldw;
#pragma unroll 4
      for (int k = gl; k < len; k += G) v = fmaf(a[k], vqa::to_f32(wr[k]), v);
    }
    for (int off = G >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (row < nrows) done(row, v, gl);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  return v;
}

// Elements moved as one (T, in device and shared memory) and their f32
// accumulator (A). f32: float4 where x, out and C allow it, else float.
// bf16: 8 elements (16 bytes) accumulated as 8 floats where they allow it,
// else one element and a float.
struct F8 {
  float4 lo, hi;
};

__device__ __forceinline__ float2 bf16x2_to_f32(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ unsigned f32_to_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float4 shfl4(const float4& a, int off) {
  return make_float4(__shfl_xor_sync(FULL, a.x, off), __shfl_xor_sync(FULL, a.y, off),
                     __shfl_xor_sync(FULL, a.z, off), __shfl_xor_sync(FULL, a.w, off));
}

template <typename E, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using T = float4;
  using A = float4;
  static __device__ __forceinline__ A zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void add(A& a, const A& b) { add4(a, b); }
  static __device__ __forceinline__ void accum(A& a, const T& x) { add4(a, x); }
  static __device__ __forceinline__ T scale(const T& x, const A& s) {
    return make_float4(x.x * s.x, x.y * s.y, x.z * s.z, x.w * s.w);
  }
  static __device__ __forceinline__ A shfl_xor(const A& a, int off) { return shfl4(a, off); }
  static __device__ __forceinline__ void copy(T* dst, const T* src) { cp_async16(dst, src); }
};
template <>
struct Vec<float, 1> {
  using T = float;
  using A = float;
  static __device__ __forceinline__ A zero() { return 0.f; }
  static __device__ __forceinline__ void add(A& a, const A& b) { a += b; }
  static __device__ __forceinline__ void accum(A& a, const T& x) { a += x; }
  static __device__ __forceinline__ T scale(const T& x, const A& s) { return x * s; }
  static __device__ __forceinline__ A shfl_xor(const A& a, int off) {
    return __shfl_xor_sync(FULL, a, off);
  }
  static __device__ __forceinline__ void copy(T* dst, const T* src) { cp_async4(dst, src); }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  using T = uint4;  // 8 bf16
  using A = F8;
  static __device__ __forceinline__ A zero() {
    return {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  static __device__ __forceinline__ void add(A& a, const A& b) {
    add4(a.lo, b.lo);
    add4(a.hi, b.hi);
  }
  static __device__ __forceinline__ void accum(A& a, const T& x) {
    const float2 e0 = bf16x2_to_f32(x.x), e1 = bf16x2_to_f32(x.y);
    const float2 e2 = bf16x2_to_f32(x.z), e3 = bf16x2_to_f32(x.w);
    add4(a.lo, make_float4(e0.x, e0.y, e1.x, e1.y));
    add4(a.hi, make_float4(e2.x, e2.y, e3.x, e3.y));
  }
  static __device__ __forceinline__ T scale(const T& x, const A& s) {
    const float2 e0 = bf16x2_to_f32(x.x), e1 = bf16x2_to_f32(x.y);
    const float2 e2 = bf16x2_to_f32(x.z), e3 = bf16x2_to_f32(x.w);
    return make_uint4(f32_to_bf16x2(e0.x * s.lo.x, e0.y * s.lo.y),
                      f32_to_bf16x2(e1.x * s.lo.z, e1.y * s.lo.w),
                      f32_to_bf16x2(e2.x * s.hi.x, e2.y * s.hi.y),
                      f32_to_bf16x2(e3.x * s.hi.z, e3.y * s.hi.w));
  }
  static __device__ __forceinline__ A shfl_xor(const A& a, int off) {
    return {shfl4(a.lo, off), shfl4(a.hi, off)};
  }
  static __device__ __forceinline__ void copy(T* dst, const T* src) { cp_async16(dst, src); }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using T = __nv_bfloat16;
  using A = float;
  static __device__ __forceinline__ A zero() { return 0.f; }
  static __device__ __forceinline__ void add(A& a, const A& b) { a += b; }
  static __device__ __forceinline__ void accum(A& a, const T& x) { a += __bfloat162float(x); }
  static __device__ __forceinline__ T scale(const T& x, const A& s) {
    return __float2bfloat16_rn(__bfloat162float(x) * s);
  }
  static __device__ __forceinline__ A shfl_xor(const A& a, int off) {
    return __shfl_xor_sync(FULL, a, off);
  }
  static __device__ __forceinline__ void copy(T* dst, const T* src) { *dst = *src; }
};

template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS) se_cluster(const __grid_constant__ Params p) {
  using V = Vec<E, VEC>;
  using T = typename V::T;
  using A = typename V::A;
  extern __shared__ __align__(16) unsigned char smc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int q = static_cast<int>(cluster_rank());  // rank in the image's cluster
  const int b = static_cast<int>(cluster_id());    // image
  const int n = p.n, C = p.C, R = p.R, HW = p.HW;
  const E* w1 = static_cast<const E*>(p.w1);
  const E* w2 = static_cast<const E*>(p.w2);
  // pushed by every rank: [n][C] sums or [n][R] shares
  float* xch = reinterpret_cast<float*>(smc + p.xch);
  float* pooled = reinterpret_cast<float*>(smc + p.pooled);  // [w] means of this block's channels
  float* s = reinterpret_cast<float*>(smc + p.s);            // [w] their scales
  float* hidden = reinterpret_cast<float*>(smc + p.hidden);  // [R]
  E* w1s = reinterpret_cast<E*>(smc + p.w1s);  // [R][w]: w1's columns [c0, c0 + nc)
  E* w2s = reinterpret_cast<E*>(smc + p.w2s);  // [w][R]: w2's rows [c0, c0 + nc)
  A* red = reinterpret_cast<A*>(smc + p.red);
  T* xs = reinterpret_cast<T*>(smc + p.xs);  // [keep][L]

  // this block's rows [r0, r0 + rows) and channels [c0, c0 + nc)
  int r0 = 0, rows = HW, c0 = 0, nc = C;
  if (p.rows_mode) {
    r0 = q * HW / n;
    rows = (q + 1) * HW / n - r0;
  } else {
    c0 = min(C, q * p.cs);
    nc = min(C, c0 + p.cs) - c0;
  }
  const int keep = min(p.keep_rows, rows), L = nc / VEC;
  const size_t C4 = C / VEC;  // vectors per row of x
  const size_t origin = (static_cast<size_t>(b) * HW + r0) * C + c0;
  const T* xg = reinterpret_cast<const T*>(static_cast<const E*>(p.x) + origin);
  T* og = reinterpret_cast<T*>(static_cast<E*>(p.out) + origin);
  // thread t owns vector column g of the rows congruent to ph mod P (and,
  // where L > THREADS, the columns g + THREADS, ...): it copies, sums and
  // rescales them
  const int P = L >= THREADS || L == 0 ? 1 : THREADS / L;
  const int work = L * P;
  const int g0 = L > THREADS ? t : (L ? t % L : 0), ph = L > THREADS ? 0 : (L ? t / L : 0);

  // 1. copy the kept rows and stage the weights of this block's channels
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS)
    for (int r = ph; r < keep; r += P) V::copy(xs + r * L + g, xg + r * C4 + g);
  if (p.staged) {
    const int ld = p.rows_mode ? C : p.cs;
    stage(w1s, ld, w1 + c0, C, R, nc, t);
    stage(w2s, R * nc, w2 + static_cast<size_t>(c0) * R, R * nc, 1, R * nc, t);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  cluster_arrive_relaxed();  // this block has started: peers may push to it

  // 2. per-channel sums: streamed rows while the copies are in flight,
  //    then this thread's own copies
  const int first = keep + (ph - keep % P + P) % P;  // first streamed row of phase ph
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS) {
    A acc = V::zero();
#pragma unroll 4
    for (int r = first; r < rows; r += P) V::accum(acc, xg[r * C4 + g]);
    red[w] = acc;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS) {
    A acc = red[w];
#pragma unroll 4
    for (int r = ph; r < keep; r += P) V::accum(acc, xs[r * L + g]);
    red[w] = acc;
  }
  //    then over the P phases, in a fixed order: shuffles within a warp
  //    and the warps in order where L divides 32, else a tree in shared
  //    memory
  if (P > 1 && 32 % L == 0) {
    A acc = red[t];
    for (int off = L; off < 32; off <<= 1) V::add(acc, V::shfl_xor(acc, off));
    __syncthreads();
    if ((t & 31) < L) red[(t >> 5) * L + (t & 31)] = acc;
    __syncthreads();
    if (t < L) {  // red[t] is read by thread t alone
      A a = red[t];
      for (int wp = 1; wp < WARPS; ++wp) V::add(a, red[wp * L + t]);
      red[t] = a;
    }
  } else if (P > 1) {
    __syncthreads();
    int span = 1;
    while (span < P) span <<= 1;
    for (span >>= 1; span > 0; span >>= 1) {
      if (t < span * L && ph + span < P) V::add(red[t], red[t + span * L]);
      __syncthreads();
    }
  }
  __syncthreads();
  const float* sums = reinterpret_cast<const float*>(red);  // [nc]

  // 3. the pooled means: split by rows, every block pushes its sums to
  //    every rank and one cluster barrier publishes them; split by
  //    channels, the block's sums are already the whole image's
  if (p.rows_mode) {
    cluster_wait();  // every peer has started
    for (int e = t; e < n * L; e += THREADS) {
      const int r = e / L, g = e - r * L;
      reinterpret_cast<A*>(cluster.map_shared_rank(xch, r))[q * L + g] =
          reinterpret_cast<const A*>(sums)[g];
    }
    cluster_arrive();
    cluster_wait();  // every rank's sums have landed
    for (int k = t; k < C; k += THREADS) {
      float a = xch[k];
      for (int r = 1; r < n; ++r) a += xch[r * C + k];
      pooled[k] = a * p.inv_hw;
    }
  } else {
    for (int k = t; k < nc; k += THREADS) pooled[k] = sums[k] * p.inv_hw;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // the staged weights
  __syncthreads();

  // 4. fc1 and relu. Split by channels, the block forms its channels'
  //    share of every hidden unit and pushes it to every rank (the lanes
  //    holding a sum split the ranks between them); one cluster barrier
  //    publishes the shares, summed in rank order
  const E* wa = p.staged ? w1s : w1 + c0;
  const int lda = p.staged ? (p.rows_mode ? C : p.cs) : C;
  if (p.rows_mode) {
    row_dots(pooled, wa, lda, R, nc, p.lg1, t, [&](int j, float v, int gl) {
      if (gl == 0) hidden[j] = fmaxf(v, 0.f);
    });
  } else {
    cluster_wait();  // every peer has started
    row_dots(pooled, wa, lda, R, nc, p.lg1, t, [&](int j, float v, int gl) {
      for (int r = gl; r < n; r += 1 << p.lg1) cluster.map_shared_rank(xch, r)[q * R + j] = v;
    });
    cluster_arrive();
    cluster_wait();  // every rank's shares have landed
    for (int j = t; j < R; j += THREADS) {
      float a = xch[j];
      for (int r = 1; r < n; ++r) a += xch[r * R + j];
      hidden[j] = fmaxf(a, 0.f);
    }
  }
  __syncthreads();

  // 5. fc2 and sigmoid for this block's channels
  const E* wb = p.staged ? w2s : w2 + static_cast<size_t>(c0) * R;
  row_dots(hidden, wb, R, nc, R, p.lg2, t, [&](int k, float v, int gl) {
    if (gl == 0) s[k] = 1.f / (1.f + expf(-v));
  });
  __syncthreads();

  // 6. rescale: kept rows from shared memory, streamed rows from device
  //    memory again
  const A* sv = reinterpret_cast<const A*>(s);
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS) {
    const A sg = sv[g];
    for (int r = ph; r < rows; r += P)
      og[r * C4 + g] = V::scale(r < keep ? xs[r * L + g] : xg[r * C4 + g], sg);
  }
}

// ---- the bf16 form: its own kernel --------------------------------------

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// Asynchronous stores into a peer's shared memory, each counted in bytes
// on the peer's mbarrier as it lands.
__device__ __forceinline__ void push(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void push(uint32_t addr, const float4& v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void push(uint32_t addr, const F8& v, uint32_t bar) {
  push(addr, v.lo, bar);
  push(addr + 16, v.hi, bar);
}

// One image per cluster of n blocks (n = 1: a block alone), the plan from
// se_plan(esize=2). The split and the order of every sum are the f32
// kernel's; the exchange between the blocks of a cluster is Hopper's
// asynchronous one. Each block's mbarrier is set up at its start to expect
// the bytes every rank will push to it (n x C sums split by rows, n x R
// shares split by channels); a block pushes with st.async, each store
// counted on the receiving block's mbarrier as it lands, and a block waits
// only for its own mbarrier: the one cluster barrier of the kernel is the
// one at its start (every block has started, so its shared memory and
// mbarrier exist), which costs little since every block reaches it at once,
// and the f32 kernel's second barrier (publish the pushes, then read) is
// gone. The kept rows and the weights are copied as two commit groups, so
// the sums start when the rows have landed. A block alone exchanges
// nothing.
template <int VEC>
__global__ void __launch_bounds__(THREADS) se_bf16(const __grid_constant__ Params p) {
  using E = __nv_bfloat16;
  using V = Vec<E, VEC>;
  using T = typename V::T;
  using A = typename V::A;
  extern __shared__ __align__(16) unsigned char smc[];
  const int t = threadIdx.x;
  const int n = p.n, C = p.C, R = p.R, HW = p.HW;
  const int q = blockIdx.x % n;  // rank in the image's cluster
  const int b = blockIdx.x / n;  // image
  const E* w1 = static_cast<const E*>(p.w1);
  const E* w2 = static_cast<const E*>(p.w2);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smc + p.bar);
  float* xch = reinterpret_cast<float*>(smc + p.xch);
  float* pooled = reinterpret_cast<float*>(smc + p.pooled);
  float* s = reinterpret_cast<float*>(smc + p.s);
  float* hidden = reinterpret_cast<float*>(smc + p.hidden);
  E* w1s = reinterpret_cast<E*>(smc + p.w1s);
  E* w2s = reinterpret_cast<E*>(smc + p.w2s);
  A* red = reinterpret_cast<A*>(smc + p.red);
  T* xs = reinterpret_cast<T*>(smc + p.xs);

  int r0 = 0, rows = HW, c0 = 0, nc = C;
  if (p.rows_mode) {
    r0 = q * HW / n;
    rows = (q + 1) * HW / n - r0;
  } else {
    c0 = min(C, q * p.cs);
    nc = min(C, c0 + p.cs) - c0;
  }
  const int keep = min(p.keep_rows, rows), L = nc / VEC;
  const size_t C4 = C / VEC;
  const size_t origin = (static_cast<size_t>(b) * HW + r0) * C + c0;
  const T* xg = reinterpret_cast<const T*>(static_cast<const E*>(p.x) + origin);
  T* og = reinterpret_cast<T*>(static_cast<E*>(p.out) + origin);
  const int P = L >= THREADS || L == 0 ? 1 : THREADS / L;
  const int work = L * P;
  const int g0 = L > THREADS ? t : (L ? t % L : 0), ph = L > THREADS ? 0 : (L ? t / L : 0);

  // phase 0: start
  // 1. the exchange's mbarrier (one arrival: its own, with the bytes it
  //    expects), then the kept rows and the weights, two commit groups
  if (n > 1 && t == 0) {
    vqa::mbar_init(bar, 1);
    vqa::mbar_expect_tx(bar, 4u * n * (p.rows_mode ? C : R));
  }
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS)
    for (int r = ph; r < keep; r += P) V::copy(xs + r * L + g, xg + r * C4 + g);
  cp_async_commit();
  if (p.staged) {
    const int ld = p.rows_mode ? C : p.cs;
    stage(w1s, ld, w1 + c0, C, R, nc, t);
    stage(w2s, R * nc, w2 + static_cast<size_t>(c0) * R, R * nc, 1, R * nc, t);
  }
  cp_async_commit();
  if (n > 1) cluster_arrive_relaxed();  // this block and its mbarrier exist

  // phase 1: copies issued
  // 2. per-channel sums in a fixed order: the streamed rows, read from
  //    device memory while the copies are in flight, then the kept rows
  //    once they have landed (a thread sums what it copied: no barrier)
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS) {
    A acc = V::zero();
#pragma unroll 4
    for (int r = keep + (ph - keep % P + P) % P; r < rows; r += P) V::accum(acc, xg[r * C4 + g]);
    red[w] = acc;
  }
  cp_async_wait_group<1>();  // the rows; the weights may be in flight
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS) {
    A acc = red[w];
#pragma unroll 4
    for (int r = ph; r < keep; r += P) V::accum(acc, xs[r * L + g]);
    red[w] = acc;
  }
  // phase 2: each thread's sums
  //    then over the P phases, in a fixed order (as the f32 kernel)
  if (P > 1 && 32 % L == 0) {
    A acc = red[t];
    for (int off = L; off < 32; off <<= 1) V::add(acc, V::shfl_xor(acc, off));
    __syncthreads();
    if ((t & 31) < L) red[(t >> 5) * L + (t & 31)] = acc;
    __syncthreads();
    if (t < L) {
      A a = red[t];
      for (int wp = 1; wp < WARPS; ++wp) V::add(a, red[wp * L + t]);
      red[t] = a;
    }
  } else if (P > 1) {
    __syncthreads();
    int span = 1;
    while (span < P) span <<= 1;
    for (span >>= 1; span > 0; span >>= 1) {
      if (t < span * L && ph + span < P) V::add(red[t], red[t + span * L]);
      __syncthreads();
    }
  }
  __syncthreads();
  const float* sums = reinterpret_cast<const float*>(red);  // [nc]

  // phase 3: the block's sums
  // 3. the pooled means: split by rows across a cluster, every rank's sums
  //    pushed to every rank and summed in rank order
  if (n > 1 && p.rows_mode) {
    cluster_wait();  // every peer has started
    for (int e = t; e < n * L; e += THREADS) {
      const int r = e / L, g = e - r * L;
      push(peer_addr(xch + (q * L + g) * VEC, r), reinterpret_cast<const A*>(sums)[g],
           peer_addr(bar, r));
    }
    vqa::mbar_wait(bar, 0);  // every rank's sums have landed
    for (int k = t; k < C; k += THREADS) {
      float a = xch[k];
      for (int r = 1; r < n; ++r) a += xch[r * C + k];
      pooled[k] = a * p.inv_hw;
    }
  } else {
    for (int k = t; k < nc; k += THREADS) pooled[k] = sums[k] * p.inv_hw;
  }
  cp_async_wait_group<0>();  // the staged weights
  __syncthreads();

  // phase 4: pooled means and staged weights
  // 4. fc1 and relu: whole in the block (alone, or split by rows), else
  //    this block's share of every hidden unit pushed to every rank and
  //    the shares summed in rank order
  const E* wa = p.staged ? w1s : w1 + c0;
  const int lda = p.staged ? (p.rows_mode ? C : p.cs) : C;
  if (n == 1 || p.rows_mode) {
    row_dots(pooled, wa, lda, R, nc, p.lg1, t, [&](int j, float v, int gl) {
      if (gl == 0) hidden[j] = fmaxf(v, 0.f);
    });
  } else {
    cluster_wait();  // every peer has started
    row_dots(pooled, wa, lda, R, nc, p.lg1, t, [&](int j, float v, int gl) {
      for (int r = gl; r < n; r += 1 << p.lg1) push(peer_addr(xch + q * R + j, r), v, peer_addr(bar, r));
    });
    vqa::mbar_wait(bar, 0);  // every rank's shares have landed
    for (int j = t; j < R; j += THREADS) {
      float a = xch[j];
      for (int r = 1; r < n; ++r) a += xch[r * R + j];
      hidden[j] = fmaxf(a, 0.f);
    }
  }
  __syncthreads();

  // phase 5: hidden units
  // 5. fc2 and sigmoid for this block's channels
  const E* wb = p.staged ? w2s : w2 + static_cast<size_t>(c0) * R;
  row_dots(hidden, wb, R, nc, R, p.lg2, t, [&](int k, float v, int gl) {
    if (gl == 0) s[k] = 1.f / (1.f + expf(-v));
  });
  __syncthreads();

  // phase 6: scales
  // 6. rescale with 16-byte stores: kept rows from shared memory, streamed
  //    rows from device memory again
  const A* sv = reinterpret_cast<const A*>(s);
  for (int w = t, g = g0; w < work; w += THREADS, g += THREADS) {
    const A sg = sv[g];
    for (int r = ph; r < rows; r += P)
      og[r * C4 + g] = V::scale(r < keep ? xs[r * L + g] : xg[r * C4 + g], sg);
  }
  // phase 7: stores issued
}

// The kernel of each form: the f32 one, and the bf16 form's own.
template <typename E, int VEC>
struct Kernel {
  static constexpr auto fn = se_cluster<E, VEC>;
};
template <int VEC>
struct Kernel<__nv_bfloat16, VEC> {
  static constexpr auto fn = se_bf16<VEC>;
};

// Raises the kernel's shared-memory limit (never lowers it) and allows
// clusters above 8, once per device and instantiation: the attributes stay
// set, and setting them on every call costs host time at small batches.
template <typename E, int VEC>
cudaError_t prepare(size_t smem, int cluster) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<size_t> smem_set[MAX_DEVICES];
  static std::atomic<bool> nonportable_set[MAX_DEVICES];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev].load() || (cluster > 8 && !nonportable_set[dev].load())) {
    std::lock_guard<std::mutex> lock(mu);
    if (smem > smem_set[dev].load()) {
      err = vqa::allow_smem(Kernel<E, VEC>::fn, smem);
      if (err != cudaSuccess) return err;
      smem_set[dev].store(smem);
    }
    if (cluster > 8 && !nonportable_set[dev].load()) {
      err = cudaFuncSetAttribute(Kernel<E, VEC>::fn,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      nonportable_set[dev].store(true);
    }
  }
  return cudaSuccess;
}

template <typename E, int VEC>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int blocks,
                      int cluster, size_t smem, cudaStream_t st) {
  const cudaError_t err = prepare<E, VEC>(smem, cluster);
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

// The plan's checks, shared by the launchers and the occupancy query.
bool plan_ok(long long B, int HW, int C, int R, int cluster, int keep_rows, int rows_mode,
             int smem_bytes, int esize) {
  if (B <= 0 || HW <= 0 || C <= 0 || R <= 0 || cluster < 1 || cluster > MAX_CLUSTER ||
      B * cluster > 0x7fffffffLL || static_cast<long long>(HW) * C >= (1LL << 31) ||
      static_cast<long long>(R) * C >= (1LL << 31) || (rows_mode != 0 && rows_mode != 1) ||
      cluster > (rows_mode ? HW : C) || keep_rows < 0 ||
      keep_rows > (rows_mode ? (HW + cluster - 1) / cluster : HW))
    return false;
  const Layout lay(C, R, cluster, keep_rows, rows_mode, esize);
  return smem_bytes == lay.total && smem_bytes <= MAX_SMEM;
}

Params make_params(const void* x, const void* w1, const void* w2, void* out, int HW, int C,
                   int R, int cluster, int keep_rows, int rows_mode, int esize) {
  const Layout lay(C, R, cluster, keep_rows, rows_mode, esize);
  Params p;
  p.x = x;
  p.w1 = w1;
  p.w2 = w2;
  p.out = out;
  p.HW = HW;
  p.C = C;
  p.R = R;
  p.n = cluster;
  p.cs = lay.cs;
  p.keep_rows = keep_rows;
  p.rows_mode = rows_mode;
  p.lg1 = lanes_per_row_log2(R, lay.w);
  p.lg2 = lanes_per_row_log2(lay.w, R);
  p.staged = lay.staged;
  p.inv_hw = 1.0f / HW;
  p.xch = lay.xch;
  p.pooled = lay.pooled;
  p.s = lay.s;
  p.hidden = lay.hidden;
  p.w1s = lay.w1s;
  p.w2s = lay.w2s;
  p.red = lay.red;
  p.xs = lay.xs;
  p.bar = lay.bar;
  return p;
}

bool host_aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One launch of the form for element type E: 16-byte vectors (WIDE
// elements) where C and the pointers allow them, else single elements.
template <typename E>
int launch_se(const void* x, const void* w1, const void* w2, void* out, int B, int HW, int C,
              int R, int cluster, int keep_rows, int rows_mode, int smem_bytes, void* stream) {
  constexpr int WIDE = 16 / sizeof(E);
  if (!plan_ok(B, HW, C, R, cluster, keep_rows, rows_mode, smem_bytes, sizeof(E)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = C % WIDE == 0 && host_aligned16(x) && host_aligned16(out);
  const Params p =
      make_params(x, w1, w2, out, HW, C, R, cluster, keep_rows, rows_mode, sizeof(E));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = wide ? configure<E, WIDE>(cfg, attr, B * cluster, cluster, smem_bytes, st)
                         : configure<E, 1>(cfg, attr, B * cluster, cluster, smem_bytes, st);
  if (err != cudaSuccess) return err;
  err = wide ? cudaLaunchKernelEx(&cfg, Kernel<E, WIDE>::fn, p)
             : cudaLaunchKernelEx(&cfg, Kernel<E, 1>::fn, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename E, int VEC>
int active_clusters(int HW, int C, int R, int cluster, int keep_rows, int rows_mode,
                    int smem_bytes, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = configure<E, VEC>(cfg, attr, cluster, cluster, smem_bytes, 0);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, Kernel<E, VEC>::fn, &cfg);
}

}  // namespace

// x, out [B, HW, C]; w1 [R, C]; w2 [C, R]. One launch; the plan comes from
// ops/se_kernel.py:se_plan and is refused (cudaErrorInvalidValue) unless it
// matches this file's layout for 4-byte elements.
VQA_EXPORT int vqa_se_f32(const float* x, const float* w1, const float* w2, float* out, int B,
                          int HW, int C, int R, int cluster, int keep_rows, int rows_mode,
                          int smem_bytes, void* stream) {
  return launch_se<float>(x, w1, w2, out, B, HW, C, R, cluster, keep_rows, rows_mode,
                          smem_bytes, stream);
}

// The same in bf16 (x, w1, w2 and out), computed in f32, by the bf16 form's
// own kernel (se_bf16); the plan is se_plan's for 2-byte elements.
VQA_EXPORT int vqa_se_bf16(const void* x, const void* w1, const void* w2, void* out, int B,
                           int HW, int C, int R, int cluster, int keep_rows, int rows_mode,
                           int smem_bytes, void* stream) {
  return launch_se<__nv_bfloat16>(x, w1, w2, out, B, HW, C, R, cluster, keep_rows, rows_mode,
                                  smem_bytes, stream);
}

// How many clusters of a plan can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters), into *clusters; esize picks the form
// (4: f32, 2: bf16) and vec its 16-byte (4 or 8 elements) or single-element
// (1) instantiation.
VQA_EXPORT int vqa_se_max_active_clusters(int HW, int C, int R, int cluster, int keep_rows,
                                          int rows_mode, int smem_bytes, int vec, int esize,
                                          int* clusters) {
  if ((esize != 4 && esize != 2) || (vec != 1 && vec != 16 / esize) ||
      !plan_ok(1, HW, C, R, cluster, keep_rows, rows_mode, smem_bytes, esize))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (esize == 4)
    return vec == 1 ? active_clusters<float, 1>(HW, C, R, cluster, keep_rows, rows_mode,
                                                smem_bytes, clusters)
                    : active_clusters<float, 4>(HW, C, R, cluster, keep_rows, rows_mode,
                                                smem_bytes, clusters);
  return vec == 1 ? active_clusters<bf, 1>(HW, C, R, cluster, keep_rows, rows_mode, smem_bytes,
                                           clusters)
                  : active_clusters<bf, 8>(HW, C, R, cluster, keep_rows, rows_mode, smem_bytes,
                                           clusters);
}
