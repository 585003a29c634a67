// Cross-attention core for Hopper, in f32: per (batch, head) slice,
// w = softmax(Q K^T * (1/scale)) and ctx = w V. Writes both the context and
// the probabilities (the engine's attention maps read them).
//
// Replaces the Pallas TPU kernel vqa_tpu/ops/cross_attention_kernel.py
// (_fused_cross_attention_bh, pl.pallas_call at :73). As there, the scores
// never reach device memory. Scores are multiplied by 1/scale as the TPU
// kernel does (cross_attention_kernel.py:49); softmax subtracts the row max,
// takes expf and divides by the row sum, in f32.
//
// What bounds it: at the model's shapes (Lq=20, Lkv=49, d=32, B*8 slices) a
// slice is 0.13 MFLOP and ~21 KB, so the call is a few microseconds of
// memory traffic and the rest is latency. The tensor cores do not help; the
// design keeps every value in registers and moves it by warp shuffles:
//
// - One block per slice stages Q, K and V in shared memory with 16-byte
//   cp.async copies (one __syncthreads). Inputs are strided views (the
//   model passes head-transposed views of its [B,L,H,d] projections, no
//   copies); only the last dimension must have unit stride.
// - One warp per ROWS query rows at once. Lane j owns keys j, j+32, ...:
//   it forms their scores against each row, reading K rows as float4 from
//   shared memory (row stride odd in float4s: conflict-free) and the query
//   rows as broadcasts. Row max and sum are warp shuffles; the
//   probabilities are stored from registers, coalesced over keys.
// - Lane d then forms ctx[d] = sum_j p_j V[j][d], fetching each p_j from its
//   owner lane by __shfl_sync; each V element read serves ROWS rows.
// - The context is written through the caller's strides, so the wrapper
//   can hand back a [B,H,Lq,d] view of [B,Lq,H,d] memory.
//
// At the main path's shapes (B=32, 256 slices) launch and staging take
// about a third of the kernel's time on the H100, and what remains is most
// likely the shared-memory pipe, which serves both the loads and the
// shuffles. 2 rows per warp with 10 warps is faster there than 4 rows with
// 5 warps or 1 row with 20.
//
// The head width D and the keys per lane KPL = ceil(Lkv/32) are template
// parameters so the loops unroll: D in {16, 32, 64} with KPL in {1, 2}. One
// general instantiation (runtime D <= 128, Lkv <= 256) runs every other
// shape; the launcher refuses anything beyond it.
//
// bf16 form (vqa_cross_attention_bf16): q, k and v in bf16, the context and
// the probabilities written in bf16, everything between in f32, as the TPU
// kernel upcasts its blocks (cross_attention_kernel.py:41-43) and casts its
// outputs once (:56-57). It has its own kernel (cross_attention_bf16, below):
//
// - What bounds it: at the main path's shapes a launch moves ~2.8 MB (half
//   the f32 form's bytes, ~0.8 us at 3.35 TB/s) and does 0.13 MFLOP per
//   slice, so not bytes: on the H100 a launch is ~1.3 us of launch and
//   drain and ~4.3 us of block, of which ~0.9 us is the staging round
//   trip and the rest FP32 instruction issue (tools/bf16_phases.py stamps
//   each phase).
// - bf16 stays bf16 in shared memory: q, k and v are staged by 16-byte
//   cp.async (a 32-wide head row is 64 bytes) with no conversion on the
//   way in, so every copy of the block is in flight at once and the block
//   waits once; the old design converted on the way in with synchronous
//   loads. Unaligned views keep element loads.
// - One (batch, head) slice per block, two query rows per warp (10 warps
//   at L_q = 20, 256 blocks at B = 32). P.V reads each key's pair of
//   probabilities from shared memory as one broadcast instead of fetching
//   it from its owner lane by a shuffle (the old design's chain of 49
//   shuffles per row pair).
// - Each warp stages its own rows' outputs and stores them itself, 16
//   bytes at a time: its weights are one contiguous run of [B,H,Lq,Lkv],
//   copied at the alignment of its destination; its context rows are 64
//   contiguous bytes each. No block barrier after the staging one.
// - The arithmetic is the f32 form's, in the same order: scores are
//   sequential f32 FMA chains over d (a product of two bf16 values is exact
//   in f32), times 1/scale, then max, expf, sum and a division; the context
//   a sequential chain over the keys.
// - Tried and dropped (PERF.md, PR 13): two slices per block and four or
//   one rows per warp (each slower on the H100); QK^T on the tensor cores
//   (mma.sync m16n8k16 bf16), with P.V on the tensor cores (P split into
//   bf16 hi + lo) or in f32, dropped on a CPU emulation before any chip
//   run: any other order of the d-sums moves a few context elements per
//   main-path call, those near 0 after cancellation, by more than one bf16
//   ulp from plain_cross_attention (an exact f64 sum does too), and a hi +
//   lo split of P more of them; the tolerance is one ulp per element.
//   Programmatic dependent launch was not tried: it could save at most
//   the launch gap before each of the two calls, inside the graphed
//   forward's run-to-run spread.

#include "common.cuh"

namespace {

constexpr int ROWS = 2;         // query rows a warp holds at once
constexpr int MAX_WARPS = 10;   // warps per block (one slice per block): Lq = 20 in one pass
constexpr int GENERAL_KPL = 8;  // keys per lane of the general kernel: Lkv <= 256
constexpr int MAX_D = 128;
constexpr unsigned FULL = 0xffffffffu;

template <typename E>  // element type in device memory: float (the bf16 form has its own kernel)
struct Args {
  const E* q;
  const E* k;
  const E* v;
  E* ctx;
  E* w;
  long long qs[3], ks[3], vs[3], cs[3];  // strides (batch, head, row) in floats
  int H, Lq, Lkv, D;
  float inv_scale;
  int vec;  // D % 4 == 0 and every row start aligned to 4 elements: vector loads
};

__host__ __device__ inline int d4_of(int D) { return (D + 3) / 4; }
// K row stride in float4s: odd, so the 8 lanes of a float4 phase hit
// distinct banks when they read 8 consecutive key rows
__host__ __device__ inline int kstride4(int D) { return d4_of(D) | 1; }
__host__ inline size_t smem_bytes(int Lq, int Lkv, int D) {
  const size_t nkeys = 32 * size_t((Lkv + 31) / 32);
  return sizeof(float4) * (size_t(Lq) * d4_of(D) + nkeys * kstride4(D) + nkeys * d4_of(D));
}

// 16-byte asynchronous copy global -> shared
__device__ __forceinline__ void cp_async16(float4* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

// 4 aligned elements into one float4 of shared memory by cp.async
__device__ __forceinline__ void copy4(float4* dst, const float* src) { cp_async16(dst, src); }

// rows [0, rows) of a [rows][D] strided source into shared memory as f32
// float4 rows of dst_stride4; rows >= valid and columns >= D are zero.
// Aligned f32 sources go by cp.async, so a thread issues all its copies
// without waiting on any; the caller waits (cp.async.wait_all) before its
// __syncthreads.
template <typename E>
__device__ __forceinline__ void stage_rows(float4* dst, int dst_stride4, const E* src,
                                           long long row_stride, int rows, int valid,
                                           int D, int D4, bool vec) {
  for (int i = threadIdx.x; i < rows * D4; i += blockDim.x) {
    const int r = i / D4, c = i - r * D4;
    float4* d = dst + r * dst_stride4 + c;
    const E* p = src + r * row_stride + 4 * c;
    if (r >= valid) {
      *d = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec) {
      copy4(d, p);
    } else {
      const int n = min(4, D - 4 * c);
      float4 val = make_float4(vqa::to_f32(p[0]), 0.f, 0.f, 0.f);
      if (n > 1) val.y = vqa::to_f32(p[1]);
      if (n > 2) val.z = vqa::to_f32(p[2]);
      if (n > 3) val.w = vqa::to_f32(p[3]);
      *d = val;
    }
  }
}

template <typename E, int DT, int KPL>  // DT = 0: the general kernel, runtime D
__global__ void __launch_bounds__(32 * MAX_WARPS)
cross_attention_kernel(const Args<E> a) {
  constexpr int DPL = DT ? (DT + 31) / 32 : MAX_D / 32;  // context dims per lane
  const int D = DT ? DT : a.D;
  const int D4 = d4_of(D), KS4 = kstride4(D), VS = 4 * D4;
  const int Lq = a.Lq, Lkv = a.Lkv;
  const int kpl = DT ? KPL : (Lkv + 31) / 32;
  const int nkeys = 32 * kpl;

  extern __shared__ __align__(16) float4 sm4[];
  float4* q_s = sm4;                // [Lq][D4]
  float4* k_s = q_s + Lq * D4;      // [nkeys][KS4]
  float4* v_s = k_s + nkeys * KS4;  // [nkeys][D4]

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const bool vec = a.vec;
  stage_rows(q_s, D4, a.q + b * a.qs[0] + h * a.qs[1], a.qs[2], Lq, Lq, D, D4, vec);
  stage_rows(k_s, KS4, a.k + b * a.ks[0] + h * a.ks[1], a.ks[2], nkeys, Lkv, D, D4, vec);
  stage_rows(v_s, D4, a.v + b * a.vs[0] + h * a.vs[1], a.vs[2], nkeys, Lkv, D, D4, vec);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  E* wb = a.w + size_t(bh) * Lq * Lkv;
  E* cb = a.ctx + b * a.cs[0] + h * a.cs[1];
  const float* vsf = reinterpret_cast<const float*>(v_s);
  const float neg_inf = -__int_as_float(0x7f800000);

  for (int r0 = warp * ROWS; r0 < Lq; r0 += nwarps * ROWS) {
    int row[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) row[r] = min(r0 + r, Lq - 1);  // spare rows: not stored

    // scores of this lane's keys against the ROWS rows
    float s[ROWS][KPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[r][kk] = 0.f;
#pragma unroll
    for (int c = 0; c < D4; ++c) {
      float4 kv[KPL];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk)
        if (kk < kpl) kv[kk] = k_s[(kk * 32 + lane) * KS4 + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = q_s[row[r] * D4 + c];
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          if (kk < kpl) {
            float t = fmaf(qv.x, kv[kk].x, s[r][kk]);
            t = fmaf(qv.y, kv[kk].y, t);
            t = fmaf(qv.z, kv[kk].z, t);
            s[r][kk] = fmaf(qv.w, kv[kk].w, t);
          }
        }
      }
    }

    // softmax per row, in registers; s becomes the probabilities
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float m = neg_inf;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const bool real = kk < kpl && kk * 32 + lane < Lkv;
        s[r][kk] = real ? s[r][kk] * a.inv_scale : neg_inf;
        m = fmaxf(m, s[r][kk]);
      }
      m = vqa::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        s[r][kk] = kk < kpl ? expf(s[r][kk] - m) : 0.f;
        sum += s[r][kk];
      }
      sum = vqa::warp_sum(sum);
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[r][kk] = s[r][kk] / sum;
      if (r0 + r < Lq) {
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          const int j = kk * 32 + lane;
          if (kk < kpl && j < Lkv) wb[(r0 + r) * Lkv + j] = vqa::from_f32<E>(s[r][kk]);
        }
      }
    }

    // context: lane d sums p_j V[j][d] over keys, p_j shuffled from lane j%32
    float acc[ROWS][DPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      if (kk >= kpl) break;
      const int n = min(32, Lkv - 32 * kk);
      const float* vrow = vsf + size_t(32 * kk) * VS;
#pragma unroll 4
      for (int src = 0; src < n; ++src) {
        float vv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          vv[i] = d < D ? vrow[src * VS + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float p = __shfl_sync(FULL, s[r][kk], src);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r0 + r >= Lq) continue;
      E* crow = cb + (r0 + r) * a.cs[2];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) crow[d] = vqa::from_f32<E>(acc[r][i]);
      }
    }
  }
}

template <typename E, int DT, int KPL>
cudaError_t launch(const Args<E>& a, int BH, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = vqa::allow_smem(cross_attention_kernel<E, DT, KPL>, smem);
  if (err != cudaSuccess) return err;
  cross_attention_kernel<E, DT, KPL><<<BH, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// 4 elements at a time need every row start aligned to 4 elements: 16
// bytes in f32, 8 in bf16
bool aligned4(const void* p, size_t esize) {
  return (reinterpret_cast<size_t>(p) & (4 * esize - 1)) == 0;
}

template <typename E>
int run(const E* q, const E* k, const E* v, E* ctx, E* w, int B, int H, int Lq, int Lkv, int D,
        const long long (&st)[12], float inv_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lkv <= 0 || D <= 0 || D > MAX_D ||
      Lkv > 32 * GENERAL_KPL || (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Lq, Lkv, D);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  Args<E> a{q, k, v, ctx, w, {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
            {st[9], st[10], st[11]}, H, Lq, Lkv, D, inv_scale, 0};
  bool vec = D % 4 == 0 && aligned4(q, sizeof(E)) && aligned4(k, sizeof(E)) &&
             aligned4(v, sizeof(E));
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 4 == 0;  // the inputs' strides
  a.vec = vec;
  const int warps = min(MAX_WARPS, (Lq + ROWS - 1) / ROWS);
  const int threads = 32 * warps, BH = B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kpl = (Lkv + 31) / 32;
  if (kpl == 1) {
    if (D == 16) return launch<E, 16, 1>(a, BH, threads, smem, s);
    if (D == 32) return launch<E, 32, 1>(a, BH, threads, smem, s);
    if (D == 64) return launch<E, 64, 1>(a, BH, threads, smem, s);
  } else if (kpl == 2) {
    if (D == 16) return launch<E, 16, 2>(a, BH, threads, smem, s);
    if (D == 32) return launch<E, 32, 2>(a, BH, threads, smem, s);
    if (D == 64) return launch<E, 64, 2>(a, BH, threads, smem, s);
  }
  return launch<E, 0, GENERAL_KPL>(a, BH, threads, smem, s);
}

// ---- the bf16 form: its own kernel --------------------------------------

constexpr int ROWS16 = 2;        // query rows a warp holds at once
constexpr int MAX_WARPS16 = 16;  // warps per block (one slice): L_q = 32 in one pass
constexpr int MAX_SMEM16 = 227 * 1024;

constexpr int round16(long long v) { return static_cast<int>((v + 15) & ~15LL); }

// Launch geometry and shared-memory layout (bytes) of the bf16 form, one
// (batch, head) slice per block; mirrored by
// ops/cross_attention_kernel.py:bf16_geometry. q [Lq][ldq], k [Lkv][ldk]
// and v [Lkv][ldq] stay bf16 (ldq = D rounded up to 8; ldk = ldq + 8, so
// that 16-byte reads of 8 lanes from 8 key rows hit distinct banks); each
// warp owns its rows' probabilities in f32 [Lkv][ROWS16] for P.V and its
// rows' outputs staged for 16-byte stores: the weights [ROWS16 * Lkv] (16
// bytes more, to shift them to the alignment of their destination) and
// the context [ROWS16][ldq]. Only the warp's own rows are staged, so the
// layout grows with L_q by its bf16 q rows alone and takes every shape the
// f32 layout takes.
struct Geometry16 {
  int warps, threads, ldq, ldk, q, k, v, per_warp, p, w, c, total;
  Geometry16(int Lq, int Lkv, int D) {
    warps = min(MAX_WARPS16, (Lq + ROWS16 - 1) / ROWS16);
    threads = 32 * warps;
    ldq = (D + 7) / 8 * 8;
    ldk = ldq + 8;
    q = 0;
    k = q + round16(2LL * Lq * ldq);
    v = k + round16(2LL * Lkv * ldk);
    p = 0;  // offsets within a warp's part
    w = p + round16(4LL * Lkv * ROWS16);
    c = w + round16(2LL * ROWS16 * Lkv + 16);
    per_warp = c + round16(2LL * ROWS16 * ldq);
    const int warps0 = v + round16(2LL * Lkv * ldq);
    total = warps0 + warps * per_warp;
  }
  int warp_base() const { return total - warps * per_warp; }
};

using bf16 = __nv_bfloat16;

struct Args16 {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* ctx;
  bf16* w;
  long long qs[3], ks[3], vs[3], cs[3];  // strides (batch, head, row) in elements
  int H, Lq, Lkv, D;
  float inv_scale;
  int vec;   // q, k and v rows by 16-byte cp.async
  int cvec;  // context rows by 16-byte stores
  int warps, off_k, off_v, off_warps, per_warp, off_p, off_w, off_c;
};

// rows x D elements of a strided source into shared rows of ld elements:
// 16-byte cp.async where vec, else element by element with columns D to
// ld zeroed (the dot products run over whole 8-element chunks).
__device__ __forceinline__ void stage16(bf16* dst, int ld, const bf16* src, long long row_stride,
                                        int rows, int D, bool vec) {
  const int D8 = (D + 7) / 8;
  for (int i = threadIdx.x; i < rows * D8; i += blockDim.x) {
    const int r = i / D8, c = i - r * D8;
    bf16* d = dst + r * ld + 8 * c;
    const bf16* s = src + r * row_stride + 8 * c;
    if (vec) {
      cp_async16(reinterpret_cast<float4*>(d), reinterpret_cast<const float*>(s));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = 8 * c + e < D ? s[e] : __float2bfloat16_rn(0.f);
    }
  }
}

// 8 bf16 (16 bytes) as f32
__device__ __forceinline__ void bf16x8_to_f32(const uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One (batch, head) slice per block; q, k and v staged as bf16 by
// cp.async, each warp taking ROWS16 query rows at a time. Lane j owns keys
// j, j + 32, ...: their scores are sequential f32 FMA chains over d (bf16
// products are exact in f32), the softmax is the f32 form's (warp max and
// sum, expf, a division); the warp's probabilities go to shared memory in
// f32 and lane d sums p_j V[j][d] over j in order, each pair of p_j one
// broadcast read. The arithmetic and its order are those of the f32
// kernel, so each output is its f32 value rounded once. The warp stores
// its rows itself, 16 bytes at a time: its weights are one contiguous run
// of [B,H,Lq,Lkv] and its context rows 64 contiguous bytes each (D = 32).
static_assert(ROWS16 == 2, "a warp's probabilities of one key are one float2");

template <int DT, int KPL>  // DT = 0: runtime D <= 128
__global__ void __launch_bounds__(32 * MAX_WARPS16)
cross_attention_bf16(const __grid_constant__ Args16 a) {
  constexpr int DPL = DT ? (DT + 31) / 32 : MAX_D / 32;  // context dims per lane
  const int D = DT ? DT : a.D;
  const int D8 = (D + 7) / 8, ldq = 8 * D8, ldk = ldq + 8;
  const int Lq = a.Lq, Lkv = a.Lkv;
  const int kpl = DT ? KPL : (Lkv + 31) / 32;
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* q_s = reinterpret_cast<bf16*>(sm);
  bf16* k_s = reinterpret_cast<bf16*>(sm + a.off_k);
  bf16* v_s = reinterpret_cast<bf16*>(sm + a.off_v);
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;

  // phase 0: start
  // 1. q, k and v, by cp.async where aligned
  stage16(q_s, ldq, a.q + b * a.qs[0] + h * a.qs[1], a.qs[2], Lq, D, a.vec);
  stage16(k_s, ldk, a.k + b * a.ks[0] + h * a.ks[1], a.ks[2], Lkv, D, a.vec);
  stage16(v_s, ldq, a.v + b * a.vs[0] + h * a.vs[1], a.vs[2], Lkv, D, a.vec);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // phase 1: q, k and v staged
  // 2. each warp's rows: scores, softmax, context, then their stores
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = sm + a.off_warps + warp * a.per_warp;
  float* pw = reinterpret_cast<float*>(mine + a.off_p);  // [Lkv][ROWS16]
  bf16* cw = reinterpret_cast<bf16*>(mine + a.off_c);    // [ROWS16][ldq]
  bf16* const cb = a.ctx + b * a.cs[0] + h * a.cs[1];
  const float neg_inf = -__int_as_float(0x7f800000);
  for (int r0 = warp * ROWS16; r0 < Lq; r0 += a.warps * ROWS16) {
    const int nrows = min(ROWS16, Lq - r0);
    int row[ROWS16];
#pragma unroll
    for (int r = 0; r < ROWS16; ++r) row[r] = min(r0 + r, Lq - 1);  // spare rows: not stored
    // the rows' weights, one run; staged at its offset in 16 bytes
    bf16* wg = a.w + (static_cast<long long>(bh) * Lq + r0) * Lkv;
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(wg) >> 1) & 7);
    bf16* ww = reinterpret_cast<bf16*>(mine + a.off_w) + mis;

    // each score a chain over d in order, chunk by chunk, every chain of
    // the warp's rows and the lane's keys advancing together (spare keys,
    // past Lkv, read the last key's row and are masked below)
    float s[ROWS16][KPL];
#pragma unroll
    for (int r = 0; r < ROWS16; ++r)
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[r][kk] = 0.f;
#pragma unroll
    for (int c = 0; c < D8; ++c) {
      float kf[KPL][8];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk)
        if (kk < kpl)
          bf16x8_to_f32(
              *reinterpret_cast<const uint4*>(k_s + min(kk * 32 + lane, Lkv - 1) * ldk + 8 * c),
              kf[kk]);
#pragma unroll
      for (int r = 0; r < ROWS16; ++r) {
        float qf[8];
        bf16x8_to_f32(*reinterpret_cast<const uint4*>(q_s + row[r] * ldq + 8 * c), qf);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          if (kk >= kpl) continue;
          float t = s[r][kk];
#pragma unroll
          for (int e = 0; e < 8; ++e) t = fmaf(qf[e], kf[kk][e], t);
          s[r][kk] = t;
        }
      }
    }
    // phase 2: scores (thread 0's rows)

#pragma unroll
    for (int r = 0; r < ROWS16; ++r) {
      float m = neg_inf;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const bool real = kk < kpl && kk * 32 + lane < Lkv;
        s[r][kk] = real ? s[r][kk] * a.inv_scale : neg_inf;
        m = fmaxf(m, s[r][kk]);
      }
      m = vqa::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        s[r][kk] = kk < kpl ? expf(s[r][kk] - m) : 0.f;
        sum += s[r][kk];
      }
      sum = vqa::warp_sum(sum);
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int j = kk * 32 + lane;
        if (kk < kpl && j < Lkv) {
          const float pr = s[r][kk] / sum;
          pw[j * ROWS16 + r] = pr;
          ww[r * Lkv + j] = __float2bfloat16_rn(pr);
        }
      }
    }
    __syncwarp();
    // phase 3: softmax (thread 0's rows)

    float acc[ROWS16][DPL];
#pragma unroll
    for (int r = 0; r < ROWS16; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < Lkv; ++j) {
      const float2 pj = *reinterpret_cast<const float2*>(pw + j * ROWS16);
      const float pr[ROWS16] = {pj.x, pj.y};
      float vv[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? __bfloat162float(v_s[j * ldq + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS16; ++r)
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] = fmaf(pr[r], vv[i], acc[r][i]);
    }
#pragma unroll
    for (int r = 0; r < ROWS16; ++r)
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) cw[r * ldq + d] = __float2bfloat16_rn(acc[r][i]);
      }
    __syncwarp();
    // phase 4: context (thread 0's rows)

    // the rows' stores: the weights' run, 16 bytes at a time between its
    // unaligned ends, and each context row in 16-byte chunks where aligned
    const int n = nrows * Lkv, head = min((8 - mis) & 7, n), chunks = (n - head) / 8;
    for (int i = lane; i < head; i += 32) wg[i] = ww[i];
    for (int i = lane; i < chunks; i += 32)
      reinterpret_cast<uint4*>(wg + head)[i] = reinterpret_cast<const uint4*>(ww + head)[i];
    for (int i = head + 8 * chunks + lane; i < n; i += 32) wg[i] = ww[i];
    if (a.cvec) {
      for (int e = lane; e < nrows * D8; e += 32) {
        const int r = e / D8, c = e - r * D8;
        *reinterpret_cast<uint4*>(cb + (r0 + r) * a.cs[2] + 8 * c) =
            *reinterpret_cast<const uint4*>(cw + r * ldq + 8 * c);
      }
    } else {
      for (int e = lane; e < nrows * D; e += 32) {
        const int r = e / D, d = e - r * D;
        cb[(r0 + r) * a.cs[2] + d] = cw[r * ldq + d];
      }
    }
    __syncwarp();  // the staging is rewritten by the next rows
  }
  // phase 5: stores issued
}

template <int DT, int KPL>
cudaError_t launch16(const Args16& a, int blocks, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = vqa::allow_smem(cross_attention_bf16<DT, KPL>, smem);
  if (err != cudaSuccess) return err;
  cross_attention_bf16<DT, KPL><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

bool refused16(int B, int H, int Lq, int Lkv, int D) {
  return B <= 0 || H <= 0 || Lq <= 0 || Lkv <= 0 || D <= 0 || D > MAX_D ||
         Lkv > 32 * GENERAL_KPL || (long long)B * H > 0x7fffffffLL ||
         Geometry16(Lq, Lkv, D).total > MAX_SMEM16;
}

int run16(const bf16* q, const bf16* k, const bf16* v, bf16* ctx, bf16* w, int B, int H, int Lq,
          int Lkv, int D, const long long (&st)[12], float inv_scale, void* stream) {
  if (refused16(B, H, Lq, Lkv, D)) return cudaErrorInvalidValue;
  const Geometry16 g(Lq, Lkv, D);
  Args16 a{q, k, v, ctx, w, {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
           {st[9], st[10], st[11]}, H, Lq, Lkv, D, inv_scale, 0, 0, g.warps, g.k, g.v,
           g.warp_base(), g.per_warp, g.p, g.w, g.c};
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;  // the inputs' strides
  a.vec = vec;
  a.cvec = D % 8 == 0 && aligned16(ctx) && st[9] % 8 == 0 && st[10] % 8 == 0 &&
           st[11] % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = g.total;
  const int kpl = (Lkv + 31) / 32, blocks = B * H;
  if (kpl == 1) {
    if (D == 16) return launch16<16, 1>(a, blocks, g.threads, smem, s);
    if (D == 32) return launch16<32, 1>(a, blocks, g.threads, smem, s);
    if (D == 64) return launch16<64, 1>(a, blocks, g.threads, smem, s);
  } else if (kpl == 2) {
    if (D == 16) return launch16<16, 2>(a, blocks, g.threads, smem, s);
    if (D == 32) return launch16<32, 2>(a, blocks, g.threads, smem, s);
    if (D == 64) return launch16<64, 2>(a, blocks, g.threads, smem, s);
  }
  return launch16<0, GENERAL_KPL>(a, blocks, g.threads, smem, s);
}

}  // namespace

// q [B,H,Lq,D], k and v [B,H,Lkv,D] with element strides (batch, head, row)
// and unit stride along D; ctx written through its strides (c*); w [B,H,Lq,Lkv]
// contiguous; f32. D <= 128 and Lkv <= 256.
VQA_EXPORT int vqa_cross_attention_f32(
    const float* q, const float* k, const float* v, float* ctx, float* w, int B, int H,
    int Lq, int Lkv, int D, long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh, long long vsl,
    long long csb, long long csh, long long csl, float inv_scale, void* stream) {
  const long long st[12] = {qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, csb, csh, csl};
  return run<float>(q, k, v, ctx, w, B, H, Lq, Lkv, D, st, inv_scale, stream);
}

// The same in bf16: every tensor bf16, computed in f32 by the bf16 form's
// own kernel (cross_attention_bf16).
VQA_EXPORT int vqa_cross_attention_bf16(
    const void* q, const void* k, const void* v, void* ctx, void* w, int B, int H,
    int Lq, int Lkv, int D, long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh, long long vsl,
    long long csb, long long csh, long long csl, float inv_scale, void* stream) {
  const long long st[12] = {qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl, csb, csh, csl};
  return run16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(ctx), static_cast<bf16*>(w), B, H,
               Lq, Lkv, D, st, inv_scale, stream);
}

// The bf16 form's launch geometry for B*H slices of Lq queries, Lkv keys
// and width D, into out[3]: warps per block (one slice), threads per block
// and shared-memory bytes (cudaErrorInvalidValue where the kernel refuses
// the shape). ops/cross_attention_kernel.py mirrors it.
VQA_EXPORT int vqa_cross_attention_bf16_geometry(int B, int H, int Lq, int Lkv, int D,
                                                 int* out) {
  if (refused16(B, H, Lq, Lkv, D)) return cudaErrorInvalidValue;
  const Geometry16 g(Lq, Lkv, D);
  out[0] = g.warps;
  out[1] = g.threads;
  out[2] = g.total;
  return 0;
}
