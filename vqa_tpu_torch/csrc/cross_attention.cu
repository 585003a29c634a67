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

#include "common.cuh"

namespace {

constexpr int ROWS = 2;         // query rows a warp holds at once
constexpr int MAX_WARPS = 10;   // warps per block (one slice per block): Lq = 20 in one pass
constexpr int GENERAL_KPL = 8;  // keys per lane of the general kernel: Lkv <= 256
constexpr int MAX_D = 128;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* ctx;
  float* w;
  long long qs[3], ks[3], vs[3], cs[3];  // strides (batch, head, row) in floats
  int H, Lq, Lkv, D;
  float inv_scale;
  int vec;  // every row start 16-byte aligned and D % 4 == 0: float4 loads
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

// rows [0, rows) of a [rows][D] strided source into shared memory as float4
// rows of dst_stride4; rows >= valid and columns >= D are zero. Aligned
// sources go by cp.async, so a thread issues all its copies without waiting
// on any; the caller waits (cp.async.wait_all) before its __syncthreads.
__device__ __forceinline__ void stage_rows(float4* dst, int dst_stride4, const float* src,
                                           long long row_stride, int rows, int valid,
                                           int D, int D4, bool vec) {
  for (int i = threadIdx.x; i < rows * D4; i += blockDim.x) {
    const int r = i / D4, c = i - r * D4;
    float4* d = dst + r * dst_stride4 + c;
    const float* p = src + r * row_stride + 4 * c;
    if (r >= valid) {
      *d = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (vec) {
      cp_async16(d, p);
    } else {
      const int n = min(4, D - 4 * c);
      float4 val = make_float4(p[0], 0.f, 0.f, 0.f);
      if (n > 1) val.y = p[1];
      if (n > 2) val.z = p[2];
      if (n > 3) val.w = p[3];
      *d = val;
    }
  }
}

template <int DT, int KPL>  // DT = 0: the general kernel, runtime D
__global__ void __launch_bounds__(32 * MAX_WARPS)
cross_attention_kernel(const Args a) {
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
  float* wb = a.w + size_t(bh) * Lq * Lkv;
  float* cb = a.ctx + b * a.cs[0] + h * a.cs[1];
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
          if (kk < kpl && j < Lkv) wb[(r0 + r) * Lkv + j] = s[r][kk];
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
      float* crow = cb + (r0 + r) * a.cs[2];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) crow[d] = acc[r][i];
      }
    }
  }
}

template <int DT, int KPL>
cudaError_t launch(const Args& a, int BH, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = vqa::allow_smem(cross_attention_kernel<DT, KPL>, smem);
  if (err != cudaSuccess) return err;
  cross_attention_kernel<DT, KPL><<<BH, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

// q [B,H,Lq,D], k and v [B,H,Lkv,D] with element strides (batch, head, row)
// and unit stride along D; ctx written through its strides (c*); w [B,H,Lq,Lkv]
// contiguous; f32. D <= 128 and Lkv <= 256.
VQA_EXPORT int vqa_cross_attention_f32(
    const float* q, const float* k, const float* v, float* ctx, float* w, int B, int H,
    int Lq, int Lkv, int D, long long qsb, long long qsh, long long qsl, long long ksb,
    long long ksh, long long ksl, long long vsb, long long vsh, long long vsl,
    long long csb, long long csh, long long csl, float inv_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lkv <= 0 || D <= 0 || D > MAX_D ||
      Lkv > 32 * GENERAL_KPL || (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Lq, Lkv, D);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  Args a{q, k, v, ctx, w, {qsb, qsh, qsl}, {ksb, ksh, ksl}, {vsb, vsh, vsl},
         {csb, csh, csl}, H, Lq, Lkv, D, inv_scale, 0};
  bool vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const long long in_strides[] = {qsb, qsh, qsl, ksb, ksh, ksl, vsb, vsh, vsl};
  for (long long s : in_strides) vec = vec && s % 4 == 0;
  a.vec = vec;
  const int warps = min(MAX_WARPS, (Lq + ROWS - 1) / ROWS);
  const int threads = 32 * warps, BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kpl = (Lkv + 31) / 32;
  if (kpl == 1) {
    if (D == 16) return launch<16, 1>(a, BH, threads, smem, st);
    if (D == 32) return launch<32, 1>(a, BH, threads, smem, st);
    if (D == 64) return launch<64, 1>(a, BH, threads, smem, st);
  } else if (kpl == 2) {
    if (D == 16) return launch<16, 2>(a, BH, threads, smem, st);
    if (D == 32) return launch<32, 2>(a, BH, threads, smem, st);
    if (D == 64) return launch<64, 2>(a, BH, threads, smem, st);
  }
  return launch<0, GENERAL_KPL>(a, BH, threads, smem, st);
}
