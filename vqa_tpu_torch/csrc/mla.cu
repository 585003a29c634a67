// Multi-head latent attention's core for Hopper, bf16 (models/decoder.py:MLA,
// ops/mla_kernel.py): for each pair b and head h, RoPE on the rotary dims of
// the query and of the key every head shares, masked scores, softmax and the
// context, read from and written to the projections' token-major buffers:
//
//   q    [B, L, H, NOPE + ROPE]   q_proj's output
//   kv   [B, L, H, NOPE + DV]     kv_b_proj's output: each head's key (no
//                                 rope part), then its value
//   kpe  row b*L + r at kpe + (b*L + r) * kpe_stride: ROPE elements, the
//                                 view of kv_a_proj_with_mqa's output
//   cos, sin [>= L, ROPE / 2] f32, keys [B, L] int32 (0 at padding)
//   out  [B, L, H, DV]            what o_proj reads
//
// It replaces no TPU kernel: the JAX package has no decoder. It replaces
// the chain of PyTorch calls that assembled each head's q, k and v in
// zeroed head-major buffers, added a materialised [B*H, P, P] mask to bf16
// scores, took their softmax in f32, cast it back and copied the context
// to token-major order, about 1.9 GB of traffic a layer at B = 256.
//
// What bounds it: at Kimi-VL-A3B's shapes (B = 256, L = 69, H = 16, dims
// 128 + 64 and 128) a layer reads 255.5 MB and writes 72.4 MB, 97.9 us at
// 3.35 TB/s, and does 12.5 GFLOP (12.6 us at the bf16 peak): about 38
// operations a byte, so bytes. The design reads each input byte once and
// keeps everything between in shared memory and registers:
//
// - One block per (pair, head), one warp per 16 query rows (5 warps at
//   L = 69: rows padded to 80). Everything a block reads goes by 16-byte
//   cp.async, issued before anything is waited on: K's no-rope part, the
//   shared rotary key as it is, the rope tables' first L rows and this
//   warp's own query rows as one commit group, V as a second, so the scores
//   and the softmax run while V lands. Rows are padded by 16 bytes (stride
//   400 B for 192 dims, 272 B for 128): ldmatrix reads 8 rows in distinct
//   banks. 106 KB of shared memory a block: two blocks per SM. (A first
//   form that read the rotary key and the tables with plain loads inside
//   its loops waited on each: 0.275 ms a layer, 36% of the bound.)
// - RoPE (DeepSeek-V3's, theta from the caller's tables) in f32 with
//   separate roundings (as apply_rope's multiply, multiply, subtract),
//   rounded once to bf16: the shared rotary key rotated in place once it
//   has landed (each of a pair's 16 blocks rotates the same 69 x 64 key,
//   read from L2), the query on each A fragment in registers. A fragment
//   register holds a pair (2i, 2i+1), so a rotated pair stays where it was
//   instead of moving to (i, i + ROPE/2) as DeepSeek-V3's layout puts it:
//   query and key are permuted alike, and the score is the same sum of the
//   same products.
// - Both products on the tensor cores (mma.sync m16n8k16, bf16 operands,
//   f32 accumulation); a warp computes only the key tiles its rows can see
//   (causal). The mask is computed from keys: no [B*H, P, P] tensor.
// - The scores stay f32 (the old path rounded them to bf16 before the
//   softmax); the softmax runs in registers over the quad that holds a
//   row, normalised in f32, then rounded to bf16 for P.V, as before.
// - Each warp stages its 16 context rows in its own query rows' shared
//   memory and stores them 16 bytes at a time to [B, L, H*DV].
// No synchronisation with the host, no allocation. A query that sees no
// key (never asked: the model's first key is an image token) gets zeros.
// On an H100 (700 W) at those shapes: 0.171 ms a layer, 57% of the bound
// (PERF.md keeps the numbers).
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_WARPS = 5;              // one warp per 16 query rows
constexpr int MAX_ROWS = 16 * MAX_WARPS;  // L <= 80
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* kv;
  const bf16* kpe;
  const float* cos;
  const float* sin;
  const int* keys;
  bf16* out;
  long long kpe_stride;
  int L, H;
  float scale_log2;  // (NOPE + ROPE)^-1/2 * log2(e)
};

template <int NOPE, int ROPE, int DV>
struct Shape {
  static constexpr int DQK = NOPE + ROPE;
  static constexpr int QS = DQK + 8;  // row stride of the staged q and k, elements
  static constexpr int VS = DV + 8;   // of the staged v
  static_assert(NOPE % 16 == 0 && ROPE % 16 == 0 && DV % 16 == 0, "dims in 16s");
  static_assert(DV <= QS, "the context is staged in the query rows");
  // q, k, v, which keys are real, and the rows' cos and sin
  static size_t smem(int rows) { return size_t(rows) * ((2 * QS + VS) * 2 + 4 + ROPE * 4); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(vqa::smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(vqa::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(vqa::smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulated
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The pair (x0, x1) = (2i, 2i+1) rotated: (x0 c - x1 s, x1 c + x0 s), each
// product and sum rounded apart (no fused multiply-add), as apply_rope's
// f32 tensor operations, then rounded once to bf16.
__device__ __forceinline__ uint32_t rotate(uint32_t pair, float c, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&pair);
  const float x0 = __low2float(v), x1 = __high2float(v);
  return pack(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)),
              __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, s)));
}

template <int NOPE, int ROPE, int DV>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2) mla_attention_bf16(const Params p) {
  using S = Shape<NOPE, ROPE, DV>;
  constexpr int DQK = S::DQK, QS = S::QS, VS = S::VS, HALF = ROPE / 2;
  // 16-byte chunks a row: q, k's no-rope part, the rotary key, v, a rope table
  constexpr int QC = DQK / 8, KC = NOPE / 8, RC = ROPE / 8, VC = DV / 8, TC = HALF / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.L, H = p.H;
  const int rows = blockDim.x / 2;  // 16 a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / H, head = blockIdx.x - b * H;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + rows * QS;
  bf16* sV = sK + rows * QS;
  float* sCos = reinterpret_cast<float*>(sV + rows * VS);  // [rows, HALF]
  float* sSin = sCos + rows * HALF;
  int* sKeep = reinterpret_cast<int*>(sSin + rows * HALF);

  const long long row0 = static_cast<long long>(b) * L;
  const bf16* qg = p.q + (row0 * H + head) * DQK;         // row r at + r * H * DQK
  const bf16* kg = p.kv + (row0 * H + head) * (NOPE + DV);  // row r at + r * H * (NOPE + DV)
  const int q0 = 16 * warp, qrows = min(16, L - q0);

  // 1. by 16-byte cp.async, nothing waited on until all are issued: K (its
  //    no-rope part, then the shared rotary key as it is), the rope tables'
  //    rows and this warp's query rows, one commit group; V, a second
  for (int i = threadIdx.x; i < L * KC; i += blockDim.x) {
    const int r = i / KC, c = i - r * KC;
    cp_async16(sK + r * QS + 8 * c, kg + static_cast<long long>(r) * H * (NOPE + DV) + 8 * c);
  }
  for (int i = threadIdx.x; i < L * RC; i += blockDim.x) {
    const int r = i / RC, c = i - r * RC;
    cp_async16(sK + r * QS + NOPE + 8 * c, p.kpe + (row0 + r) * p.kpe_stride + 8 * c);
  }
  for (int i = threadIdx.x; i < L * TC; i += blockDim.x) {
    const int r = i / TC, c = i - r * TC;
    cp_async16(sCos + r * HALF + 4 * c, p.cos + r * HALF + 4 * c);
    cp_async16(sSin + r * HALF + 4 * c, p.sin + r * HALF + 4 * c);
  }
  for (int i = lane; i < qrows * QC; i += 32) {
    const int r = i / QC, c = i - r * QC;
    cp_async16(sQ + (q0 + r) * QS + 8 * c, qg + static_cast<long long>(q0 + r) * H * DQK + 8 * c);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < L * VC; i += blockDim.x) {
    const int r = i / VC, c = i - r * VC;
    cp_async16(sV + r * VS + 8 * c,
               kg + static_cast<long long>(r) * H * (NOPE + DV) + NOPE + 8 * c);
  }
  cp_async_commit();

  // 2. which keys are real; V's padding rows zeroed (their probabilities
  //    are 0, their values must not be NaN); then, once the first group has
  //    landed, the shared rotary key rotated in place
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    sKeep[i] = i < L && __ldg(p.keys + row0 + i) != 0;
  for (int i = threadIdx.x; i < (rows - L) * VC; i += blockDim.x) {
    const int r = L + i / VC, c = i % VC;
    *reinterpret_cast<uint4*>(sV + r * VS + 8 * c) = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait<1>();
  __syncthreads();
  for (int i = threadIdx.x; i < L * HALF; i += blockDim.x) {
    const int r = i / HALF, j = i - r * HALF;
    uint32_t* pair = reinterpret_cast<uint32_t*>(sK + r * QS + NOPE + 2 * j);
    *pair = rotate(*pair, sCos[r * HALF + j], sSin[r * HALF + j]);
  }
  __syncthreads();

  // 3. scores of this warp's 16 rows against the keys they can see,
  //    0 .. 16 * warp + 15: two 8-key tiles per 16 keys
  const int g = lane / 4, t = lane % 4;
  const int r_lo = q0 + g, r_hi = r_lo + 8;
  // the rows' cos and sin (padding rows read the last real row's)
  const float* cos_lo = sCos + min(r_lo, L - 1) * HALF;
  const float* sin_lo = sSin + min(r_lo, L - 1) * HALF;
  const float* cos_hi = sCos + min(r_hi, L - 1) * HALF;
  const float* sin_hi = sSin + min(r_hi, L - 1) * HALF;
  float s[2 * MAX_WARPS][4];
#pragma unroll
  for (int j = 0; j < 2 * MAX_WARPS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, sQ + (q0 + lane % 16) * QS + 16 * kk + (lane / 16) * 8);
    if (16 * kk >= NOPE) {  // a rope k-step: a[0], a[1] hold pair i, a[2], a[3] pair i + 4
      const int i = (16 * kk - NOPE) / 2 + t;
      a[0] = rotate(a[0], cos_lo[i], sin_lo[i]);
      a[1] = rotate(a[1], cos_hi[i], sin_hi[i]);
      a[2] = rotate(a[2], cos_lo[i + 4], sin_lo[i + 4]);
      a[3] = rotate(a[3], cos_hi[i + 4], sin_hi[i + 4]);
    }
#pragma unroll
    for (int jp = 0; jp < MAX_WARPS; ++jp) {
      if (jp <= warp) {
        uint32_t k4[4];
        ldsm_x4(k4, sK + (16 * jp + lane % 8 + (lane / 16) * 8) * QS + 16 * kk +
                        ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * jp], a, k4[0], k4[1]);
        mma_bf16(s[2 * jp + 1], a, k4[2], k4[3]);
      }
    }
  }

  // 4. mask and softmax in f32: a row's keys are spread over the 4 lanes of
  //    its quad (lane t holds keys 8j + 2t, 8j + 2t + 1 of each tile j)
  float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * MAX_WARPS; ++j) {
    if (j < 2 * (warp + 1)) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * t + e;
        const bool real = sKeep[n];
        s[j][e] = real && n <= r_lo ? s[j][e] : -INFINITY;
        s[j][2 + e] = real && n <= r_hi ? s[j][2 + e] : -INFINITY;
        m_lo = fmaxf(m_lo, s[j][e]);
        m_hi = fmaxf(m_hi, s[j][2 + e]);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }
  const float c = p.scale_log2;
  const float base_lo = m_lo == -INFINITY ? 0.f : m_lo * c;
  const float base_hi = m_hi == -INFINITY ? 0.f : m_hi * c;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * MAX_WARPS; ++j) {
    if (j < 2 * (warp + 1)) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], c, -base_lo));
        s[j][2 + e] = exp2f(fmaf(s[j][2 + e], c, -base_hi));
        sum_lo += s[j][e];
        sum_hi += s[j][2 + e];
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
  }
  const float inv_lo = sum_lo > 0.f ? 1.f / sum_lo : 0.f;
  const float inv_hi = sum_hi > 0.f ? 1.f / sum_hi : 0.f;

  // 5. the context: P (normalised, rounded to bf16) times V, 16 keys a step
  cp_async_wait<0>();
  __syncthreads();
  float o[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MAX_WARPS; ++kk) {
    if (kk <= warp) {
      const uint32_t a[4] = {pack(s[2 * kk][0] * inv_lo, s[2 * kk][1] * inv_lo),
                             pack(s[2 * kk][2] * inv_hi, s[2 * kk][3] * inv_hi),
                             pack(s[2 * kk + 1][0] * inv_lo, s[2 * kk + 1][1] * inv_lo),
                             pack(s[2 * kk + 1][2] * inv_hi, s[2 * kk + 1][3] * inv_hi)};
#pragma unroll
      for (int vp = 0; vp < DV / 16; ++vp) {
        uint32_t v4[4];
        ldsm_x4_trans(v4, sV + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * VS + 16 * vp +
                              (lane / 16) * 8);
        mma_bf16(o[2 * vp], a, v4[0], v4[1]);
        mma_bf16(o[2 * vp + 1], a, v4[2], v4[3]);
      }
    }
  }

  // 6. rounded once to bf16, staged in this warp's own query rows, stored
  //    16 bytes at a time
  __syncwarp();
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    *reinterpret_cast<uint32_t*>(sQ + r_lo * QS + 8 * j + 2 * t) = pack(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(sQ + r_hi * QS + 8 * j + 2 * t) = pack(o[j][2], o[j][3]);
  }
  __syncwarp();
  bf16* og = p.out + (row0 * H + head) * DV;
  for (int i = lane; i < qrows * VC; i += 32) {
    const int r = i / VC, c8 = i - r * VC;
    *reinterpret_cast<uint4*>(og + static_cast<long long>(q0 + r) * H * DV + 8 * c8) =
        *reinterpret_cast<const uint4*>(sQ + (q0 + r) * QS + 8 * c8);
  }
}

template <int NOPE, int ROPE, int DV>
int launch(const Params& p, int B, cudaStream_t stream) {
  using S = Shape<NOPE, ROPE, DV>;
  const int warps = (p.L + 15) / 16;
  const size_t smem = S::smem(16 * warps);
  cudaError_t err = vqa::allow_smem(mla_attention_bf16<NOPE, ROPE, DV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_attention_bf16<NOPE, ROPE, DV><<<B * p.H, 32 * warps, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The head dims the kernel is built for: (NOPE, ROPE, DV) = (128, 64, 128),
// Kimi-VL-A3B's and DeepSeek-V3's, and (16, 16, 16), the tests' tiny
// decoder; 1 <= L <= 80. q, kv, kpe and out 16-byte aligned, kpe's row
// stride a multiple of 8. Anything else: cudaErrorInvalidValue, nothing
// launched (ops/mla_kernel.py checks the same first).
VQA_EXPORT int vqa_mla_attention_bf16(const void* q, const void* kv, const void* kpe,
                                      const void* cos, const void* sin, const void* keys,
                                      void* out, int B, int L, int H, int nope, int rope, int dv,
                                      long long kpe_stride, float scale, cudaStream_t stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_ROWS) return cudaErrorInvalidValue;
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
                 static_cast<const bf16*>(kpe), static_cast<const float*>(cos),
                 static_cast<const float*>(sin), static_cast<const int*>(keys),
                 static_cast<bf16*>(out), kpe_stride, L, H, scale * LOG2E};
  if (nope == 128 && rope == 64 && dv == 128) return launch<128, 64, 128>(p, B, stream);
  if (nope == 16 && rope == 16 && dv == 16) return launch<16, 16, 16>(p, B, stream);
  return cudaErrorInvalidValue;
}
