// Kimi Delta Attention's core for Hopper, bf16 in and out, f32 between
// (models/decoder.py:KDA, ops/kda_kernel.py): for each pair b and head h,
// the short convolutions, the L2 norms, the per-channel decay, beta and the
// gated delta rule over the pair's positions, read from and written to the
// projections' token-major buffers:
//
//   q, k, v  rows b*L + t at q + (b*L + t) * ldq, H*D elements: q_proj's,
//            k_proj's and v_proj's outputs before their convolutions
//   g        rows at g + (b*L + t) * ldg, H*D: f_b_proj's output
//   beta     rows at b + (b*L + t) * ldb, H: b_proj's logits
//   wq, wk, wv [H*D, W] f32 (the depthwise convolutions' weights), A_log
//            [H] f32, dt_bias [H*D] f32
//   out      [B, L, H, D]: o, what o_norm reads
//
// It replaces no TPU kernel: the JAX package has no decoder. In plain
// PyTorch the recurrence is a loop of L steps of several launches each,
// every step reading and writing the whole [B, H, D, D] f32 state.
//
// What bounds it: at Kimi-Linear's shapes (B = 256, L = 69, H = 32, D =
// 128) a layer reads 0.58 GB and writes 0.14 GB (0.22 ms at 3.35 TB/s), and
// its recurrence does 4 f32 operations per state element per position,
// 37 G a layer: 1.1 ms on the f32 pipes of 132 SMs. So the f32 pipes, and
// the design keeps them fed as far as a recurrence can:
//
// - One block of 4*D/C threads per (pair, head), two blocks an SM. The
//   state S [D, D] lives in registers for the whole pair: thread (cg, qr)
//   holds columns C*cg .. C*cg + C-1 of rows 16i + 4qr .. 16i + 4qr + 3
//   (128 values at D = 128, C = 4), so the products Sᵀk and Sᵀq are sums
//   over the thread's own rows and then over the four quarters of a quad
//   (two shuffles each), and the update is thread-local. No state byte
//   reaches memory.
// - The positions are prepared 16 at a time into one of two shared-memory
//   buffers, f32: the convolution and SiLU, the decay, q and k normalised
//   (the sums of q.q, k.k and q.k over the channels by shuffles), beta and
//   k.q. Chunk 0 is prepared before the first step; chunk n+1 during chunk
//   n's steps, one position (of the thread's channel) after each step, so
//   the preparation's latency fills the steps' stalls; one barrier a chunk
//   hands it over. The raw rows (with the 3 rows before, for the
//   convolution, zeros before the pair's first position) come by cp.async
//   two chunks ahead into one of two staging buffers.
// - Per step, with no block barrier: the sums a = Sᵀk and c = Sᵀq with S =
//   Diag(alpha) S in one pass over the registers, the position's k, q and
//   decay read as float4 broadcasts (k kept in registers for the update);
//   u = beta (v - a); o = c + u (k.q), since (S + k uᵀ)ᵀ q = Sᵀq + u (kᵀq);
//   S += k uᵀ in a second pass. o is rounded once and stored by one lane of
//   each quad.
//
// On an H100 (700 W) at the cell's shape: 3.26-3.29 ms a layer, 6.6% of
// the byte bound and a third of the f32 pipes. Forms tried there: two
// columns a thread, 5.28 ms (twice the shared-memory loads per product);
// the preparation run in turn with the steps, 4.14 (prepared alone 2.2 and
// stepped alone 1.9: the latency of the one added to the other); a
// preparing warpgroup beside a stepping one, 5.27 (one block an SM: too
// few stepping warps); the channel's constants re-read through L1 instead
// of registers, 3.73; two sums per product instead of one, 3.39. The
// steps alone are latency-bound at two blocks an SM; a chunked form on the
// tensor cores is the way past that.
// No synchronisation with the host, no allocation: a CUDA graph holds it.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_L = 80;
constexpr int CHUNK = 16;  // positions prepared at a time
constexpr int MAX_W = 4;   // convolution taps
constexpr int HALO = MAX_W - 1;
constexpr float L2_EPS = 1e-6f;

struct KdaParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* g;
  const bf16* b;
  long long ldq, ldk, ldv, ldg, ldb;
  const float* wq;
  const float* wk;
  const float* wv;
  const float* a_log;
  const float* dt_bias;
  bf16* out;
  int L, H, W;
  float scale;  // D^-1/2
};

template <int D, int C>
struct Layout {
  static constexpr int THREADS = 4 * D / C;        // 4 row quarters x D / C column groups
  static constexpr int HALVES = THREADS / D;       // positions a preparation pass takes
  static constexpr int NP = D >= 32 ? D / 32 : 1;  // partial sums of a position
  static constexpr int LANES = D >= 32 ? 32 : D;   // channels a warp's shuffles sum
  // a prepared chunk, f32: q, k, the decay, v [CHUNK][D], beta, k.q
  // [CHUNK], the partial sums [CHUNK][NP][3]; a staging buffer, bf16: the
  // raw q, k, v rows with the halo and the raw g rows; two of each
  static constexpr int PREPARED = 4 * CHUNK * D + 2 * CHUNK + CHUNK * NP * 3;
  static constexpr int RAW = (3 * (CHUNK + HALO) + CHUNK) * D;
  static constexpr size_t BYTES = size_t(2) * PREPARED * 4 + size_t(2) * RAW * 2;
  static_assert(D % 16 == 0 && (C == 2 || C == 4) && THREADS % D == 0, "the layout");
  static_assert(PREPARED % 4 == 0, "the staging buffers start 16-byte aligned");
};

// A prepared chunk's arrays in its buffer.
template <int D>
struct Prepared {
  float* q;  // [CHUNK][D] each
  float* k;
  float* a;
  float* v;
  float* beta;  // [CHUNK]
  float* kq;
  float* part;  // [CHUNK][NP][3]
  __device__ explicit Prepared(float* buf)
      : q(buf), k(q + CHUNK * D), a(k + CHUNK * D), v(a + CHUNK * D), beta(v + CHUNK * D),
        kq(beta + CHUNK), part(kq + CHUNK) {}
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

// SiLU and the decay with the fast exponential and division: their errors
// (a few f32 ulps) are far below the output's bf16 rounding
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }

__device__ __forceinline__ float softplus(float x) {  // torch's, threshold 20
  return x > 20.f ? x : log1pf(__expf(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The raw rows of the chunk from t0 into a staging buffer: q, k, v from
// HALO positions back (zeros before the pair's first), g; by cp.async,
// committed as one group.
template <int D, int C>
__device__ void stage(const KdaParams& p, bf16* raw, long long row0, int hd, int t0, int len,
                      int tid) {
  constexpr int VC = D / 8;  // 16-byte chunks a row
  bf16* rq = raw;            // [CHUNK + HALO][D] each
  bf16* rk = rq + (CHUNK + HALO) * D;
  bf16* rv = rk + (CHUNK + HALO) * D;
  bf16* rg = rv + (CHUNK + HALO) * D;  // [CHUNK][D]
  for (int i = tid; i < (len + HALO) * VC; i += Layout<D, C>::THREADS) {
    const int r = i / VC, c8 = i - r * VC;
    const int t = t0 - HALO + r;
    if (t >= 0) {
      const long long row = row0 + t;
      cp_async16(rq + r * D + 8 * c8, p.q + row * p.ldq + hd + 8 * c8);
      cp_async16(rk + r * D + 8 * c8, p.k + row * p.ldk + hd + 8 * c8);
      cp_async16(rv + r * D + 8 * c8, p.v + row * p.ldv + hd + 8 * c8);
    } else {
      const uint4 zero = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(rq + r * D + 8 * c8) = zero;
      *reinterpret_cast<uint4*>(rk + r * D + 8 * c8) = zero;
      *reinterpret_cast<uint4*>(rv + r * D + 8 * c8) = zero;
    }
  }
  for (int i = tid; i < len * VC; i += Layout<D, C>::THREADS) {
    const int r = i / VC, c8 = i - r * VC;
    cp_async16(rg + r * D + 8 * c8, p.g + (row0 + t0 + r) * p.ldg + hd + 8 * c8);
  }
  cp_async_commit();
}

// Per-channel constants of the preparation.
struct Channel {
  float wq[MAX_W], wk[MAX_W], wv[MAX_W];  // tap j multiplies position t - (W-1) + j
  float decay_rate, dt_bias;
};

// Position tl of a chunk from its staged rows, channel c: the convolutions
// and SiLU, the decay, unnormalised q and k, and this warp's sums of q.q,
// k.k and q.k into the partials. Every lane of the warp takes part in the
// shuffles; `valid` says whether the position exists (else zeros).
template <int D, int C>
__device__ __forceinline__ void prepare(const Prepared<D>& out, const bf16* raw, const Channel& ch,
                                        int W, int tl, bool valid, int c) {
  using S = Layout<D, C>;
  const bf16* rq = raw;
  const bf16* rk = rq + (CHUNK + HALO) * D;
  const bf16* rv = rk + (CHUNK + HALO) * D;
  const bf16* rg = rv + (CHUNK + HALO) * D;
  float xq = 0.f, xk = 0.f, xv = 0.f, a = 0.f;
  if (valid) {
#pragma unroll
    for (int j = 0; j < MAX_W; ++j) {
      if (j < W) {
        const int r = tl + HALO - (W - 1) + j;
        xq = fmaf(ch.wq[j], __bfloat162float(rq[r * D + c]), xq);
        xk = fmaf(ch.wk[j], __bfloat162float(rk[r * D + c]), xk);
        xv = fmaf(ch.wv[j], __bfloat162float(rv[r * D + c]), xv);
      }
    }
    xq = silu(xq);
    xk = silu(xk);
    xv = silu(xv);
    a = __expf(ch.decay_rate * softplus(__bfloat162float(rg[tl * D + c]) + ch.dt_bias));
    out.q[tl * D + c] = xq;
    out.k[tl * D + c] = xk;
    out.v[tl * D + c] = xv;
    out.a[tl * D + c] = a;
  }
  float s1 = xq * xq, s2 = xk * xk, s3 = xq * xk;
#pragma unroll
  for (int off = S::LANES / 2; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    s3 += __shfl_xor_sync(0xffffffffu, s3, off);
  }
  if (valid && c % S::LANES == 0) {
    float* sums = out.part + (tl * S::NP + c / S::LANES) * 3;
    sums[0] = s1;
    sums[1] = s2;
    sums[2] = s3;
  }
}

// A prepared chunk's q and k normalised, q scaled by D^-1/2, and each
// position's k.q, once every partial sum is in.
template <int D, int C>
__device__ __forceinline__ void normalise(const Prepared<D>& out, int len, float scale, int c,
                                          int half) {
  using S = Layout<D, C>;
#pragma unroll 4
  for (int tl = half; tl < len; tl += S::HALVES) {
    float s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = 0; j < S::NP; ++j) {
      s1 += out.part[(tl * S::NP + j) * 3];
      s2 += out.part[(tl * S::NP + j) * 3 + 1];
      s3 += out.part[(tl * S::NP + j) * 3 + 2];
    }
    const float rnq = 1.f / sqrtf(s1 + L2_EPS), rnk = 1.f / sqrtf(s2 + L2_EPS);
    out.q[tl * D + c] *= rnq * scale;
    out.k[tl * D + c] *= rnk;
    if (c == 0) out.kq[tl] = s3 * rnq * rnk * scale;
  }
}

template <int D, int C>
__global__ void __launch_bounds__(4 * D / C, 2) kda_recurrence_bf16(const KdaParams p) {
  using S = Layout<D, C>;
  constexpr int RG = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* bufs = reinterpret_cast<float*>(smem);  // two prepared chunks
  bf16* raws = reinterpret_cast<bf16*>(bufs + 2 * S::PREPARED);  // two staging buffers

  const int tid = threadIdx.x;
  const int L = p.L, H = p.H, W = p.W;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const long long row0 = static_cast<long long>(b) * L;
  const int hd = h * D;
  // the steps' layout: columns C*cg .. C*cg + C-1, rows 16i + 4qr + j
  const int cg = tid >> 2, qr = tid & 3;
  // the preparation's: channel c, every HALVES-th position from `half`
  const int c = tid % D, half = tid / D;

  // the first two chunks' rows by cp.async, then chunk 0 prepared whole
  stage<D, C>(p, raws, row0, hd, 0, min(CHUNK, L), tid);
  if (L > CHUNK) stage<D, C>(p, raws + S::RAW, row0, hd, CHUNK, min(CHUNK, L - CHUNK), tid);
  Channel ch;
#pragma unroll
  for (int j = 0; j < MAX_W; ++j) {
    ch.wq[j] = j < W ? p.wq[(hd + c) * W + j] : 0.f;
    ch.wk[j] = j < W ? p.wk[(hd + c) * W + j] : 0.f;
    ch.wv[j] = j < W ? p.wv[(hd + c) * W + j] : 0.f;
  }
  ch.decay_rate = -expf(p.a_log[h]);
  ch.dt_bias = p.dt_bias[hd + c];
  {
    const Prepared<D> first(bufs);
    const int len = min(CHUNK, L);
    if (tid < len) first.beta[tid] = sigmoid(__bfloat162float(p.b[(row0 + tid) * p.ldb + h]));
    if (L > CHUNK)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int tl = half; tl < CHUNK; tl += S::HALVES)
      prepare<D, C>(first, raws, ch, W, tl, tl < len, c);
    __syncthreads();
    normalise<D, C>(first, len, p.scale, c, half);
  }

  float s[RG][4][C];
#pragma unroll
  for (int i = 0; i < RG; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < C; ++e) s[i][j][e] = 0.f;

  for (int n = 0, t0 = 0; t0 < L; ++n, t0 += CHUNK) {
    const int len = min(CHUNK, L - t0);
    const int next = t0 + CHUNK < L ? min(CHUNK, L - t0 - CHUNK) : 0;  // the next chunk's
    const Prepared<D> cur(bufs + (n & 1) * S::PREPARED), nxt(bufs + ((n + 1) & 1) * S::PREPARED);
    const bf16* raw_next = raws + ((n + 1) & 1) * S::RAW;
    // the chunk after next into the staging buffer this chunk's rows left;
    // the next chunk's rows (staged a chunk ago) waited for, and its beta
    // loaded to be stored after the steps
    if (t0 + 2 * CHUNK < L) {
      stage<D, C>(p, raws + (n & 1) * S::RAW, row0, hd, t0 + 2 * CHUNK,
                  min(CHUNK, L - t0 - 2 * CHUNK), tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const float beta_logit =
        tid < next ? __bfloat162float(p.b[(row0 + t0 + CHUNK + tid) * p.ldb + h]) : 0.f;
    __syncthreads();  // this chunk is prepared; the next chunk's rows have landed

    // the steps, with no block barrier, each followed by the preparation of
    // one position of the next chunk
    for (int tl = 0; tl < len; ++tl) {
      const float* kt = cur.k + tl * D + 4 * qr;
      const float* qt = cur.q + tl * D + 4 * qr;
      const float* at = cur.a + tl * D + 4 * qr;
      float kr[RG][4];  // this thread's rows of k, kept for the update
      float sa[C], sc[C];
#pragma unroll
      for (int e = 0; e < C; ++e) sa[e] = sc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float4 al = *reinterpret_cast<const float4*>(at + 16 * i);
        const float4 kk = *reinterpret_cast<const float4*>(kt + 16 * i);
        const float4 qq = *reinterpret_cast<const float4*>(qt + 16 * i);
        const float av[4] = {al.x, al.y, al.z, al.w};
        const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
        kr[i][0] = kk.x;
        kr[i][1] = kk.y;
        kr[i][2] = kk.z;
        kr[i][3] = kk.w;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < C; ++e) {
            s[i][j][e] *= av[j];
            sa[e] = fmaf(s[i][j][e], kr[i][j], sa[e]);
            sc[e] = fmaf(s[i][j][e], qv[j], sc[e]);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
        for (int e = 0; e < C; ++e) {
          sa[e] += __shfl_xor_sync(0xffffffffu, sa[e], off);
          sc[e] += __shfl_xor_sync(0xffffffffu, sc[e], off);
        }
      }
      const float beta = cur.beta[tl], kq = cur.kq[tl];
      float vv[C], u[C];
      if constexpr (C == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(cur.v + tl * D + 4 * cg);
        vv[0] = v4.x, vv[1] = v4.y, vv[2] = v4.z, vv[3] = v4.w;
      } else {
        const float2 v2 = *reinterpret_cast<const float2*>(cur.v + tl * D + 2 * cg);
        vv[0] = v2.x, vv[1] = v2.y;
      }
#pragma unroll
      for (int e = 0; e < C; ++e) u[e] = beta * (vv[e] - sa[e]);
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < C; ++e) s[i][j][e] = fmaf(kr[i][j], u[e], s[i][j][e]);
      if (qr == 0) {
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
            p.out + (row0 + t0 + tl) * H * D + hd + C * cg);
#pragma unroll
        for (int e = 0; e < C; e += 2)
          o[e / 2] = __floats2bfloat162_rn(fmaf(u[e], kq, sc[e]), fmaf(u[e + 1], kq, sc[e + 1]));
      }
      const int pos = tl * S::HALVES + half;  // of the next chunk
      if (next && tl * S::HALVES < CHUNK)
        prepare<D, C>(nxt, raw_next, ch, W, pos, pos < next, c);
    }
    if (tid < next) nxt.beta[tid] = sigmoid(beta_logit);
    if (next) {
      __syncthreads();  // every partial sum of the next chunk is in
      normalise<D, C>(nxt, next, p.scale, c, half);
    }
  }
}

template <int D, int C>
int launch(const KdaParams& p, int B, cudaStream_t stream) {
  using S = Layout<D, C>;
  cudaError_t err = vqa::allow_smem(kda_recurrence_bf16<D, C>, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_recurrence_bf16<D, C><<<B * p.H, S::THREADS, S::BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The head dims the kernel is built for: D = K = V = 128, Kimi-Linear's,
// and 16, the tests' tiny decoder; 1 <= L <= 80, 1 <= W <= 4. q, k, v, g,
// b and out 16-byte aligned, their row strides multiples of 8. Anything
// else: cudaErrorInvalidValue, nothing launched (ops/kda_kernel.py checks
// the same first).
VQA_EXPORT int vqa_kda_attention_bf16(const void* q, const void* k, const void* v, const void* g,
                                      const void* b, long long ldq, long long ldk, long long ldv,
                                      long long ldg, long long ldb, const void* wq,
                                      const void* wk, const void* wv, const void* a_log,
                                      const void* dt_bias, void* out, int B, int L, int H, int D,
                                      int W, float scale, cudaStream_t stream) {
  if (B < 1 || H < 1 || L < 1 || L > MAX_L || W < 1 || W > MAX_W) return cudaErrorInvalidValue;
  if ((ldq | ldk | ldv | ldg | ldb) % 8) return cudaErrorInvalidValue;
  const KdaParams p{static_cast<const bf16*>(q),      static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v),      static_cast<const bf16*>(g),
                    static_cast<const bf16*>(b),      ldq,
                    ldk,                              ldv,
                    ldg,                              ldb,
                    static_cast<const float*>(wq),    static_cast<const float*>(wk),
                    static_cast<const float*>(wv),    static_cast<const float*>(a_log),
                    static_cast<const float*>(dt_bias), static_cast<bf16*>(out),
                    L,                                H,
                    W,                                scale};
  if (D == 128) return launch<128, 4>(p, B, stream);
  if (D == 16) return launch<16, 2>(p, B, stream);
  return cudaErrorInvalidValue;
}
