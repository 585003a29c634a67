// Cross-attention core for Hopper, in f32: per (batch, head) slice,
// w = softmax(Q K^T * (1/scale)) and ctx = w V. Writes both the context and
// the probabilities (the engine's attention maps read them).
//
// Replaces the Pallas TPU kernel vqa_tpu/ops/cross_attention_kernel.py
// (_fused_cross_attention_bh, pl.pallas_call at :73). As there, one slice's
// Q [Lq,d], K and V [Lkv,d] and the [Lq,Lkv] score tile stay on chip
// (shared memory here, 19 KB at Lq=20, Lkv=49, d=32) so the scores never
// round-trip device memory. Scores are multiplied by 1/scale as the TPU
// kernel does (cross_attention_kernel.py:49); softmax subtracts the row max
// and divides by the row sum, in f32.
//
// What bounds it: at the model's shapes a slice is 0.13 MFLOP and ~21 KB,
// so the whole call (B*8 slices) is a few microseconds of memory traffic and
// launch latency dominates. One block of 128 threads per slice keeps the
// code simple; packing slices per block or batching the two fusion layers
// into one launch is later work.
//
// K rows are padded to d+1 floats in shared memory so the lanes of a warp,
// which walk consecutive keys in the score loop, hit distinct banks.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
cross_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ ctx,
                       float* __restrict__ wout, int Lq, int Lkv, int D,
                       float inv_scale) {
  extern __shared__ __align__(16) float sm[];
  const int dp = D + 1;
  float* q_s = sm;               // [Lq][D]
  float* k_s = q_s + Lq * D;     // [Lkv][D+1]
  float* v_s = k_s + Lkv * dp;   // [Lkv][D]
  float* p_s = v_s + Lkv * D;    // [Lq][Lkv]

  const int t = threadIdx.x;
  const size_t bh = blockIdx.x;
  const float* qb = q + bh * Lq * D;
  const float* kb = k + bh * Lkv * D;
  const float* vb = v + bh * Lkv * D;
  for (int i = t; i < Lq * D; i += THREADS) q_s[i] = qb[i];
  for (int i = t; i < Lkv * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    k_s[r * dp + c] = kb[i];
    v_s[i] = vb[i];
  }
  __syncthreads();

  for (int i = t; i < Lq * Lkv; i += THREADS) {
    const int qi = i / Lkv, kj = i - qi * Lkv;
    const float* qr = q_s + qi * D;
    const float* kr = k_s + kj * dp;
    float a = 0.f;
    for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
    p_s[i] = a * inv_scale;
  }
  __syncthreads();

  // softmax, one warp per query row
  const int warp = t >> 5, lane = t & 31;
  float* wb = wout + bh * Lq * Lkv;
  for (int row = warp; row < Lq; row += THREADS / 32) {
    float* pr = p_s + row * Lkv;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int j = lane; j < Lkv; j += 32) m = fmaxf(m, pr[j]);
    m = vqa::warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lkv; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    sum = vqa::warp_sum(sum);
    for (int j = lane; j < Lkv; j += 32) {
      const float p = pr[j] / sum;
      pr[j] = p;
      wb[row * Lkv + j] = p;
    }
  }
  __syncthreads();

  float* cb = ctx + bh * Lq * D;
  for (int i = t; i < Lq * D; i += THREADS) {
    const int qi = i / D, d = i - qi * D;
    const float* pr = p_s + qi * Lkv;
    float a = 0.f;
    for (int j = 0; j < Lkv; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
    cb[i] = a;
  }
}

}  // namespace

// q [BH, Lq, D]; k, v [BH, Lkv, D]; ctx [BH, Lq, D]; w [BH, Lq, Lkv]; f32.
VQA_EXPORT int vqa_cross_attention_f32(const float* q, const float* k, const float* v,
                                       float* ctx, float* w, int BH, int Lq, int Lkv,
                                       int D, float inv_scale, void* stream) {
  if (BH <= 0 || Lq <= 0 || Lkv <= 0 || D <= 0) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t(Lq) * D + size_t(Lkv) * (D + 1) + size_t(Lkv) * D + size_t(Lq) * Lkv);
  cudaError_t err = vqa::allow_smem(cross_attention_kernel, smem);
  if (err != cudaSuccess) return err;
  cross_attention_kernel<<<BH, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, ctx, w, Lq, Lkv, D, inv_scale);
  return cudaGetLastError();
}
