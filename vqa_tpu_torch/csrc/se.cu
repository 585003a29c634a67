// Squeeze-and-Excitation for Hopper, in f32: per image, global average pool
// over H*W, relu(pooled . w1^T), sigmoid(hidden . w2^T), then x * s per
// channel.
//
// Replaces the Pallas TPU kernel vqa_tpu/ops/se_kernel.py (_fused_se_flat,
// pl.pallas_call at :50). That kernel holds one whole [HW, C] image in VMEM;
// here an image does not fit a block's shared memory (stage 1 is 802,816
// bytes per image against 232,448), so the work is split in two phases,
// launched back to back on the caller's stream:
//
//   1. se_pool_partial: grid (chunks, B). Each block sums a chunk of rows of
//      one image for every channel (float4 loads, one pass over the chunk)
//      and writes partial[b][chunk][C]. Threads combine in a fixed order and
//      no atomics are used, so the result is the same on every run.
//   2. se_excite_scale: grid (chunks, B). Each block sums its image's
//      partials in chunk order, multiplies by 1/HW (sum then scale, as the
//      TPU kernel does at se_kernel.py:34), runs both tiny FCs and the
//      sigmoid in shared memory, then rescales its chunk of rows.
//
// What bounds it: bytes. x is read twice (once per phase, the second read
// mostly from L2 for the smaller stages) and the output written once; the
// FCs are at most 2*C*C/r MACs per block. Chunks are sized to ~32 KB so
// even stage 1 at B=32 launches hundreds of blocks.
//
// w1 is fc1's nn.Linear weight [R, C] and w2 is fc2's [C, R]. C must be a
// multiple of 4 and at most 1024; x and out 16-byte aligned.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
se_pool_partial(const float* __restrict__ x, float* __restrict__ partial, int HW,
                int C, int rows_per_chunk, int nchunks) {
  __shared__ float4 red[THREADS];
  const int t = threadIdx.x, k = blockIdx.x, b = blockIdx.y;
  const int C4 = C / 4;
  const int rows_in_flight = THREADS / C4;
  const int c4 = t % C4, r0 = t / C4;
  const int row_begin = k * rows_per_chunk;
  const int row_end = min(HW, row_begin + rows_per_chunk);
  const float4* xb = reinterpret_cast<const float4*>(x + size_t(b) * HW * C);

  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r0 < rows_in_flight) {
    for (int r = row_begin + r0; r < row_end; r += rows_in_flight) {
      const float4 v = xb[size_t(r) * C4 + c4];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  red[t] = s;
  __syncthreads();
  if (t < C4) {
    float4 a = red[t];
    for (int i = 1; i < rows_in_flight; ++i) {
      const float4 v = red[t + i * C4];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    reinterpret_cast<float4*>(partial + (size_t(b) * nchunks + k) * C)[t] = a;
  }
}

__global__ void __launch_bounds__(THREADS)
se_excite_scale(const float* __restrict__ x, const float* __restrict__ partial,
                const float* __restrict__ w1, const float* __restrict__ w2,
                float* __restrict__ out, int HW, int C, int R, int rows_per_chunk,
                int nchunks, float inv_hw) {
  extern __shared__ __align__(16) float sm[];
  float* s = sm;               // [C] channel scales (float4-aligned)
  float* pooled = sm + C;      // [C]
  float* hidden = pooled + C;  // [R]
  const int t = threadIdx.x, k = blockIdx.x, b = blockIdx.y;

  const float* pb = partial + size_t(b) * nchunks * C;
  for (int c = t; c < C; c += THREADS) {
    float a = 0.f;
    for (int j = 0; j < nchunks; ++j) a += pb[j * C + c];
    pooled[c] = a * inv_hw;
  }
  __syncthreads();

  // hidden[r] = relu(sum_c pooled[c] * w1[r][c]): one warp per r
  const int warp = t >> 5, lane = t & 31;
  for (int r = warp; r < R; r += THREADS / 32) {
    float a = 0.f;
    for (int c = lane; c < C; c += 32) a = fmaf(pooled[c], w1[size_t(r) * C + c], a);
    a = vqa::warp_sum(a);
    if (lane == 0) hidden[r] = fmaxf(a, 0.f);
  }
  __syncthreads();

  for (int c = t; c < C; c += THREADS) {
    float a = 0.f;
    for (int r = 0; r < R; ++r) a = fmaf(hidden[r], w2[size_t(c) * R + r], a);
    s[c] = 1.f / (1.f + expf(-a));
  }
  __syncthreads();

  const int C4 = C / 4;
  const int row_begin = k * rows_per_chunk;
  const int nrows = min(HW, row_begin + rows_per_chunk) - row_begin;
  const size_t off4 = (size_t(b) * HW + row_begin) * C4;
  const float4* xb = reinterpret_cast<const float4*>(x) + off4;
  float4* ob = reinterpret_cast<float4*>(out) + off4;
  const float4* s4 = reinterpret_cast<const float4*>(s);
  for (int i = t; i < nrows * C4; i += THREADS) {
    const float4 v = xb[i];
    const float4 g = s4[i % C4];
    ob[i] = make_float4(v.x * g.x, v.y * g.y, v.z * g.z, v.w * g.w);
  }
}

}  // namespace

// x, out [B, HW, C]; w1 [R, C]; w2 [C, R]; partial [B, nchunks, C] scratch.
VQA_EXPORT int vqa_se_f32(const float* x, const float* w1, const float* w2,
                          float* partial, float* out, int B, int HW, int C, int R,
                          int rows_per_chunk, int nchunks, void* stream) {
  if (B <= 0 || HW <= 0 || R <= 0 || C <= 0 || C % 4 != 0 || C / 4 > THREADS ||
      rows_per_chunk <= 0 || nchunks != (HW + rows_per_chunk - 1) / rows_per_chunk ||
      B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunks, B);
  se_pool_partial<<<grid, THREADS, 0, st>>>(x, partial, HW, C, rows_per_chunk, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (2 * size_t(C) + R);
  err = vqa::allow_smem(se_excite_scale, smem);
  if (err != cudaSuccess) return err;
  se_excite_scale<<<grid, THREADS, smem, st>>>(x, partial, w1, w2, out, HW, C, R,
                                               rows_per_chunk, nchunks, 1.0f / HW);
  return cudaGetLastError();
}
