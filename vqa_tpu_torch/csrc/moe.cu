// The data movement of an MoE layer's routed experts around its two
// grouped GEMMs (vqa_tpu_torch/models/moe.py, ops/moe_kernel.py), bf16:
//
//   moe_gather_bf16   permute: row r of the sorted buffer is token src[r]
//   swiglu_bf16       silu(gate) * up of each routed row, one rounding;
//                     the same kernel computes every row of the dense
//                     SwiGLUs (the dense layer, the shared experts)
//   moe_combine_bf16  unpermute: each token's routed rows, weighted and
//                     summed in f32, rounded, plus its shared-expert row
//
// They replace no TPU kernel: the JAX package has no mixture of experts.
// How many rows the held experts got is known only on the device, so the
// routed buffers are sized for the most that can come (tokens x experts per
// token) and the gather and the routed SwiGLU read the count, `*total`,
// from device memory: rows at or past it are neither read nor written, so
// no row that was not routed here is computed, and nothing waits on the
// host. Each is
// bound by bytes (a few operations per element): 16-byte vectors, one block
// per row at a time over a grid of a few blocks per SM that strides over
// the rows.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

// out[r] = x[src[r]] for r < *total; `vecs` 16-byte vectors a row.
__global__ void __launch_bounds__(THREADS)
    moe_gather_bf16(const uint4* __restrict__ x, const int* __restrict__ src,
                    const int* __restrict__ total, uint4* __restrict__ out, int vecs) {
  const int n = __ldg(total);
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const uint4* from = x + static_cast<int64_t>(__ldg(src + r)) * vecs;
    uint4* to = out + static_cast<int64_t>(r) * vecs;
    for (int v = threadIdx.x; v < vecs; v += THREADS) to[v] = __ldg(from + v);
  }
}

// out[r, j] = silu(h[r, j]) * h[r, width + j], in f32 and rounded once;
// `vecs` = width / 8.
__device__ __forceinline__ void swiglu_row(const uint4* __restrict__ h, uint4* __restrict__ out,
                                           int r, int vecs) {
  const uint4* gate = h + static_cast<int64_t>(r) * 2 * vecs;
  const uint4* up = gate + vecs;
  uint4* to = out + static_cast<int64_t>(r) * vecs;
  for (int v = threadIdx.x; v < vecs; v += THREADS) {
    const uint4 g = __ldg(gate + v), u = __ldg(up + v);
    const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(&g);
    const __nv_bfloat16* ub = reinterpret_cast<const __nv_bfloat16*>(&u);
    uint4 o;
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = bf(gb[i]);
      ob[i] = __float2bfloat16_rn(a / (1.0f + expf(-a)) * bf(ub[i]));
    }
    to[v] = o;
  }
}

// The rows r < n: n = *total, read on the device, for the routed rows
// (kRouted), else `rows`, every row of a dense SwiGLU. The template
// argument also tells the two apart in a profiler's trace.
template <bool kRouted>
__global__ void __launch_bounds__(THREADS)
    swiglu_bf16(const uint4* __restrict__ h, const int* __restrict__ total, int rows,
                uint4* __restrict__ out, int vecs) {
  const int n = kRouted ? __ldg(total) : rows;
  for (int r = blockIdx.x; r < n; r += gridDim.x) swiglu_row(h, out, r, vecs);
}

// out[t] = bf16(bf16(sum over j with slot[t, j] >= 0 of w[t, j] * y[slot[t, j]])
//               + shared[t]), the sum in f32 in the order j = 0 .. k-1.
__global__ void __launch_bounds__(THREADS)
    moe_combine_bf16(const uint4* __restrict__ y, const int* __restrict__ slot,
                     const float* __restrict__ w, const uint4* __restrict__ shared,
                     uint4* __restrict__ out, int tokens, int k, int vecs) {
  for (int t = blockIdx.x; t < tokens; t += gridDim.x) {
    const int* s = slot + static_cast<int64_t>(t) * k;
    const float* wt = w + static_cast<int64_t>(t) * k;
    for (int v = threadIdx.x; v < vecs; v += THREADS) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < k; ++j) {
        const int row = __ldg(s + j);
        if (row < 0) continue;
        const float c = __ldg(wt + j);
        const uint4 yv = __ldg(y + static_cast<int64_t>(row) * vecs + v);
        const __nv_bfloat16* yb = reinterpret_cast<const __nv_bfloat16*>(&yv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += c * bf(yb[i]);
      }
      const uint4 sv = __ldg(shared + static_cast<int64_t>(t) * vecs + v);
      const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(&sv);
      uint4 o;
      __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ob[i] = __float2bfloat16_rn(bf(__float2bfloat16_rn(acc[i])) + bf(sb[i]));
      out[static_cast<int64_t>(t) * vecs + v] = o;
    }
  }
}

}  // namespace

// x [T, width], src [rows], *total <= rows, out [rows, width]; width % 8 == 0.
VQA_EXPORT int vqa_moe_gather_bf16(const void* x, const void* src, const void* total, void* out,
                                   int width, int blocks, cudaStream_t stream) {
  moe_gather_bf16<<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const int*>(src),
      static_cast<const int*>(total), static_cast<uint4*>(out), width / 8);
  return static_cast<int>(cudaGetLastError());
}

// h [rows, 2 * width], out [rows, width]; width % 8 == 0. The rows before
// *total where `total` is given (the routed rows, *total <= rows), else all.
VQA_EXPORT int vqa_swiglu_bf16(const void* h, const void* total, void* out, int rows, int width,
                               int blocks, cudaStream_t stream) {
  const uint4* in = static_cast<const uint4*>(h);
  const int* n = static_cast<const int*>(total);
  if (n != nullptr)
    swiglu_bf16<true><<<blocks, THREADS, 0, stream>>>(in, n, rows, static_cast<uint4*>(out),
                                                      width / 8);
  else
    swiglu_bf16<false><<<blocks, THREADS, 0, stream>>>(in, n, rows, static_cast<uint4*>(out),
                                                       width / 8);
  return static_cast<int>(cudaGetLastError());
}

// y [rows, width], slot [tokens, k] (-1 where not routed here), w [tokens, k]
// f32, shared and out [tokens, width]; width % 8 == 0.
VQA_EXPORT int vqa_moe_combine_bf16(const void* y, const void* slot, const void* w,
                                    const void* shared, void* out, int tokens, int k, int width,
                                    int blocks, cudaStream_t stream) {
  moe_combine_bf16<<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(y), static_cast<const int*>(slot), static_cast<const float*>(w),
      static_cast<const uint4*>(shared), static_cast<uint4*>(out), tokens, k, width / 8);
  return static_cast<int>(cudaGetLastError());
}
