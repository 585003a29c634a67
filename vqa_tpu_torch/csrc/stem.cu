// Fused CNN stem for Hopper: conv 7x7 stride 2 pad 3 (3 -> cout, no bias),
// BN-eval affine (scale*y + bias), ReLU, maxpool 3x3 stride 2 pad 1, in f32.
//
// Replaces the Pallas TPU kernel vqa_tpu/ops/stem_kernel.py
// (_fused_stem_planes, pl.pallas_call at :141). Like it, the conv output
// [B, CH, CW, cout] never reaches device memory: each block keeps its conv
// tile in shared memory and max-pools from there. The TPU kernel's polyphase
// planes, 21->32 tap padding and 16-row blocks exist for the MXU's lanes and
// Mosaic's tiling and have no counterpart here.
//
// What bounds it: operations. At B=32, 224x224 the conv is 7.55 GFLOP of
// f32 FMAs on the CUDA cores against ~45 MB of input and output, so the f32
// rate (not the 3.35 TB/s memory) sets the floor. The design keeps the FMA
// units fed from registers: each warp owns 8 output channels (weights read
// as warp-wide broadcasts) and each lane 10 conv positions, so one tap costs
// 10 shared-memory loads and 2 float4 weight loads for 80 FMAs.
//
// Tiling: a block computes an 8x8 tile of pool outputs for all cout
// channels. That tile needs a 17x17 tile of conv outputs (pool window rows
// 2py-1 .. 2py+1), which needs a 39x39x3 input patch. Shared memory holds the
// weights [147][cout+4], the patch [3][39][39] and the conv tile
// [cout][289]: 132,220 bytes at cout = 64.
//
// Padding: conv positions outside the conv output (the pool's padding) are
// stored as 0 instead of -inf. That is exact because post-ReLU values are
// >= 0 and every pool window holds at least one real conv position
// (2*py <= CH-1 for every pool row py < PH), so the window max is unchanged.
//
// Works for any H, W >= 1 and cout a multiple of 8 up to 64; in_channels 3.

#include "common.cuh"

namespace {

constexpr int KS = 7;                  // conv kernel size
constexpr int CIN = 3;                 // input channels
constexpr int TAPS = CIN * KS * KS;    // 147, tap = ci*49 + kh*7 + kw
constexpr int TP = 8;                  // pool outputs per tile side
constexpr int TC = 2 * TP + 1;         // conv positions per tile side: 17
constexpr int TI = 2 * (TC - 1) + KS;  // input rows/cols per tile side: 39
constexpr int NPOS = TC * TC;          // conv positions per tile: 289
constexpr int PPL = (NPOS + 31) / 32;  // conv positions per lane: 10
constexpr int CG = 8;                  // output channels per warp

__host__ __device__ inline int w_stride(int cout) {
  // +4 floats: keeps float4 alignment and spreads the transposing writes
  // of the weight load over 4 banks' worth of rows
  return cout + 4;
}

__host__ inline size_t stem_smem_bytes(int cout) {
  return sizeof(float) * (size_t(TAPS) * w_stride(cout) + CIN * TI * TI + size_t(cout) * NPOS);
}

__global__ void __launch_bounds__(256)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            float* __restrict__ out, int H, int W, int CH, int CW, int PH, int PW,
            int cout) {
  extern __shared__ __align__(16) float smem[];
  const int ws = w_stride(cout);
  float* w_s = smem;                      // [TAPS][ws]
  float* in_s = w_s + TAPS * ws;          // [CIN][TI][TI]
  float* conv_s = in_s + CIN * TI * TI;   // [cout][NPOS]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.z;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // first conv row/col of the tile
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // first input row/col

  // weights OIHW [cout][3][7][7], read coalesced, stored [tap][co]
  for (int i = tid; i < TAPS * cout; i += nthreads) {
    const int co = i / TAPS, tap = i - co * TAPS;
    w_s[tap * ws + co] = w[i];
  }
  // input patch from NHWC, zero outside the image (the conv's padding)
  const float* xb = x + size_t(b) * H * W * CIN;
  for (int i = tid; i < TI * TI * CIN; i += nthreads) {
    const int ci = i % CIN, rc = i / CIN;
    const int c = rc % TI, r = rc / TI;
    const int gy = iy0 + r, gx = ix0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = xb[(size_t(gy) * W + gx) * CIN + ci];
    in_s[(ci * TI + r) * TI + c] = v;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int c0 = warp * CG;
  int base[PPL];
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    int p = lane + 32 * j;
    if (p >= NPOS) p = 0;  // spare slot: computed, never stored
    base[j] = 2 * (p / TC) * TI + 2 * (p % TC);
  }
  float acc[PPL][CG];
#pragma unroll
  for (int j = 0; j < PPL; ++j)
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[j][c] = 0.f;

  for (int ci = 0; ci < CIN; ++ci) {
#pragma unroll 1
    for (int kh = 0; kh < KS; ++kh) {
      const float* in_row = in_s + (ci * TI + kh) * TI;
      const float* w_row = w_s + ((ci * KS + kh) * KS) * ws + c0;
#pragma unroll
      for (int kw = 0; kw < KS; ++kw) {
        const float4 wa = *reinterpret_cast<const float4*>(w_row + kw * ws);
        const float4 wb = *reinterpret_cast<const float4*>(w_row + kw * ws + 4);
#pragma unroll
        for (int j = 0; j < PPL; ++j) {
          const float v = in_row[base[j] + kw];
          acc[j][0] = fmaf(v, wa.x, acc[j][0]);
          acc[j][1] = fmaf(v, wa.y, acc[j][1]);
          acc[j][2] = fmaf(v, wa.z, acc[j][2]);
          acc[j][3] = fmaf(v, wa.w, acc[j][3]);
          acc[j][4] = fmaf(v, wb.x, acc[j][4]);
          acc[j][5] = fmaf(v, wb.y, acc[j][5]);
          acc[j][6] = fmaf(v, wb.z, acc[j][6]);
          acc[j][7] = fmaf(v, wb.w, acc[j][7]);
        }
      }
    }
  }

  // BN affine + ReLU into the conv tile; positions outside the conv output
  // hold 0 (see the padding note above)
  float sc[CG], bi[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    sc[c] = scale[c0 + c];
    bi[c] = bias[c0 + c];
  }
#pragma unroll
  for (int j = 0; j < PPL; ++j) {
    const int p = lane + 32 * j;
    if (p < NPOS) {
      const int gy = cy0 + p / TC, gx = cx0 + p % TC;
      const bool real = gy >= 0 && gy < CH && gx >= 0 && gx < CW;
#pragma unroll
      for (int c = 0; c < CG; ++c)
        conv_s[(c0 + c) * NPOS + p] = real ? fmaxf(acc[j][c] * sc[c] + bi[c], 0.f) : 0.f;
    }
  }
  __syncthreads();

  // 3x3 stride-2 max pool from shared memory; channel-fastest threads give
  // coalesced NHWC stores and conflict-free reads (NPOS = 1 mod 32)
  float* ob = out + size_t(b) * PH * PW * cout;
  for (int i = tid; i < TP * TP * cout; i += nthreads) {
    const int co = i % cout, q = i / cout;
    const int ly = q / TP, lx = q % TP;
    const int py = py0 + ly, px = px0 + lx;
    if (py >= PH || px >= PW) continue;
    const float* cs = conv_s + co * NPOS + 2 * ly * TC + 2 * lx;
    float m = cs[0];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, cs[dy * TC + dx]);
    ob[(size_t(py) * PW + px) * cout + co] = m;
  }
}

}  // namespace

// x [B,H,W,3] NHWC, w [cout,3,7,7] OIHW, scale/bias [cout], out [B,PH,PW,cout]
// NHWC, all f32 and contiguous.
VQA_EXPORT int vqa_stem_f32(const float* x, const float* w, const float* scale,
                            const float* bias, float* out, int B, int H, int W,
                            int cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cout <= 0 || cout % CG != 0 || cout > 64 || B > 65535)
    return cudaErrorInvalidValue;
  const int CH = (H - 1) / 2 + 1, CW = (W - 1) / 2 + 1;
  const int PH = (CH - 1) / 2 + 1, PW = (CW - 1) / 2 + 1;
  const size_t smem = stem_smem_bytes(cout);
  cudaError_t err = vqa::allow_smem(stem_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((PW + TP - 1) / TP, (PH + TP - 1) / TP, B);
  const dim3 block(32 * (cout / CG));
  stem_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, bias, out, H, W, CH, CW, PH, PW, cout);
  return cudaGetLastError();
}
