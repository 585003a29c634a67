// Fused CNN stem for Hopper: conv 7x7 stride 2 pad 3 (3 -> cout, no bias),
// BN-eval affine (scale*y + bias), ReLU, maxpool 3x3 stride 2 pad 1, in f32.
//
// Replaces the Pallas TPU kernel vqa_tpu/ops/stem_kernel.py
// (_fused_stem_planes, pl.pallas_call at :141). Like it, the conv output
// [B, CH, CW, cout] never reaches device memory: each tile's conv output
// stays in shared memory and is max-pooled from there. The TPU kernel's
// polyphase planes, 21->32 tap padding and 16-row blocks exist for the
// MXU's lanes and Mosaic's tiling and have no counterpart here.
//
// What bounds it: operations. At B=32, 224x224 the conv is 7.55 GFLOP
// against ~45 MB of input and output. The fastest f32-accurate route the
// card has for it is the tensor cores in 3xTF32: with hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna), a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, three
// TF32 products at 495 TFLOP/s against 67 TFLOP/s of f32 FMAs outside the
// tensor cores; the dropped lo*lo term is ~2^-22 of the product, so the
// result keeps the f32 contract (atol/rtol 1e-5).
//
// Design: an implicit GEMM per tile of 8x7 pool outputs, which needs a
// 17x15 tile of conv outputs (M = 255 positions + 1 spare = 4 m-blocks of
// 64), N = 64 channels, K = 147 taps zero-padded to 152 (19 k-steps of 8),
// on wgmma.m64n64k8 TF32 with A from registers:
//
// - Persistent blocks, one per SM (202 KB of shared memory), walk the
//   (image, tile) pairs. The weights are split into hi/lo once per block
//   and stored as 38 B tiles [64 n][8 k] in the K-major no-swizzle layout
//   the tensor cores read through a shared-memory descriptor.
// - The next tile's 39x35x3 input patch arrives by cp.async (zero-filled
//   outside the image: the conv's padding) while the current one computes.
//   TMA would need 16-byte rows; an NHWC row of 3 floats is not. Each patch
//   element is then split once into an interleaved {hi, lo} pair, so every
//   A fragment that reads it pays one 8-byte load and no conversion.
// - Two warpgroups, each owning two m-blocks. Per k-step a warp gathers its
//   16 rows of A im2col-style from the split patch into registers (the
//   mma.m16n8k8 fragment order that wgmma takes for A), then the warpgroup
//   issues 3 wgmma per m-block: lo*hi, hi*lo, hi*hi. 64 accumulators per
//   thread.
// - Epilogue: BN scale and bias and ReLU into the conv tile [position][72]
//   in shared memory (conflict-free float2 stores from the accumulators),
//   then the 3x3/2 max pool reads it as float4 and writes coalesced NHWC.
//
// Why wgmma and not mma.sync: mma.sync's B fragments would come through
// the shared-memory pipe with A, and on the H100 its loads and products do
// not overlap; wgmma reads B from shared memory itself. The tile loop stays
// sequential (split, GEMM, epilogue, pool): running the next patch's load
// and the previous tile's pool under the asynchronous wgmma gains little
// and needs all 255 registers.
//
// Halo: 255 conv positions computed per 224 unique (14%).
//
// Padding: conv positions outside the conv output (the pool's padding) are
// stored as 0 instead of -inf. That is exact because post-ReLU values are
// >= 0 and every pool window holds at least one real conv position
// (2*py <= CH-1 for every pool row py < PH), so the window max is unchanged.
//
// Works for any H, W >= 1 and cout a multiple of 8 up to 64; in_channels 3.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int KS = 7;                  // conv kernel size
constexpr int CIN = 3;                 // input channels
constexpr int TAPS = CIN * KS * KS;    // 147, tap = ci*49 + kh*7 + kw
constexpr int KSTEPS = (TAPS + 7) / 8; // 19 k-steps: K padded to 152
constexpr int TPY = 8, TPX = 7;        // pool outputs per tile (rows, cols)
constexpr int TCY = 2 * TPY + 1;       // conv rows per tile: 17
constexpr int TCX = 2 * TPX + 1;       // conv cols per tile: 15
constexpr int TIY = 2 * (TCY - 1) + KS;  // input rows per tile: 39
constexpr int TIX = 2 * (TCX - 1) + KS;  // input cols per tile: 35
constexpr int NPOS = TCY * TCX;        // conv positions per tile: 255
constexpr int MROWS = 256;             // GEMM rows: 4 m-blocks of 64 (1 spare)
constexpr int NCH = 64;                // channels computed: the wgmma's N
constexpr int CST = NCH + 8;           // conv tile row stride: conflict-free float2 stores
constexpr int PATCH = CIN * TIY * TIX; // 4095 floats
constexpr int THREADS = 256;           // 2 warpgroups
constexpr int MB_PER_WG = 2;           // m-blocks of 64 rows per warpgroup
constexpr int BTILE = 2048;            // bytes of one [64 n][8 k] TF32 B tile
constexpr int BF4 = KSTEPS * 2 * BTILE / 16;       // float4s of B (hi and lo): 4864
constexpr int BF4_PER_THREAD = BF4 / THREADS;      // 19
static_assert(BF4 % THREADS == 0, "B staging assumes whole rounds");

// shared memory: B tiles, conv tile, split patch {hi, lo}, raw patch
// (cp.async target), tap offsets, scale and bias
constexpr size_t SMEM_BYTES = size_t(KSTEPS) * 2 * BTILE + sizeof(float) * MROWS * CST +
                              sizeof(float2) * PATCH + sizeof(float) * PATCH +
                              sizeof(int) * 8 * KSTEPS + sizeof(float) * 2 * NCH;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// {hi, lo} with hi = tf32(x), lo = tf32(x - hi), as TF32 bit patterns
__device__ __forceinline__ float2 split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return make_float2(__uint_as_float(hi), __uint_as_float(tf32_rna(x - __uint_as_float(hi))));
}

// Shared-memory descriptor of one B tile: K-major, no swizzle. A core
// matrix is 8 n-rows of 16 bytes (4 TF32 along k); the tile's two core
// matrices along k are LBO = 128 bytes apart, its 8-row groups along n
// SBO = 256 bytes apart.
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((addr >> 4) & 0x3fff) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

// d[64 x 64] += a[64 x 8] * b[8 x 64], TF32 in, f32 accumulators; a from
// registers (this warp's 16 rows, mma.m16n8k8 A-fragment order), b from
// shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>  // until at most N committed wgmma groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A fragments of k-step ks for this thread's rows: rows gq, gq+8; columns
// (taps) tq, tq+4; hi and lo from the split patch
__device__ __forceinline__ void load_a(uint32_t (&ah)[MB_PER_WG][4],
                                       uint32_t (&al)[MB_PER_WG][4], const float2* a_s,
                                       const int* tap_s, const int (&poff)[MB_PER_WG][2],
                                       int ks, int tq) {
  const int ta = tap_s[8 * ks + tq], tb = tap_s[8 * ks + tq + 4];
#pragma unroll
  for (int m = 0; m < MB_PER_WG; ++m) {
    const float2 v0 = a_s[poff[m][0] + ta], v1 = a_s[poff[m][1] + ta];
    const float2 v2 = a_s[poff[m][0] + tb], v3 = a_s[poff[m][1] + tb];
    ah[m][0] = __float_as_uint(v0.x);
    ah[m][1] = __float_as_uint(v1.x);
    ah[m][2] = __float_as_uint(v2.x);
    ah[m][3] = __float_as_uint(v3.x);
    al[m][0] = __float_as_uint(v0.y);
    al[m][1] = __float_as_uint(v1.y);
    al[m][2] = __float_as_uint(v2.y);
    al[m][3] = __float_as_uint(v3.y);
  }
}

// one k-step as one wgmma group: per m-block lo*hi, hi*lo, hi*hi (small
// products first) against that k-step's hi and lo B tiles
__device__ __forceinline__ void issue_kstep(float (&acc)[MB_PER_WG][32],
                                            const uint32_t (&ah)[MB_PER_WG][4],
                                            const uint32_t (&al)[MB_PER_WG][4],
                                            const float4* b_s, int ks) {
  const uint64_t dh = b_desc(b_s + (2 * ks) * (BTILE / 16));
  const uint64_t dl = b_desc(b_s + (2 * ks + 1) * (BTILE / 16));
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int m = 0; m < MB_PER_WG; ++m) {
    wgmma_tf32(acc[m], al[m], dh);
    wgmma_tf32(acc[m], ah[m], dl);
    wgmma_tf32(acc[m], ah[m], dh);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// 4-byte asynchronous copy global -> shared; bytes = 0 stores a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

struct Geometry {
  int H, W, CH, CW, PH, PW, TX, TY, cout, ntiles;
};

struct Tile {
  int b, py0, px0;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g, int t) {
  const int per_image = g.TX * g.TY;
  const int b = t / per_image, r = t - b * per_image;
  const int ty = r / g.TX;
  return {b, ty * TPY, (r - ty * g.TX) * TPX};
}

// the tile's input patch [CIN][TIY][TIX] from NHWC, read in global order
__device__ __forceinline__ void load_patch(float* dst, const float* __restrict__ x,
                                           const Geometry& g, int t) {
  const Tile tl = tile_of(g, t);
  const int iy0 = 4 * tl.py0 - 5, ix0 = 4 * tl.px0 - 5;  // 2*(2*p0 - 1) - 3
  const float* xb = x + size_t(tl.b) * g.H * g.W * CIN;
  for (int i = threadIdx.x; i < PATCH; i += THREADS) {
    const int r = i / (TIX * CIN), j = i - r * (TIX * CIN);
    const int c = j / CIN, ci = j - c * CIN;
    const int gy = iy0 + r, gx = ix0 + c;
    const bool in = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
    const float* src = in ? xb + (size_t(gy) * g.W + gx) * CIN + ci : x;
    cp_async4(dst + (ci * TIY + r) * TIX + c, src, in ? 4 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            float* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(128) float4 smem4[];
  float4* b_s = smem4;                                           // [KSTEPS][hi, lo] tiles
  float* conv_s = reinterpret_cast<float*>(b_s + BF4);           // [MROWS][CST]
  float2* a_s = reinterpret_cast<float2*>(conv_s + MROWS * CST); // [PATCH] {hi, lo}
  float* raw_s = reinterpret_cast<float*>(a_s + PATCH);          // [PATCH]
  int* tap_s = reinterpret_cast<int*>(raw_s + PATCH);            // [8 * KSTEPS]
  float* sc_s = reinterpret_cast<float*>(tap_s + 8 * KSTEPS);    // [NCH]
  float* bi_s = sc_s + NCH;                                      // [NCH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const int cout = g.cout;

  int tile = blockIdx.x;
  if (tile < g.ntiles) load_patch(raw_s, x, g, tile);
  asm volatile("cp.async.commit_group;" ::: "memory");

  // weights OIHW [cout][147] -> per k-step a hi and a lo B tile; float4 f
  // of a tile holds w[n][k0..k0+3], n = 8*(f/16) + f%8, k0 = 8*ks + 4*(f/8%2),
  // at byte 16*f: core matrix (n/8, k0/4 %2) at (n/8)*256 + (k0/4 %2)*128.
  // Zero beyond cout and 147 taps. All of a thread's loads are issued
  // before any is used.
  {
    float4 wv[BF4_PER_THREAD];
#pragma unroll
    for (int u = 0; u < BF4_PER_THREAD; ++u) {
      const int f = tid + u * THREADS;
      const int ks = f / 256, r = f % 128;  // tile = f / 128 = 2*ks + part
      const int n = 8 * (r / 16) + r % 8, k0 = 8 * ks + 4 * (r / 8 % 2);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = n < cout && k0 + e < TAPS ? __ldg(w + n * TAPS + k0 + e) : 0.f;
      wv[u] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int u = 0; u < BF4_PER_THREAD; ++u) {
      const int f = tid + u * THREADS;
      const bool lo = f / 128 % 2;
      const float2 sx = split_tf32(wv[u].x), sy = split_tf32(wv[u].y);
      const float2 sz = split_tf32(wv[u].z), sw = split_tf32(wv[u].w);
      b_s[f] = lo ? make_float4(sx.y, sy.y, sz.y, sw.y) : make_float4(sx.x, sy.x, sz.x, sw.x);
    }
  }
  // the tensor cores read B through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int k = tid; k < 8 * KSTEPS; k += THREADS) {
    const int ci = k / (KS * KS), r = k - ci * KS * KS, kh = r / KS, kw = r - kh * KS;
    tap_s[k] = k < TAPS ? (ci * TIY + kh) * TIX + kw : 0;  // padded taps meet zero weights
  }
  for (int c = tid; c < NCH; c += THREADS) {
    sc_s[c] = c < cout ? scale[c] : 0.f;
    bi_s[c] = c < cout ? bias[c] : 0.f;
  }

  // this thread's A rows: warpgroup wg owns m-blocks 2wg, 2wg+1; its warp
  // supplies rows 16*(warp%4) + gq and + 8 of each
  const int wg = warp >> 2;
  int prow[MB_PER_WG][2], poff[MB_PER_WG][2];
#pragma unroll
  for (int m = 0; m < MB_PER_WG; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = 64 * (MB_PER_WG * wg + m) + 16 * (warp & 3) + gq + 8 * hf;
      prow[m][hf] = p;
      const int pa = p < NPOS ? p : 0;  // spare row: computed, never stored
      poff[m][hf] = 2 * (pa / TCX) * TIX + 2 * (pa % TCX);
    }

  for (; tile < g.ntiles; tile += gridDim.x) {
    // the raw patch has landed; split it once into {hi, lo}
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    for (int i = tid; i < PATCH; i += THREADS) a_s[i] = split_tf32(raw_s[i]);
    __syncthreads();
    // the next tile's patch arrives while this one computes
    const int next = tile + gridDim.x;
    if (next < g.ntiles) load_patch(raw_s, x, g, next);
    asm volatile("cp.async.commit_group;" ::: "memory");

    float acc[MB_PER_WG][32];
#pragma unroll
    for (int m = 0; m < MB_PER_WG; ++m)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;

    // two register sets of A fragments: the gather for k-step ks+1 runs
    // while the wgmma group of k-step ks is in flight
    uint32_t ah0[MB_PER_WG][4], al0[MB_PER_WG][4], ah1[MB_PER_WG][4], al1[MB_PER_WG][4];
    load_a(ah0, al0, a_s, tap_s, poff, 0, tq);
#pragma unroll 1
    for (int ks = 0; ks < KSTEPS; ks += 2) {
      issue_kstep(acc, ah0, al0, b_s, ks);
      wgmma_wait<1>();  // the group that read set 1 is done
      if (ks + 1 < KSTEPS) {
        load_a(ah1, al1, a_s, tap_s, poff, ks + 1, tq);
        issue_kstep(acc, ah1, al1, b_s, ks + 1);
      }
      wgmma_wait<1>();  // the group that read set 0 is done
      if (ks + 2 < KSTEPS) load_a(ah0, al0, a_s, tap_s, poff, ks + 2, tq);
    }
    wgmma_wait<0>();

    // BN affine + ReLU into the conv tile [p][c]; positions outside the conv
    // output hold 0 (see the padding note above). Channels >= cout hold
    // zeros (zero weights, scale and bias) and are never read. Accumulator
    // 4*j + e of a row pair is channel 8*j + 2*tq + (e & 1), row + 8*(e >> 1).
    const Tile tl = tile_of(g, tile);
    const int cy0 = 2 * tl.py0 - 1, cx0 = 2 * tl.px0 - 1;
#pragma unroll
    for (int m = 0; m < MB_PER_WG; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = prow[m][hf];
        if (p >= NPOS) continue;
        const int gy = cy0 + p / TCX, gx = cx0 + p % TCX;
        const bool real = gy >= 0 && gy < g.CH && gx >= 0 && gx < g.CW;
#pragma unroll
        for (int j = 0; j < NCH / 8; ++j) {
          const int c = 8 * j + 2 * tq;
          float2 y = make_float2(0.f, 0.f);
          if (real) {
            y.x = fmaxf(acc[m][4 * j + 2 * hf] * sc_s[c] + bi_s[c], 0.f);
            y.y = fmaxf(acc[m][4 * j + 2 * hf + 1] * sc_s[c + 1] + bi_s[c + 1], 0.f);
          }
          *reinterpret_cast<float2*>(conv_s + p * CST + c) = y;
        }
      }
    __syncthreads();

    // 3x3 stride-2 max pool from shared memory, four channels a thread:
    // float4 reads (conflict-free within each 8-lane phase) and coalesced
    // float4 NHWC stores
    const int c4 = cout / 4;
    float* ob = out + size_t(tl.b) * g.PH * g.PW * cout;
    for (int i = tid; i < TPY * TPX * c4; i += THREADS) {
      const int co = 4 * (i % c4), q = i / c4;
      const int ly = q / TPX, lx = q % TPX;
      const int py = tl.py0 + ly, px = tl.px0 + lx;
      if (py >= g.PH || px >= g.PW) continue;
      const float* cs = conv_s + (2 * ly * TCX + 2 * lx) * CST + co;
      float4 mx = *reinterpret_cast<const float4*>(cs);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 v = *reinterpret_cast<const float4*>(cs + (dy * TCX + dx) * CST);
          mx = make_float4(fmaxf(mx.x, v.x), fmaxf(mx.y, v.y), fmaxf(mx.z, v.z),
                           fmaxf(mx.w, v.w));
        }
      *reinterpret_cast<float4*>(ob + (size_t(py) * g.PW + px) * cout + co) = mx;
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

}  // namespace

// Dynamic shared memory of one block (ptxas -v reports static memory only).
VQA_EXPORT int vqa_stem_smem_bytes() { return static_cast<int>(SMEM_BYTES); }

// x [B,H,W,3] NHWC, w [cout,3,7,7] OIHW, scale/bias [cout], out [B,PH,PW,cout]
// NHWC, all f32 and contiguous.
VQA_EXPORT int vqa_stem_f32(const float* x, const float* w, const float* scale,
                            const float* bias, float* out, int B, int H, int W,
                            int cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cout <= 0 || cout % 8 != 0 || cout > NCH)
    return cudaErrorInvalidValue;
  Geometry g;
  g.H = H;
  g.W = W;
  g.CH = (H - 1) / 2 + 1;
  g.CW = (W - 1) / 2 + 1;
  g.PH = (g.CH - 1) / 2 + 1;
  g.PW = (g.CW - 1) / 2 + 1;
  g.TX = (g.PW + TPX - 1) / TPX;
  g.TY = (g.PH + TPY - 1) / TPY;
  g.cout = cout;
  const long long ntiles = (long long)B * g.TX * g.TY;
  if (ntiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  g.ntiles = static_cast<int>(ntiles);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = vqa::allow_smem(stem_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, bias, out, g);
  return cudaGetLastError();
}
