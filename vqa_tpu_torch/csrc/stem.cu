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
//   (TMA could take an image row of W*12 bytes as one 16-byte-multiple row,
//   as the bf16 form does; the split below needs a pass over the patch
//   anyway.) Each patch element is then split once into an interleaved
//   {hi, lo} pair, so every A fragment that reads it pays one 8-byte load
//   and no conversion.
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
//
// bf16 form (vqa_stem_bf16, stem_kernel_bf16): x and w in bf16, scale and
// bias f32, output bf16, as the TPU kernel takes x's dtype for w and its
// output and keeps the affine f32 (stem_kernel.py:205-211). Its design
// (patch by TMA, K in the TPU kernel's per-row order, a bf16 conv tile) is
// described at its section below.

#include <cuda.h>  // CUtensorMap and its enums (types only: encode_tiled below)

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

// BN affine + ReLU into the conv tile [p][c]; positions outside the conv
// output hold 0 (see the padding note above). Channels >= cout hold zeros
// (zero weights, scale and bias) and are never read. Accumulator 4*j + e
// of a row pair is channel 8*j + 2*tq + (e & 1), row + 8*(e >> 1).
__device__ __forceinline__ void store_conv_tile(float* conv_s, const float (&acc)[MB_PER_WG][32],
                                                const int (&prow)[MB_PER_WG][2],
                                                const float* sc_s, const float* bi_s,
                                                const Geometry& g, const Tile& tl, int tq) {
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
}

// four channels of the output: a float4 store
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// 3x3 stride-2 max pool from shared memory, four channels a thread:
// float4 reads (conflict-free within each 8-lane phase) and coalesced NHWC
// stores
template <typename E>
__device__ __forceinline__ void pool_tile(E* __restrict__ out, const float* conv_s,
                                          const Geometry& g, const Tile& tl) {
  const int cout = g.cout, c4 = cout / 4;
  E* ob = out + size_t(tl.b) * g.PH * g.PW * cout;
  for (int i = threadIdx.x; i < TPY * TPX * c4; i += THREADS) {
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
    store4(ob + (size_t(py) * g.PW + px) * cout + co, mx);
  }
}

// this thread's A rows: warpgroup wg owns m-blocks 2wg, 2wg+1; its warp
// supplies rows 16*(warp%4) + gq and + 8 of each. prow: the GEMM row (conv
// position) of each, poff: its offset in the [CIN][TIY][TIX] patch.
__device__ __forceinline__ void a_rows(int (&prow)[MB_PER_WG][2], int (&poff)[MB_PER_WG][2],
                                       int warp, int gq) {
  const int wg = warp >> 2;
#pragma unroll
  for (int m = 0; m < MB_PER_WG; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = 64 * (MB_PER_WG * wg + m) + 16 * (warp & 3) + gq + 8 * hf;
      prow[m][hf] = p;
      const int pa = p < NPOS ? p : 0;  // spare row: computed, never stored
      poff[m][hf] = 2 * (pa / TCX) * TIX + 2 * (pa % TCX);
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

  int prow[MB_PER_WG][2], poff[MB_PER_WG][2];
  a_rows(prow, poff, warp, gq);

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

    const Tile tl = tile_of(g, tile);
    store_conv_tile(conv_s, acc, prow, sc_s, bi_s, g, tl, tq);
    __syncthreads();
    pool_tile(out, conv_s, g, tl);
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---- bf16 form ---------------------------------------------------------
//
// The same function on bf16 x and w (scale and bias f32, output bf16):
// one wgmma.m64n64k16.f32.bf16.bf16 per k-step and m-block, A from
// registers, f32 accumulators. A bf16 product is exact in f32, so the conv
// needs no hi/lo split. What bounds it: the bound is operations (7.55
// GFLOP at B = 32), but a tile issues 1.57x the conv's products (K = 147
// taps in 176 slots, M = 256 rows for 49 pool outputs), and beside them
// shared memory carries each wgmma's 2 KB B tile, the A gather, the conv
// tile and the pool's reads, while the epilogue and pool leave the tensor
// cores idle unless the SM's other block is multiplying. The design keeps
// the patch load off that path and cuts the rest:
//
// - The patch arrives by TMA, two tiles ahead. x is viewed as a 3-D tensor
//   [B][H][W*3] of bf16, so an image row is one TMA row (W*6 bytes, a
//   multiple of 16 when W % 8 == 0), and a box of [37 rows][112 elements]
//   at (e0, 4*py0 - 5, b) lands the tile's patch in shared memory as it
//   lies in the image: row r, element 3*col + c. TMA takes a box only from
//   a 16-byte aligned element along a row (an unaligned start faults), so
//   e0 is the patch's first element 3*(4*px0 - 5) rounded down to a
//   multiple of 8, and the patch starts `shift` (1 or 5) elements into
//   each box row. TMA fills every coordinate outside the tensor with zeros,
//   which is the conv's padding on all four sides, and the batch is its
//   own dimension, so nothing bleeds across images. One thread issues the
//   copy into the buffer the tile just finished with; an mbarrier with the
//   box's byte count says when it has landed. Where TMA cannot take x
//   (W % 8 != 0, or x not 16-byte aligned: a view with a storage offset)
//   the same box is filled by plain loads, one tile ahead, chosen by
//   geometry (ops/stem_kernel.py:stem_plan).
// - K is ordered as the TPU kernel packs it (pack_stem_weights,
//   vqa_tpu/ops/stem_kernel.py:176): per kernel row kh, taps kw*3 + c, in
//   24 slots a row, slot s holding tap s - 1 (slots 0, 22 and 23 zero), 3
//   groups of 8 slots a row, 11 k-steps of 16 (the 22nd group is zero);
//   the groups go row by row for each third of a row in turn, the even
//   rows first (kh_of, q_of: see below). In the box the
//   21 taps of row kh for conv position (cy, cx) are 21 consecutive
//   elements from element 6*cx + shift of box row 2*cy + kh, so an A
//   register (slots 8q + 2tq, +1: taps 8q + 2tq - 1, +1) starts at an even
//   element, since shift is odd: one aligned 32-bit shared load at a
//   constant offset from the thread's base, no tap table, no packing. The
//   padding slots are masked to zero in the register (tq = 0's low half in
//   a row's first group, tq = 3's pair in its last), so a non-finite pixel
//   just outside a window cannot reach a sum through a zero weight.
// - Each thread's four GEMM rows (rows gq and gq+8 of its warpgroup's two
//   m-blocks) are a vertical strip of four conv positions (cy0..cy0+3, cx):
//   the 28 (position, kernel row) pairs read only 13 box rows, 2*cy0 + 0..12,
//   so a thread loads 39 A registers per tile (13 rows x 3 groups), not 84,
//   and keeps each in a register for the k-steps that use it (~15 live in
//   the group order kh_of/q_of).
// - The strip also pools itself: a pool row ly takes conv rows 2ly .. 2ly+2,
//   so strip k (tile rows 4k .. 4k+3) holds pool row 2k whole and two of
//   the three rows of 2k+1. The epilogue stores, per strip and channel
//   pair, E = max(r0, r1, r2), O = max(r2, r3) and Z = r0 (3 stores for 4
//   positions), and the pool reads 3 of them for an even pool row
//   (E at 3 columns) and 6 for an odd one (O and the next strip's Z), not 9.
//   Each position is rounded to bf16 with its ReLU in one cvt and the
//   maxima taken in bf16: rounding is monotonic, so the max of the rounded
//   values is the rounded f32 max that the plain version computes.
// - A tile is 7x7 pool outputs: 15x15 conv positions in 4 strips of 4
//   rows, 60 strips of the block's 64 (M = 256; row 15 and 4 strips are
//   spare). Weights are staged once per persistent block: read coalesced
//   into shared memory, then permuted into the 11 B tiles [64 n][16 k], the
//   K-major no-swizzle layout and descriptor of the TF32 tiles (LBO 128 B,
//   SBO 256 B). Two blocks per SM, two sets of E/O/Z planes each (the
//   epilogue of tile t+1 writes the set tile t's pool is not reading), so a
//   tile takes one block barrier (one set with a second barrier measured
//   the same on the H100: PERF.md §6).

constexpr int TPY16 = 7, TPX16 = 7;               // pool outputs per tile
constexpr int TCY16 = 2 * TPY16 + 1;              // conv rows per tile: 15
constexpr int TCX16 = 2 * TPX16 + 1;              // conv cols per tile: 15
constexpr int STRIP = 4;                          // conv rows per strip (a thread's GEMM rows)
constexpr int STRIP_ROWS = (TCY16 + STRIP - 1) / STRIP;  // strips down a tile: 4
constexpr int NSTRIPS = STRIP_ROWS * TCX16;       // 60 of the 64 the block's rows hold
constexpr int ROWS_IN = 2 * (STRIP - 1) + KS;     // box rows one strip reads: 13
constexpr int BOX_ROWS = 2 * (STRIP * STRIP_ROWS - 1) + KS;  // 37
constexpr int PITCH16 = (5 + CIN * (2 * (TCX16 - 1) + KS) + 7) / 8 * 8;  // box row: 112
constexpr int BOX_BYTES = 2 * BOX_ROWS * PITCH16;            // 8288
constexpr int PATCH_BYTES = (BOX_BYTES + 127) / 128 * 128;   // 8320
constexpr int ROWTAPS = 24;                        // slots of one kernel row, 21 taps + 3 zeros
constexpr int KGROUPS = KS * ROWTAPS / 8;          // 21 groups of 8 slots
constexpr int KSTEPS16 = (KGROUPS + 1) / 2;        // 11 k-steps of 16
constexpr int B16_CHUNKS = KSTEPS16 * BTILE / 16;  // 16-byte chunks of B: 1408
constexpr int CST16 = NCH + 8;                     // a strip's channels: 144 bytes
constexpr int PLANE16 = 64 * CST16;                // one of E, O, Z: a row per strip slot
constexpr int CONV_BYTES = 2 * 3 * PLANE16;        // 27648
constexpr int POOL_ITEMS = TPY16 * TPX16 * (NCH / 8);  // (pool output, 8 channels): 392
constexpr int POOL_PER_THREAD = (POOL_ITEMS + THREADS - 1) / THREADS;
static_assert(STRIP_ROWS * STRIP >= TCY16 && NSTRIPS <= 64, "a tile's strips fit the block");
static_assert(4 + 6 * (TCX16 - 1) + ROWTAPS <= PITCH16, "every slot read lies in the box");
static_assert(CONV_BYTES >= 2 * NCH * TAPS, "the raw weights fit the conv planes");

constexpr int BLOCKS_PER_SM16 = 2;  // persistent blocks on each SM
// shared memory: B tiles, two boxes, two sets of conv planes, scale and
// bias, two mbarriers (94,992 bytes)
constexpr size_t SMEM16_BYTES = size_t(KSTEPS16) * BTILE + 2 * PATCH_BYTES + 2 * CONV_BYTES +
                                sizeof(float) * 2 * NCH + 2 * sizeof(uint64_t);

// Group g (g < KGROUPS) is slots 8*q_of(g) .. +7 of kernel row kh_of(g):
// the 7 rows' first 8 slots, then their second and third, each pass over
// the even rows first, then the odd. A box row a strip reads serves kernel
// rows 2 apart, so this order keeps ~15 A registers live (21 with each
// row's three groups in turn).
__host__ __device__ constexpr int kh_of(int g) {
  return g % KS < 4 ? 2 * (g % KS) : 2 * (g % KS - 4) + 1;
}
__host__ __device__ constexpr int q_of(int g) { return g / KS; }

// the first group that reads box row rho (of a strip's 13) at group slot q
__host__ __device__ constexpr int first_use(int rho, int q) {
  for (int g = KS * q; g < KS * (q + 1); ++g) {
    const int d = rho - kh_of(g);
    if (d >= 0 && d <= 2 * (STRIP - 1) && d % 2 == 0) return g;
  }
  return -1;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery's round-up method with a 33-bit multiplier 2^32 + mul): the
// tile walk divides by sizes known only at launch
struct FastDiv {
  uint32_t mul;
  int shift;
};

FastDiv make_fastdiv(uint32_t d) {  // d >= 1
  int s = 0;
  while ((1u << s) < d) ++s;
  return {static_cast<uint32_t>((uint64_t(1) << 32) * ((uint64_t(1) << s) - d) / d + 1), s};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return static_cast<int>((__umulhi(static_cast<uint32_t>(n), f.mul) + static_cast<uint32_t>(n)) >>
                          f.shift);
}

struct Geometry16 {
  int H, W, CH, CW, PH, PW, TX, TY, cout, ntiles, tma;
  FastDiv per_image, tx;  // by TX * TY and by TX
};

__device__ __forceinline__ Tile tile_of16(const Geometry16& g, int t) {
  const int b = fdiv(t, g.per_image), r = t - b * g.TX * g.TY;
  const int ty = fdiv(r, g.tx);
  return {b, ty * TPY16, (r - ty * g.TX) * TPX16};
}

// The tile's box starts at element e0 of the [W*3] image row: the patch's
// first element 3*(4*px0 - 5) rounded down to a multiple of 8 (TMA takes
// only 16-byte aligned starts along a row), so patch element e lies at box
// element e + shift, shift = 1 or 5 (odd: 3*(4*px0 - 5) is odd).
__device__ __forceinline__ int box_x(int px0, int& shift) {
  const int e = CIN * (4 * px0 - 5);
  shift = e & 7;
  return e - shift;
}

// d[64 x 64] += a[64 x 16] * b[16 x 64], bf16 in, f32 accumulators; a from
// registers (this warp's 16 rows, mma.m16n8k16 A-fragment order), b from
// shared memory, K-major (no transpose)
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

// The A register group G first reads for strip position D: box row
// rho = kh + 2*D at group slot q = q_of(G), from pb (this thread's strip base
// + 4*tq bytes); mask0 and mask2 zero the padding slots.
template <int G, int D>
__device__ __forceinline__ void load_one(uint32_t (&v)[ROWS_IN][3], const char* pb,
                                         uint32_t mask0, uint32_t mask2) {
  constexpr int q = q_of(G), rho = kh_of(G) + 2 * D;
  if constexpr (first_use(rho, q) == G) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(pb + 2 * (rho * PITCH16 + 8 * q));
    if constexpr (q == 0)
      v[rho][q] = x & mask0;
    else if constexpr (q == 2)
      v[rho][q] = x & mask2;
    else
      v[rho][q] = x;
  }
}

template <int G>
__device__ __forceinline__ void load_group(uint32_t (&v)[ROWS_IN][3], const char* pb,
                                           uint32_t mask0, uint32_t mask2) {
  if constexpr (G < KGROUPS) {
    load_one<G, 0>(v, pb, mask0, mask2);
    load_one<G, 1>(v, pb, mask0, mask2);
    load_one<G, 2>(v, pb, mask0, mask2);
    load_one<G, 3>(v, pb, mask0, mask2);
  }
}

// k-step S as one wgmma group: per m-block m, rows gq and gq+8 are strip
// positions 2m and 2m+1 (box rows kh + 4m and kh + 4m + 2)
template <int S>
__device__ __forceinline__ void issue_kstep16(float (&acc)[2][32], const uint32_t (&v)[ROWS_IN][3],
                                              const uint4* b_s) {
  constexpr int g0 = 2 * S, g1 = 2 * S + 1;
  constexpr int kh0 = kh_of(g0), q0 = q_of(g0);
  constexpr int kh1 = kh_of(g1 < KGROUPS ? g1 : 0), q1 = q_of(g1 < KGROUPS ? g1 : 0);
  const uint64_t d = b_desc(b_s + S * (BTILE / 16));
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if constexpr (g1 < KGROUPS)
      wgmma_bf16(acc[m], v[kh0 + 4 * m][q0], v[kh0 + 4 * m + 2][q0], v[kh1 + 4 * m][q1],
                 v[kh1 + 4 * m + 2][q1], d);
    else
      wgmma_bf16(acc[m], v[kh0 + 4 * m][q0], v[kh0 + 4 * m + 2][q0], 0u, 0u, d);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// k-steps S.. of a tile: the loads k-step S+1 first needs run while the
// wgmma group of k-step S is in flight
template <int S>
__device__ __forceinline__ void gemm16(float (&acc)[2][32], uint32_t (&v)[ROWS_IN][3],
                                       const uint4* b_s, const char* pb, uint32_t mask0,
                                       uint32_t mask2) {
  if constexpr (S < KSTEPS16) {
    issue_kstep16<S>(acc, v, b_s);
    if constexpr (S + 1 < KSTEPS16) {
      wgmma_wait<1>();  // k-step S-1's group is done: its registers may be reused
      load_group<2 * S + 2>(v, pb, mask0, mask2);
      load_group<2 * S + 3>(v, pb, mask0, mask2);
    }
    gemm16<S + 1>(acc, v, b_s, pb, mask0, mask2);
  }
}

// the tile's box [BOX_ROWS][PITCH16] (row r: image row 4*py0 - 5 + r,
// elements from box_x), zero outside the image, by plain loads: the route
// where TMA cannot take x. All of a thread's loads are issued before its
// stores.
__device__ __forceinline__ void fill_patch16(unsigned short* dst,
                                             const unsigned short* __restrict__ x,
                                             const Geometry16& g, int t) {
  constexpr int N = BOX_ROWS * PITCH16, PER = (N + THREADS - 1) / THREADS;
  const Tile tl = tile_of16(g, t);
  int shift;
  const int iy0 = 4 * tl.py0 - 5, ie0 = box_x(tl.px0, shift), row = CIN * g.W;
  const unsigned short* xb = x + size_t(tl.b) * g.H * row;
  unsigned short v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int r = i / PITCH16, e = i - r * PITCH16;
    const int gy = iy0 + r, ge = ie0 + e;
    v[u] = i < N && gy >= 0 && gy < g.H && ge >= 0 && ge < row ? __ldg(xb + size_t(gy) * row + ge)
                                                               : static_cast<unsigned short>(0);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i < N) dst[i] = v[u];
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint4 hmax8(uint4 a, uint4 b) {
  return make_uint4(as_u32(__hmax2(as_bf162(a.x), as_bf162(b.x))),
                    as_u32(__hmax2(as_bf162(a.y), as_bf162(b.y))),
                    as_u32(__hmax2(as_bf162(a.z), as_bf162(b.z))),
                    as_u32(__hmax2(as_bf162(a.w), as_bf162(b.w))));
}
__device__ __forceinline__ uint4 lds128(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint32_t hmax2u(uint32_t a, uint32_t b) {
  return as_u32(__hmax2(as_bf162(a), as_bf162(b)));
}
// {relu(lo), relu(hi)} rounded to bf16, lo in the low half: one cvt
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// x, w bf16 bit patterns (unsigned short), out bf16. tmap: x as [B][H][W*3]
// with a [1][BOX_ROWS][PITCH16] box (unused where g.tma == 0).
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM16)
stem_kernel_bf16(const __grid_constant__ CUtensorMap tmap, const unsigned short* __restrict__ x,
                 const unsigned short* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 const Geometry16 g) {
  extern __shared__ __align__(128) uint4 smem16[];
  uint4* b_s = smem16;                                                   // [KSTEPS16] B tiles
  char* patch_s = reinterpret_cast<char*>(b_s + B16_CHUNKS);             // [2][PATCH_BYTES]
  __nv_bfloat16* conv_s =
      reinterpret_cast<__nv_bfloat16*>(patch_s + 2 * PATCH_BYTES);       // [2][E,O,Z][64][CST16]
  float* sc_s = reinterpret_cast<float*>(reinterpret_cast<char*>(conv_s) + 2 * CONV_BYTES);
  float* bi_s = sc_s + NCH;
  uint64_t* bar = reinterpret_cast<uint64_t*>(bi_s + NCH);               // [2] box landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, thread in group
  const int cout = g.cout, step = gridDim.x;

  // the first two tiles' boxes start first, under the weights' staging
  if (g.tma && tid == 0) {
    vqa::mbar_init(&bar[0], 1);
    vqa::mbar_init(&bar[1], 1);
    for (int i = 0; i < 2; ++i) {
      const int t = blockIdx.x + i * step;
      if (t >= g.ntiles) break;
      const Tile tl = tile_of16(g, t);
      int shift;
      vqa::mbar_expect_tx(&bar[i], BOX_BYTES);
      vqa::tma_load_3d(patch_s + i * PATCH_BYTES, &tmap, &bar[i], box_x(tl.px0, shift),
                       4 * tl.py0 - 5, tl.b);
    }
  }
  if (!g.tma && blockIdx.x < g.ntiles)
    fill_patch16(reinterpret_cast<unsigned short*>(patch_s), x, g, blockIdx.x);

  // weights OIHW [cout][147], read coalesced into the (not yet used) conv
  // planes, then permuted into one B tile per k-step: chunk f (16 bytes) of
  // a tile holds w[n][k0..k0+7], n = 8*(f/16) + f%8, k0 = 16*ks + 8*(f/8%2),
  // core matrix (n/8, f/8%2) at (n/8)*256 + (f/8%2)*128 as the TF32 tiles;
  // k = 8*group + e is slot 8*q_of(group) + e of kernel row kh_of(group),
  // tap t = slot - 1 = kw*3 + c. Zero beyond cout, outside taps 0..20 and
  // beyond 21 groups.
  unsigned short* raw = reinterpret_cast<unsigned short*>(conv_s);
  if ((reinterpret_cast<uintptr_t>(w) & 15) == 0) {  // cout * 294 bytes: whole 16-byte chunks
    constexpr int PER = (NCH * TAPS * 2 / 16 + THREADS - 1) / THREADS;
    const int n16 = cout * TAPS * 2 / 16;
    uint4 v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS;
      if (i < n16) v[u] = __ldg(reinterpret_cast<const uint4*>(w) + i);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS;
      if (i < n16) reinterpret_cast<uint4*>(raw)[i] = v[u];
    }
  } else {
#pragma unroll 8
    for (int i = tid; i < cout * TAPS; i += THREADS) raw[i] = __ldg(w + i);
  }
  for (int c = tid; c < NCH; c += THREADS) {
    sc_s[c] = c < cout ? scale[c] : 0.f;
    bi_s[c] = c < cout ? bias[c] : 0.f;
  }
  __syncthreads();
  for (int f = tid; f < B16_CHUNKS; f += THREADS) {
    const int ks = f / 128, r = f % 128;
    const int n = 8 * (r / 16) + r % 8, grp = 2 * ks + r / 8 % 2;
    const int kh = kh_of(grp), t0 = 8 * q_of(grp);
    unsigned short v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = t0 + e - 1, kw = t / CIN, c = t - kw * CIN;
      v[e] = n < cout && grp < KGROUPS && t >= 0 && t < KS * CIN
                 ? raw[n * TAPS + c * KS * KS + kh * KS + kw]
                 : static_cast<unsigned short>(0);
    }
    b_s[f] = make_uint4(v[0] | uint32_t(v[1]) << 16, v[2] | uint32_t(v[3]) << 16,
                        v[4] | uint32_t(v[5]) << 16, v[6] | uint32_t(v[7]) << 16);
  }
  // the tensor cores read B through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();  // B staged, the raw weights read, the first box filled

  // this thread's strip: slot sg of the block's 64, conv rows 4*sk .. +3 of
  // column sx (spare slots compute strip 0 again and store to their own,
  // unread rows of the planes); its A base offset in a box
  const int sg = 32 * (warp >> 2) + 8 * (warp & 3) + gq;
  const int sk = sg < NSTRIPS ? sg / TCX16 : 0, sx = sg < NSTRIPS ? sg % TCX16 : 0;
  const int soff = 2 * (2 * STRIP * sk * PITCH16 + 6 * sx) + 4 * tq;
  // slot 0 (tap -1) is tq 0's low half in a row's first group; slots 22
  // and 23 are tq 3's pair in its last
  const uint32_t mask0 = tq == 0 ? 0xffff0000u : 0xffffffffu;
  const uint32_t mask2 = tq == 3 ? 0u : 0xffffffffu;

  int it = 0;
  for (int tile = blockIdx.x; tile < g.ntiles; tile += step, ++it) {
    // phase 0: the tile starts (tools/stem_phases.py stamps each phase line)
    const int buf = it & 1;
    const Tile tl = tile_of16(g, tile);
    int shift;
    box_x(tl.px0, shift);
    // slot pair (2k, 2k+1) of a kernel row is taps 2k-1, 2k: box elements
    // 6*cx + 2k - 1 + shift, an even start since shift is odd
    const char* pb = patch_s + buf * PATCH_BYTES + soff + 2 * (shift - 1);
    if (g.tma) {
      vqa::mbar_wait(&bar[buf], (it >> 1) & 1);
      __syncwarp();  // converged for the warpgroup's wgmma
    }

    // phase 1: its box has landed
    float acc[2][32];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;
    uint32_t v[ROWS_IN][3];
    load_group<0>(v, pb, mask0, mask2);
    load_group<1>(v, pb, mask0, mask2);
    gemm16<0>(acc, v, b_s, pb, mask0, mask2);
    wgmma_wait<0>();
    // phase 2: its products are done

    // epilogue: BN affine in f32, then ReLU and the rounding to bf16 in one
    // cvt per channel pair (0 outside the conv output: see the padding note
    // above), then the strip's E, O and Z as bf16 maxima, which equal the
    // rounded f32 maxima (rounding is monotonic). Accumulator 4*j + e of
    // m-block m is channel 8*j + 2*tq + (e & 1) of strip position
    // 2*m + (e >> 1).
    // this tile's planes: the other set is the previous tile's, which its
    // pool may still read
    __nv_bfloat16* cv = conv_s + (it & 1) * (CONV_BYTES / 2);
    const int gx = 2 * tl.px0 - 1 + sx, gy0 = 2 * tl.py0 - 1 + STRIP * sk;
    uint32_t keep[STRIP];  // all ones at a conv output position, else 0
#pragma unroll
    for (int r = 0; r < STRIP; ++r)
      keep[r] = gx >= 0 && gx < g.CW && gy0 + r >= 0 && gy0 + r < g.CH ? 0xffffffffu : 0u;
    uint32_t* ep = reinterpret_cast<uint32_t*>(cv + sg * CST16 + 2 * tq);
#pragma unroll
    for (int j = 0; j < NCH / 8; ++j) {
      const float2 sc = *reinterpret_cast<const float2*>(sc_s + 8 * j + 2 * tq);
      const float2 bi = *reinterpret_cast<const float2*>(bi_s + 8 * j + 2 * tq);
      uint32_t y[STRIP];
#pragma unroll
      for (int r = 0; r < STRIP; ++r)
        y[r] = relu_bf16x2(acc[r >> 1][4 * j + 2 * (r & 1)] * sc.x + bi.x,
                           acc[r >> 1][4 * j + 2 * (r & 1) + 1] * sc.y + bi.y) & keep[r];
      ep[4 * j] = hmax2u(hmax2u(y[0], y[1]), y[2]);  // E
      ep[PLANE16 / 2 + 4 * j] = hmax2u(y[2], y[3]);  // O
      ep[PLANE16 + 4 * j] = y[0];                    // Z
    }
    // plain-load route: the next tile's box into the other buffer (last
    // read by the previous tile's products, before the previous barrier)
    const int next = tile + step;
    if (!g.tma && next < g.ntiles)
      fill_patch16(reinterpret_cast<unsigned short*>(patch_s + (buf ^ 1) * PATCH_BYTES), x, g,
                   next);
    // phase 3: this thread's part of the planes is written
    __syncthreads();  // the planes are written; every read of this box is done
    // phase 4: the block's planes are written
    if (g.tma && tid == 0 && next + step < g.ntiles) {
      const Tile nt = tile_of16(g, next + step);
      int nshift;
      vqa::mbar_expect_tx(&bar[buf], BOX_BYTES);
      vqa::tma_load_3d(patch_s + buf * PATCH_BYTES, &tmap, &bar[buf], box_x(nt.px0, nshift),
                       4 * nt.py0 - 5, nt.b);
    }

    // the pool's horizontal pass over the strips' vertical maxima: 16-byte
    // reads of 8 channels and coalesced 16-byte NHWC stores
    __nv_bfloat16* ob = out + size_t(tl.b) * g.PH * g.PW * cout;
    // Item i: pool output (ly, lx) = (i/8 / 7, i/8 % 7), channels co..co+7;
    // it reads E of strip ly/2 for an even ly, O of strip ly/2 and Z of
    // strip ly/2 + 1 for an odd one, at conv columns 2*lx .. 2*lx+2.
#pragma unroll
    for (int u = 0; u < POOL_PER_THREAD; ++u) {
      const int i = tid + u * THREADS, co = 8 * (i % (NCH / 8)), q = i / (NCH / 8);
      const int ly = q / TPX16, lx = q % TPX16, py = tl.py0 + ly, px = tl.px0 + lx;
      if (i >= POOL_ITEMS || co >= cout || py >= g.PH || px >= g.PW) continue;
      const __nv_bfloat16* cs = cv + (ly & 1) * PLANE16 + ((ly >> 1) * TCX16 + 2 * lx) * CST16 + co;
      uint4 mx = hmax8(hmax8(lds128(cs), lds128(cs + CST16)), lds128(cs + 2 * CST16));
      if (ly & 1) {  // O of this strip (above) and Z of the next
        const __nv_bfloat16* zs = cs + PLANE16 + TCX16 * CST16;
        mx = hmax8(mx, hmax8(hmax8(lds128(zs), lds128(zs + CST16)), lds128(zs + 2 * CST16)));
      }
      *reinterpret_cast<uint4*>(ob + (size_t(py) * g.PW + px) * cout + co) = mx;
    }
    // phase 5: pooled
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links against nothing but it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// x [B][H][W*3] bf16 with a [1][BOX_ROWS][PITCH16] box; zero fill outside
cudaError_t encode_x(CUtensorMap& map, const void* x, int B, int H, int W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cuuint64_t(CIN) * W, cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[2] = {2ull * CIN * W, 2ull * CIN * W * H};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {PITCH16, BOX_ROWS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Geometry of a launch; false where the sizes are out of range.
bool make_geometry(int B, int H, int W, int cout, Geometry& g) {
  if (B <= 0 || H <= 0 || W <= 0 || cout <= 0 || cout % 8 != 0 || cout > NCH) return false;
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
  if (ntiles > 0x7fffffffLL) return false;
  g.ntiles = static_cast<int>(ntiles);
  return true;
}

// blocks of a persistent launch: `per_sm` on each SM, no more than tiles
cudaError_t persistent_grid(const Geometry& g, int per_sm, int& grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  grid = g.ntiles < per_sm * sms ? g.ntiles : per_sm * sms;
  return err;
}

// Geometry of a bf16 launch; false where the sizes are out of range.
bool make_geometry16(int B, int H, int W, int cout, int tma, Geometry16& g) {
  Geometry g32;
  if (!make_geometry(B, H, W, cout, g32)) return false;
  const int tx = (g32.PW + TPX16 - 1) / TPX16, ty = (g32.PH + TPY16 - 1) / TPY16;
  g = {g32.H, g32.W, g32.CH, g32.CW, g32.PH, g32.PW, tx, ty, cout, 0, tma,
       make_fastdiv(uint32_t(tx) * ty), make_fastdiv(tx)};
  const long long ntiles = (long long)B * tx * ty;
  if (ntiles > 0x7fffffffLL) return false;
  g.ntiles = static_cast<int>(ntiles);
  return true;
}

}  // namespace

// Dynamic shared memory of one block (ptxas -v reports static memory only).
VQA_EXPORT int vqa_stem_smem_bytes() { return static_cast<int>(SMEM_BYTES); }
VQA_EXPORT int vqa_stem_bf16_smem_bytes() { return static_cast<int>(SMEM16_BYTES); }

// x [B,H,W,3] NHWC, w [cout,3,7,7] OIHW, scale/bias [cout], out [B,PH,PW,cout]
// NHWC, all f32 and contiguous.
VQA_EXPORT int vqa_stem_f32(const float* x, const float* w, const float* scale,
                            const float* bias, float* out, int B, int H, int W,
                            int cout, void* stream) {
  Geometry g;
  if (!make_geometry(B, H, W, cout, g)) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = persistent_grid(g, 1, grid);
  if (err == cudaSuccess) err = vqa::allow_smem(stem_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  stem_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x, w, scale, bias, out, g);
  return cudaGetLastError();
}

// The same with x, w and out bf16 (scale and bias f32), all contiguous,
// under the plan of ops/stem_kernel.py:stem_plan: the box by TMA (tma = 1:
// needs W % 8 == 0 and a 16-byte aligned x) or by plain loads, and
// smem_bytes of dynamic shared memory. A plan that does not match the
// kernel's own layout is refused (cudaErrorInvalidValue).
VQA_EXPORT int vqa_stem_bf16(const void* x, const void* w, const float* scale,
                             const float* bias, void* out, int B, int H, int W, int cout, int tma,
                             int smem_bytes, void* stream) {
  Geometry16 g;
  if (smem_bytes != static_cast<int>(SMEM16_BYTES) || !make_geometry16(B, H, W, cout, tma != 0, g))
    return cudaErrorInvalidValue;
  CUtensorMap map{};
  if (g.tma) {
    if (W % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return cudaErrorInvalidValue;
    const cudaError_t err = encode_x(map, x, B, H, W);
    if (err != cudaSuccess) return err;
  }
  Geometry g32;
  g32.ntiles = g.ntiles;
  int grid = 0;
  cudaError_t err = persistent_grid(g32, BLOCKS_PER_SM16, grid);
  if (err == cudaSuccess) err = vqa::allow_smem(stem_kernel_bf16, SMEM16_BYTES);
  if (err != cudaSuccess) return err;
  stem_kernel_bf16<<<grid, THREADS, SMEM16_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w), scale,
      bias, static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}
