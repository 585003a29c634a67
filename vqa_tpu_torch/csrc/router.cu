// The router of an MoE layer and its route plan, bf16 activations
// (vqa_tpu_torch/models/moe.py, ops/moe_kernel.py):
//
//   moe_route_bf16  logits in f32 from an f32 weight, sigmoid, the biased
//                   top-k and the normalised, scaled weights of each token
//   moe_plan        the (token, choice) pairs grouped by held expert, in a
//                   stable order: each sorted row's token, each held
//                   expert's end row and count, each pair's row
//
// They replace no TPU kernel: the JAX package has no mixture of experts.
// They replace, on the card, an f32 copy of the layer's input, cuBLAS's
// f32 GEMM, sigmoid, bias, torch.topk, gather and normalisation (the gate),
// and a stable radix sort with searchsorted, scatter, where, casts and
// diff (the plan): 11.7 ms of kernels in 1,326 launches a bucket-256
// forward of Kimi-VL-A3B's 26 MoE layers on an H100.
//
// moe_route_bf16. What bounds it: at T = 17,664 tokens, D = 2,048 and
// N = 64 experts a layer reads x once (72.4 MB, 21.6 us at 3.35 TB/s) and
// writes a few hundred KB. The logits stay f32 from the f32 weight, as
// DeepSeek-V3 computes them: x is bf16, so every product x * w is exact once
// w is split into three bf16 planes that sum to it exactly, hi + (mid +
// lo) * 2^-12 (ops/moe_kernel.py:weight_planes; the lower two are scaled so
// their bits stay clear of bf16's subnormals and of its overflow for
// weights from 2^-122 to 2^123). Three bf16 products with f32 accumulation
// give the f32 GEMM's products in another summation order: hi's products a
// stage (64 columns) at a time, each stage's sum added to the running sum
// in f32 (the tensor cores truncate their own f32 sums: left to them over
// all of D, the logits strayed 1.5e-5 from cuBLAS's), mid's and lo's into
// a second sum, scaled back by 2^-12 and added at the end.
// - A block per 64 * groups tokens, groups chosen so the grid is about one
//   block per SM: each block reads every plane from L2 once, and with a
//   block per 64 tokens those reads took two thirds of the time. A
//   warpgroup computes 64 tokens by 64 experts with wgmma (m64n64k16, x
//   from registers by ldmatrix, the planes from shared memory); one more
//   warp loads.
// - The loading warp fills a ring of up to four stages: each stage's planes
//   in one bulk copy (route_tiles stores them stage by stage, already in
//   the layout the descriptors read), the x rows by 16-byte cp.async (rows
//   past T as zeros), both counted on the stage's full barrier; each
//   compute warp arrives on its empty barrier once its wgmma are done: no
//   block-wide barrier in the loop, and x's rows are read from HBM in
//   128-byte runs.
// - The logits go through shared memory to one thread per token: sigmoid
//   (1 / (1 + expf(-z)), full precision, as torch's), the bias added, the
//   top k kept in order by insertion (ties to the lower expert), then the
//   unbiased scores of the choices summed in order, + 1e-20, each divided
//   by the sum and times the scaling. Nothing is rounded below f32 (a warp
//   a token, or two threads, measured slower: PERF.md).
//
// moe_plan. The pairs' keys are their held expert's local index, held
// for an expert held elsewhere; the plan is the stable sort of the keys in
// (token, choice) order, as torch.sort(stable=True) gives it. One cluster
// of 16 blocks of 32 warps, each warp a contiguous run of pairs: a warp
// ranks its pairs among equal keys 32 at a time (match.any), the block
// turns its warps' counts into offsets, the cluster exchanges the blocks'
// counts through distributed shared memory, and each pair's row is its
// key's start, plus the counts of its key before its block and warp, plus
// its rank. No pass over the grid waits on another launch, no atomics: the
// rows are the same on every run.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// ---- moe_route_bf16 ------------------------------------------------------

constexpr int BK = 64;          // columns of x and of the planes a stage: four k-steps
constexpr int SX = BK + 8;      // a staged x row's stride, elements (144 B)
constexpr int MAX_STAGES = 4;
constexpr int TILE_M = 64;      // tokens a warpgroup: one wgmma's rows
constexpr int CHUNK = 64;       // experts a warpgroup: one wgmma's columns
constexpr int MAX_K = 8;
constexpr int MAX_EXPERTS = 256;
constexpr float LOW_SCALE = 1.0f / 4096.0f;  // the lower planes' 2^-12
constexpr size_t SMEM_LIMIT = 227 * 1024;
constexpr int BARRIERS = 128;  // bytes before the ring: the stages' full and empty barriers
static_assert(2 * MAX_STAGES * sizeof(uint64_t) <= BARRIERS, "the barriers fit");

struct RouteParams {
  const bf16* x;      // [T, D]
  const bf16* tiles;  // the planes by stage (ops/moe_kernel.py:route_tiles)
  const float* bias;  // [N]
  int* idx;           // [T, k]
  float* w;           // [T, k]
  float* logits;      // [T, N], or null: the logits too (a test's view)
  int T, D, N, k;
  int chunks, groups, stages;  // 64-expert chunks, 64-token groups a block; the ring
  float scaling;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(vqa::smem_addr(p)));
}

// 16 bytes from global `src` to shared `dst` (zeros where `bytes` is 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(vqa::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void arrive_when_copied(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(vqa::smem_addr(bar))
               : "memory");
}

// `bytes` from global `src` to shared `dst`, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(vqa::smem_addr(dst)), "l"(src), "r"(bytes), "r"(vqa::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(vqa::smem_addr(bar)) : "memory");
}

// Shared-memory descriptor of one k-step's 64 rows of a plane: K-major, no
// swizzle; a core matrix is 8 rows of 16 bytes (8 bf16 along k), its two
// along k LBO = 128 bytes apart, its 8-row groups SBO = 256 bytes apart.
__device__ __forceinline__ uint64_t plane_desc(const void* tile) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return ((addr >> 4) & 0x3fff) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

// d[64 x 64] (+)= a[64 x 16] * b[16 x 64], bf16 in, f32 accumulators; a
// from registers (each warp its 16 rows, mma.m16n8k16 A-fragment order), b
// from shared memory; `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "
      "%36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// A stage: the block's x rows [groups * TILE_M][SX], then every plane's
// columns of the stage as route_tiles lays them out, the descriptors'
// layout: [plane][k-step][8-row group][k half][8 rows][8].
__host__ __device__ __forceinline__ int x_elems(int groups) { return groups * TILE_M * SX; }
__host__ __device__ __forceinline__ int w_elems(int chunks) {
  return 3 * BK * chunks * CHUNK;
}
__host__ __device__ __forceinline__ size_t stage_bytes(int chunks, int groups) {
  return (static_cast<size_t>(x_elems(groups)) + w_elems(chunks)) * sizeof(bf16);
}

// The producer warp: tile n into stage n % S once the consumers are done
// with tile n - S there; the planes' stage in one bulk copy by lane 0, the
// x rows by 16-byte cp.async (rows past T as zeros), all counted on full.
__device__ __forceinline__ void produce(const RouteParams& p, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty, int row0, int lane) {
  const int S = p.stages, rows = p.groups * TILE_M, kts = p.D / BK;
  const uint32_t wbytes = w_elems(p.chunks) * sizeof(bf16);
  for (int n = 0; n < kts; ++n) {
    const int s = n % S;
    if (n >= S) vqa::mbar_wait(empty + s, (n / S - 1) & 1);
    bf16* stage = reinterpret_cast<bf16*>(smem + s * stage_bytes(p.chunks, p.groups));
    if (lane == 0) {
      vqa::mbar_expect_tx(full + s, wbytes);
      bulk_copy(stage + x_elems(p.groups), p.tiles + static_cast<int64_t>(n) * w_elems(p.chunks),
                wbytes, full + s);
    }
    for (int c = lane; c < rows * (BK / 8); c += 32) {
      const int r = c / (BK / 8), q = c % (BK / 8);
      const int t = row0 + r;
      cp_async16(stage + r * SX + q * 8,
                 p.x + static_cast<int64_t>(min(t, p.T - 1)) * p.D + n * BK + q * 8,
                 t < p.T ? 16 : 0);
    }
    arrive_when_copied(full + s);
  }
}

// Warpgroups of 4 warps compute, each 64 tokens by 64 experts; one more
// warp loads (`produce`). WARPGROUPS: the most a block has.
template <int WARPGROUPS>
__global__ void __launch_bounds__(128 * WARPGROUPS + 32, 1) moe_route_bf16(const RouteParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);  // a stage's x and planes landed
  uint64_t* empty = full + MAX_STAGES;  // every compute warp is done with a stage
  unsigned char* smem = smem_raw + BARRIERS;
  const int N = p.N, S = p.stages;
  const int bm = p.groups * TILE_M;
  const int row0 = blockIdx.x * bm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int computing = 4 * p.groups * p.chunks;  // compute warps; the producer is the last
  if (threadIdx.x == 0)
    for (int s = 0; s < S; ++s) {
      vqa::mbar_init(full + s, 1 + 32);   // lane 0's bytes, every producer lane's copies
      vqa::mbar_init(empty + s, computing);
    }
  __syncthreads();

  // 1. the products over a ring of S stages
  float sum[32], lo[32];
  if (warp == computing) {
    produce(p, smem, full, empty, row0, lane);
  } else {
    // this warpgroup's experts and tokens, its warp's 16 rows of them
    const int chunk = warp / 4 % p.chunks, group = warp / 4 / p.chunks, wq = warp % 4;
    const int wrow = TILE_M * group + 16 * wq;
    // hi's sum in f32 adds of one stage's products at a time (the tensor
    // cores truncate their own f32 sums: a stage's 64 products only), one
    // stage's hi products, mid's and lo's sum
    float hi[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sum[e] = hi[e] = lo[e] = 0.f;
    for (int kt = 0; kt < p.D / BK; ++kt) {
      const int s = kt % S;
      vqa::mbar_wait(full + s, (kt / S) & 1);
      const bf16* sx = reinterpret_cast<const bf16*>(smem + s * stage_bytes(p.chunks, p.groups));
      const bf16* sw = sx + x_elems(p.groups);
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        ldsm_x4(a[ks], sx + (wrow + lane % 16) * SX + 16 * ks + (lane / 16) * 8);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
        for (int plane = 0; plane < 3; ++plane) {
          const uint64_t d = plane_desc(
              sw + ((plane * (BK / 16) + ks) * (p.chunks * CHUNK / 8) + chunk * 8) * 128);
          if (plane == 0)
            wgmma_bf16(hi, a[ks], d, ks);
          else
            wgmma_bf16(lo, a[ks], d, 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (lane == 0) arrive(empty + s);
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[e] += hi[e];
    }
  }
  __syncthreads();  // the ring is free: the logits take its place

  // 2. the logits, f32, to shared memory [bm, N + 1] (an odd row stride: a
  //    warp's 32 tokens read one expert's column in 32 banks), then the bias
  float* logits = reinterpret_cast<float*>(smem);
  const int ls = N + 1;
  if (warp < computing) {
    const int chunk = warp / 4 % p.chunks, group = warp / 4 / p.chunks, wq = warp % 4;
    const int wrow = TILE_M * group + 16 * wq;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wrow + g + 8 * (e / 2), c = chunk * CHUNK + 8 * j + 2 * t + e % 2;
        if (c < N) logits[r * ls + c] = sum[4 * j + e] + lo[4 * j + e] * LOW_SCALE;
      }
  }
  float* bias = logits + bm * ls;
  for (int e = threadIdx.x; e < N; e += blockDim.x) bias[e] = __ldg(p.bias + e);
  __syncthreads();
  if (p.logits != nullptr)
    for (int i = threadIdx.x; i < bm * N; i += blockDim.x) {
      const int r = i / N, c = i - r * N;
      if (row0 + r < p.T) p.logits[static_cast<int64_t>(row0 + r) * N + c] = logits[r * ls + c];
    }

  // 3. one thread per token: the biased scores kept in descending order in
  //    MAX_K slots by insertion, in expert order (a later equal score goes
  //    after: ties to the lower expert)
  const int r = threadIdx.x;
  if (r >= bm || row0 + r >= p.T) return;
  const float* z = logits + r * ls;
  float best[MAX_K];
  int chosen[MAX_K];
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    best[j] = -INFINITY;
    chosen[j] = 0x7fffffff;
  }
  for (int e = 0; e < N; ++e) {
    float v = 1.0f / (1.0f + expf(-z[e])) + bias[e];
    int at = e;
#pragma unroll
    for (int j = 0; j < MAX_K; ++j)
      if (v > best[j]) {
        const float bv = best[j];
        const int ba = chosen[j];
        best[j] = v;
        chosen[j] = at;
        v = bv;
        at = ba;
      }
  }
  float score[MAX_K], total = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j) {
    score[j] = j < p.k && chosen[j] < N ? 1.0f / (1.0f + expf(-z[chosen[j]])) : 0.f;
    total += score[j];
  }
  const float denom = total + 1e-20f;
  const int64_t at = static_cast<int64_t>(row0 + r) * p.k;
#pragma unroll
  for (int j = 0; j < MAX_K; ++j)
    if (j < p.k) {
      p.idx[at + j] = chosen[j];
      p.w[at + j] = score[j] / denom * p.scaling;
    }
}

// ---- moe_plan ------------------------------------------------------------

constexpr int PLAN_CLUSTER = 16;  // above 8: a non-portable cluster size, which the H100 has
constexpr int PLAN_WARPS = 32;
static_assert(PLAN_WARPS == 32 && PLAN_CLUSTER <= 32, "a warp's lanes span the warps and blocks");
constexpr int BATCH = 8;  // rounds of 32 pairs a warp loads before it ranks or stores
constexpr int MAX_KEYS = MAX_EXPERTS + 1;  // the held experts, then "held elsewhere"

__device__ __forceinline__ int key_of(int expert, int offset, int held) {
  const int local = expert - offset;
  return local >= 0 && local < held ? local : held;
}

__global__ void __launch_bounds__(32 * PLAN_WARPS)
    moe_plan(const int* __restrict__ idx, int pairs, int k, int offset, int held,
             int* __restrict__ src, int* __restrict__ ends, int* __restrict__ slot,
             int* __restrict__ counts) {
  __shared__ int warp_base[PLAN_WARPS][MAX_KEYS];  // counts, then offsets in the block
  __shared__ int block_total[MAX_KEYS];            // read by the cluster's blocks
  __shared__ int grand[MAX_KEYS];
  __shared__ int key_base[MAX_KEYS];  // this block's first row of each key
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int keys = held + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int runs = PLAN_CLUSTER * PLAN_WARPS;
  const int per_run = (pairs + runs - 1) / runs;
  const int first = (rank * PLAN_WARPS + warp) * per_run;
  const int last = min(pairs, first + per_run);
  int* mine = warp_base[warp];

  // 1. each warp ranks its pairs among equal keys, 32 at a time, with
  //    BATCH rounds' keys loaded before any is ranked; the rank waits in
  //    `slot`, which only this lane reads back
  for (int c = lane; c < keys; c += 32) mine[c] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  for (int base = first; base < last; base += 32 * BATCH) {
    int key[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int q = base + 32 * u + lane;
      key[u] = q < last ? key_of(__ldg(idx + q), offset, held) : -1;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int q = base + 32 * u + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      const int before = __popc(peers & below);
      const int r = key[u] >= 0 ? mine[key[u]] + before : 0;
      __syncwarp();
      if (key[u] >= 0 && before == 0) mine[key[u]] += __popc(peers);
      __syncwarp();
      if (key[u] >= 0) slot[q] = r;
    }
  }
  __syncthreads();

  // 2. the warps' counts to offsets in the block, and the block's totals:
  //    a warp a key, lane w holding warp w's count
  for (int c = warp; c < keys; c += PLAN_WARPS) {
    const int v = warp_base[lane][c];
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    warp_base[lane][c] = incl - v;
    if (lane == 31) block_total[c] = incl;
  }
  cluster.sync();  // every block's totals are written

  // 3. each key's count over the cluster, and over the blocks before this
  //    one: a warp a key, lane b reading block b's total
  for (int c = warp; c < keys; c += PLAN_WARPS) {
    const int v = lane < PLAN_CLUSTER ? *cluster.map_shared_rank(block_total + c, lane) : 0;
    int all = v, before = lane < rank ? v : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      all += __shfl_xor_sync(0xffffffffu, all, off);
      before += __shfl_xor_sync(0xffffffffu, before, off);
    }
    if (lane == 0) {
      grand[c] = all;
      key_base[c] = before;
    }
  }
  cluster.sync();  // no block leaves while a peer reads its totals

  // 4. each key's first row: the counts of the keys before it, by one warp
  if (warp == 0) {
    const int span = (keys + 31) / 32;
    const int c0 = min(keys, lane * span), c1 = min(keys, c0 + span);
    int sum = 0;
    for (int c = c0; c < c1; ++c) sum += grand[c];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int start = incl - sum;
    for (int c = c0; c < c1; ++c) {
      key_base[c] += start;
      if (rank == 0 && c < held) {
        ends[c] = start + grand[c];
        counts[c] = grand[c];
      }
      start += grand[c];
    }
  }
  __syncthreads();

  // 5. each pair's row, BATCH rounds' loads before any store
  for (int base = first; base < last; base += 32 * BATCH) {
    int key[BATCH], rank_in_warp[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int q = base + 32 * u + lane;
      key[u] = q < last ? key_of(__ldg(idx + q), offset, held) : -1;
      rank_in_warp[u] = q < last ? slot[q] : 0;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int q = base + 32 * u + lane;
      if (key[u] >= 0) {
        const int row = key_base[key[u]] + mine[key[u]] + rank_in_warp[u];
        src[row] = q / k;
        slot[q] = key[u] < held ? row : -1;
      }
    }
  }
}

}  // namespace

// x [T, D] bf16, tiles (route_tiles' planes) bf16, bias [N] f32 → idx
// [T, k] int32, w [T, k] f32, and the logits [T, N] f32 where `logits` is
// not null. D a multiple of 64, N a multiple of 16 from 16 to 256, 1 <= k
// <= min(8, N); x and tiles 16-byte aligned; `sms` the device's SMs.
// Anything else: cudaErrorInvalidValue, nothing launched (ops/moe_kernel.py
// checks the same first).
VQA_EXPORT int vqa_moe_route_bf16(const void* x, const void* tiles, const void* bias,
                                  void* idx, void* w, void* logits, int T, int D, int N, int k,
                                  float scaling, int sms, cudaStream_t stream) {
  if (T < 1 || D < BK || D % BK || N < 16 || N > MAX_EXPERTS || N % 16 || k < 1 ||
      k > MAX_K || k > N || sms < 1)
    return cudaErrorInvalidValue;
  const int chunks = (N + CHUNK - 1) / CHUNK;
  // about one block per SM: each block reads the planes from L2 once
  const int most = chunks <= 3 ? 3 : 4;  // warpgroups a block
  const int groups = max(1, min(most / chunks, (T + TILE_M * sms - 1) / (TILE_M * sms)));
  const int bm = groups * TILE_M;
  const size_t stage = stage_bytes(chunks, groups);
  const size_t fit = (SMEM_LIMIT - BARRIERS) / stage;
  const int stages = fit < MAX_STAGES ? static_cast<int>(fit) : MAX_STAGES;
  const size_t table = (static_cast<size_t>(bm) * (N + 1) + N) * sizeof(float);
  const size_t ring = stages * stage;
  const size_t smem = BARRIERS + (ring > table ? ring : table);
  if (stages < 2 || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const RouteParams p{static_cast<const bf16*>(x), static_cast<const bf16*>(tiles),
                      static_cast<const float*>(bias), static_cast<int*>(idx),
                      static_cast<float*>(w), static_cast<float*>(logits), T, D, N, k, chunks,
                      groups, stages, scaling};
  const int blocks = (T + bm - 1) / bm, threads = 128 * chunks * groups + 32;
  cudaError_t err;
  if (most == 3) {
    err = vqa::allow_smem(moe_route_bf16<3>, smem);
    if (err == cudaSuccess) moe_route_bf16<3><<<blocks, threads, smem, stream>>>(p);
  } else {
    err = vqa::allow_smem(moe_route_bf16<4>, smem);
    if (err == cudaSuccess) moe_route_bf16<4><<<blocks, threads, smem, stream>>>(p);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// idx [tokens, k] int32 (expert ids) → src [tokens * k], ends [held],
// slot [tokens, k] and counts [held], int32: the pairs of held expert
// offset + e in the e-th group, the others last, each group in (token,
// choice) order. 1 <= held <= 256, offset >= 0.
VQA_EXPORT int vqa_moe_plan(const void* idx, int tokens, int k, int offset, int held, void* src,
                            void* ends, void* slot, void* counts, cudaStream_t stream) {
  if (tokens < 1 || k < 1 || held < 1 || held > MAX_EXPERTS || offset < 0 ||
      static_cast<long long>(tokens) * k > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(moe_plan, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(PLAN_CLUSTER);
  cfg.blockDim = dim3(32 * PLAN_WARPS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PLAN_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, moe_plan, static_cast<const int*>(idx), tokens * k, k, offset,
                           held, static_cast<int*>(src), static_cast<int*>(ends),
                           static_cast<int*>(slot), static_cast<int*>(counts));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
