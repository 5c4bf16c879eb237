// Fused score + top-k for the ALS serving path, hand-written for Hopper
// (sm_90a). Built by oryx_tpu_torch/ops/_build.py with nvcc into a shared
// library with a plain C interface; oryx_tpu_torch/ops/topk.py loads it with
// ctypes and launches on PyTorch's current stream.
//
// Replaces oryx_tpu/ops/pallas_topk.py:_topk_kernel (both the float and the
// quantized=True variants) and, inside it, the bitonic selection network
// (_cmp_exchange, _bitonic_merge_desc, _merge_top, _block_topk). What is
// ported is what that kernel computes -- per query row, the exact top-k of
// xs @ y.T in (value desc, index asc) order without materializing the [B, I]
// score matrix -- not its block structure. The TPU grid walks item blocks in
// order and carries one running top-128 in VMEM; Hopper blocks run in
// parallel, so the work splits in two kernels:
//
// topk_dot_partial<T> (grid: query-row blocks x item splits)
//   As many item splits as give one wave of resident blocks on every SM
//   (ops/topk.py launch_plan). The row blocks that share an item split are
//   neighbours in launch order, so they run side by side and a Y tile comes
//   from device memory about once and from L2 for the rest. Each block walks
//   its contiguous item range in ascending tiles and scores every
//   (row, item) pair.
//   - bf16 and int8 (the serving views): one warpgroup of 128 threads owns
//     64 query rows. Item rows sit in device memory at a pitch that is a
//     multiple of 16 bytes (ops/transfer.py), so a 2D TMA tensor map tiles
//     the catalog: boxes of [128 bytes of features, 64 items] (one chunk),
//     128-byte swizzled, features past F and items past n filled with zeros
//     by the hardware. A tile of 64 items is ceil(F x itemsize / 128) such
//     chunks, and they stream through a ring of 2 to 8 stages of one chunk
//     each, so the ring's size does not grow with F. Each stage has a full
//     mbarrier, completed by the TMA's transaction bytes, and an empty one,
//     on which every warp arrives once the wgmma group that read the stage
//     has retired; thread 0 then loads the chunk `stages` ahead into it.
//     The queries are staged once per block in the same swizzled K-major
//     layout (zeros past F and past B), all chunks of them, and are wgmma's
//     operand A; the item chunk is operand B. The dot is wgmma.mma_async
//     m64n64k16 bf16 -> f32 or m64n64k32 s8 -> s32, 32 bytes of features per
//     step, 4 steps (or 1 or 2 for F x itemsize <= 64 bytes) committed per
//     chunk. A tile's chunks are released after its dot and refilled after
//     its selection, but where a row has more chunks than the ring has
//     stages, the first ones are retired and refilled while the next chunk
//     is multiplied. A row of one chunk, the serving width, is an
//     instantiation of its own with none of that loop. No thread reads Y
//     from device memory. The int32 sums are exact,
//     converted to f32 and multiplied by the item scale before selection,
//     so int8 scores are bit-identical to the plain version's.
//     Widths: the query block (64 rows x F x itemsize, in whole chunks), a
//     ring of 2 stages and the rows' lists must fit a block's 227 KB, which
//     at kb=128 holds F <= 1,024 in bf16 and F <= 2,048 in int8
//     (oryx_topk_max_features; the serving model checks it when built).
//     wgmma's accumulator layout gives warp w all 64 items of rows
//     16w..16w+15, so each warp selects for its own 16 rows with no block
//     barrier. A row keeps its sorted top-kb list and a tail of up to 24
//     unsorted candidates in shared memory. A score is a candidate if it
//     beats the row's threshold, the kb-th entry of its list; candidates
//     are appended to the tail, and a full tail is flushed: sorted by a
//     warp bitonic network and merged into the list by rank, after which
//     the list's kb-th entry is the new threshold. Between flushes the
//     threshold lags the true kb-th value, so the tail holds a superset of
//     what can enter; since tiles are visited in ascending index order, a
//     strict '>' against it loses nothing under (value desc, index asc).
//     (A tile whose candidates overflow a tail flushes it mid-tile; the list
//     then holds items of that tile, so its remaining entries equal to the
//     new threshold stay candidates, and the merge's total order decides.)
//   - f32: on the CUDA cores (full f32 FMA, no TF32), 32 rows per block,
//     each thread scoring one item against 16 rows from a transposed query
//     block, with each Y tile staged in shared memory (rows read at the
//     view's pitch). A score enters a row's candidate buffer if it beats the
//     row's current kb-th entry, and one warp per row then inserts the
//     candidates into the row's sorted top-kb list.
//   Both write one sorted partial [S, B, kb] (values f32, indices int32;
//   unfilled slots hold (-inf, -1)).
//
// topk_merge (grid: one block per query row)
//   Merges the S sorted partial lists of a row into the final top-k under
//   the same total order: teams of kb threads fold lists pairwise with a
//   rank-based merge (each element's output slot is its index plus a binary
//   search in the other list). The counterpart of _merge_top; the sharded
//   merge reuses it.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 tensor, 1,979 TOP/s int8
// tensor, ~67 TFLOP/s f32 CUDA cores, 3.35 TB/s HBM): at B=512, I=1M, F=50
// the bf16 catalog is 112 MB pitched (about 33 us to read) and the dot is
// 51 GFLOP (about 52 us on the tensor cores); int8 halves both. With TMA and
// wgmma the loads and the products cost the threads few issue slots; the
// kernel is bound by latency in the selection (PERF.md has the ablation of
// ops/topk_probe.py): the tail flushes, the appends, and the wgmma, which
// makes the block's four warps meet once per tile, so one warp's flush holds
// up the other three.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;       // f32 partial and merge kernels
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;  // f32: query rows staged per block
constexpr int kTileItems = 128;    // f32: items scored per tile
constexpr int kMaxKb = 128;
constexpr int kMergeSlots = 256;   // teams * kb in topk_merge

// f32 kernel: each thread scores one item against 16 rows
constexpr int kRowsPerThread = kRowsPerBlock * kTileItems / kThreads;  // 16
constexpr int kChunkWords = 64;    // feature words staged per Y tile pass
static_assert(kRowsPerThread == 16, "the inner loop reads 4 x float4 of queries");

// tensor-core kernel: one warpgroup, 64 rows (wgmma M) per block, tiles of
// 64 items (wgmma N), features in chunks of 128 bytes (one swizzle span)
constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;
constexpr int kMmaTile = 64;
constexpr int kChunkBytes = 128;
constexpr int kStepBytes = 32;     // features per wgmma: 16 bf16 or 32 int8
constexpr int kChunkSteps = kChunkBytes / kStepBytes;     // 4
constexpr int kMaxStages = 8;      // ring stages, one item chunk each
constexpr int kTileChunkBytes = kMmaTile * kChunkBytes;   // 8 KB: a stage
constexpr int kQueryChunkBytes = kMmaRows * kChunkBytes;  // 8 KB
constexpr int kSwizzleAlign = 1024;  // a 128-byte swizzle atom: 8 rows
constexpr int kTail = 24;          // unsorted candidates a row holds

// Phase switches for the ablation in ops/topk_probe.py; a served build sets
// none. Each, defined to 1, compiles one phase out: the tensor-core kernel's
// products (wgmma; its TMA loads still stream), its selection of a tile's
// scores (the compares), the insertion of candidates (the tensor-core
// kernel's appends and flushes, which drops the candidates it finds; the
// f32 kernel's sorted insert).
#ifndef ORYX_PROBE_NO_DOT
#define ORYX_PROBE_NO_DOT 0
#endif
#ifndef ORYX_PROBE_NO_SELECT
#define ORYX_PROBE_NO_SELECT 0
#endif
#ifndef ORYX_PROBE_NO_INSERT
#define ORYX_PROBE_NO_INSERT 0
#endif

// strict total order of the TPU kernel's _cmp_exchange: value desc, index asc
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// ---------------------------------------------------------------------------
// selection state of the f32 partial kernel
// ---------------------------------------------------------------------------

// Per block: a candidate buffer per row for the current tile, each row's
// sorted top-kb, and each row's candidate count.
struct Lists {
  float* cand_v;  // [32][128]
  int* cand_i;
  float* lv;      // [32][kb]
  int* li;
  int* cnt;       // [32]
};

size_t lists_bytes(int kb) {
  return 4 * (2 * static_cast<size_t>(kRowsPerBlock) * kTileItems +
              2 * static_cast<size_t>(kRowsPerBlock) * kb + kRowsPerBlock);
}

__device__ Lists carve_lists(void* at, int kb) {
  Lists L;
  L.cand_v = static_cast<float*>(at);
  L.cand_i = reinterpret_cast<int*>(L.cand_v + kRowsPerBlock * kTileItems);
  L.lv = reinterpret_cast<float*>(L.cand_i + kRowsPerBlock * kTileItems);
  L.li = reinterpret_cast<int*>(L.lv + kRowsPerBlock * kb);
  L.cnt = L.li + kRowsPerBlock * kb;
  return L;
}

__device__ void init_lists(const Lists& L, int kb, int tid) {
  for (int e = tid; e < kRowsPerBlock * kb; e += kThreads) {
    L.lv[e] = -INFINITY;
    L.li[e] = -1;
  }
  if (tid < kRowsPerBlock) L.cnt[tid] = 0;
}

// A score of this tile enters the row's candidates if it beats the row's
// kb-th entry as it stood before the tile (every index in the tile is larger
// than any in the list, so '>' is exact under (value desc, index asc)).
__device__ __forceinline__ void push(const Lists& L, int row, float s,
                                     int item) {
  const int slot = atomicAdd(&L.cnt[row], 1);
  L.cand_v[row * kTileItems + slot] = s;
  L.cand_i[row * kTileItems + slot] = item;
}

__device__ __forceinline__ void offer(const Lists& L, int kb, int row,
                                      float s, int item) {
  if (s > L.lv[row * kb + kb - 1]) push(L, row, s, item);
}

// Insert each row's candidates into its sorted top-kb, one warp per row.
__device__ void insert_candidates(const Lists& L, int kb, int warp,
                                  int lane) {
  for (int row = warp; row < kRowsPerBlock; row += kWarps) {
    const int n = ORYX_PROBE_NO_INSERT ? 0 : L.cnt[row];
    float* v = L.lv + row * kb;
    int* ix = L.li + row * kb;
    for (int c = 0; c < n; ++c) {
      const float cv = L.cand_v[row * kTileItems + c];
      const int ci = L.cand_i[row * kTileItems + c];
      if (!better(cv, ci, v[kb - 1], ix[kb - 1])) continue;  // warp-uniform
      int pos = 0;
      for (int m = 0; m < kb; m += 32) {
        const int j = m + lane;
        const bool b = j < kb && better(v[j], ix[j], cv, ci);
        pos += __popc(__ballot_sync(0xffffffffu, b));
      }
      float nv[kMaxKb / 32];
      int ni[kMaxKb / 32];
#pragma unroll
      for (int q = 0; q < kMaxKb / 32; ++q) {
        const int j = q * 32 + lane;
        nv[q] = 0.0f;
        ni[q] = 0;
        if (j < kb) {
          if (j > pos) {
            nv[q] = v[j - 1];
            ni[q] = ix[j - 1];
          } else if (j == pos) {
            nv[q] = cv;
            ni[q] = ci;
          } else {
            nv[q] = v[j];
            ni[q] = ix[j];
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kMaxKb / 32; ++q) {
        const int j = q * 32 + lane;
        if (j < kb) {
          v[j] = nv[q];
          ix[j] = ni[q];
        }
      }
      __syncwarp();
    }
    __syncwarp();
    if (lane == 0) L.cnt[row] = 0;
  }
}

__device__ void write_partials(const Lists& L, float* part_v, int* part_i,
                               int B, int row0, int split, int kb, int tid) {
  for (int e = tid; e < kRowsPerBlock * kb; e += kThreads) {
    const int row = e / kb;
    const int j = e % kb;
    const int grow = row0 + row;
    if (grow < B) {
      const size_t o = (static_cast<size_t>(split) * B + grow) * kb + j;
      part_v[o] = L.lv[e];
      part_i[o] = L.li[e];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 partial kernel (CUDA cores)
// ---------------------------------------------------------------------------

size_t fma_smem_bytes(int F, int kb) {
  const int cw_max = F < kChunkWords ? F : kChunkWords;
  const int stride = cw_max | 1;
  return 4 * (static_cast<size_t>(F) * kRowsPerBlock +
              static_cast<size_t>(kTileItems) * stride) +
         lists_bytes(kb);
}

__global__ void __launch_bounds__(kThreads)
topk_dot_partial_f32_kernel(const float* __restrict__ xs,
                            const float* __restrict__ y,
                            float* __restrict__ part_v,
                            int* __restrict__ part_i, int B, int n_items,
                            int F, int pitch, int kb, int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cw_max = F < kChunkWords ? F : kChunkWords;
  const int stride = cw_max | 1;  // odd: item rows hit distinct banks

  float* qs = reinterpret_cast<float*>(smem);                  // [F][32]
  float* ys = qs + static_cast<size_t>(F) * kRowsPerBlock;      // [128][stride]
  const Lists L = carve_lists(ys + kTileItems * stride, kb);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int split = blockIdx.y;
  const long long start = static_cast<long long>(split) * split_len;
  const long long stop_ll = start + split_len;
  const long long end = stop_ll < n_items ? stop_ll : n_items;

  // stage the query block, transposed: qs[f * 32 + r]
  for (int e = tid; e < F * kRowsPerBlock; e += kThreads) {
    const int f = e / kRowsPerBlock;
    const int grow = row0 + e % kRowsPerBlock;
    qs[e] = grow < B ? xs[static_cast<size_t>(grow) * F + f] : 0.0f;
  }
  init_lists(L, kb, tid);
  __syncthreads();

  const int it = tid % kTileItems;     // this thread's item within a tile
  const int half = tid / kTileItems;   // which 16 of the 32 rows
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (long long base = start; base < end; base += kTileItems) {
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

    for (int c0 = 0; c0 < F; c0 += kChunkWords) {
      const int cw = (F - c0) < kChunkWords ? (F - c0) : kChunkWords;
      // stage Y[base:base+128, c0:c0+cw]. Element e = tid + 256 j is
      // feature e % cw of item e / cw; both advance by fixed steps as j
      // grows, so the loop carries them instead of dividing per element
      const int step_items = kThreads / cw;
      const int step_words = kThreads % cw;
      int ti = tid / cw;
      int tw = tid % cw;
      for (int e = tid; e < kTileItems * cw; e += kThreads) {
        const long long item = base + ti;
        ys[ti * stride + tw] =
            item < end ? y[static_cast<size_t>(item) * pitch + c0 + tw] : 0.0f;
        ti += step_items;
        tw += step_words;
        if (tw >= cw) {
          tw -= cw;
          ++ti;
        }
      }
      __syncthreads();
      const float* yrow = ys + it * stride;
      const float* qbase = qs + static_cast<size_t>(c0) * kRowsPerBlock +
                           half * kRowsPerThread;
#pragma unroll 2
      for (int w = 0; w < cw; ++w) {
        const float yv = yrow[w];
        const float4* q4 =
            reinterpret_cast<const float4*>(qbase + w * kRowsPerBlock);
#pragma unroll
        for (int v = 0; v < kRowsPerThread / 4; ++v) {
          const float4 q = q4[v];
          acc[4 * v + 0] = fmaf(yv, q.x, acc[4 * v + 0]);
          acc[4 * v + 1] = fmaf(yv, q.y, acc[4 * v + 1]);
          acc[4 * v + 2] = fmaf(yv, q.z, acc[4 * v + 2]);
          acc[4 * v + 3] = fmaf(yv, q.w, acc[4 * v + 3]);
        }
      }
      __syncthreads();
    }

    const long long item = base + it;
    if (item < end) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int row = half * kRowsPerThread + r;
        if (row0 + row < B) offer(L, kb, row, acc[r], static_cast<int>(item));
      }
    }
    __syncthreads();
    insert_candidates(L, kb, warp, lane);
    __syncthreads();
  }
  write_partials(L, part_v, part_i, B, row0, split, kb, tid);
}

// ---------------------------------------------------------------------------
// bf16 / int8 partial kernel (TMA + wgmma)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Block until the phase of parity `parity` of the barrier has completed. A
// wait that outlasts any load by orders of magnitude (a lost transaction)
// traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t tries = 0;
  do {
    if (++tries > (1u << 26)) asm volatile("trap;");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// TMA: the box of `map` at (feature c0, item c1) into shared memory at dst;
// its bytes complete transactions on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzled layout TMA writes: rows of 128 bytes, 8-row atoms 1024 bytes
// apart (stride byte offset), start address in 16-byte units. A step of 32
// bytes along K advances the start address inside the atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |                       // LBO (unused)
         (static_cast<uint64_t>(kSwizzleAlign >> 4) << 32) |      // SBO
         (static_cast<uint64_t>(1) << 62);                        // 128B swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define ORYX_ACC8(C, d, i)                                              \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]),          \
      C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define ORYX_ACC32(C, d) \
  ORYX_ACC8(C, d, 0), ORYX_ACC8(C, d, 8), ORYX_ACC8(C, d, 16), ORYX_ACC8(C, d, 24)
#define ORYX_ACC_REGS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"

// d[64 rows x 64 items] (+)= A[64 x 32 bytes] . B[64 x 32 bytes]^T, both
// K-major in shared memory; accumulate=0 overwrites d.
__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ORYX_ACC_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ORYX_ACC32("+f", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_step(int (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " ORYX_ACC_REGS
      ", %32, %33, p;\n"
      "}\n"
      : ORYX_ACC32("+r", d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Shared memory of the tensor-core kernel: 1024 bytes of alignment slack,
// the query block (chunks x 64 rows x 128 bytes), a ring of `stages` item
// chunks (64 items x 128 bytes each), a full and an empty mbarrier per
// stage, and the 64 rows' lists and tails. The ring takes 2 to 8 stages: as
// many as keep the most blocks resident on an SM by shared memory.
constexpr size_t kMaxSmem = 232448;       // a block's limit
constexpr size_t kSmPerSm = 233472;       // an SM's shared memory
constexpr size_t kBlockReserved = 1024;   // the runtime's share per block

struct MmaPlan {
  int chunks;  // 128-byte feature chunks of a row (F x itemsize rounded up)
  int steps;   // wgmma steps per chunk: 4, or 1 or 2 for a row of <= 64 bytes
  int stages;
  size_t smem;
};

MmaPlan mma_plan(int F, int kb, int elem_bytes) {
  MmaPlan p;
  const int row_steps = (F * elem_bytes + kStepBytes - 1) / kStepBytes;
  p.chunks = (row_steps + kChunkSteps - 1) / kChunkSteps;
  p.steps = row_steps <= 2 ? row_steps : kChunkSteps;
  const size_t fixed = kSwizzleAlign +
                       static_cast<size_t>(p.chunks) * kQueryChunkBytes +
                       16 * kMaxStages +
                       8 * static_cast<size_t>(kMmaRows) * (kb + kTail + 1);
  p.stages = 2;
  size_t best = 0;
  for (int s = kMaxStages; s >= 2; --s) {
    const size_t smem = fixed + static_cast<size_t>(s) * kTileChunkBytes;
    const size_t blocks = smem > kMaxSmem ? 0 : kSmPerSm / (smem + kBlockReserved);
    if (blocks > best) {
      best = blocks;
      p.stages = s;
    }
  }
  p.smem = fixed + static_cast<size_t>(p.stages) * kTileChunkBytes;
  return p;
}

// Each row's selection state in shared memory: its sorted top-kb list,
// then a tail of up to kTail unsorted candidates appended tile by tile.
// A full tail is flushed: sorted and merged into the list, whose kb-th
// entry becomes the row's new threshold. So a candidate costs an append and
// a share of one small sort, not an insertion into the list.

// One compare-exchange step of a bitonic network over the 32 R (value,
// index) pairs a warp holds (lane l holds pair q * 32 + l in v[q], i[q]):
// pairs j apart, within blocks of k ordered better-first where (pair & k)
// is 0 and worse-first elsewhere (k = 32 R: all better-first).
template <int R>
__device__ __forceinline__ void bitonic_step(float (&v)[R], int (&i)[R],
                                             int lane, int k, int j) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const bool up = ((q * 32 + lane) & k) == 0;
    if (j >= 32) {  // the partner is this lane's register q ^ (j / 32)
      const int o = q ^ (j / 32);
      if (o > q && (up ? better(v[o], i[o], v[q], i[q])
                       : better(v[q], i[q], v[o], i[o]))) {
        const float tv = v[q];
        const int ti = i[q];
        v[q] = v[o];
        i[q] = i[o];
        v[o] = tv;
        i[o] = ti;
      }
    } else {
      const float ov = __shfl_xor_sync(0xffffffffu, v[q], j);
      const int oi = __shfl_xor_sync(0xffffffffu, i[q], j);
      const bool low = (lane & j) == 0;
      if ((low == up) == better(ov, oi, v[q], i[q])) {
        v[q] = ov;
        i[q] = oi;
      }
    }
  }
}

// Merge a row's tail of cnt candidates (1 <= cnt <= kTail) into its sorted
// list of kb entries (R = kb / 32 registers a lane, at least 1) and return
// the new kb-th value. One warp, in step, all in registers: the tail is
// sorted by a bitonic network; entry p of the list against entry
// 32 R - 1 - p of the sorted tail, the better of each pair, are the list's
// new entries as a bitonic sequence, which a half-cleaner network sorts.
template <int R>
__device__ float flush_row_r(float* rv, int* ri, int kb, int cnt, int lane) {
  float tv[1] = {lane < cnt ? rv[kb + lane] : -INFINITY};
  int ti[1] = {lane < cnt ? ri[kb + lane] : INT_MAX};
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) bitonic_step<1>(tv, ti, lane, k, j);
  }
  float v[R];
  int i[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int e = q * 32 + lane;
    v[q] = e < kb ? rv[e] : -INFINITY;
    i[q] = e < kb ? ri[e] : -1;
  }
  // only the list's last 32 entries meet the tail's 32 (the rest of the
  // tail, padded to 32 R, is worse than any list entry)
  const float rev_v = __shfl_sync(0xffffffffu, tv[0], 31 - lane);
  const int rev_i = __shfl_sync(0xffffffffu, ti[0], 31 - lane);
  if (better(rev_v, rev_i, v[R - 1], i[R - 1])) {
    v[R - 1] = rev_v;
    i[R - 1] = rev_i;
  }
#pragma unroll
  for (int j = 16 * R; j > 0; j >>= 1) bitonic_step<R>(v, i, lane, 32 * R, j);
  float kth = v[0];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int e = q * 32 + lane;
    if (e < kb) {
      rv[e] = v[q];
      ri[e] = i[q];
    }
    if (q == (kb - 1) / 32) kth = v[q];
  }
  __syncwarp();
  return __shfl_sync(0xffffffffu, kth, (kb - 1) % 32);
}

__device__ float flush_row(float* rv, int* ri, int kb, int cnt, int lane) {
  if (kb <= 32) return flush_row_r<1>(rv, ri, kb, cnt, lane);
  if (kb == 64) return flush_row_r<2>(rv, ri, kb, cnt, lane);
  return flush_row_r<4>(rv, ri, kb, cnt, lane);
}

// a[bit] for a runtime bit < 16, by a tree of selects (no local memory)
__device__ __forceinline__ float pick16(const float (&a)[16], int bit) {
  float l1[8], l2[4], l3[2];
#pragma unroll
  for (int k = 0; k < 8; ++k) l1[k] = (bit & 1) ? a[2 * k + 1] : a[2 * k];
#pragma unroll
  for (int k = 0; k < 4; ++k) l2[k] = (bit & 2) ? l1[2 * k + 1] : l1[2 * k];
#pragma unroll
  for (int k = 0; k < 2; ++k) l3[k] = (bit & 4) ? l2[2 * k + 1] : l2[2 * k];
  return (bit & 8) ? l3[1] : l3[0];
}

// bit g of the result: any of lanes 4g..4g+3 set in a ballot
__device__ __forceinline__ uint32_t group_bits(uint32_t ballot) {
  uint32_t x = ballot | (ballot >> 1);
  x |= x >> 2;
  uint32_t out = 0;
#pragma unroll
  for (int g = 0; g < 8; ++g) out |= ((x >> (4 * g)) & 1u) << g;
  return out;
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
template <typename A>
__device__ __forceinline__ void fence_acc(A (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (std::is_same<A, float>::value) {
      asm volatile("" : "+f"(d[i])::"memory");
    } else {
      asm volatile("" : "+r"(d[i])::"memory");
    }
  }
}

// kSteps: the wgmma steps of one 128-byte chunk (mma_plan): 4, or 1 or 2
// when a row is at most 64 bytes. kWide: a row of more than one chunk
// (`chunk_count` of them); otherwise a row is one chunk, known at compile
// time. Compile-time counts make a chunk's wgmma sequence straight-line code
// the tensor cores pipeline. Steps past F read zeros on both sides: the
// query block is zero-padded, and the TMA fills features past F with zeros.
template <typename T, int kSteps, bool kWide>
__global__ void __launch_bounds__(kMmaThreads, 4)
topk_dot_partial_mma_kernel(const __grid_constant__ CUtensorMap ymap,
                            const T* __restrict__ xs,
                            const float* __restrict__ scales,
                            float* __restrict__ part_v,
                            int* __restrict__ part_i, int B, int n_items,
                            int F, int kb, int split_len, int chunk_count,
                            int stages) {
  const int chunks = kWide ? chunk_count : 1;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  using Raw = typename std::conditional<kInt8, uint8_t, uint16_t>::type;
  constexpr int kElem = static_cast<int>(sizeof(T));
  constexpr int kChunkElems = kChunkBytes / kElem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kSwizzleAlign - (smem_addr(smem_raw) & (kSwizzleAlign - 1))) &
                  (kSwizzleAlign - 1));
  unsigned char* qs = smem;                                  // [chunks][64][128 B]
  unsigned char* ring = qs + chunks * kQueryChunkBytes;      // [stages][64][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kTileChunkBytes);
  uint64_t* empty = full + kMaxStages;
  // [64][kb + kTail + 1]: the extra entry spreads the rows' tails over the
  // shared-memory banks
  const int stride = kb + kTail + 1;
  float* lv = reinterpret_cast<float*>(empty + kMaxStages);
  int* li = reinterpret_cast<int*>(lv + kMmaRows * stride);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * kMmaRows;
  const int split = blockIdx.y;
  const long long start = static_cast<long long>(split) * split_len;
  const long long stop_ll = start + split_len;
  const long long end = stop_ll < n_items ? stop_ll : n_items;
  const int n_tiles =
      end > start ? static_cast<int>((end - start + kMmaTile - 1) / kMmaTile) : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kMmaThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // stage the query block in the swizzled K-major layout: 16-byte unit u of
  // row r lands at unit u ^ (r % 8); zeros past F and past B
  const Raw* xr = reinterpret_cast<const Raw*>(xs);
  const int row_elems = chunks * kChunkElems;
  for (int e = tid; e < kMmaRows * row_elems; e += kMmaThreads) {
    const int r = e / row_elems;
    const int f = e % row_elems;
    const int grow = row0 + r;
    const Raw v =
        (grow < B && f < F) ? xr[static_cast<size_t>(grow) * F + f] : Raw(0);
    const int byte = (f % kChunkElems) * kElem;
    const int off = (f / kChunkElems) * kQueryChunkBytes + r * kChunkBytes +
                    ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
    *reinterpret_cast<Raw*>(qs + off) = v;
  }
  for (int e = tid; e < kMmaRows * stride; e += kMmaThreads) {
    lv[e] = -INFINITY;
    li[e] = -1;
  }
  // the queries were written by threads; wgmma reads them through the async
  // proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // thread 0 fills the ring. The split's chunks are numbered in the order
  // the dot takes them, u = tile x chunks + chunk; chunk u goes to stage
  // u % stages, and its full barrier's phase is u / stages
  const int n_chunks = n_tiles * chunks;
  auto load_chunk = [&](int u) {
    const int s = u % stages;
    const uint32_t bar = smem_addr(&full[s]);
    mbar_expect_tx(bar, static_cast<uint32_t>(kTileChunkBytes));
    tma_load(smem_addr(ring + s * kTileChunkBytes), &ymap, bar,
             (u % chunks) * kChunkElems,
             static_cast<int>(start) + (u / chunks) * kMmaTile);
  };
  if (tid == 0) {
    for (int u = 0; u < stages && u < n_chunks; ++u) load_chunk(u);
  }
  // until chunk u has landed (a wide row's warp leaves converged, as its
  // chunk loop holds wgmma)
  auto wait_chunk = [&](int u) {
    mbar_wait(smem_addr(&full[u % stages]),
              static_cast<uint32_t>((u / stages) & 1));
    if (kWide) __syncwarp();
  };
  // every warp has read chunk u: its stage is free once all four arrive
  auto release = [&](int u) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[u % stages]));
  };
  // thread 0 loads chunk u + stages into chunk u's stage once every warp
  // has released it (the warp leaves converged: wgmma's instructions are
  // warp-aligned). A tile's chunk whose
  // successor `stages` on lies in the same tile (a row of more chunks than
  // the ring has stages) is released and refilled during the dot; the rest
  // after the tile's selection, as whole tiles were
  const int early = kWide && chunks > stages ? chunks - stages : 0;
  auto refill = [&](int u) {
    if (tid == 0 && u + stages < n_chunks) {
      mbar_wait(smem_addr(&empty[u % stages]),
                static_cast<uint32_t>((u / stages) & 1));
      load_chunk(u + stages);
    }
    __syncwarp();
  };

  const uint32_t q_addr = smem_addr(qs);
  // accumulator layout (wgmma m64nN, PTX ISA): warp w holds rows 16w..16w+15;
  // d[4j + h] is row 16w + lane/4 ("row a"), d[4j + 2 + h] that row + 8
  // ("row b"), both at item 8j + 2 (lane % 4) + h. So warp w scores, selects
  // and inserts for its own 16 rows: their lists are the warp's alone, and
  // no block barrier is needed after the dot.
  const int g = lane / 4;
  const int col = 2 * (lane % 4);
  const int row_a = warp * 16 + g;
  const bool live_a = row0 + row_a < B;
  const bool live_b = row0 + row_a + 8 < B;
  float thr_a = -INFINITY;  // kb-th value of row a's list, of row b's
  float thr_b = -INFINITY;
  int cnt_a = 0;            // candidates in row a's tail, in row b's
  int cnt_b = 0;
  // flush the tails of the warp's rows that hold more than `limit`
  // candidates, one row at a time, and take up their new thresholds
  auto flush_rows = [&](int limit) {
    uint32_t todo =
        group_bits(__ballot_sync(0xffffffffu, cnt_a > limit)) |
        (group_bits(__ballot_sync(0xffffffffu, cnt_b > limit)) << 8);
    while (todo) {
      const int r = __ffs(todo) - 1;
      todo &= todo - 1;
      const bool half = r >= 8;
      const int n = __shfl_sync(0xffffffffu, half ? cnt_b : cnt_a, 4 * (r % 8));
      const float thr = flush_row(lv + (warp * 16 + r) * stride,
                                  li + (warp * 16 + r) * stride, kb, n, lane);
      if (g == r % 8) {
        if (half) {
          thr_b = thr;
          cnt_b = 0;
        } else {
          thr_a = thr;
          cnt_a = 0;
        }
      }
    }
  };

  // append a lane's pending candidates (bits of p, scores sc) to its row's
  // tail: the 4 lanes of a row take consecutive runs, by a scan of their
  // counts within the group, as far as the tail has room; what does not fit
  // stays pending
  auto append = [&](uint32_t& p, const float (&sc)[16], int& cnt, int row,
                    long long base) {
    const int c = __popc(p);
    int x = c;
#pragma unroll
    for (int dd = 1; dd < 4; dd <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, dd, 4);
      if (lane % 4 >= dd) x += y;
    }
    const int total = __shfl_sync(0xffffffffu, x, 3, 4);
    int off = cnt + x - c;
    for (; p != 0 && off < kTail; ++off) {
      const int k = __ffs(p) - 1;
      p &= p - 1;
      lv[row * stride + kb + off] = pick16(sc, k);
      li[row * stride + kb + off] = static_cast<int>(base) + 8 * (k / 2) + col + k % 2;
    }
    cnt = min(kTail, cnt + total);
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int u0 = t * chunks;  // the tile's first chunk
    const long long base = start + static_cast<long long>(t) * kMmaTile;
    const int n_tile =
        static_cast<int>(end - base < kMmaTile ? end - base : kMmaTile);
    // int8: the tile's 64 item scales, two per lane, loaded before the wait
    float sc_lo = 1.0f, sc_hi = 1.0f;
    if (kInt8) {
      sc_lo = lane < n_tile ? __ldg(scales + base + lane) : 0.0f;
      sc_hi = lane + 32 < n_tile ? __ldg(scales + base + lane + 32) : 0.0f;
    }

    Acc d[32];
    if (ORYX_PROBE_NO_DOT) {
#pragma unroll
      for (int k = 0; k < 32; ++k) d[k] = Acc(0);
      for (int c = 0; c < chunks; ++c) {
        wait_chunk(u0 + c);
        release(u0 + c);
        if (c < early) refill(u0 + c);
      }
    } else {
      // each chunk's steps are committed as one group. Chunks 0..early-1
      // are retired, released and refilled while the next one is multiplied
      // (one group stays in flight); the others stay until the tile's end.
      // No group instruction sits in a branch: ptxas would serialize wgmma
      fence_acc(d);
      auto issue = [&](int c, bool first) {
        const int u = u0 + c;
        wait_chunk(u);
        wgmma_fence();
        const uint32_t a_addr = q_addr + c * kQueryChunkBytes;
        const uint32_t b_addr = smem_addr(ring + (u % stages) * kTileChunkBytes);
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          wgmma_step(d, sw128_desc(a_addr + k * kStepBytes),
                     sw128_desc(b_addr + k * kStepBytes), !first || k > 0);
        }
        wgmma_commit();
      };
      issue(0, true);
      if constexpr (kWide) {
        for (int c = 1; c <= early; ++c) {
          issue(c, false);
          wgmma_wait<1>();
          release(u0 + c - 1);
          refill(u0 + c - 1);
        }
        for (int c = early + 1; c < chunks; ++c) issue(c, false);
      }
      wgmma_wait<0>();
      fence_acc(d);
      for (int c = early; c < chunks; ++c) release(u0 + c);
    }

    // scores (the int8 sums exact in int32, times the item scale) and the
    // entries that beat their row's threshold
    float sa[16], sb[16];
    uint32_t valid = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int j = k / 2, h = k % 2;
      float scale = 1.0f;
      if (kInt8) {
        scale = __shfl_sync(0xffffffffu, j < 4 ? sc_lo : sc_hi,
                            (8 * j + col + h) % 32);
      }
      sa[k] = static_cast<float>(d[4 * j + h]) * scale;
      sb[k] = static_cast<float>(d[4 * j + 2 + h]) * scale;
      valid |= static_cast<uint32_t>(8 * j + col + h < n_tile) << k;
    }
    // the valid entries above thr (or equal to it: see the flush below)
    auto above = [&](const float (&sc)[16], float thr, bool or_equal) {
      uint32_t m = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        m |= static_cast<uint32_t>(sc[k] > thr || (or_equal && sc[k] == thr)) << k;
      }
      return m & valid;
    };
    uint32_t pa = 0, pb = 0;  // pending candidates of row a, of row b
    if (!ORYX_PROBE_NO_SELECT) {
      pa = live_a ? above(sa, thr_a, false) : 0u;
      pb = live_b ? above(sb, thr_b, false) : 0u;
    }
    if (!ORYX_PROBE_NO_INSERT) {
      while (__ballot_sync(0xffffffffu, (pa | pb) != 0) != 0) {
        append(pa, sa, cnt_a, row_a, base);
        append(pb, sb, cnt_b, row_a + 8, base);
        __syncwarp();
        if (__ballot_sync(0xffffffffu, (pa | pb) != 0) == 0) break;
        // a full tail holds back candidates: flush the full tails, then
        // keep only the pending entries that can still enter. The lists now
        // hold items of this tile, so an entry equal to the new threshold
        // may have the smaller index and win the tie: it stays pending, and
        // the flush's total order decides
        flush_rows(kTail - 1);
        pa &= above(sa, thr_a, true);
        pb &= above(sb, thr_b, true);
      }
    }
    // the stages of the tile's other chunks take the chunks `stages` ahead
    for (int c = early; c < chunks; ++c) refill(u0 + c);
  }
  if (!ORYX_PROBE_NO_INSERT) flush_rows(0);
  // each warp writes its own 16 rows
  for (int r = 0; r < 16; ++r) {
    const int grow = row0 + warp * 16 + r;
    if (grow >= B) break;
    const size_t o = (static_cast<size_t>(split) * B + grow) * kb;
    for (int j = lane; j < kb; j += 32) {
      part_v[o + j] = lv[(warp * 16 + r) * stride + j];
      part_i[o + j] = li[(warp * 16 + r) * stride + j];
    }
  }
}

// ---------------------------------------------------------------------------
// merge kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int B, int S, int kb, int k) {
  __shared__ float run_v[kMergeSlots], buf_v[kMergeSlots], tmp_v[kMergeSlots];
  __shared__ int run_i[kMergeSlots], buf_i[kMergeSlots], tmp_i[kMergeSlots];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  int teams = kMergeSlots / kb;
  if (teams > 8) teams = 8;
  const int team = tid / kb;
  const int t = tid % kb;
  const bool active = team < teams;
  const int slot = team * kb + t;

  auto load = [&](float* dv, int* di, int s) {
    if (active) {
      if (s < S) {
        const size_t o = (static_cast<size_t>(s) * B + row) * kb + t;
        dv[slot] = part_v[o];
        di[slot] = part_i[o];
      } else {
        dv[slot] = -INFINITY;
        di[slot] = -1;
      }
    }
  };
  // tmp[a_base..] = top-kb of the sorted lists at a_base and b_base, by
  // rank: an element's output slot is its own index plus the number of
  // elements of the other list ahead of it (ties go to list a first)
  auto merge = [&](int a_base, const float* bv_arr, const int* bi_arr,
                   int b_base) {
    const float av = run_v[a_base + t];
    const int ai = run_i[a_base + t];
    int lo = 0, hi = kb;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (better(bv_arr[b_base + mid], bi_arr[b_base + mid], av, ai)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (t + lo < kb) {
      tmp_v[a_base + t + lo] = av;
      tmp_i[a_base + t + lo] = ai;
    }
    const float bv = bv_arr[b_base + t];
    const int bi = bi_arr[b_base + t];
    lo = 0;
    hi = kb;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (!better(bv, bi, run_v[a_base + mid], run_i[a_base + mid])) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (t + lo < kb) {
      tmp_v[a_base + t + lo] = bv;
      tmp_i[a_base + t + lo] = bi;
    }
  };

  // phase 1: team j folds lists j, j + teams, j + 2 teams, ...
  load(run_v, run_i, team);
  __syncthreads();
  const int rounds = (S + teams - 1) / teams;
  for (int r = 1; r < rounds; ++r) {
    load(buf_v, buf_i, r * teams + team);
    __syncthreads();
    if (active) merge(team * kb, buf_v, buf_i, team * kb);
    __syncthreads();
    if (active) {
      run_v[slot] = tmp_v[slot];
      run_i[slot] = tmp_i[slot];
    }
    __syncthreads();
  }
  // phase 2: team 0 folds the other teams' lists
  const int used = teams < S ? teams : S;
  for (int j = 1; j < used; ++j) {
    if (team == 0) merge(0, run_v, run_i, j * kb);
    __syncthreads();
    if (team == 0) {
      run_v[t] = tmp_v[t];
      run_i[t] = tmp_i[t];
    }
    __syncthreads();
  }
  for (int j = tid; j < k; j += kThreads) {
    out_v[static_cast<size_t>(row) * k + j] = run_v[j];
    out_i[static_cast<size_t>(row) * k + j] = run_i[j];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A block's dynamic shared memory; more than kMaxSmem where F is too wide.
size_t partial_smem_bytes(int F, int kb, int elem_bytes) {
  if (elem_bytes == 4) return fma_smem_bytes(F, kb);
  return mma_plan(F, kb, elem_bytes).smem;
}

// The widest F whose block fits in shared memory at this kb (the size grows
// with F, so a bisection finds it).
int max_features(int kb, int elem_bytes) {
  int lo = 0, hi = 1 << 20;  // fits at lo, not at hi
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (partial_smem_bytes(mid, kb, elem_bytes) <= kMaxSmem) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Blocks of the partial kernel that fit on one SM at this shared-memory
// size (after raising the kernel's dynamic shared-memory limit to it), or
// minus the CUDA error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return n;
}

bool bad_partial_args(int B, int n_items, int F, int pitch, int kb,
                      int n_splits, int split_len) {
  return B < 1 || n_items < 1 || F < 1 || pitch < F || kb < 1 ||
         kb > kMaxKb || n_splits < 1 || split_len < 1 ||
         static_cast<long long>(n_splits) * split_len < n_items ||
         n_splits > 65535;
}

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();  // clear, then report it
  return err;
}

// cuTensorMapEncodeTiled lives in libcuda.so.1, not in the CUDA runtime.
// PyTorch has already loaded that library, so it is looked up there rather
// than linked.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiledFn>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

constexpr int kEncodeErrorBase = 10000;  // a CUresult r is returned as base + r

// The 2D tensor map over the pitched item view: dimensions [F, n], a row
// stride of pitch bytes, boxes of [128 bytes of features, 64 items] in the
// 128-byte swizzle; elements past F and past n read as zeros.
int make_item_map(CUtensorMap* map, const void* y, int n_items, int F,
                  int pitch, int elem_bytes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(n_items)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunkBytes / elem_bytes),
                             static_cast<cuuint32_t>(kMmaTile)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(
      map,
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(y), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeErrorBase + static_cast<int>(r);
}

template <typename T>
using MmaKernel = void (*)(const CUtensorMap, const T*, const float*, float*,
                           int*, int, int, int, int, int, int, int);

// The instantiation for a plan: a chunk's step count (1, 2 or 4), and
// whether a row takes more than one chunk.
template <typename T>
MmaKernel<T> mma_kernel(const MmaPlan& plan) {
  if (plan.chunks > 1) return topk_dot_partial_mma_kernel<T, kChunkSteps, true>;
  if (plan.steps == 1) return topk_dot_partial_mma_kernel<T, 1, false>;
  if (plan.steps == 2) return topk_dot_partial_mma_kernel<T, 2, false>;
  return topk_dot_partial_mma_kernel<T, kChunkSteps, false>;
}

template <typename T>
int mma_blocks_per_sm(int F, int kb) {
  const MmaPlan plan = mma_plan(F, kb, sizeof(T));
  if (plan.smem > kMaxSmem) return 0;
  return blocks_per_sm(mma_kernel<T>(plan), kMmaThreads, plan.smem);
}

template <typename T>
int launch_mma(const void* xs, const void* y, const float* scales,
               float* part_v, int* part_i, int B, int n_items, int F,
               int pitch, int kb, int n_splits, int split_len, void* stream) {
  constexpr int kElem = static_cast<int>(sizeof(T));
  if (bad_partial_args(B, n_items, F, pitch, kb, n_splits, split_len) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || (pitch * kElem) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MmaPlan plan = mma_plan(F, kb, kElem);
  if (plan.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const MmaKernel<T> kernel = mma_kernel<T>(plan);
  const cudaError_t err = raise_smem_limit(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  const int rc = make_item_map(&map, y, n_items, F, pitch, kElem);
  if (rc != 0) return rc;
  const dim3 grid((B + kMmaRows - 1) / kMmaRows, n_splits);
  kernel<<<grid, kMmaThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
          map, static_cast<const T*>(xs), scales, part_v, part_i, B, n_items,
          F, kb, split_len, plan.chunks, plan.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The C interface's version: 2 since the partial entry points take a row
// pitch (the first version of this library has no such symbol).
int oryx_topk_abi(void) { return 2; }

// elem_bytes: 4 for f32, 2 for bf16, 1 for int8
int oryx_topk_partial_smem_bytes(int F, int kb, int elem_bytes) {
  return static_cast<int>(partial_smem_bytes(F, kb, elem_bytes));
}

// The widest F the partial kernel takes at this kb (a block's shared
// memory holds the query block, whose size grows with F).
int oryx_topk_max_features(int kb, int elem_bytes) {
  return max_features(kb, elem_bytes);
}

int oryx_topk_partial_blocks_per_sm(int F, int kb, int elem_bytes) {
  const size_t smem = partial_smem_bytes(F, kb, elem_bytes);
  if (elem_bytes == 4) {
    return blocks_per_sm(topk_dot_partial_f32_kernel, kThreads, smem);
  }
  if (elem_bytes == 2) {
    return mma_blocks_per_sm<__nv_bfloat16>(F, kb);
  }
  return mma_blocks_per_sm<int8_t>(F, kb);
}

// Partial top-kb of xs [B, F] against the item view y: n_items rows of F
// features at a row pitch of `pitch` elements. bf16 and int8 take a pitch
// of a multiple of 16 bytes and a 16-byte aligned y (TMA). Returns 0 or a
// CUDA runtime error; a tensor-map encoding failure returns 10000 plus its
// CUresult.
int oryx_topk_dot_partial_f32(const void* xs, const void* y, float* part_v,
                              int* part_i, int B, int n_items, int F,
                              int pitch, int kb, int n_splits, int split_len,
                              void* stream) {
  if (bad_partial_args(B, n_items, F, pitch, kb, n_splits, split_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fma_smem_bytes(F, kb);
  const cudaError_t err = raise_smem_limit(topk_dot_partial_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, n_splits);
  topk_dot_partial_f32_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(y), part_v,
      part_i, B, n_items, F, pitch, kb, split_len);
  return static_cast<int>(cudaGetLastError());
}

int oryx_topk_dot_partial_bf16(const void* xs, const void* y, float* part_v,
                               int* part_i, int B, int n_items, int F,
                               int pitch, int kb, int n_splits, int split_len,
                               void* stream) {
  return launch_mma<__nv_bfloat16>(xs, y, nullptr, part_v, part_i, B,
                                   n_items, F, pitch, kb, n_splits,
                                   split_len, stream);
}

int oryx_topk_dot_partial_i8(const void* xs, const void* y,
                             const float* scales, float* part_v, int* part_i,
                             int B, int n_items, int F, int pitch, int kb,
                             int n_splits, int split_len, void* stream) {
  return launch_mma<int8_t>(xs, y, scales, part_v, part_i, B, n_items, F,
                            pitch, kb, n_splits, split_len, stream);
}

int oryx_topk_merge(const float* part_v, const int* part_i, float* out_v,
                    int* out_i, int B, int S, int kb, int k, void* stream) {
  if (B < 1 || S < 1 || kb < 1 || kb > kMaxKb || k < 1 || k > kb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  topk_merge_kernel<<<B, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      part_v, part_i, out_v, out_i, B, S, kb, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
