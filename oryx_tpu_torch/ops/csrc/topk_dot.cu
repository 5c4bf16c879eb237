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
//   One warpgroup of 128 threads owns 64 query rows, for every type. Item
//   rows sit in device memory at a pitch that is a multiple of 16 bytes
//   (ops/transfer.py), so a 2D TMA tensor map tiles the catalog: boxes of
//   [128 bytes of features, 64 items] (one chunk), 128-byte swizzled,
//   features past F and items past n filled with zeros by the hardware. A
//   tile of 64 items is ceil(F x itemsize / 128) such chunks, and they
//   stream through a ring of 2 to 8 stages of one chunk each, so the ring's
//   size does not grow with F. Each stage has a full mbarrier, completed by
//   the TMA's transaction bytes, and an empty one, on which every warp
//   arrives once it has read the stage; thread 0 then loads the chunk
//   `stages` ahead into it. The queries are staged once per block in the
//   same swizzled K-major layout (zeros past F and past B), all chunks of
//   them. A bf16 or int8 tile's chunks are refilled after its selection
//   (f32: see below), but where a row
//   has more chunks than the ring has stages, the first ones are released
//   and refilled while the next chunk is multiplied. No thread reads Y from
//   device memory.
//   - bf16 and int8 (the serving views): the queries are wgmma's operand A
//     and the item chunk operand B. The dot is wgmma.mma_async m64n64k16
//     bf16 -> f32 or m64n64k32 s8 -> s32, 32 bytes of features per step, 4
//     steps (or 1 or 2 for F x itemsize <= 64 bytes) committed per chunk. A
//     row of one chunk, the serving width, is an instantiation of its own
//     with none of the chunk loop. The int32 sums are exact, converted to
//     f32 and multiplied by the item scale before selection, so int8 scores
//     are bit-identical to the plain version's. Widths: the query block
//     (64 rows x F x itemsize, in whole chunks), a ring of 2 stages and the
//     rows' lists must fit a block's 227 KB, which at kb=128 holds
//     F <= 1,024 in bf16 and F <= 2,048 in int8 (oryx_topk_max_features;
//     the serving model checks it when built).
//   - f32: the same ring and block, the dot on the CUDA cores in full f32
//     FMA (no TF32: the reference computes with Precision.HIGHEST), each
//     thread accumulating 4 rows x 8 items, 4 features at a time from
//     16-byte loads of the swizzled tiles (fma_chunk), then trading halves
//     with a partner lane into wgmma's accumulator layout (2 rows x 16
//     items) for the selection. Each warp multiplies on its own and
//     releases a chunk as soon as it has read it, and the chunk `stages`
//     ahead is then loaded into its stage at once. Where the query block does
//     not fit beside the lists (past about 450 features at kb=128), each
//     ring stage carries the item chunk and the same chunk of the 64 query
//     rows, both by TMA from pitched views, so f32 rows take any width up
//     to the library's bound (65,535 features).
//   In the accumulator layout warp w holds all 64 items of rows
//   16w..16w+15, so each warp selects for its own 16 rows with no block
//   barrier (RowSelect, one code for every type). A row keeps its sorted
//   top-kb list and a tail of up to 24 unsorted candidates in shared
//   memory. A score is a candidate if it beats the row's threshold, the
//   kb-th entry of its list; candidates are appended to the tail, and a
//   full tail is flushed: sorted by a warp bitonic network and merged into
//   the list by rank, after which the list's kb-th entry is the new
//   threshold. Between flushes the threshold lags the true kb-th value, so
//   the tail holds a superset of what can enter; since tiles are visited in
//   ascending index order, a strict '>' against it loses nothing under
//   (value desc, index asc). (A tile whose candidates overflow a tail
//   flushes it mid-tile; the list then holds items of that tile, so its
//   remaining entries equal to the new threshold stay candidates, and the
//   merge's total order decides.) Every type writes one sorted partial
//   [S, B, kb] (values f32, indices int32; unfilled slots hold (-inf, -1)).
//
// topk_merge (grid: one block per query row, of 512 threads, or 256 or 128
// for a batch too large for one wave of 512)
//   The final top-k of a row over its S sorted partial lists, under the
//   same total order; the counterpart of _merge_top, which the sharded
//   merge can reuse. One parallel pass, not a fold over the lists: a bound
//   that every entry of the answer meets (from the lists' k-th entries and
//   order statistics of their leading entries), the entries that meet it
//   compacted into
//   shared memory, and each one's rank among them counted; a radix select
//   over 64-bit order keys takes over where more than 1,024 meet it.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 tensor, 1,979 TOP/s int8
// tensor, ~67 TFLOP/s f32 CUDA cores, 3.35 TB/s HBM): at B=512, I=1M, F=50
// the bf16 catalog is 112 MB pitched (about 33 us to read) and the dot is
// 51 GFLOP (about 52 us on the tensor cores); int8 halves both. With TMA and
// wgmma the loads and the products cost the threads few issue slots; the
// bf16 and int8 kernel is bound by latency in the selection (PERF.md has the ablation of
// ops/topk_probe.py): the tail flushes, the appends, and the wgmma, which
// makes the block's four warps meet once per tile, so one warp's flush holds
// up the other three. The f32 dot is 2 x 1M x 512 x 50 = 51 GFLOP at B=512,
// about 764 us at the CUDA cores' peak: the f32 kernel is bound by its FMAs.
// The merge reads the partials once from L2, where the partial kernel
// has just written them: 8.65 MB at B=512 (66 splits, kb=32), 2.6 us at
// the memory rate; it is bound by the latency of its few dependent steps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxKb = 128;

// merge kernel: the survivors a row sorts in shared memory, and the lists
// whose leading entries bound a row's k-th entry
constexpr int kMergeCap = 1024;
constexpr int kMergeLists = 128;
constexpr int kMergePositions = 7;  // 0, 1, 3, ..., 63: below k - 1 <= 127

// partial kernel: one warpgroup, 64 rows (wgmma M) per block, tiles of 64
// items (wgmma N), features in chunks of 128 bytes (one swizzle span)
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
// none. Each, defined to 1, compiles one phase out of the partial kernel:
// the products (wgmma, or the f32 FMA loop; the TMA loads still stream), the
// selection of a tile's scores (the compares), the insertion of candidates
// (the appends and flushes, which drops the candidates it finds).
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
// partial kernel (TMA ring; wgmma for bf16 and int8, FMA for f32)
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

// Shared memory of the partial kernel: 1024 bytes of alignment slack, the
// query block (chunks x 64 rows x 128 bytes), a ring of `stages` stages of
// one item chunk (64 items x 128 bytes) each, a full and an empty mbarrier
// per stage, and the 64 rows' lists and tails. The ring takes 2 to 8
// stages: as many as keep the most blocks resident on an SM by shared
// memory. f32 rows too wide for a resident query block stream it instead:
// each stage then holds the item chunk and the same chunk of the 64 query
// rows, both by TMA, so shared memory does not grow with F at all.
constexpr size_t kMaxSmem = 232448;       // a block's limit
constexpr size_t kSmPerSm = 233472;       // an SM's shared memory
constexpr size_t kBlockReserved = 1024;   // the runtime's share per block
constexpr int kMaxFeatures = 65536;       // bound of oryx_topk_max_features

struct MmaPlan {
  int chunks;  // 128-byte feature chunks of a row (F x itemsize rounded up)
  int steps;   // wgmma steps per chunk: 4, or 1 or 2 for a row of <= 64 bytes
  int stages;
  bool stream_q;      // f32 only: query chunks ride the ring with the items
  int stage_bytes;    // one item chunk, or an item and a query chunk
  size_t smem;
};

MmaPlan mma_plan(int F, int kb, int elem_bytes) {
  MmaPlan p;
  const int row_steps = (F * elem_bytes + kStepBytes - 1) / kStepBytes;
  p.chunks = (row_steps + kChunkSteps - 1) / kChunkSteps;
  p.steps = row_steps <= 2 ? row_steps : kChunkSteps;
  const size_t lists = 8 * static_cast<size_t>(kMmaRows) * (kb + kTail + 1);
  size_t fixed = kSwizzleAlign + static_cast<size_t>(p.chunks) * kQueryChunkBytes +
                 16 * kMaxStages + lists;
  p.stage_bytes = kTileChunkBytes;
  p.stream_q = elem_bytes == 4 && fixed + 2 * kTileChunkBytes > kMaxSmem;
  if (p.stream_q) {
    fixed = kSwizzleAlign + 16 * kMaxStages + lists;
    p.stage_bytes = kTileChunkBytes + kQueryChunkBytes;
  }
  p.stages = 2;
  size_t best = 0;
  for (int s = kMaxStages; s >= 2; --s) {
    const size_t smem = fixed + static_cast<size_t>(s) * p.stage_bytes;
    const size_t blocks = smem > kMaxSmem ? 0 : kSmPerSm / (smem + kBlockReserved);
    if (blocks > best) {
      best = blocks;
      p.stages = s;
    }
  }
  p.smem = fixed + static_cast<size_t>(p.stages) * p.stage_bytes;
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

// Per-warp selection over the 16 rows a warp's accumulators hold. In the
// accumulator layout of wgmma m64nN (PTX ISA), which the f32 FMA loop keeps,
// warp w holds rows 16w..16w+15: d[4j + h] is row 16w + lane/4 ("row a"),
// d[4j + 2 + h] that row + 8 ("row b"), both at item 8j + 2 (lane % 4) + h.
// So a warp scores, selects and inserts for its own 16 rows: their lists
// are the warp's alone, and no block barrier is needed after the dot.
struct RowSelect {
  float* lv;  // [64][stride]: each row's list, then its tail
  int* li;
  int stride, kb, warp, lane, g, col, row_a;
  bool live_a, live_b;
  float thr_a = -INFINITY;  // kb-th value of row a's list, of row b's
  float thr_b = -INFINITY;
  int cnt_a = 0;            // candidates in row a's tail, in row b's
  int cnt_b = 0;

  __device__ __forceinline__ RowSelect(float* lv_, int* li_, int stride_,
                                       int kb_, int row0, int B)
      : lv(lv_), li(li_), stride(stride_), kb(kb_),
        warp(threadIdx.x / 32), lane(threadIdx.x % 32), g(lane / 4),
        col(2 * (lane % 4)), row_a(warp * 16 + g),
        live_a(row0 + row_a < B), live_b(row0 + row_a + 8 < B) {}

  // flush the tails of the warp's rows that hold more than `limit`
  // candidates, one row at a time, and take up their new thresholds
  __device__ __forceinline__ void flush_rows(int limit) {
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
  }

  // append a lane's pending candidates (bits of p, scores sc) to its row's
  // tail: the 4 lanes of a row take consecutive runs, by a scan of their
  // counts within the group, as far as the tail has room; what does not fit
  // stays pending
  __device__ __forceinline__ void append(uint32_t& p, const float (&sc)[16],
                                         int& cnt, int row, long long base) {
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
  }

  // the valid entries of a row's scores above thr (or equal to it: see the
  // flush in tile())
  __device__ __forceinline__ static uint32_t above(const float (&sc)[16],
                                                   float thr, bool or_equal,
                                                   uint32_t valid) {
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      m |= static_cast<uint32_t>(sc[k] > thr || (or_equal && sc[k] == thr)) << k;
    }
    return m & valid;
  }

  // Select from one tile's scores of rows a and b (entry k at item
  // base + 8 (k / 2) + col + k % 2, valid where bit k of `valid` is set).
  __device__ __forceinline__ void tile(const float (&sa)[16],
                                       const float (&sb)[16], uint32_t valid,
                                       long long base) {
    uint32_t pa = 0, pb = 0;  // pending candidates of row a, of row b
    if (!ORYX_PROBE_NO_SELECT) {
      pa = live_a ? above(sa, thr_a, false, valid) : 0u;
      pb = live_b ? above(sb, thr_b, false, valid) : 0u;
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
        pa &= above(sa, thr_a, true, valid);
        pb &= above(sb, thr_b, true, valid);
      }
    }
  }

  // flush every tail and write the warp's 16 sorted lists
  __device__ __forceinline__ void write(float* part_v, int* part_i, int B,
                                        int row0, int split) {
    if (!ORYX_PROBE_NO_INSERT) flush_rows(0);
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
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// The f32 dot of one 128-byte chunk on the CUDA cores (full f32 FMA; no
// TF32, as the reference computes with Precision.HIGHEST). Query rows (q)
// and item rows (y) are 128-byte lines in the 128-byte swizzle, which
// permutes whole 16-byte units (unit u of line r sits at unit u ^ (r % 8)),
// so 4 features are one float4 load. Lanes 4g + c and 4(g ^ 1) + c share
// the rows of both (rows g, g ^ 1 and those + 8 of the warp's 16) and
// split the items of column c (8j + 2c + h): the lane with g even takes
// h = 0, the other h = 1. Each lane so holds 4 rows x 8 items, d[4j + r]
// for row r in (even g, odd g, even g + 8, odd g + 8): 12 LDS.128 per 128
// FMAs (2 rows x 16 items would take 18), all conflict-free, a row's q
// units a broadcast. to_wgmma_layout then trades halves with the partner.
__device__ __forceinline__ void fma_chunk(float (&d)[32],
                                          const unsigned char* q,
                                          const unsigned char* y, int units,
                                          int warp, int lane) {
  const int g = lane / 4;
  const int ge = g & ~1;                      // the even row of the pair
  const int it = 2 * (lane % 4) + (g & 1);    // item 8j + it, it < 8
  const unsigned char* q0 = q + (warp * 16 + ge) * kChunkBytes;
  const unsigned char* yc = y + it * kChunkBytes;
  for (int u = 0; u < units; ++u) {
    const int oe = (u ^ ge) << 4;
    const int oo = (u ^ (ge + 1)) << 4;
    const float4 x0 = *reinterpret_cast<const float4*>(q0 + oe);
    const float4 x1 = *reinterpret_cast<const float4*>(q0 + kChunkBytes + oo);
    const float4 x2 = *reinterpret_cast<const float4*>(q0 + 8 * kChunkBytes + oe);
    const float4 x3 = *reinterpret_cast<const float4*>(q0 + 9 * kChunkBytes + oo);
    const int yo = (u ^ it) << 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 yv =
          *reinterpret_cast<const float4*>(yc + 8 * j * kChunkBytes + yo);
      d[4 * j + 0] = dot4(x0, yv, d[4 * j + 0]);
      d[4 * j + 1] = dot4(x1, yv, d[4 * j + 1]);
      d[4 * j + 2] = dot4(x2, yv, d[4 * j + 2]);
      d[4 * j + 3] = dot4(x3, yv, d[4 * j + 3]);
    }
  }
}

// From fma_chunk's layout to wgmma's (RowSelect): the lane with g even
// keeps its rows g and g + 8 at h = 0 and takes h = 1 of them from its
// partner, which keeps its rows at h = 1 and takes h = 0.
__device__ __forceinline__ void to_wgmma_layout(float (&d)[32], int lane) {
  const bool odd = (lane / 4) & 1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const float mine = odd ? d[4 * j + r] : d[4 * j + r + 1];
      const float got = __shfl_xor_sync(0xffffffffu, mine, 4);
      if (odd) {
        d[4 * j + r] = got;
      } else {
        d[4 * j + r + 1] = got;
      }
    }
  }
}

// kSteps: the wgmma steps of one 128-byte chunk (mma_plan): 4, or 1 or 2
// when a row is at most 64 bytes (f32 has no steps). kWide: a row of more
// than one chunk (`chunk_count` of them); otherwise a row is one chunk,
// known at compile time. Compile-time counts make a chunk's wgmma sequence
// straight-line code the tensor cores pipeline. Steps past F read zeros on
// both sides: the query block is zero-padded, and the TMA fills features
// past F with zeros. `xmap` tiles the queries for a streamed f32 block
// (stream_q); the other instantiations never read it.
template <typename T, int kSteps, bool kWide>
__global__ void __launch_bounds__(kMmaThreads, 4)
topk_dot_partial_kernel(const __grid_constant__ CUtensorMap ymap,
                        const __grid_constant__ CUtensorMap xmap,
                        const T* __restrict__ xs,
                        const float* __restrict__ scales,
                        float* __restrict__ part_v, int* __restrict__ part_i,
                        int B, int n_items, int F, int x_pitch, int kb,
                        int split_len, int chunk_count, int stages,
                        int stream_q) {
  const int chunks = kWide ? chunk_count : 1;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  using Raw = typename std::conditional<
      kInt8, uint8_t,
      typename std::conditional<kF32, uint32_t, uint16_t>::type>::type;
  constexpr int kElem = static_cast<int>(sizeof(T));
  constexpr int kChunkElems = kChunkBytes / kElem;
  const bool qstream = kF32 && stream_q != 0;
  const int stage_bytes =
      qstream ? kTileChunkBytes + kQueryChunkBytes : kTileChunkBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((kSwizzleAlign - (smem_addr(smem_raw) & (kSwizzleAlign - 1))) &
                  (kSwizzleAlign - 1));
  unsigned char* qs = smem;                                  // [chunks][64][128 B]
  unsigned char* ring = qs + (qstream ? 0 : chunks * kQueryChunkBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
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
  if (!qstream) {
    const Raw* xr = reinterpret_cast<const Raw*>(xs);
    const int row_elems = chunks * kChunkElems;
    for (int e = tid; e < kMmaRows * row_elems; e += kMmaThreads) {
      const int r = e / row_elems;
      const int f = e % row_elems;
      const int grow = row0 + r;
      const Raw v = (grow < B && f < F)
                        ? xr[static_cast<size_t>(grow) * x_pitch + f]
                        : Raw(0);
      const int byte = (f % kChunkElems) * kElem;
      const int off = (f / kChunkElems) * kQueryChunkBytes + r * kChunkBytes +
                      ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
      *reinterpret_cast<Raw*>(qs + off) = v;
    }
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
    unsigned char* dst = ring + s * stage_bytes;
    const int c0 = (u % chunks) * kChunkElems;
    mbar_expect_tx(bar, static_cast<uint32_t>(stage_bytes));
    tma_load(smem_addr(dst), &ymap, bar, c0,
             static_cast<int>(start) + (u / chunks) * kMmaTile);
    if (qstream) tma_load(smem_addr(dst + kTileChunkBytes), &xmap, bar, c0, row0);
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
  RowSelect sel(lv, li, stride, kb, row0, B);
  const int col = 2 * (lane % 4);

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
    if constexpr (kF32) {
      // each warp multiplies its own 16 rows; each chunk is released and
      // refilled as soon as it is used (the warps need not meet at a
      // wgmma, and a row of 2 chunks would otherwise have its second chunk
      // asked for only a tile ahead)
#pragma unroll
      for (int k = 0; k < 32; ++k) d[k] = 0.0f;
      for (int c = 0; c < chunks; ++c) {
        const int u = u0 + c;
        wait_chunk(u);
        if (!ORYX_PROBE_NO_DOT) {
          const unsigned char* stage = ring + (u % stages) * stage_bytes;
          const int rest = F - c * kChunkElems;
          const int units = rest >= kChunkElems ? kChunkElems / 4 : (rest + 3) / 4;
          fma_chunk(d, qstream ? stage + kTileChunkBytes : qs + c * kQueryChunkBytes,
                    stage, units, warp, lane);
        }
        release(u);
        refill(u);
      }
      to_wgmma_layout(d, lane);
      fence_acc(d);  // keeps the dot where the ablation drops the selection
    } else if constexpr (ORYX_PROBE_NO_DOT != 0) {
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
    sel.tile(sa, sb, valid, base);
    // the stages of the tile's other chunks take the chunks `stages` ahead
    if constexpr (!kF32) {
      for (int c = early; c < chunks; ++c) refill(u0 + c);
    }
  }
  sel.write(part_v, part_i, B, row0, split);
}

// ---------------------------------------------------------------------------
// merge kernel
// ---------------------------------------------------------------------------

// A 64-bit key whose unsigned order is the total order: larger is better
// (value desc, then index asc). The value's bits are flipped into unsigned
// order, -0.0 counted as 0.0 as `better` counts it.
using Key = unsigned long long;

__device__ __forceinline__ Key order_key(float v, int i) {
  uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const uint32_t lo = ~(static_cast<uint32_t>(i) ^ 0x80000000u);
  return (static_cast<Key>(u) << 32) | lo;
}

struct __align__(8) Entry {
  float v;
  int i;
};

// The rank of x = buf[a] among buf[0..n) in the total order; equal pairs
// rank by slot, so the n ranks are 0..n-1.
__device__ __forceinline__ int rank_of(const Entry* buf, int n, int a,
                                       Entry x) {
  int r = 0;
  for (int b = 0; b < n; ++b) {
    const Entry y = buf[b];
    r += better(y.v, y.i, x.v, x.i) || (y.v == x.v && y.i == x.i && b < a);
  }
  return r;
}

// The r-th best (1-based) of the keys key_of(0..n-1), by a block-wide radix
// select, 8 bits a pass from the top; `need` returns how many entries equal
// to it are among the r best.
template <int kThreads, typename KeyOf>
__device__ Key radix_select(KeyOf key_of, int n, int r, int* hist, int* pick,
                            int& need) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  Key prefix = 0, mask = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (int e = tid; e < n; e += kThreads) {
      const Key key = key_of(e);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255], 1);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l counts digits 255 - 8l down to 248 - 8l; a scan over the
      // lanes gives the count in better digits
      int c[8];
      int sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = hist[255 - 8 * lane - q];
        sum += c[q];
      }
      int incl = sum;
#pragma unroll
      for (int dd = 1; dd < 32; dd <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, dd);
        if (lane >= dd) incl += y;
      }
      int above = incl - sum;
      if (above < r && r <= incl) {
        for (int q = 0; q < 8; ++q) {
          if (above + c[q] >= r) {
            pick[0] = 255 - 8 * lane - q;
            pick[1] = r - above;
            break;
          }
          above += c[q];
        }
      }
    }
    __syncthreads();
    r = pick[1];
    prefix |= static_cast<Key>(pick[0]) << shift;
    mask |= static_cast<Key>(0xFF) << shift;
  }
  need = r;
  return prefix;
}

// One block of kThreads per row, one parallel pass over the row's
// lists (no loop runs once per list). Only a list's first k entries can
// reach the answer (each later one has k better in its own list). A bound
// T: every entry of the answer is at least T in the total order. If m
// lists each hold an entry X at position p (0-based), the m (p + 1) entries
// at or before them are at least as good as the worst such X, so with
// m (p + 1) >= k that X is a bound. T is the best of such bounds:
//   - the best of all the lists' k-th entries (p = k - 1, m = 1), and
//   - for p = 0, 1, 3, 7, ... below k - 1, the m-th best of the entries at
//     position p of the first kMergeLists lists, m = ceil(k / (p + 1)),
//     where there are as many lists (p = 0, the heads, is the tight one at
//     large S; the others where S < k).
// The entries at least T (at least k of them; about k plus a few on
// serving data) are compacted into shared memory and each one's rank is
// counted against the others; ranks below k are the answer. Where more
// than kMergeCap survive (ties across interleaved lists, or many lists of
// padding), a radix select over 64-bit order keys finds the k-th entry
// exactly and the k entries up to it are ranked the same way.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int B, int S, int kb, int k) {
  __shared__ Entry buf[kMergeCap];
  __shared__ Key lead[kMergePositions * kMergeLists];
  __shared__ int hist[256];
  __shared__ int count[2];
  __shared__ int pick[2];
  __shared__ Key bound;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t list_stride = static_cast<size_t>(B) * kb;
  const float* pv = part_v + static_cast<size_t>(row) * kb;
  const int* pi = part_i + static_cast<size_t>(row) * kb;
  const int n = S * k;  // the candidates: each list's first k entries
  auto cand = [&](int e) {
    const int s = e / k;
    const size_t o = s * list_stride + (e - s * k);
    return Entry{__ldg(pv + o), __ldg(pi + o)};
  };

  if (tid == 0) {
    bound = 0;
    count[0] = 0;
    count[1] = 0;
  }
  // the keys of the entries at positions 2^j - 1 < k - 1 of the first h
  // lists, one group of h per position
  const int h = min(S, kMergeLists);
  int n_pos = 0;
  while ((1 << n_pos) - 1 < k - 1) ++n_pos;
  for (int e = tid; e < n_pos * h; e += kThreads) {
    const size_t o = (e % h) * list_stride + (1 << (e / h)) - 1;
    lead[e] = order_key(__ldg(pv + o), __ldg(pi + o));
  }
  __syncthreads();
  Key t = 0;  // below every key of a finite or infinite score
  for (int s = tid; s < S; s += kThreads) {
    const size_t o = s * list_stride + k - 1;
    const Key key = order_key(__ldg(pv + o), __ldg(pi + o));
    if (key > t) t = key;
  }
  for (int e = tid; e < n_pos * h; e += kThreads) {
    const int per = 1 << (e / h);          // p + 1
    const int m = (k + per - 1) / per;     // lists needed at this position
    const Key key = lead[e];
    if (m <= h && key > t) {
      // its rank in its group, equal keys by slot
      const Key* group = lead + (e / h) * h;
      const int a = e % h;
      int r = 0;
      for (int b = 0; b < h; ++b) r += group[b] > key || (group[b] == key && b < a);
      if (r == m - 1) t = key;
    }
  }
#pragma unroll
  for (int dd = 16; dd > 0; dd >>= 1) {
    const Key other = __shfl_xor_sync(0xffffffffu, t, dd);
    if (other > t) t = other;
  }
  if (tid % 32 == 0) atomicMax(&bound, t);
  __syncthreads();
  t = bound;

  // compact the candidates at least T; four loads in flight a thread
  for (int e0 = tid; e0 < n; e0 += 4 * kThreads) {
    Entry x[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * kThreads;
      x[q] = e < n ? cand(e) : Entry{-INFINITY, INT_MAX};
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (e0 + q * kThreads < n && order_key(x[q].v, x[q].i) >= t) {
        const int slot = atomicAdd(&count[0], 1);
        if (slot < kMergeCap) buf[slot] = x[q];
      }
    }
  }
  __syncthreads();
  int m = count[0];
  if (m > kMergeCap) {
    // too many survive: the k-th candidate exactly, then the entries
    // better than it and as many equal to it as the k best hold
    int need;
    const Key kth = radix_select<kThreads>(
        [&](int e) {
          const Entry x = cand(e);
          return order_key(x.v, x.i);
        },
        n, k, hist, pick, need);
    if (tid == 0) {
      count[0] = 0;
      count[1] = 0;
    }
    __syncthreads();
    for (int e = tid; e < n; e += kThreads) {
      const Entry x = cand(e);
      const Key key = order_key(x.v, x.i);
      if (key > kth) {
        buf[atomicAdd(&count[0], 1)] = x;
      } else if (key == kth) {
        const int q = atomicAdd(&count[1], 1);
        if (q < need) buf[k - need + q] = x;
      }
    }
    __syncthreads();
    m = k;
  }
  for (int a = tid; a < m; a += kThreads) {
    const Entry x = buf[a];
    const int r = rank_of(buf, m, a, x);
    if (r < k) {
      out_v[static_cast<size_t>(row) * k + r] = x.v;
      out_i[static_cast<size_t>(row) * k + r] = x.i;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A block's dynamic shared memory; more than kMaxSmem where F is too wide.
size_t partial_smem_bytes(int F, int kb, int elem_bytes) {
  return mma_plan(F, kb, elem_bytes).smem;
}

// The widest F (up to kMaxFeatures) whose block fits in shared memory at
// this kb (the size grows with F, so a bisection finds it). f32 streams its
// query block past a width, so every f32 width up to the bound fits.
int max_features(int kb, int elem_bytes) {
  int lo = 0, hi = kMaxFeatures;  // fits at lo, not at hi
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

bool bad_partial_args(int B, int n_items, int F, int pitch, int x_pitch,
                      int kb, int n_splits, int split_len) {
  return B < 1 || n_items < 1 || F < 1 || F >= kMaxFeatures || pitch < F ||
         x_pitch < F || kb < 1 || kb > kMaxKb || n_splits < 1 ||
         split_len < 1 ||
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

// The 2D tensor map over a pitched view (the items, or f32 queries that
// stream): dimensions [F, rows], a row stride of pitch elements, boxes of
// [128 bytes of features, 64 rows] in the 128-byte swizzle; elements past F
// and past the last row read as zeros.
int make_row_map(CUtensorMap* map, const void* base, int rows, int F,
                 int pitch, int elem_bytes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunkBytes / elem_bytes),
                             static_cast<cuuint32_t>(kMmaTile)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUresult r = fn(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeErrorBase + static_cast<int>(r);
}

template <typename T>
using PartialKernel = void (*)(const CUtensorMap, const CUtensorMap, const T*,
                               const float*, float*, int*, int, int, int, int,
                               int, int, int, int, int);

// The instantiation for a plan: a chunk's step count (1, 2 or 4; f32 has
// none), and whether a row takes more than one chunk.
template <typename T>
PartialKernel<T> partial_kernel(const MmaPlan& plan) {
  if (plan.chunks > 1) return topk_dot_partial_kernel<T, kChunkSteps, true>;
  if constexpr (!std::is_same<T, float>::value) {
    if (plan.steps == 1) return topk_dot_partial_kernel<T, 1, false>;
    if (plan.steps == 2) return topk_dot_partial_kernel<T, 2, false>;
  }
  return topk_dot_partial_kernel<T, kChunkSteps, false>;
}

template <typename T>
int partial_blocks_per_sm(int F, int kb) {
  const MmaPlan plan = mma_plan(F, kb, sizeof(T));
  if (plan.smem > kMaxSmem) return 0;
  return blocks_per_sm(partial_kernel<T>(plan), kMmaThreads, plan.smem);
}

bool misaligned(const void* p, int pitch, int elem_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0 || (pitch * elem_bytes) % 16 != 0;
}

template <typename T>
int launch_partial(const void* xs, const void* y, const float* scales,
                   float* part_v, int* part_i, int B, int n_items, int F,
                   int pitch, int x_pitch, int kb, int n_splits, int split_len,
                   void* stream) {
  constexpr int kElem = static_cast<int>(sizeof(T));
  if (bad_partial_args(B, n_items, F, pitch, x_pitch, kb, n_splits, split_len) ||
      misaligned(y, pitch, kElem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MmaPlan plan = mma_plan(F, kb, kElem);
  // only streamed queries are tiled by TMA; a resident query block is
  // staged with element loads, at any pitch
  if (plan.smem > kMaxSmem || (plan.stream_q && misaligned(xs, x_pitch, kElem))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PartialKernel<T> kernel = partial_kernel<T>(plan);
  const cudaError_t err = raise_smem_limit(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap ymap, xmap = {};
  int rc = make_row_map(&ymap, y, n_items, F, pitch, kElem);
  if (rc == 0 && plan.stream_q) rc = make_row_map(&xmap, xs, B, F, x_pitch, kElem);
  if (rc != 0) return rc;
  const dim3 grid((B + kMmaRows - 1) / kMmaRows, n_splits);
  kernel<<<grid, kMmaThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      ymap, xmap, static_cast<const T*>(xs), scales, part_v, part_i, B,
      n_items, F, x_pitch, kb, split_len, plan.chunks, plan.stages,
      plan.stream_q ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The C interface's version: 2 since the partial entry points take a row
// pitch, 3 since they also take the queries' row pitch (the first version
// of this library has no such symbol).
int oryx_topk_abi(void) { return 3; }

// elem_bytes: 4 for f32, 2 for bf16, 1 for int8
int oryx_topk_partial_smem_bytes(int F, int kb, int elem_bytes) {
  return static_cast<int>(partial_smem_bytes(F, kb, elem_bytes));
}

// The widest F the partial kernel takes at this kb (a block's shared
// memory holds the bf16 or int8 query block, whose size grows with F).
int oryx_topk_max_features(int kb, int elem_bytes) {
  return max_features(kb, elem_bytes);
}

// 1 where f32 rows of F features stream their queries through the ring at
// this kb, so the queries need the pitch and alignment of y; else 0.
int oryx_topk_partial_streams_queries(int F, int kb, int elem_bytes) {
  return mma_plan(F, kb, elem_bytes).stream_q ? 1 : 0;
}

int oryx_topk_partial_blocks_per_sm(int F, int kb, int elem_bytes) {
  if (elem_bytes == 4) return partial_blocks_per_sm<float>(F, kb);
  if (elem_bytes == 2) return partial_blocks_per_sm<__nv_bfloat16>(F, kb);
  return partial_blocks_per_sm<int8_t>(F, kb);
}

// Partial top-kb of xs [B, F] (rows x_pitch elements apart) against the item
// view y: n_items rows of F features at a row pitch of `pitch` elements. y
// takes a pitch of a multiple of 16 bytes and a 16-byte aligned start (TMA),
// and so do f32 queries that stream (oryx_topk_partial_streams_queries).
// Returns 0 or a CUDA runtime error; a tensor-map
// encoding failure returns 10000 plus its CUresult.
int oryx_topk_dot_partial_f32(const void* xs, const void* y, float* part_v,
                              int* part_i, int B, int n_items, int F,
                              int pitch, int x_pitch, int kb, int n_splits,
                              int split_len, void* stream) {
  return launch_partial<float>(xs, y, nullptr, part_v, part_i, B, n_items, F,
                               pitch, x_pitch, kb, n_splits, split_len, stream);
}

int oryx_topk_dot_partial_bf16(const void* xs, const void* y, float* part_v,
                               int* part_i, int B, int n_items, int F,
                               int pitch, int x_pitch, int kb, int n_splits,
                               int split_len, void* stream) {
  return launch_partial<__nv_bfloat16>(xs, y, nullptr, part_v, part_i, B,
                                       n_items, F, pitch, x_pitch, kb,
                                       n_splits, split_len, stream);
}

int oryx_topk_dot_partial_i8(const void* xs, const void* y,
                             const float* scales, float* part_v, int* part_i,
                             int B, int n_items, int F, int pitch, int x_pitch,
                             int kb, int n_splits, int split_len,
                             void* stream) {
  return launch_partial<int8_t>(xs, y, scales, part_v, part_i, B, n_items, F,
                                pitch, x_pitch, kb, n_splits, split_len,
                                stream);
}

int oryx_topk_merge(const float* part_v, const int* part_i, float* out_v,
                    int* out_i, int B, int S, int kb, int k, void* stream) {
  if (B < 1 || S < 1 || S > 65535 || kb < 1 || kb > kMaxKb || k < 1 ||
      k > kb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 512 threads a row while the rows fill the card's threads, fewer
  // beyond, so that a large batch still runs in about one wave
  static const int resident = [] {
    int dev = 0, sms = 132, per_sm = 2048;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    }
    cudaGetLastError();
    return sms * per_sm;
  }();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = B;
  if (rows * 512 <= resident) {
    topk_merge_kernel<512><<<B, 512, 0, st>>>(part_v, part_i, out_v, out_i, B, S, kb, k);
  } else if (rows * 256 <= resident) {
    topk_merge_kernel<256><<<B, 256, 0, st>>>(part_v, part_i, out_v, out_i, B, S, kb, k);
  } else {
    topk_merge_kernel<128><<<B, 128, 0, st>>>(part_v, part_i, out_v, out_i, B, S, kb, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
