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
//   from device memory about once and from L2 for the rest. Each block
//   stages its 32 query rows in shared memory and walks its contiguous item
//   range in ascending tiles of 128 items, scoring every (row, item) pair:
//   - bf16 and int8 (the serving views): on the tensor cores, mma.sync
//     m16n8k16 bf16 -> f32 and m16n8k32 s8 -> s32; each warp scores 16
//     items against the 32 rows. The int32 sums are exact, converted to
//     f32 and multiplied by the item scale before selection, so int8
//     scores are bit-identical to the plain version's. Each thread reads
//     its B fragments straight from the catalog through L1 at the row's
//     own alignment, with zeros past the row's end; the query fragments
//     come from a zero-padded, bank-staggered shared block.
//   - f32: on the CUDA cores (full f32 FMA, no TF32), each thread scoring
//     one item against 16 rows from a transposed query block, with each Y
//     tile staged in shared memory.
//   A score enters a row's candidate buffer only if it beats that row's
//   current kb-th entry; since tiles are visited in ascending index order,
//   a strict '>' against the kb-th value is exact under (value desc, index
//   asc). One warp per row then inserts the candidates into the row's
//   sorted top-kb list, written out as one sorted partial [S, B, kb]
//   (values f32, indices int32; unfilled slots hold (-inf, -1)).
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
// the bf16 catalog is 100 MB (about 30 us to read) and the dot is
// 51 GFLOP (about 52 us on the tensor cores); int8 halves both. Y is read
// in place at its real F (50 is not a multiple of 8 or 16; the kernel masks
// ragged rows and features itself instead of a per-dispatch padded copy of
// the catalog). Measured (PERF.md, ops/topk_probe.py), the kernel is far
// from that bound and bound by instruction issue: per tile each thread
// spends more instructions on 4-byte fragment loads and their masking than
// on the MMAs, then on the selection compares and two block barriers.
// Wider, permuted fragment loads from a TMA-fed shared tile and wgmma are
// the next step; shared staging with cp.async and holding the query
// fragments in registers were tried and lost (more registers, fewer
// resident blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;  // query rows staged per block
constexpr int kTileItems = 128;    // items scored per tile
constexpr int kMaxKb = 128;
constexpr int kMergeSlots = 256;   // teams * kb in topk_merge

// f32 kernel: each thread scores one item against 16 rows
constexpr int kRowsPerThread = kRowsPerBlock * kTileItems / kThreads;  // 16
constexpr int kChunkWords = 64;    // feature words staged per Y tile pass
static_assert(kRowsPerThread == 16, "the inner loop reads 4 x float4 of queries");

// MMA kernel: each warp scores 16 items (two n8 tiles) against the 32 rows
// (two m16 tiles)
static_assert(kWarps * 16 == kTileItems, "one warp per 16 items of a tile");
static_assert(kRowsPerBlock == 32, "two m16 tiles of rows");

// Phase switches for the ablation in ops/topk_probe.py; a served build sets
// none. Each, defined to 1, compiles one phase out: the tensor-core dot loop,
// the selection of a tile's scores, the insertion of candidates.
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
// selection state shared by both partial kernels
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
                            int F, int kb, int split_len) {
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
            item < end ? y[static_cast<size_t>(item) * F + c0 + tw] : 0.0f;
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
// bf16 / int8 partial kernel (tensor cores)
// ---------------------------------------------------------------------------

// Query rows sit in shared memory at their own type, padded with zeros to a
// whole number of MMA k-steps (8 words: 16 bf16 or 32 int8), plus 4 words so
// that the 8 rows one fragment load touches start in distinct bank groups.
__host__ __device__ int mma_row_words(int F, int elem_bytes) {
  const int words = (F * elem_bytes + 3) / 4;
  return (words + 7) / 8 * 8;
}

size_t mma_smem_bytes(int F, int kb, int elem_bytes) {
  const int st = mma_row_words(F, elem_bytes) + 4;
  return 4 * static_cast<size_t>(kRowsPerBlock) * st + lists_bytes(kb);
}

__device__ __forceinline__ void mma_16x8(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_16x8(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Word w (features packed at the row's own type) of an item row of
// row_bytes, zero past the row's end. A row is aligned to the widest of 4,
// 2 and 1 bytes that divides row_bytes, and read at that width.
__device__ __forceinline__ uint32_t row_word(const unsigned char* row, int w,
                                             int row_bytes) {
  const int b = 4 * w;
  if (b + 4 <= row_bytes) {
    if ((row_bytes & 3) == 0) {
      return __ldg(reinterpret_cast<const unsigned int*>(row + b));
    }
    if ((row_bytes & 1) == 0) {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(row + b);
      return __ldg(h) | (static_cast<uint32_t>(__ldg(h + 1)) << 16);
    }
  }
  uint32_t v = 0;
  for (int t = 0; t < 4 && b + t < row_bytes; ++t) {
    v |= static_cast<uint32_t>(__ldg(row + b + t)) << (8 * t);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_dot_partial_mma_kernel(const T* __restrict__ xs,
                            const T* __restrict__ y,
                            const float* __restrict__ scales,
                            float* __restrict__ part_v,
                            int* __restrict__ part_i, int B, int n_items,
                            int F, int kb, int split_len) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  using Raw = typename std::conditional<kInt8, uint8_t, uint16_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kw = mma_row_words(F, sizeof(T));
  const int st = kw + 4;  // words; st = 4 (mod 8)
  const int row_elems = st * 4 / static_cast<int>(sizeof(T));
  const int kpad = kw * 4 / static_cast<int>(sizeof(T));

  uint32_t* qs = reinterpret_cast<uint32_t*>(smem);  // [32][st]
  const Lists L = carve_lists(qs + kRowsPerBlock * st, kb);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int split = blockIdx.y;
  const long long start = static_cast<long long>(split) * split_len;
  const long long stop_ll = start + split_len;
  const long long end = stop_ll < n_items ? stop_ll : n_items;

  // stage the query block, zero past F and past B
  const Raw* xr = reinterpret_cast<const Raw*>(xs);
  Raw* qe = reinterpret_cast<Raw*>(qs);
  for (int e = tid; e < kRowsPerBlock * kpad; e += kThreads) {
    const int r = e / kpad;
    const int f = e % kpad;
    const int grow = row0 + r;
    qe[r * row_elems + f] =
        (grow < B && f < F) ? xr[static_cast<size_t>(grow) * F + f] : Raw(0);
  }
  init_lists(L, kb, tid);
  __syncthreads();

  const int row_bytes = F * static_cast<int>(sizeof(T));
  const unsigned char* ybytes = reinterpret_cast<const unsigned char*>(y);
  const int g = lane / 4;   // fragment row / column group
  const int tg = lane % 4;  // word within a k-step's half
  const int n0 = warp * 16;

  for (long long base = start; base < end; base += kTileItems) {
    const int n_tile = static_cast<int>(end - base < kTileItems ? end - base
                                                                : kTileItems);
    // this warp: rows 0..31 (m tiles mt) x items n0..n0+15 (n tiles nt).
    // Fragment words (PTX ISA, mma.m16n8k16 / m16n8k32): A rows g and
    // g + 8, words tg and tg + 4 of the k-step; B item g, the same words,
    // read straight from the catalog (L1 / L2) with no shared staging
    const unsigned char* yrow[2];
    bool live[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int local = n0 + nt * 8 + g;
      live[nt] = local < n_tile;
      yrow[nt] = ybytes + (base + local) * row_bytes;
    }
    Acc c[2][2][4] = {};
#pragma unroll 4
    for (int w0 = 0; w0 < (ORYX_PROBE_NO_DOT ? 0 : kw); w0 += 8) {
      const int w = w0 + tg;
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        b[nt][0] = live[nt] ? row_word(yrow[nt], w, row_bytes) : 0u;
        b[nt][1] = live[nt] ? row_word(yrow[nt], w + 4, row_bytes) : 0u;
      }
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* q0 = qs + (mt * 16 + g) * st;
        const uint32_t* q8 = q0 + 8 * st;
        a[mt][0] = q0[w];
        a[mt][1] = q8[w];
        a[mt][2] = q0[w + 4];
        a[mt][3] = q8[w + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_16x8(c[mt][nt], a[mt], b[nt][0], b[nt][1]);
        }
      }
    }

    // accumulator (mt, nt, r): row mt*16 + g + 8*(r / 2), item
    // n0 + nt*8 + 2*tg + r % 2. A thread's scores fall in 4 rows, so it
    // reads those rows' thresholds once.
    float thr[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        thr[mt][hr] = L.lv[(mt * 16 + g + 8 * hr) * kb + kb - 1];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int local = n0 + nt * 8 + 2 * tg + h;
        if (!ORYX_PROBE_NO_SELECT && local < n_tile) {
          const int item = static_cast<int>(base) + local;
          float scale = 1.0f;
          if constexpr (kInt8) scale = scales[item];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int row = mt * 16 + g + 8 * hr;
              const Acc acc = c[mt][nt][2 * hr + h];
              const float s = kInt8 ? static_cast<float>(acc) * scale
                                    : static_cast<float>(acc);
              if (row0 + row < B && s > thr[mt][hr]) push(L, row, s, item);
            }
          }
        }
      }
    }
    __syncthreads();
    insert_candidates(L, kb, warp, lane);
    __syncthreads();
  }
  write_partials(L, part_v, part_i, B, row0, split, kb, tid);
}

size_t partial_smem_bytes(int F, int kb, int elem_bytes) {
  return elem_bytes == 4 ? fma_smem_bytes(F, kb)
                         : mma_smem_bytes(F, kb, elem_bytes);
}

// Blocks of the partial kernel that fit on one SM at this shared-memory
// size (after raising the kernel's dynamic shared-memory limit to it), or
// minus the CUDA error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return n;
}

template <typename Kernel, typename... Args>
int launch_partial(Kernel kernel, int elem_bytes, int B, int n_items, int F,
                   int kb, int n_splits, int split_len, void* stream,
                   Args... args) {
  if (B < 1 || n_items < 1 || F < 1 || kb < 1 || kb > kMaxKb ||
      n_splits < 1 || split_len < 1 ||
      static_cast<long long>(n_splits) * split_len < n_items ||
      n_splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = partial_smem_bytes(F, kb, elem_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear, then report the attribute failure
    return static_cast<int>(err);
  }
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, n_splits);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args..., B, n_items, F, kb, split_len);
  return static_cast<int>(cudaGetLastError());
}

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

}  // namespace

extern "C" {

// elem_bytes: 4 for f32, 2 for bf16, 1 for int8
int oryx_topk_partial_smem_bytes(int F, int kb, int elem_bytes) {
  return static_cast<int>(partial_smem_bytes(F, kb, elem_bytes));
}

int oryx_topk_partial_blocks_per_sm(int F, int kb, int elem_bytes) {
  const size_t smem = partial_smem_bytes(F, kb, elem_bytes);
  if (elem_bytes == 4) return blocks_per_sm(topk_dot_partial_f32_kernel, smem);
  if (elem_bytes == 2) {
    return blocks_per_sm(topk_dot_partial_mma_kernel<__nv_bfloat16>, smem);
  }
  return blocks_per_sm(topk_dot_partial_mma_kernel<int8_t>, smem);
}

int oryx_topk_dot_partial_f32(const void* xs, const void* y, float* part_v,
                              int* part_i, int B, int n_items, int F, int kb,
                              int n_splits, int split_len, void* stream) {
  return launch_partial(topk_dot_partial_f32_kernel, 4, B, n_items, F, kb,
                        n_splits, split_len, stream,
                        static_cast<const float*>(xs),
                        static_cast<const float*>(y), part_v, part_i);
}

int oryx_topk_dot_partial_bf16(const void* xs, const void* y, float* part_v,
                               int* part_i, int B, int n_items, int F, int kb,
                               int n_splits, int split_len, void* stream) {
  return launch_partial(topk_dot_partial_mma_kernel<__nv_bfloat16>, 2, B,
                        n_items, F, kb, n_splits, split_len, stream,
                        static_cast<const __nv_bfloat16*>(xs),
                        static_cast<const __nv_bfloat16*>(y),
                        static_cast<const float*>(nullptr), part_v, part_i);
}

int oryx_topk_dot_partial_i8(const void* xs, const void* y,
                             const float* scales, float* part_v, int* part_i,
                             int B, int n_items, int F, int kb, int n_splits,
                             int split_len, void* stream) {
  return launch_partial(topk_dot_partial_mma_kernel<int8_t>, 1, B, n_items, F,
                        kb, n_splits, split_len, stream,
                        static_cast<const int8_t*>(xs),
                        static_cast<const int8_t*>(y), scales, part_v, part_i);
}

int oryx_topk_merge(const float* part_v, const int* part_i, float* out_v,
                    int* out_i, int B, int S, int kb, int k, void* stream) {
  if (B < 1 || S < 1 || kb < 1 || kb > kMaxKb || k < 1 || k > kb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  topk_merge_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      part_v, part_i, out_v, out_i, B, S, kb, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
