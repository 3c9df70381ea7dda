// Brute-force Hamming matching with a fused top-2 on Hopper's int8 tensor
// cores (sm_90a, wgmma).
//
// Replaces opencalibration_tpu/ops/hamming_pallas.py::_match_kernel, the
// Pallas TPU kernel that unpacks the packed descriptors to +-1 int8, takes
// similarities from MXU products, and keeps a running best / second / argmin
// per set-1 row so the [N1, N2] distance matrix never reaches memory. Here the
// same +-1 product runs on the tensor cores:
//
//   sim = sum_k a_k * b_k over 512 int8 lanes (exact int32 accumulation),
//   a_k, b_k = +-1 for the 486 real bits of each descriptor,
//   distance = (486 - sim) / 2, exact because 486 - sim is even.
//
// The 26 padding lanes carry set 2's validity instead of bits (see PAD_*), so
// garbage padding never counts and the scan needs no valid flags.
//
// What bounds it on this card: int8 tensor-core operations. A batch of P pairs
// does P * N1 * N2 * 512 multiply-adds (2 ops each): 1.80e11 ops at the
// calibration step's [42, 2048, 2048], 0.091 ms at the H100's 1,979 int8
// TOP/s, against 12 MB of device traffic (3.6 us at 3.35 TB/s). The design:
//
// - A block of two warpgroups (256 threads) owns 128 set-1 rows. Their packed
//   words are expanded once to int8 in shared memory (64 KB, K-major,
//   128-byte swizzle), 64 rows per warpgroup.
// - Set 2 streams through in tiles of 128 descriptors. Their packed words
//   (8 KB) are copied with cp.async into a two-tile ring a whole tile ahead;
//   each tile is expanded to int8 (64 KB) into one of two shared-memory
//   buffers while the tensor cores work on the other, and is shared by both
//   warpgroups, i.e. by 128 set-1 rows.
// - Each warpgroup issues 16 wgmma.m64n128k32.s32.s8.s8 per tile (512 of
//   depth). Its top-2 scan is in registers: each thread holds 2 rows x 32
//   columns of every tile, turns each similarity into a key that also orders
//   by column, and keeps a running top-2 of keys (3 operations a column). The
//   4 threads that share a row merge at the end with an order-independent
//   rule (below), so the result is bit-identical run to run.
// - Shared memory bandwidth is the tight resource next to the tensor cores:
//   per tile the two warpgroups' wgmma read 192 KB of operands and the
//   expansion writes 64 KB, about 2,000 cycles at 128 bytes a cycle, as long
//   as the tile's 2,048 cycles of MMA. The scan and the block barrier per
//   tile are not overlapped with the MMA.
// - One block fills an SM (about 211 KB of shared memory). When blocks are
//   few or the last round of blocks is short, set 2 is split over S blocks of
//   one thread-block cluster (the launch picks S from the shape). Each writes
//   its partial top-2 to its own shared memory and the cluster's first block
//   merges them, in increasing split order, through distributed shared
//   memory: no scratch memory, and the entry point keeps its signature.
//
// Contract (bit-exact with the plain version, hamming.py
// hamming_top2_reference): ties go to the lowest set-2 index and a tie for
// best leaves second == best; invalid columns are never chosen; a row with no
// valid column returns best = second = SENTINEL and idx 0. Merging two partial
// results of disjoint column sets:
//   best = min(best_a, best_b); idx = the lower index among the sides whose
//   best equals it; second = min(second_a, second_b, max(best_a, best_b)).

#include <algorithm>
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WORDS = 16;            // 512 padded bits
constexpr int REAL_BITS = 486;
constexpr int ROWS = 128;            // set-1 rows per block (two warpgroups)
constexpr int COLS = 128;            // set-2 descriptors per tile (wgmma N)
constexpr int THREADS = 256;
constexpr int KSTEPS = 16;           // 512 bytes of depth / 32 per wgmma
constexpr int KBLOCK = 128;          // bytes of depth per 128-byte swizzle row
constexpr int TILE_BYTES = 128 * 512;  // one expanded 128 x 512 int8 operand
constexpr int PACKED_BYTES = COLS * WORDS * 4;  // one packed set-2 tile (8 KB)
constexpr int SENTINEL = 1024;       // 2 * padded bits, as the reference
// The 26 padding lanes carry validity into the product: set 1 has +1 there,
// a valid set-2 column 0 and an invalid one (or one past N2) -127, so an
// invalid column's similarity is its real one minus 26 * 127, at most
// 486 - 3302 = -2816, below every valid one (>= -486).
constexpr uint32_t PAD_ROW = 0x01010101u;
constexpr uint32_t PAD_INVALID = 0x81818181u;  // -127 in each byte
constexpr int NO_SIM = -1000;  // running similarity of a row with no valid column yet
constexpr int MAX_SPLITS = 8;        // portable thread-block cluster size
// A, two B buffers, two packed tiles, the partial results, 1 KB alignment
constexpr int SMEM_BYTES = 3 * TILE_BYTES + 2 * PACKED_BYTES + ROWS * 3 * 4 + 1024;

struct Top2 {
  int best, second, idx;
};

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  Top2 r;
  r.best = min(a.best, b.best);
  r.idx = a.best < b.best ? a.idx : (b.best < a.best ? b.idx : min(a.idx, b.idx));
  r.second = min(min(a.second, b.second), max(a.best, b.best));
  return r;
}

// 32 bits -> 32 bytes of +-1 (bit k -> byte k: 1 -> 0x01, 0 -> 0xFF)
__device__ __forceinline__ void expand_word(uint32_t w, uint32_t (&o)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // the 4 bits of nibble j into the low bit of 4 bytes (shifts 0, 7, 14,
    // 21 do not overlap, so the product carries nothing between bytes)
    const uint32_t b = (((w >> (4 * j)) & 0xFu) * 0x00204081u) & 0x01010101u;
    o[j] = b | ((b ^ 0x01010101u) * 0xFFu);
  }
}

// byte offset of 16-byte chunk `chunk` (0..31 along the 512-byte depth) of
// operand row `r` in the K-major, 128-byte-swizzled layout: 4 blocks of
// [128 rows x 128 bytes], 16-byte chunks XOR-ed with the row's index mod 8
__device__ __forceinline__ uint32_t swizzled(int r, int chunk) {
  const int kb = chunk >> 3, c = chunk & 7;
  return kb * (ROWS * KBLOCK) + r * KBLOCK + ((c ^ (r & 7)) << 4);
}

// the 8 packed words w0..w0+7 of operand row r -> 256 bytes of int8, with
// `pad` (4 bytes) in the 26 padding lanes
__device__ __forceinline__ void store_expanded(uint8_t* base, int r, int w0, uint4 lo, uint4 hi, uint32_t pad) {
  const uint32_t words[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t o[8];
    expand_word(words[k], o);
    if (w0 + k == WORDS - 1) {
      // real bits 480..485 are bits 0..5 of the last word: the rest is padding
      o[1] = (o[1] & 0x0000FFFFu) | (pad & 0xFFFF0000u);
#pragma unroll
      for (int j = 2; j < 8; ++j) o[j] = pad;
    }
    const int chunk = 2 * (w0 + k);
    *reinterpret_cast<uint4*>(base + swizzled(r, chunk)) = make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(base + swizzled(r, chunk + 1)) = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t descriptor(uint32_t saddr) {
  uint64_t d = 0;
  d |= (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset (unused when swizzled)
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// D = A * B^T for one warpgroup: A 64 x 32 and B 128 x 32 int8 in shared
// memory, D 64 x 128 int32 in registers. `wgmma_first` starts a sum (its
// accumulators are outputs only, so they hold nothing live before it);
// `wgmma_next` adds to it.
#define WGMMA_M64N128K32                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
  "%64, %65, p;\n}\n"
#define WGMMA_D(M)                                                                                   \
  M(d[0]), M(d[1]), M(d[2]), M(d[3]), M(d[4]), M(d[5]), M(d[6]), M(d[7]), M(d[8]), M(d[9]),          \
      M(d[10]), M(d[11]), M(d[12]), M(d[13]), M(d[14]), M(d[15]), M(d[16]), M(d[17]), M(d[18]),      \
      M(d[19]), M(d[20]), M(d[21]), M(d[22]), M(d[23]), M(d[24]), M(d[25]), M(d[26]), M(d[27]),      \
      M(d[28]), M(d[29]), M(d[30]), M(d[31]), M(d[32]), M(d[33]), M(d[34]), M(d[35]), M(d[36]),      \
      M(d[37]), M(d[38]), M(d[39]), M(d[40]), M(d[41]), M(d[42]), M(d[43]), M(d[44]), M(d[45]),      \
      M(d[46]), M(d[47]), M(d[48]), M(d[49]), M(d[50]), M(d[51]), M(d[52]), M(d[53]), M(d[54]),      \
      M(d[55]), M(d[56]), M(d[57]), M(d[58]), M(d[59]), M(d[60]), M(d[61]), M(d[62]), M(d[63])
#define OUT_ONLY(x) "=r"(x)
#define IN_OUT(x) "+r"(x)

__device__ __forceinline__ void wgmma_first(uint32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(WGMMA_M64N128K32 : WGMMA_D(OUT_ONLY) : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_next(uint32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(WGMMA_M64N128K32 : WGMMA_D(IN_OUT) : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 16 bytes global -> shared, asynchronously; `bytes` = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's generic-proxy shared-memory writes visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving other reads or writes of the accumulators
// across this point (they belong to the asynchronous wgmma between issue and
// wait)
__device__ __forceinline__ void fence_operands(uint32_t (&acc)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+r"(acc[j])::"memory");
}

// 16 k-steps of one warpgroup's 64 rows against a 128-column tile
__device__ __forceinline__ void mma_tile(uint32_t (&acc)[64], uint32_t a_saddr, uint32_t b_saddr) {
  wgmma_fence();
  wgmma_first(acc, descriptor(a_saddr), descriptor(b_saddr));
#pragma unroll
  for (int s = 1; s < KSTEPS; ++s) {
    const uint32_t off = (s >> 2) * (ROWS * KBLOCK) + (s & 3) * 32;
    wgmma_next(acc, descriptor(a_saddr + off), descriptor(b_saddr + off));
  }
  wgmma_commit();
  fence_operands(acc);
}

// A row's running result in similarity space: the best and second-best
// similarity (largest first) and the best's column.
struct Run {
  int best, second, idx;
};

// accumulator register j = 4 * b + 2 * i + p holds row 16 * warp + lane / 4 +
// 8 * i and column 8 * b + 2 * (lane % 4) + p of the warpgroup's 64 x 128 tile.
// Within the tile each similarity becomes a key sim * 128 + (127 - column), so
// the largest key is the largest similarity at the lowest column, and a
// running top-2 of keys takes 3 operations a column; the tile's top-2 then
// joins the row's running result (the tile's columns all come later).
__device__ __forceinline__ void scan_tile(const uint32_t (&acc)[64], int col0, int q, Run (&run)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int kb = INT_MIN, ks = INT_MIN;
#pragma unroll
    for (int b = 0; b < COLS / 8; ++b) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int key = static_cast<int>(acc[4 * b + 2 * i + p]) * COLS + (COLS - 1 - 8 * b - p - 2 * q);
        ks = max(ks, min(kb, key));
        kb = max(kb, key);
      }
    }
    const int tb = kb >> 7, ts = ks >> 7;  // floor: the low 7 bits are the column part
    run[i].idx = tb > run[i].best ? col0 + COLS - 1 - (kb & (COLS - 1)) : run[i].idx;
    run[i].second = max(max(run[i].second, ts), min(run[i].best, tb));
    run[i].best = max(run[i].best, tb);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
hamming_top2_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    const uint8_t* __restrict__ valid2, int n1, int n2, int tiles_per_split,
                    int32_t* __restrict__ best_out, int32_t* __restrict__ second_out,
                    int32_t* __restrict__ idx_out) {
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t raw_saddr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  uint8_t* smem = smem_raw + ((1024 - (raw_saddr & 1023)) & 1023);  // swizzle atoms are 1 KB
  uint8_t* a_tile = smem;
  uint8_t* b_tiles = smem + TILE_BYTES;  // two buffers
  uint8_t* packed = smem + 3 * TILE_BYTES;  // two packed tiles
  Top2* partial = reinterpret_cast<Top2*>(packed + 2 * PACKED_BYTES);
  const uint32_t a_saddr = static_cast<uint32_t>(__cvta_generic_to_shared(a_tile));
  const uint32_t b_saddr = static_cast<uint32_t>(__cvta_generic_to_shared(b_tiles));

  const int tid = threadIdx.x;
  const int split = blockIdx.x;  // == the block's rank in its cluster
  const int row0 = blockIdx.y * ROWS;
  const int pair = blockIdx.z;
  const uint4* a_p = a + (size_t)pair * n1 * (WORDS / 4);
  const uint4* b_p = b + (size_t)pair * n2 * (WORDS / 4);
  const uint8_t* v_p = valid2 + (size_t)pair * n2;

  const int n_tiles = (n2 + COLS - 1) / COLS;
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);
  const int T = max(0, tile_end - tile_begin);

  // expansion: thread -> (operand row tid / 2, words 8 * (tid % 2) .. + 7)
  const int er = tid >> 1, ew = 8 * (tid & 1);
  {
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    if (row0 + er < n1) {
      const uint4* src = a_p + (size_t)(row0 + er) * (WORDS / 4) + ew / 4;
      lo = src[0];
      hi = src[1];
      store_expanded(a_tile, er, ew, lo, hi, PAD_ROW);
    } else {
      // rows past N1 are all zero: no real bit
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < 16; ++k) *reinterpret_cast<uint4*>(a_tile + swizzled(er, 2 * ew + k)) = z;
    }
  }

  // Set 2's packed words go through a two-tile ring in shared memory: each
  // thread copies its own 32 bytes of tile t + 2 with cp.async while tile t + 1
  // is expanded, and reads back only what it copied, so the ring needs no
  // barrier of its own.
  const uint32_t packed_saddr = static_cast<uint32_t>(__cvta_generic_to_shared(packed)) + tid * 32;
  auto prefetch = [&](int t) {
    const int col = (tile_begin + t) * COLS + er;
    const bool in = t < T && col < n2;
    const uint4* src = in ? b_p + (size_t)col * (WORDS / 4) + ew / 4 : b;
    const uint32_t dst = packed_saddr + (t & 1) * PACKED_BYTES;
    cp_async16(dst, src, in ? 16 : 0);
    cp_async16(dst + 16, in ? src + 1 : src, in ? 16 : 0);
    cp_async_commit();
  };
  // tile t: packed ring -> expanded buffer t & 1, validity in the padding
  auto stage = [&](int t) {
    const int col = (tile_begin + t) * COLS + er;
    const bool valid = col < n2 && v_p[col];
    cp_async_wait<1>();  // this thread's copy of tile t has landed
    const uint4* src = reinterpret_cast<const uint4*>(packed + (t & 1) * PACKED_BYTES + tid * 32);
    store_expanded(b_tiles + (t & 1) * TILE_BYTES, er, ew, src[0], src[1], valid ? 0u : PAD_INVALID);
    prefetch(t + 2);  // into the slot just read
  };

  if (T > 0) {
    prefetch(0);
    prefetch(1);
    stage(0);
  }
  fence_async_shared();
  __syncthreads();

  const int wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = wtid % 32, q = lane % 4;
  const uint32_t a_wg = a_saddr + wg * 64 * KBLOCK;  // this warpgroup's 64 rows
  Run run[2] = {{NO_SIM, NO_SIM, 0}, {NO_SIM, NO_SIM, 0}};
  uint32_t acc[64];  // the first k-step of a tile overwrites it

  // per tile: expand tile t + 1 while the tensor cores run tile t, then scan
  // tile t and start tile t + 1 once every warpgroup has its buffer
  if (T > 0) {
    mma_tile(acc, a_wg, b_saddr);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) stage(t + 1);
      fence_async_shared();
      wgmma_wait<0>();
      fence_operands(acc);
      scan_tile(acc, (tile_begin + t) * COLS, q, run);
      __syncthreads();  // tile t + 1 is staged; tile t's buffer is free
      if (t + 1 < T) mma_tile(acc, a_wg, b_saddr + ((t + 1) & 1) * TILE_BYTES);
    }
  }

  // to distances, then merged over the 4 threads of a row and the splits of
  // the cluster
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    Top2 top;
    top.best = run[i].best > NO_SIM ? (REAL_BITS - run[i].best) >> 1 : SENTINEL;
    top.second = run[i].second > NO_SIM ? (REAL_BITS - run[i].second) >> 1 : SENTINEL;
    top.idx = run[i].idx;
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      Top2 o;
      o.best = __shfl_xor_sync(0xFFFFFFFFu, top.best, m);
      o.second = __shfl_xor_sync(0xFFFFFFFFu, top.second, m);
      o.idx = __shfl_xor_sync(0xFFFFFFFFu, top.idx, m);
      top = merge(top, o);
    }
    if (q == 0) partial[wg * 64 + warp * 16 + lane / 4 + 8 * i] = top;
  }
  cluster.sync();
  if (split == 0 && tid < ROWS) {
    Top2 r = partial[tid];
    for (int s = 1; s < (int)cluster.num_blocks(); ++s) r = merge(r, cluster.map_shared_rank(partial, s)[tid]);
    const int row = row0 + tid;
    if (row < n1) {
      const size_t o = (size_t)pair * n1 + row;
      best_out[o] = r.best;
      second_out[o] = r.second;
      idx_out[o] = r.idx;
    }
  }
  cluster.sync();  // the other blocks' shared memory stays until it is read
}

}  // namespace

// a [P, n1, 16] and b [P, n2, 16] packed words (16-byte aligned), valid2
// [P, n2] bytes, outputs [P, n1] int32. Launches on `stream` and returns
// cudaGetLastError() (0 on success). Does not synchronise.
extern "C" int hamming_top2_launch(const void* a, const void* b, const void* valid2, int pairs, int n1,
                                   int n2, void* best, void* second, void* idx, void* stream) {
  if (pairs <= 0 || n1 <= 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaError_t err = cudaFuncSetAttribute(hamming_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);

  // Split set 2 over S blocks of a cluster where that shortens the launch.
  // One block fills an SM, so a launch takes rounds(S) = ceil(blocks * S /
  // SMs) rounds of (its tiles + about one tile of set-1 expansion and set-up)
  // each; take the S that minimises the product (the smallest on a tie).
  const int row_tiles = (n1 + ROWS - 1) / ROWS;
  const int n_tiles = (n2 + COLS - 1) / COLS;
  const long blocks = (long)row_tiles * pairs;
  int splits = 1, tiles_per_split = n_tiles;
  long best_cost = -1;
  for (int s = 1; s <= std::min(MAX_SPLITS, std::max(n_tiles, 1)); ++s) {
    const int tps = (n_tiles + s - 1) / s;
    const int used = tps ? (n_tiles + tps - 1) / tps : 1;  // no empty split
    const long cost = ((blocks * used + sms - 1) / sms) * (tps + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      splits = used;
      tiles_per_split = tps;
    }
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, row_tiles, pairs);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, hamming_top2_kernel, static_cast<const uint4*>(a), static_cast<const uint4*>(b),
                           static_cast<const uint8_t*>(valid2), n1, n2, tiles_per_split,
                           static_cast<int32_t*>(best), static_cast<int32_t*>(second), static_cast<int32_t*>(idx));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
