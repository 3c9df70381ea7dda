// Brute-force Hamming matching with a fused top-2, for Hopper (sm_90a).
//
// Replaces opencalibration_tpu/ops/hamming_pallas.py::_match_kernel, the
// Pallas TPU kernel that streams set 2 through VMEM and keeps a running
// best / second / argmin per set-1 row so the [N1, N2] distance matrix never
// reaches memory. The TPU version unpacks the words to +-1 int8 and takes
// distances from MXU products; here each distance is XOR + __popc over the
// 16 packed words, the reference's own form (ops/hamming.py
// hamming_matrix_popcount), which is integer-exact.
//
// What bounds it on this card: integer throughput. A batch of P pairs costs
// P * N1 * N2 * 16 XOR + popcount pairs (42 * 2048 * 2048 * 16 = 2.8e9 on the
// calibration main path) while it reads only (N1 + N2) * 64 bytes per pair
// from device memory, so it is far from the bandwidth roof. The design keeps
// the work on the integer pipes: one thread per set-1 row holds its 16 words
// in registers, a block of ROWS threads stages COLS set-2 descriptors (plus
// their valid flags) in shared memory, and every thread of a warp reads the
// same shared word at once (a broadcast, no bank conflicts). Only the three
// [N1] results are written. Tensor cores (an int8 +-1 MMA, wgmma/TMA) are
// not used yet.
//
// Contract (bit-exact with the plain version, hamming.py
// hamming_top2_reference): columns are scanned in increasing index with a
// strict '<', so ties go to the lowest index and a tie for best leaves
// second == best; invalid columns are never chosen; best and second start at
// SENTINEL with idx 0, which is what a row with no valid column returns.
// Bits above the 486 real ones (the top 26 bits of word 15) are masked out of
// every XOR, so garbage in the padding never counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 16;                 // 512 padded bits
constexpr int ROWS = 128;                 // set-1 rows per block = threads
constexpr int COLS = 128;                 // set-2 descriptors per smem tile
constexpr uint32_t LAST_WORD_MASK = (1u << 6) - 1u;  // 486 = 15 * 32 + 6
constexpr int SENTINEL = 1024;            // 2 * padded bits, as the reference

__global__ void __launch_bounds__(ROWS)
hamming_top2_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    const uint8_t* __restrict__ valid2, int n1, int n2,
                    int32_t* __restrict__ best_out,
                    int32_t* __restrict__ second_out,
                    int32_t* __restrict__ idx_out) {
  __shared__ uint4 tile[COLS][WORDS / 4];  // 8 KiB
  __shared__ uint8_t tile_valid[COLS];

  const int pair = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x;
  const uint4* a_p = a + (size_t)pair * n1 * (WORDS / 4);
  const uint4* b_p = b + (size_t)pair * n2 * (WORDS / 4);
  const uint8_t* v_p = valid2 + (size_t)pair * n2;

  uint32_t q[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS / 4; ++w) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n1) v = a_p[(size_t)row * (WORDS / 4) + w];
    q[4 * w + 0] = v.x;
    q[4 * w + 1] = v.y;
    q[4 * w + 2] = v.z;
    q[4 * w + 3] = v.w;
  }

  int best = SENTINEL, second = SENTINEL, idx = 0;
  for (int c0 = 0; c0 < n2; c0 += COLS) {
    const int ncol = min(COLS, n2 - c0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < COLS * (WORDS / 4); i += ROWS) {
      const int c = i / (WORDS / 4), w = i % (WORDS / 4);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < ncol) v = b_p[(size_t)(c0 + c) * (WORDS / 4) + w];
      tile[c][w] = v;
    }
    for (int c = threadIdx.x; c < COLS; c += ROWS)
      tile_valid[c] = c < ncol ? v_p[c0 + c] : 0;
    __syncthreads();

    for (int c = 0; c < ncol; ++c) {
      if (!tile_valid[c]) continue;  // uniform across the block
      int d = 0;
#pragma unroll
      for (int w = 0; w < WORDS / 4 - 1; ++w) {
        const uint4 t = tile[c][w];
        d += __popc(q[4 * w + 0] ^ t.x) + __popc(q[4 * w + 1] ^ t.y) +
             __popc(q[4 * w + 2] ^ t.z) + __popc(q[4 * w + 3] ^ t.w);
      }
      const uint4 t = tile[c][WORDS / 4 - 1];
      d += __popc(q[12] ^ t.x) + __popc(q[13] ^ t.y) + __popc(q[14] ^ t.z) +
           __popc((q[15] ^ t.w) & LAST_WORD_MASK);
      if (d < best) {
        second = best;
        best = d;
        idx = c0 + c;
      } else if (d < second) {
        second = d;
      }
    }
  }

  if (row < n1) {
    const size_t o = (size_t)pair * n1 + row;
    best_out[o] = best;
    second_out[o] = second;
    idx_out[o] = idx;
  }
}

}  // namespace

// a [P, n1, 16] and b [P, n2, 16] packed words (16-byte aligned), valid2
// [P, n2] bytes, outputs [P, n1] int32. Launches on `stream` and returns
// cudaGetLastError() (0 on success). Does not synchronise.
extern "C" int hamming_top2_launch(const void* a, const void* b,
                                   const void* valid2, int pairs, int n1,
                                   int n2, void* best, void* second, void* idx,
                                   void* stream) {
  if (pairs <= 0 || n1 <= 0) return 0;
  const dim3 grid((n1 + ROWS - 1) / ROWS, pairs);
  hamming_top2_kernel<<<grid, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<const uint8_t*>(valid2), n1, n2,
      static_cast<int32_t*>(best), static_cast<int32_t*>(second),
      static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
