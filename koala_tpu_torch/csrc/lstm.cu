// One layer-step of an LSTM over many independent rows, with its gates:
//
//   [x_t | h_{t-1}] @ W + b -> i, f, g, o;  c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c')
//
// It replaces no TPU kernel: the JAX package has no LSTM. It serves both
// recurrences of FullSubNet (models/fullsubnet.py): the sub-band LSTM on
// B x 257 rows (hidden 384) and the full-band LSTM on B rows (hidden 512);
// and Demucs's LSTM (models/demucs.py) on B rows at kx = H = 1024.
// Numerics: x and h rounded to bf16 as they enter the product, W bf16, f32
// sums (tensor cores), f32 bias, gates, c and h; the gate functions from the
// fast exponential and division (resident.cuh: about 1e-7 from the exact).
//
// Bound on this card: at the sub-band's 526,336 rows (B = 2048) a layer-step
// is a [526336 x 416] @ [416 x 1536] or [526336 x 768] @ [768 x 1536]
// product, 0.67 or 1.24 TFLOP, beside 3.3 or 4.1 GB of f32 rows and states
// read and written: the first is bound by bytes (0.99 ms), the second by
// operations (1.26 ms). Written unfused, the gates ([rows, 4H] f32) would go
// to device memory and back, another 6.5 GB.
//
// Design: a warp-specialised, persistent wgmma kernel in clusters of two blocks.
//  - Tile. A block holds ROWS rows of [x | 0 | h] in shared memory as bf16
//    (x padded with zeros to kxp, a multiple of 16), the whole depth K, in
//    panels 64 deep laid out in the 128-byte swizzle that wgmma reads. One
//    consumer warpgroup per 64 rows runs wgmma m64n128k16 (bf16 in, f32 sums
//    in registers); a pass is 128 gate columns, the four gates of 32 hidden
//    units, so each thread ends the pass holding i, f, g and o of the same
//    (row, unit) pairs and finishes c' and h' in registers: no gate leaves
//    the SM.
//  - Ring. One producer warp a block streams W through a ring of stages 32
//    deep x 128 columns (8 KB, the 64-byte swizzle) by TMA: each block of
//    the cluster fetches half of every stage and multicasts it into both,
//    each stage is signalled full by an mbarrier's byte count and handed back
//    empty by every consumer warp of both blocks. So each byte of W fetched
//    from L2 serves 2 x ROWS rows, and each block's TMA unit moves half of
//    what its tensor cores read (measured on the card: the ring's delivery
//    into a block, not L2, is what a block's TMA unit limits). W lies in pass
//    order (stack_weights in ops/kernels/lstm.py): row 32 g + 8 q + t of the
//    [4H, K] operand is gate q of unit 8 g + t, so a pass's columns are one
//    box.
//  - Persistent walk. The grid is as many clusters as are resident at once;
//    a cluster walks the work items (pair of row tiles, group of passes)
//    c, c + clusters, ..., its two blocks taking the pair's two tiles. The
//    producers run ahead across passes and tiles, so the ring is full when
//    the consumers come back from a tile's A load and the epilogues.
//  - Tile height from K, never from M. 128 rows (two consumer warpgroups)
//    where the A tile and a ring of at least four stages fit in the 227 KB a
//    block may hold: K = 416 (A 112 KB, 12 stages) and 768 (A 192 KB, 4
//    stages). 64 rows (one warpgroup) where they do not: K = 784 and 1024,
//    the full band, whose 2048 rows are 1% of a frame's work.
//  - K-panels where even 64 rows of the whole depth do not fit: Demucs's
//    LSTM (models/demucs.py), K = 1024 + 1024, whose 64-row A tile would be
//    256 KB. The tile then holds a segment of the depth (seg_chunks stages'
//    worth, 1024 deep at K = 2048: 128 KB and a ring of 12 stages), and each
//    pass walks the depth segment by segment, reloading a segment's rows
//    from L2 (16 chunks of 8 floats in flight a thread) with the sums held
//    in registers; an odd pass walks the segments last first, so it starts
//    on the one the pass before ended on (chunk_at): one reload a pass
//    instead of two at K = 2048. The order of the sums is then the pass's
//    own, never the row count's. At Demucs's 2048 rows on an H100 80GB HBM3
//    (700 W) the reloads are most of the step's time: 0.28 ms without them,
//    0.77 with every segment reloaded each pass, 0.60 with the odd passes
//    reversed; the rest is the ring's delivery of W. A row's sums
//    run over k in 16-deep steps in one order, at any place in any tile, so
//    its bits depend only on its own inputs and the width: a stream's output
//    does not depend on its batch. The split of passes over clusters (plan)
//    follows the shape and changes no row's arithmetic.
//  - What bounds it (measured at 526,336 rows): the ring's delivery of W
//    (about half the time alone), then the tile's A load, f32 rows read and
//    converted to bf16 while the tensor cores wait (at K = 768 there is no
//    room for a second A tile), then the gates' exponentials and divisions
//    on the special function units, likewise not overlapped. Rows and states
//    are read and written with the streaming cache hint (.cs): 4 GB a step
//    pass through L2 once, and left to the default policy they push W out
//    of it (15% of the time at K = 768).
// Launches take no allocation and no host synchronisation (the TMA
// descriptor is a __grid_constant__ parameter), so they can be captured in
// a CUDA graph.

#include <cuda.h>
#include <dlfcn.h>
#include <stdint.h>

#include "resident.cuh"

namespace koala {
namespace {

constexpr int UNITS = 32;                           // hidden units of a pass
constexpr int PASS_N = 4 * UNITS;                   // gate columns of a pass
constexpr int WG_ROWS = 64;                         // rows of a consumer warpgroup
constexpr int PANEL_K = 64;                         // depth of an A panel (128-byte rows)
constexpr int STAGE_K = 32;                         // depth of a W stage (64-byte rows)
constexpr int STAGE_BYTES = PASS_N * STAGE_K * 2;   // 8 KB
constexpr int CLUSTER = 2;                          // blocks that share each W stage
constexpr int SLICE_N = PASS_N / CLUSTER;           // columns of a stage one block fetches
constexpr int MAX_STAGES = 12;
constexpr int MIN_STAGES_128 = 4;                   // a 128-row tile needs this deep a ring
constexpr size_t SMEM_LIMIT = 232448;               // shared memory a block may hold
constexpr size_t SMEM_SLACK = 1024 + 256;           // the carve-out's alignment, the barriers
// A consumer or producer that waits this many polls on one stage traps: a
// fault in the ring's accounting surfaces as an error of the launch.
constexpr unsigned SPIN_LIMIT = 1u << 26;

struct LstmArgs {
  const float* x;       // [M, kx] rows, stride ldx
  const float* h;       // [M, H], stride ldh
  const float* c;       // [M, H], stride ldc
  float* h_out;         // [M, H], stride ldho
  float* c_out;         // [M, H], stride ldco
  const float* bias;    // [4H]: b_ih + b_hh, PyTorch's gate order
  long long ldx, ldh, ldc, ldho, ldco;
  int M, kx, kxp, H;
  int passes_per_block, groups, items, stages;
  int seg_chunks;       // W stages' depth of the A tile: >= chunks holds the whole depth
};

size_t a_bytes(int rows, int K) { return (size_t)((K + PANEL_K - 1) / PANEL_K) * rows * 128; }

int ring_stages(int rows, int K) {
  const long long left = (long long)(SMEM_LIMIT - SMEM_SLACK) - (long long)a_bytes(rows, K);
  if (left < 0) return 0;
  return (int)(left / STAGE_BYTES < MAX_STAGES ? left / STAGE_BYTES : MAX_STAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed; trap
// after SPIN_LIMIT polls. One asm block, so the compiler sees no branch.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .u32 n;\n\tmov.u32 n, 0;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "add.u32 n, n, 1;\n\t"
      "setp.gt.u32 p, n, %2;\n\t"
      "@p trap;\n\t"
      "bra WAIT;\n"
      "DONE:\n\t}"
      :: "r"(bar), "r"(parity), "r"(SPIN_LIMIT) : "memory");
}

// Arrive on the barrier at the same place in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n\t.reg .b32 r;\n\t"
      "mapa.shared::cluster.u32 r, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [r];\n\t}"
      :: "r"(bar), "r"(cta) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// A 2-D box of the tensor map into shared memory at the same place in every
// block of the cluster, its bytes counted on the barrier at `bar` in each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int k, int n) {
  const uint16_t all = (1u << CLUSTER) - 1;
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(bar), "h"(all)
      : "memory");
}

// Every thread of both blocks of the cluster: what each wrote before is
// visible to the other after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// This block's rank in its cluster, the cluster's index and their number.
__device__ __forceinline__ int cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return (int)v;
}
__device__ __forceinline__ int cluster_index() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return (int)v;
}
__device__ __forceinline__ int cluster_count() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(v));
  return (int)v;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// A wgmma operand descriptor: K-major rows in shared memory, swizzled
// (layout 1: 128-byte rows; 2: 64-byte rows), 8-row groups `sbo` bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 128] (+)= A[64 x 16] @ B[16 x 128], both from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A float of the rows: read once (.cs, streaming), or kept in L2 for the
// next pass's reload (.cg) in K-panels.
template <bool ONCE>
__device__ __forceinline__ float4 ld_row4(const float4* p) {
  return ONCE ? __ldcs(p) : __ldcg(p);
}
template <bool ONCE>
__device__ __forceinline__ float ld_row(const float* p) {
  return ONCE ? __ldcs(p) : __ldcg(p);
}

// Columns k0 .. k0 + 7 of row m of [x | 0 | h] as bf16. k0 is a multiple of
// 8, so the eight lie in x and its padding or in h, never in both.
template <bool ONCE>
__device__ __forceinline__ uint4 a_chunk(const LstmArgs& a, long long m, int k0, bool vx,
                                         bool vh) {
  const bool in_h = k0 >= a.kxp;
  const float* src = in_h ? a.h + m * a.ldh + (k0 - a.kxp) : a.x + m * a.ldx + k0;
  float4 p = make_float4(0.f, 0.f, 0.f, 0.f), q = p;
  if (in_h ? vh : vx) {
    if (in_h || k0 < a.kx) {
      p = ld_row4<ONCE>(reinterpret_cast<const float4*>(src));
      q = ld_row4<ONCE>(reinterpret_cast<const float4*>(src) + 1);
    }
  } else {
    const int n = in_h ? 8 : a.kx - k0;   // columns of the eight that exist
    float f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = j < n ? ld_row<ONCE>(src + j) : 0.0f;
    p = make_float4(f[0], f[1], f[2], f[3]);
    q = make_float4(f[4], f[5], f[6], f[7]);
  }
  return make_uint4(pack_bf16(p.x, p.y), pack_bf16(p.z, p.w), pack_bf16(q.x, q.y),
                    pack_bf16(q.z, q.w));
}

// Rows m0 .. m0 + 63 of columns k_lo .. k_lo + depth - 1 of [x | 0 | h]
// into a warpgroup's 64 rows of the A panels as bf16: element (r, k_lo + k)
// in panel k / 64, row r, 16-byte chunk (k % 64) / 8 XOR r % 8 (the 128-byte
// swizzle; k_lo is a multiple of 64). Rows past M, and columns from K on
// (K rounded up to a stage), are zeros. t: the thread's index in its
// warpgroup. U chunks (of 8 floats) a thread are loaded before any is
// stored: 4 for a tile loaded once (32 KB in flight a block of two
// warpgroups), 16 for K-panels, reloaded every pass (64 KB in flight).
template <int U, bool ONCE>
__device__ __forceinline__ void load_a(unsigned char* a_wg, int panel_bytes, const LstmArgs& a,
                                       long long m0, int k_lo, int depth, int t) {
  const int K = a.kxp + a.H, q = depth / 8, n = WG_ROWS * q;
  const bool vx = ((reinterpret_cast<size_t>(a.x) & 15) == 0) && a.ldx % 4 == 0 && a.kx % 8 == 0;
  const bool vh = ((reinterpret_cast<size_t>(a.h) & 15) == 0) && a.ldh % 4 == 0;
  for (int i0 = t; i0 < n; i0 += 128 * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 128;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n) {
        const int r = i / q, k0 = k_lo + (i - r * q) * 8;
        if (m0 + r < a.M && k0 < K) v[u] = a_chunk<ONCE>(a, m0 + r, k0, vx, vh);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 128;
      if (i < n) {
        const int r = i / q, k0 = (i - r * q) * 8;
        const int chunk = ((k0 & (PANEL_K - 1)) >> 3) ^ (r & 7);
        *reinterpret_cast<uint4*>(a_wg + (size_t)(k0 / PANEL_K) * panel_bytes + r * 128 +
                                  chunk * 16) = v[u];
      }
    }
  }
}

// The chunk of W (and of the depth) that step cc of pass p takes. In
// K-panels an odd pass walks the segments last first (each segment's chunks
// in ascending order), so that it starts on the segment the even pass before
// it ended on and the tile holds it already: half the reloads. The order is
// the pass's (its hidden units') alone, never the plan's: a row's bits do not
// depend on the row count. Without K-panels, cc itself.
template <bool SEG>
__device__ __forceinline__ int chunk_at(int cc, int p, int seg_chunks, int chunks) {
  if (!SEG || !(p & 1)) return cc;
  const int nseg = (chunks + seg_chunks - 1) / seg_chunks;
  const int last = chunks - (nseg - 1) * seg_chunks;   // chunks of the last segment
  if (cc < last) return (nseg - 1) * seg_chunks + cc;
  const int r = cc - last;
  return (nseg - 2 - r / seg_chunks) * seg_chunks + r % seg_chunks;
}

// One layer-step. Threads: WGS consumer warpgroups, then one producer warp.
// SEG: the A tile in K-panels (seg_chunks stages deep), reloaded each pass;
// else the whole depth, loaded once a tile.
template <int WGS, bool SEG>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(WGS * 128 + 32, 1)
    lstm_cell_kernel(const __grid_constant__ CUtensorMap w_map, const LstmArgs a) {
  constexpr int ROWS = WGS * WG_ROWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int H = a.H, K = a.kxp + H;
  const int panel_bytes = ROWS * 128;
  const int passes = (H + UNITS - 1) / UNITS, chunks = (K + STAGE_K - 1) / STAGE_K;
  // the A tile holds the whole depth, or seg_chunks stages' worth of it at a time
  const int tile_k = SEG ? a.seg_chunks * STAGE_K : K;
  unsigned char* a_s = smem;
  unsigned char* ring = smem + (size_t)((tile_k + PANEL_K - 1) / PANEL_K) * panel_bytes;
  const int stages = a.stages;
  const uint32_t full0 = smem_u32(ring + (size_t)stages * STAGE_BYTES);
  const uint32_t empty0 = full0 + 8 * stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int rank = cluster_rank(), cluster = cluster_index(), clusters = cluster_count();

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      // every consumer warp of both blocks hands a stage back: both blocks'
      // copies of it are written by each block's producer
      mbar_init(empty0 + 8 * s, CLUSTER * 4 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  if (warp == 4 * WGS) {
    // the producer: its half of each of W's stages, in the order the
    // consumers take them, into both blocks
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];"
                   :: "l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int item = cluster; item < a.items; item += clusters) {
        const int p0 = (item % a.groups) * a.passes_per_block;
        const int p1 = min(passes, p0 + a.passes_per_block);
        for (int p = p0; p < p1; ++p)
          for (int cc = 0; cc < chunks; ++cc) {
            const int c = chunk_at<SEG>(cc, p, a.seg_chunks, chunks);
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            mbar_expect_tx(full0 + 8 * stage, STAGE_BYTES);   // both halves
            tma_load_multicast(smem_u32(ring + (size_t)stage * STAGE_BYTES + rank * SLICE_N * 64),
                               &w_map, full0 + 8 * stage, c * STAGE_K,
                               p * PASS_N + rank * SLICE_N);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
    __syncwarp();
  } else {
    // a consumer warpgroup: 64 rows of the tile
    const int wg = warp >> 2, t = tid & 127;
    unsigned char* a_wg = a_s + wg * WG_ROWS * 128;
    const uint32_t a_addr = smem_u32(a_wg), ring_addr = smem_u32(ring);
    int stage = 0;
    uint32_t phase = 0;

    // the cluster's blocks take its tiles in turn and share each stage of W
    for (int item = cluster; item < a.items; item += clusters) {
      const long long m0 = ((long long)(item / a.groups) * CLUSTER + rank) * ROWS + wg * WG_ROWS;
      const int p0 = (item % a.groups) * a.passes_per_block;
      const int p1 = min(passes, p0 + a.passes_per_block);
      int seg_held = -1;   // the segment of the depth the tile holds (K-panels)
      if (!SEG) {
        named_barrier(1 + wg, 128);   // every warp is done with the last tile's A
        load_a<4, true>(a_wg, panel_bytes, a, m0, 0, chunks * STAGE_K, t);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // visible to wgmma
        named_barrier(1 + wg, 128);
      }

      // this thread's rows (ma, ma + 8) and first unit in each 8-unit group
      const long long ma = m0 + (warp & 3) * 16 + (lane >> 2), mb = ma + 8;
      for (int p = p0; p < p1; ++p) {
        const int u0 = p * UNITS, ub = u0 + 2 * (lane & 3);
        // the pass's bias and c, loaded while the products run
        float2 bias[4][4], cin[4][2];
#pragma unroll
        for (int ug = 0; ug < 4; ++ug) {
          const bool valid = u0 + 8 * ug < H;
          const int u = ub + 8 * ug;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bias[ug][q] = valid ? __ldg(reinterpret_cast<const float2*>(a.bias + q * H + u))
                                : make_float2(0.f, 0.f);
          cin[ug][0] = valid && ma < a.M
                           ? __ldcs(reinterpret_cast<const float2*>(a.c + ma * a.ldc + u))
                           : make_float2(0.f, 0.f);
          cin[ug][1] = valid && mb < a.M
                           ? __ldcs(reinterpret_cast<const float2*>(a.c + mb * a.ldc + u))
                           : make_float2(0.f, 0.f);
        }

        // the sums live only through a pass, so a tile's A load has their registers
        float d[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) d[i] = 0.0f;
        int prev = 0;
        for (int cc = 0; cc < chunks; ++cc) {
          const int c = chunk_at<SEG>(cc, p, a.seg_chunks, chunks);
          const int cl = SEG ? c % a.seg_chunks : c;   // the chunk's place in the tile
          if (SEG && cl == 0 && c / a.seg_chunks != seg_held) {
            // the next segment of the depth: every product reading the tile is done
            if (cc > 0) {
              wgmma_wait<0>();
              fence_acc(d);
            }
            named_barrier(1 + wg, 128);
            load_a<16, false>(a_wg, panel_bytes, a, m0, c * STAGE_K,
                              min(a.seg_chunks, chunks - c) * STAGE_K, t);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            named_barrier(1 + wg, 128);
            seg_held = c / a.seg_chunks;
          }
          mbar_wait(full0 + 8 * stage, phase);
          const uint32_t b_addr = ring_addr + stage * STAGE_BYTES;
          // the chunk's two 16-deep steps (past K, A and W hold zeros)
          const uint32_t a_k = a_addr + (cl >> 1) * panel_bytes + (cl & 1) * 64;
          fence_acc(d);
          wgmma_fence();
          wgmma_m64n128k16(d, smem_desc(a_k, 1024, 1), smem_desc(b_addr, 512, 2), cc > 0);
          wgmma_m64n128k16(d, smem_desc(a_k + 32, 1024, 1), smem_desc(b_addr + 32, 512, 2), 1);
          wgmma_commit();
          fence_acc(d);
          if (cc > 0) {
            wgmma_wait<1>();   // the last chunk's products are done: its stage goes back
            fence_acc(d);
            if (lane < CLUSTER) mbar_arrive_cluster(empty0 + 8 * prev, lane);
          }
          prev = stage;
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_acc(d);
        if (lane < CLUSTER) mbar_arrive_cluster(empty0 + 8 * prev, lane);

        // the cell: d[16 ug + 4 q + 2 half + j] is gate q of unit ub + 8 ug + j
        // in row (half ? mb : ma); computed for every row, stored for those that
        // exist (the accumulators are read on no divergent path)
#pragma unroll
        for (int ug = 0; ug < 4; ++ug) {
          const int u = ub + 8 * ug;
          const bool unit_ok = u0 + 8 * ug < H;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const long long m = half ? mb : ma;
            const int e = 16 * ug + 2 * half;
            const float2 cc = cin[ug][half];
            const float2* bq = bias[ug];
            const float i0 = sigmoid_fast(d[e] + bq[0].x), i1 = sigmoid_fast(d[e + 1] + bq[0].y);
            const float f0 = sigmoid_fast(d[e + 4] + bq[1].x);
            const float f1 = sigmoid_fast(d[e + 5] + bq[1].y);
            const float g0 = tanh_fast(d[e + 8] + bq[2].x), g1 = tanh_fast(d[e + 9] + bq[2].y);
            const float o0 = sigmoid_fast(d[e + 12] + bq[3].x);
            const float o1 = sigmoid_fast(d[e + 13] + bq[3].y);
            const float c0 = f0 * cc.x + i0 * g0, c1 = f1 * cc.y + i1 * g1;
            const float2 hh = make_float2(o0 * tanh_fast(c0), o1 * tanh_fast(c1));
            if (unit_ok && m < a.M) {
              __stcs(reinterpret_cast<float2*>(a.c_out + m * a.ldco + u), make_float2(c0, c1));
              __stcs(reinterpret_cast<float2*>(a.h_out + m * a.ldho + u), hh);
            }
          }
        }
      }
    }
  }
  // neither block leaves while the other may still write into it
  cluster_sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda, which the CUDA runtime has
// already loaded into the process: nothing links against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A persistent grid: as many clusters as are resident at once (read once a
// device, at the largest shared memory asked so far), at most one an item.
template <int WGS, bool SEG>
cudaError_t launch(const CUtensorMap& map, const LstmArgs& a, size_t smem, int dev,
                   cudaStream_t stream) {
  static size_t set_to[64] = {};
  static int resident[64] = {};
  if (smem > set_to[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel<WGS, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER * 64);
    cfg.blockDim = dim3(WGS * 128 + 32);
    cfg.dynamicSmemBytes = smem;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, lstm_cell_kernel<WGS, SEG>, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = n;
    set_to[dev] = smem;
  }
  const int grid = CLUSTER * (a.items < resident[dev] ? a.items : resident[dev]);
  lstm_cell_kernel<WGS, SEG><<<grid, WGS * 128 + 32, smem, stream>>>(map, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace koala

using koala::LstmArgs;

// One layer-step over M rows in tiles of `rows` (64 or 128, from the width
// alone), each tile's passes in `groups` groups of `passes_per_block`: a
// persistent grid of clusters of two blocks walks the (pair of tiles, group)
// items. tile_k: the depth the A tile holds, a multiple of 64; the whole
// depth (K rounded up to 32) or more takes the undivided tile.
// w: [4H, kxp + H] bf16 in pass order (16-byte aligned rows).
extern "C" int koala_lstm_cell(const void* x, const void* h, const void* c, void* h_out,
                               void* c_out, const void* w, const void* bias, long long ldx,
                               long long ldh, long long ldc, long long ldho, long long ldco, int M,
                               int kx, int kxp, int H, int rows, int passes_per_block, int groups,
                               int tile_k, void* stream) {
  const int passes = (H + koala::UNITS - 1) / koala::UNITS;
  if (M < 1 || kx < 1 || kxp < kx || kxp % 16 || H < 16 || H % 16 || passes_per_block < 1 ||
      groups < 1 || (long long)passes_per_block * groups < passes ||
      (rows != 64 && rows != 128) || (reinterpret_cast<size_t>(w) & 15) || tile_k < 64 ||
      tile_k % 64)
    return (int)cudaErrorInvalidValue;
  const int K = kxp + H;
  const int chunks = (K + koala::STAGE_K - 1) / koala::STAGE_K;
  const int seg_chunks = tile_k / koala::STAGE_K;
  const int held = seg_chunks >= chunks ? K : tile_k;
  if (held < K && rows != 64) return (int)cudaErrorInvalidValue;   // K-panels: 64-row tiles
  const int stages = koala::ring_stages(rows, held);
  if (stages < (rows == 128 ? koala::MIN_STAGES_128 : 2)) return (int)cudaErrorInvalidValue;
  // items: (pair of row tiles, group of passes), a cluster's work at a time
  const long long tiles = (M + rows - 1) / rows;
  const long long items = (tiles + koala::CLUSTER - 1) / koala::CLUSTER * groups;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = koala::SMEM_SLACK + koala::a_bytes(rows, held) +
                      (size_t)stages * koala::STAGE_BYTES;

  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;

  const koala::EncodeTiled encode = koala::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)(4 * H)};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)koala::STAGE_K, (cuuint32_t)koala::SLICE_N};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  LstmArgs a{static_cast<const float*>(x), static_cast<const float*>(h),
             static_cast<const float*>(c), static_cast<float*>(h_out),
             static_cast<float*>(c_out), static_cast<const float*>(bias), ldx, ldh, ldc, ldho,
             ldco, M, kx, kxp, H, passes_per_block, groups, (int)items, stages, seg_chunks};
  const cudaStream_t s = (cudaStream_t)stream;
  if (held < K) return (int)koala::launch<1, true>(map, a, smem, dev, s);
  return (int)(rows == 128 ? koala::launch<2, false>(map, a, smem, dev, s)
                            : koala::launch<1, false>(map, a, smem, dev, s));
}
