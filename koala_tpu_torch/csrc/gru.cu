// Whole L-layer GRU recurrence over T steps in one cooperative launch.
//
// Replaces the JAX package's TPU kernel ops/pallas/gru.py (gru_stack_pallas ->
// _kernel), both of its traced variants. Per step t and layer l, with
// x_0 = x[t]:
//   xp = bf16(x_l) @ wx_l + bx_l,  hp = bf16(h_l) @ wh_l + bh_l  (f32 sums)
//   h_l' = gates(h_l, hp, xp);  x_{l+1} = x_l + h_l' (f32), re-cast to bf16
//   y[t] = x_L (bf16)
// The training variant (return_hidden there, HS here) also streams every
// layer's post-update state of every step out as hs [T, L, B, H] f32, the
// residuals of the backward pass: one more store by the element's owner
// under a template flag, so y and h_final are bit-identical between the two.
//
// Bound on this card: at the main path's shapes (B = 64, T = 376, H = 384,
// L = 2) the least time is set by operations, the bf16 products on the
// tensor cores (85 GFLOP, about 86 us); the bytes (x in, y out, h in and
// out, the 3.5 MB of bf16 weights once) take about 12 us. Neither is what a
// recurrence can reach: its steps depend on each other, so the floor of
// this design is its chain of grid barriers (see koala_grid_barriers).
//
// Design: weight-stationary and column-split. The 3.5 MB of weights fit no
// single SM, but they fit the card's register files (132 x 256 KB) and its
// shared memory several times over, so
//  - block j of a row group owns W hidden units (W = 8 or 16) of EVERY
//    layer: gate columns {j, H + j, 2H + j} of wx_l and wh_l. Each of its
//    warps takes one unit of that slice for the whole launch (layer, 8-unit
//    tile, x or h half, k range of at most 12 k tiles) and gathers the
//    unit's weights from device memory once, as tensor-core B fragments in
//    its REGISTERS (72 a thread at 12 k tiles): no weight is read again,
//    not from L2 and not from shared memory either, whose bandwidth a
//    16-row product would otherwise spend on re-reading them every tick;
//  - it keeps the f32 state h_l[:, slice] and the f32 residual stream
//    x_f[:, slice] of its rows in shared memory for all T, and does the
//    gates, the residual add and the y / hs / h_final stores for its slice;
//  - what other blocks need is bf16 only: bf16(h_l) (next step's recurrent
//    operand) and bf16(x_{l+1}) (next layer's input). Each block publishes
//    its slice into a small exchange buffer in device memory (it stays in
//    L2), two copies of each chosen by parity so that a fast block never
//    overwrites what a slow one still reads; after the barrier every block
//    copies the whole [rows, H] operands into shared memory (cp.async
//    through L2) for its products;
//  - the layers run as a wavefront: in tick k layer l works on step k - l.
//    All that a tick reads was published in the tick before (x_l(t) by
//    layer l - 1, h_l(t - 1) by layer l), so the layers of one tick are
//    independent, share one product phase and one gate phase, and one
//    barrier over the group's H / W blocks separates two ticks: T + L - 1
//    ticks for the launch instead of T x L dependent layer-steps;
//  - between arriving at the barrier and waiting on it a block starts the
//    copy of the next input rows x[k + 1], which depend on nobody.
// Rows are cut into chunks of RB rows (a multiple of 16); row chunks never
// interact, so `groups` of them run side by side on their own blocks with
// their own barrier counter, and a group walks over its further chunks one
// after the other with the weights still resident. Rows past B are zero in
// every operand and never stored.
// The products of a tick, [RB, 2H] x [2H, 3W] per layer with the x and the h
// half concatenated: a warp walks its unit over the chunk's 16-row tiles
// (A from padded rows in shared memory), and the units' partial sums meet in
// shared memory and are added in a fixed order: the same bits in every launch.

#include "resident.cuh"

using namespace koala;

constexpr int GRU_THREADS = 512;
constexpr int GRU_WARPS = GRU_THREADS / 32;
constexpr int ACC_FLOATS = 128;              // one 16 x 8 accumulator tile
constexpr int UNIT_FLOATS = 3 * ACC_FLOATS;  // z, r and n partial sums of a unit
constexpr int UNIT_K_TILES = 12;             // k tiles of weights a warp holds in registers
constexpr int MAX_CHUNK_ROWS = 64;

// Built with -DKOALA_GRU_PROFILE (scripts/gru_phase_profile.py does), thread 0
// of block 0 adds up the cycles it spends in each phase of a tick and leaves
// the six sums, in units of 16 cycles, behind the groups' barrier counters:
// 0 waiting for the tick's copies, 1 products, 2 gates and publish, 3 arriving
// at the barrier and starting the input copy, 4 waiting at the barrier,
// 5 starting the exchange copies. Otherwise the macros are empty.
#ifdef KOALA_GRU_PROFILE
#define PHASE_INIT long long phase_sum[6] = {0, 0, 0, 0, 0, 0}, phase_last = 0;
#define PHASE_START phase_last = clock64();
#define PHASE(i) { const long long now = clock64(); phase_sum[i] += now - phase_last; phase_last = now; }
#define PHASE_STORE(out) \
  if (blockIdx.x == 0 && threadIdx.x == 0) \
    for (int i = 0; i < 6; ++i) (out)[i] = (unsigned)(phase_sum[i] >> 4);
#else
#define PHASE_INIT
#define PHASE_START
#define PHASE(i)
#define PHASE_STORE(out)
#endif

struct GruShape {
  int T, B, H, L;
  int W;       // hidden units per block
  int RB;      // rows per chunk
  int chunks;  // row chunks covering B
  int groups;  // row chunks in flight at once (blocks = groups * H / W)
};

// k ranges per product half: short enough for a warp's registers, and enough
// of them to give every warp a unit
__host__ __device__ inline int gru_k_splits(int H, int L, int W) {
  const int KT = H / 16;
  int ks = (KT + UNIT_K_TILES - 1) / UNIT_K_TILES;
  if (ks < GRU_WARPS / (L * (W / 8) * 2)) ks = GRU_WARPS / (L * (W / 8) * 2);
  if (ks > KT) ks = KT;
  return ks;
}

// units of one block: (layer, 8-unit tile, half, k range); one warp each
__host__ __device__ inline int gru_units(int H, int L, int W) {
  return L * (W / 8) * 2 * gru_k_splits(H, L, W);
}

struct GruSmem {
  size_t bias, ops, stage, h, xf, tiles, total;
};

__host__ __device__ inline GruSmem gru_smem_layout(int H, int L, int W, int RB) {
  const int items = (RB / 16) * (W / 8);
  GruSmem s;
  s.bias = 0;
  s.ops = s.bias + align128((size_t)L * 6 * W * 4);
  s.stage = s.ops + align128((size_t)2 * L * RB * (H + 8) * 2);
  s.h = s.stage + align128((size_t)L * items * 2 * gru_k_splits(H, L, W) * UNIT_FLOATS * 4);
  s.xf = s.h + align128((size_t)L * items * ACC_FLOATS * 4);
  s.tiles = s.xf + align128((size_t)2 * L * items * ACC_FLOATS * 4);
  s.total = s.tiles + align128((size_t)L * items * 2 * 4);
  return s;
}

// The z, r and n partial sums of one 16-row tile over a unit's k tiles:
// a_tile is the tile's first k tile in a padded operand buffer (row stride
// S), b the unit's weight fragments. The A tile is asked for two k tiles
// ahead of its products. FULL: the unit has all UNIT_K_TILES k tiles, so
// nothing in the unrolled loop is predicated (it runs a fifth faster so).
template <bool FULL>
__device__ __forceinline__ void unit_products(const bf16* a_tile, int S, int lane, int k_tiles,
                                              const uint2 (&b)[UNIT_K_TILES][3], float (&az)[4],
                                              float (&ar)[4], float (&an)[4]) {
  const int n = FULL ? UNIT_K_TILES : k_tiles;
  unsigned a[3][4];
  ldmatrix_x4(a[0], a_tile, S, lane);
  if (1 < n) ldmatrix_x4(a[1], a_tile + 16, S, lane);
#pragma unroll
  for (int i = 0; i < UNIT_K_TILES; ++i) {
    if (i < n) {
      if (i + 2 < n) ldmatrix_x4(a[(i + 2) % 3], a_tile + (i + 2) * 16, S, lane);
      mma_bf16(az, a[i % 3], b[i][0]);
      mma_bf16(ar, a[i % 3], b[i][1]);
      mma_bf16(an, a[i % 3], b[i][2]);
    }
  }
}

template <bool HS>
__global__ void __launch_bounds__(GRU_THREADS, 1)
    gru_stack_kernel(const bf16* __restrict__ x, const float* __restrict__ h0,
                     const bf16* __restrict__ wx, const float* __restrict__ bx,
                     const bf16* __restrict__ wh, const float* __restrict__ bh,
                     bf16* __restrict__ y, float* __restrict__ hs, float* __restrict__ h_final,
                     bf16* exch, unsigned* counters, GruShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = s.T, B = s.B, H = s.H, L = s.L, W = s.W, RB = s.RB;
  const GruSmem lay = gru_smem_layout(H, L, W, RB);
  float* bias_s = reinterpret_cast<float*>(smem + lay.bias);
  bf16* ops_s = reinterpret_cast<bf16*>(smem + lay.ops);
  float* stage = reinterpret_cast<float*>(smem + lay.stage);
  float* h_s = reinterpret_cast<float*>(smem + lay.h);
  float* xf_s = reinterpret_cast<float*>(smem + lay.xf);
  int* tile_tab = reinterpret_cast<int*>(smem + lay.tiles);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NB = H / W, NU = W / 8, KT = H / 16, S = H + 8;
  const int items = (RB / 16) * NU;            // 16 x 8 output tiles of one layer
  const int MT = RB / 16;
  const int ks = gru_k_splits(H, L, W);
  const int elems = L * items * ACC_FLOATS;    // state elements of the block: [l][tile][128]
  const int layer_elems = items * ACC_FLOATS;
  const int slice = blockIdx.x % NB, group = blockIdx.x / NB;
  const int col0 = slice * W;
  unsigned* counter = counters + group;
  unsigned barriers = 0;
  PHASE_INIT
  const int op_elems = RB * S;                 // one operand buffer in shared memory
  const size_t ex_elems = (size_t)RB * H;      // one exchange buffer in device memory

  // ---- this warp's unit u = ((l * NU + unit tile) * 2 + half) * ks + k range,
  // and its weights, once, as B fragments: lane n * 4 + i holds rows
  // {2i, 2i + 1} (.x) and {2i + 8, 2i + 9} (.y) of column n of each k tile
  const bool has_unit = warp < gru_units(H, L, W);
  const int u_sp = warp % ks, u_half = (warp / ks) & 1, u_tile = (warp / (2 * ks)) % NU;
  const int u_l = warp / (2 * ks * NU);
  const int u_k0 = u_sp * KT / ks, u_klen = has_unit ? (u_sp + 1) * KT / ks - u_k0 : 0;
  uint2 breg[UNIT_K_TILES][3];
  {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(u_half ? wh : wx) +
                              (size_t)(has_unit ? u_l : 0) * H * 3 * H + col0 + u_tile * 8 +
                              (lane >> 2);
#pragma unroll
    for (int i = 0; i < UNIT_K_TILES; ++i) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        breg[i][g] = make_uint2(0u, 0u);
        if (i < u_klen) {
          const unsigned short* p = w + (size_t)((u_k0 + i) * 16 + (lane & 3) * 2) * 3 * H + g * H;
          breg[i][g].x = __ldg(p) | ((unsigned)__ldg(p + 3 * H) << 16);
          breg[i][g].y = __ldg(p + 8 * 3 * H) | ((unsigned)__ldg(p + 9 * 3 * H) << 16);
        }
      }
    }
  }
  // biases: [l][bx z, r, n, bh z, r, n][W]
  for (int i = tid; i < L * 6 * W; i += GRU_THREADS) {
    const int c = i % W, g = (i / W) % 6, l = i / (6 * W);
    const float* b = g < 3 ? bx : bh;
    bias_s[i] = b[(size_t)l * 3 * H + (g % 3) * H + col0 + c];
  }
  for (int i = tid; i < L * items; i += GRU_THREADS) {
    tile_tab[2 * i] = i / items;
    tile_tab[2 * i + 1] = i % items;
  }
  __syncthreads();

  // state element g = (l * items + tile) * 128 + position in the accumulator
  // tile (lane * 4 + pair * 2 + q): its layer, its row and its column (NU is 1 or 2)
  struct Elem { int l, r, c, at; };
  auto element = [&](int g) {
    const int l = tile_tab[2 * (g >> 7)], tile = tile_tab[2 * (g >> 7) + 1], at = g & 127;
    Elem e;
    e.l = l;
    e.r = (tile >> (NU - 1)) * 16 + acc_row(at >> 2, (at >> 1) & 1);
    e.c = (tile & (NU - 1)) * 8 + acc_col(at >> 2) + (at & 1);
    e.at = at;
    return e;
  };
  // copy RB rows of H bf16 (row stride H) into a padded operand buffer;
  // rows from `valid` on are zero-filled
  auto copy_rows = [&](bf16* dst, const bf16* src, int valid) {
    for (int r = warp; r < RB; r += GRU_WARPS) {
      const bool live = r < valid;
      for (int c = lane * 8; c < H; c += 256)
        cp_async16(dst + r * S + c, src + (live ? (size_t)r * H + c : 0), live ? 16 : 0);
    }
  };

  // operand buffers: bf16(x_0) (the input rows), bf16(h_0), bf16(x_1), bf16(h_1), ...
  auto operand = [&](int l, int half) { return ops_s + (size_t)(2 * l + half) * op_elems; };
  // the unit's partial z, r, n sums for tick k, 16-row tile by tile
  auto run_unit = [&](int k) {
    if (!has_unit || k - u_l < 0 || k - u_l >= T) return;
    const bf16* a_rows = operand(u_l, u_half) + u_k0 * 16;
    float* out_rows = stage + ((size_t)((u_l * items + u_tile) * 2 + u_half) * ks + u_sp) *
                                  UNIT_FLOATS;
    for (int mi = 0; mi < MT; ++mi) {
      float az[4] = {0.f, 0.f, 0.f, 0.f}, ar[4] = {0.f, 0.f, 0.f, 0.f},
            an[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* a_tile = a_rows + (size_t)mi * 16 * S;
      if (u_klen == UNIT_K_TILES)
        unit_products<true>(a_tile, S, lane, u_klen, breg, az, ar, an);
      else
        unit_products<false>(a_tile, S, lane, u_klen, breg, az, ar, an);
      float4* out = reinterpret_cast<float4*>(
                        out_rows + (size_t)mi * NU * 2 * ks * UNIT_FLOATS) + lane;
      out[0] = make_float4(az[0], az[1], az[2], az[3]);
      out[32] = make_float4(ar[0], ar[1], ar[2], ar[3]);
      out[64] = make_float4(an[0], an[1], an[2], an[3]);
    }
  };

  for (int chunk = group; chunk < s.chunks; chunk += s.groups) {
    const int row0 = chunk * RB;
    bf16* ex = exch + (size_t)chunk * (4 * L - 2) * ex_elems;
    // what tick k publishes lies in the copy of parity k & 1: bf16(h_l) in
    // hbuf(l, .), bf16(x_{l+1}) in xbuf(l, .)
    auto hbuf = [&](int l, int parity) { return ex + (size_t)(l * 2 + parity) * ex_elems; };
    auto xbuf = [&](int l, int parity) { return ex + (size_t)(2 * L + l * 2 + parity) * ex_elems; };
    // the input rows of tick k (layer 0, step k): they depend on no other block
    auto start_input = [&](int k) {
      if (k < T) copy_rows(operand(0, 0), x + ((size_t)k * B + row0) * H, min(RB, B - row0));
    };
    // what tick k reads of tick k - 1's publishes; closes the tick's copy group
    auto start_exchange = [&](int k) {
      for (int l = 0; l < L; ++l) {
        if (k - l < 0 || k - l >= T) continue;
        copy_rows(operand(l, 1), hbuf(l, (k + 1) & 1), RB);
        if (l > 0) copy_rows(operand(l, 0), xbuf(l - 1, (k + 1) & 1), RB);
      }
      cp_async_commit();
    };

    // ---- this chunk's state in; its bf16 copy published where layer l's
    // first tick (k = l) looks for the tick before it
    for (int g = tid; g < elems; g += GRU_THREADS) {
      const Elem e = element(g);
      const int b = row0 + e.r;
      const float v = b < B ? h0[((size_t)e.l * B + b) * H + col0 + e.c] : 0.0f;
      h_s[g] = v;
      hbuf(e.l, (e.l + 1) & 1)[(size_t)e.r * H + col0 + e.c] = __float2bfloat16(v);
    }
    grid_barrier_arrive(counter);
    start_input(0);
    grid_barrier_wait(counter, ++barriers * NB);
    start_exchange(0);

    const int ticks = T > 0 ? T + L - 1 : 0;
    for (int k = 0; k < ticks; ++k) {
      PHASE_START
      cp_async_wait<0>();
      __syncthreads();
      PHASE(0)

      run_unit(k);
      __syncthreads();
      PHASE(1)

      // ---- gates, state, residual, publish: one element a thread, the two
      // columns of an accumulator pair in neighbouring lanes
      for (int g = tid; g < elems; g += GRU_THREADS) {
        const Elem e = element(g);
        const int l = e.l, t = k - l;
        if (t < 0 || t >= T) continue;          // whole warps: 128 elements share a layer
        const float* sx = stage + (size_t)(g >> 7) * 2 * ks * UNIT_FLOATS + e.at;
        const float* sh = sx + (size_t)ks * UNIT_FLOATS;
        float xz = 0.f, xr = 0.f, xn = 0.f, hz = 0.f, hr = 0.f, hn = 0.f;
        for (int sp = 0; sp < ks; ++sp) {
          xz += sx[sp * UNIT_FLOATS];
          xr += sx[sp * UNIT_FLOATS + ACC_FLOATS];
          xn += sx[sp * UNIT_FLOATS + 2 * ACC_FLOATS];
          hz += sh[sp * UNIT_FLOATS];
          hr += sh[sp * UNIT_FLOATS + ACC_FLOATS];
          hn += sh[sp * UNIT_FLOATS + 2 * ACC_FLOATS];
        }
        const float* bl = bias_s + (size_t)l * 6 * W + e.c;
        const float z = sigmoid_fast((xz + bl[0]) + (hz + bl[3 * W]));
        const float rg = sigmoid_fast((xr + bl[W]) + (hr + bl[4 * W]));
        const float n = tanh_fast((xn + bl[2 * W]) + rg * (hn + bl[5 * W]));
        const int b = row0 + e.r;
        // rows past B stay exact zeros in state, stream and operands
        const float h_new = (b < B ? 1.0f : 0.0f) * ((1.0f - z) * n + z * h_s[g]);
        const float x_in = l == 0 ? __bfloat162float(operand(0, 0)[(size_t)e.r * S + col0 + e.c])
                                  : xf_s[((k + 1) & 1) * elems + g];
        const float x_new = x_in + h_new;
        h_s[g] = h_new;
        if (l < L - 1) xf_s[(k & 1) * elems + g + layer_elems] = x_new;
        // even lanes store the pair of h, odd lanes the pair of x
        const bool odd = e.at & 1;
        const float mine = odd ? x_new : h_new;
        const float other = __shfl_xor_sync(0xffffffffu, odd ? h_new : x_new, 1);
        const __nv_bfloat162 pair = odd ? __floats2bfloat162_rn(other, mine)
                                        : __floats2bfloat162_rn(mine, other);
        const size_t at = (size_t)e.r * H + col0 + (e.c & ~1);
        if (!odd)
          *reinterpret_cast<__nv_bfloat162*>(hbuf(l, k & 1) + at) = pair;
        else if (l < L - 1)
          *reinterpret_cast<__nv_bfloat162*>(xbuf(l, k & 1) + at) = pair;
        else if (b < B)
          *reinterpret_cast<__nv_bfloat162*>(y + ((size_t)t * B + b) * H + col0 + (e.c & ~1)) =
              pair;
        if (HS && b < B) hs[(((size_t)t * L + l) * B + b) * H + col0 + e.c] = h_new;
      }

      PHASE(2)
      if (k + 1 < ticks) {
        grid_barrier_arrive(counter);
        start_input(k + 1);
        PHASE(3)
        grid_barrier_wait(counter, ++barriers * NB);
        PHASE(4)
        start_exchange(k + 1);
        PHASE(5)
      }
    }

    PHASE_STORE(counters + s.groups)
    __syncthreads();
    for (int g = tid; g < elems; g += GRU_THREADS) {
      const Elem e = element(g);
      const int b = row0 + e.r;
      if (b < B) h_final[((size_t)e.l * B + b) * H + col0 + e.c] = h_s[g];
    }
    __syncthreads();
  }
}

// n barriers and nothing else, on the grid of a GRU launch: the cost of the
// chain of barriers alone.
__global__ void __launch_bounds__(GRU_THREADS, 1)
    grid_barriers_kernel(unsigned* counters, int blocks_per_group, int n) {
  unsigned* counter = counters + blockIdx.x / blocks_per_group;
  for (int i = 1; i <= n; ++i) {
    grid_barrier_arrive(counter);
    grid_barrier_wait(counter, (unsigned)i * blocks_per_group);
  }
}

// A cooperative launch is refused unless every block is resident at once;
// the occupancy is asked first so that the refusal names its reason.
static int launch_cooperative(const void* kernel, int blocks, size_t smem, void** args,
                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GRU_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (blocks > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(GRU_THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Shared memory of one block, for the wrapper's plan to be held against.
extern "C" size_t koala_gru_smem_bytes(int H, int L, int W, int RB) {
  return gru_smem_layout(H, L, W, RB).total;
}

// hs == nullptr: the inference variant. Otherwise hs [T, L, B, H] f32 is
// written too (the training variant). exch: chunks * (4L - 2) * RB * H bf16
// of scratch; counters: `groups` zeroed unsigned ints.
extern "C" int koala_gru_stack(const void* x, const void* h0, const void* wx, const void* bx,
                               const void* wh, const void* bh, void* y, void* hs, void* h_final,
                               void* exch, void* counters, int T, int B, int H, int L, int W,
                               int RB, int chunks, int groups, void* stream) {
  if (T < 0 || B < 1 || L < 1 || H < 16 || H % 16 || (W != 8 && W != 16) || RB < 16 ||
      RB % 16 || RB > MAX_CHUNK_ROWS || gru_units(H, L, W) > GRU_WARPS ||
      (H / 16 + gru_k_splits(H, L, W) - 1) / gru_k_splits(H, L, W) > UNIT_K_TILES ||
      groups < 1 || groups > chunks || (size_t)chunks * RB < (size_t)B)
    return (int)cudaErrorInvalidValue;
  GruShape s = {T, B, H, L, W, RB, chunks, groups};
  const size_t smem = gru_smem_layout(H, L, W, RB).total;
  void* args[] = {&x, &h0, &wx, &bx, &wh, &bh, &y, &hs, &h_final, &exch, &counters, &s};
  const void* kernel = hs == nullptr ? (const void*)gru_stack_kernel<false>
                                     : (const void*)gru_stack_kernel<true>;
  return launch_cooperative(kernel, groups * (H / W), smem, args, stream);
}

// n grid barriers on `groups` groups of `blocks_per_group` blocks each.
extern "C" int koala_grid_barriers(void* counters, int blocks_per_group, int groups, int n,
                                   void* stream) {
  if (blocks_per_group < 1 || groups < 1 || n < 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&counters, &blocks_per_group, &n};
  return launch_cooperative((const void*)grid_barriers_kernel, groups * blocks_per_group, 0,
                            args, stream);
}
