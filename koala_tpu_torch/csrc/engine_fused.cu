// The whole enhancement engine over T hops of B streams: one C entry, five
// launches back to back on the caller's stream.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/engine_fused.py
// (fused_sequence -> _fused_call -> _kernel). Per hop of every stream:
//   windowed DFT of [hop t-1 | hop t] -> log-magnitude, band log-energy, floor
//   tracker, SNR and floor-level features, cepstral group maxima -> encoder +
//   tanh-GELU -> L-layer GRU -> decoder sigmoid mask + passthrough gate ->
//   masked inverse DFT -> overlap-add.
// Numerics are the TPU kernel's: bf16 product operands (bases included) with
// f32 sums, f32 elementwise math and state, the frame carry rounded to bf16.
//
// Bound on this card: operations. At the main path's shapes (B = 64,
// T = 376) about 5.1 MFLOP of bf16 products per frame at the real widths,
// 124 GFLOP in all, about 125 us on the tensor cores; the bytes (hops in and
// audio out as f32, state and the ~5 MB of bf16 weights and bases once) take
// about 17 us. Two thirds of the operations are the GRU's, whose steps depend
// on each other: its chain of grid barriers is the floor of the whole.
//
// Design: the chain is split by its dependences, not by stream rows. Only
// three things carry state from hop t-1 to hop t: the GRU, the floor tracker
// (one add and one min per band) and two shifts that are pure indexing (the
// frame is [hop t-1 | hop t]; the output is synth[t][:256] + synth[t-1][256:]).
// Everything else is frame-local, so it runs as ordinary tiled products over
// all M = B x T frames at once, tiles of 64 frames in the order m = b T + t on
// every SM (tile_gemm.cuh), the weights streamed from L2 through shared
// memory, the elementwise math done on the accumulators:
//   front   frame @ fwd -> re | im (kept as f32 in the workspace); the
//           log-magnitude feature (bf16); power and log-magnitude as bf16 @
//           band, cepb -> lb = log(. + eps2) [T,B,nbp] and the cepstral group
//           maxima cg [M,8].
//   floor   floor_scan.cuh over lb's B x nbp columns -> floors [T,B,nbp] and
//           the final floor (the stand-alone floor_scan's kernel).
//   encode  [feature | snr | level] @ wenc + bias + cepstral rank-1 rows,
//           tanh-GELU -> x bf16 [T,B,H].
//   GRU     koala_gru_stack (gru.cu), the inference variant as it is, with the
//           plan the wrapper made: x -> y bf16 [T,B,H], final h.
//   back    y @ wdec -> sigmoid mask and passthrough gate; spectrum x mask as
//           bf16 @ inv -> synth; out[t] = synth[t][:256] + synth[t-1][256:].
//           A tile computes 64 consecutive frames and writes the last 63: its
//           first frame is there only to give its tail to the second (for a
//           stream's first hop the tail is ola0), so no tile waits on another.
// The spectrum is computed on the 257 real bins padded to KR = 272 re and
// KI = 256 im columns (the im Nyquist bin is identically zero); padding
// carries exact zeros. Frames past M are zero and never stored. Every frame's
// sums run in an order that depends on nothing but the frame (tile_gemm.cuh),
// the floor and the GRU are sequential in t and exact under chunking, so a
// sequence cut into calls or segments gives the bits of one call.
// The workspace (spectrum, feature, lb, floors, cg, x, y: 4480 bytes a frame
// at H = 384, nbp = 32) is the wrapper's, which walks long inputs in segments.

#include "floor_scan.cuh"
#include "tile_gemm.cuh"

using namespace koala;

constexpr int FRAME = 256;
constexpr int FFT = 512;
constexpr int KR = 272;          // re bins (257 real, zero padded)
constexpr int KI = 256;          // im bins 0..255
constexpr int KS = KR + KI;      // spectrum width
constexpr int LAGP = 176;        // cepstral lags 40..200 (161, zero padded)
constexpr int MAX_CEP = 8;
constexpr int DECN = KR + 16;    // decoder columns: the mask's, then the gate's tile
constexpr int BIN_CHUNK = 64;    // bins of one pass of the forward DFT (re and im together)
constexpr int BACK_ROWS = MT - 1;  // frames that a tile of the back stage writes

// Field for field the ctypes structure _Args in ops/kernels/engine_fused.py.
// hops, out: the call's first hop; hop_stride, out_stride: elements between
// two streams there. carry0: the hop before the first, carry_stride apart.
// floor0, floor_out: [B, nbp], padded bands at 30. h0, h_out: [L, B, H].
// stage_ms: null, or 5 floats in host memory that receive the stages' times
// (the call then waits for the card).
struct FusedArgs {
  const void *hops, *carry0, *fwd, *band, *cepb, *wenc, *benc, *wcep, *wx, *bx, *wh, *bh, *wdec,
      *bdec, *inv, *ola0, *floor0, *h0;
  void *out, *ola_out, *floor_out, *h_out;
  void *spec, *feat, *lb, *floors, *cg, *x, *y, *exch, *counters, *stage_ms, *stream;
  int B, T, H, L, nbp, cep, hop_stride, carry_stride, out_stride;
  int gru_w, gru_rb, gru_chunks, gru_groups;
  int cep_lo[MAX_CEP], cep_hi[MAX_CEP];
  float eps2, feat_shift, feat_scale, rise, snr_scale, snr_clip, cep_scale;
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Shared memory of the three stages (bytes), for the launches and the gate.
__host__ __device__ inline size_t front_smem() {
  return (size_t)MT * (FFT + A_PAD) * 2 + 2 * (size_t)MT * (KR + A_PAD) * 2 + W_STAGES_BYTES;
}
__host__ __device__ inline size_t encode_smem(int nbp) {
  return align128((size_t)MT * (KR + 2 * nbp + A_PAD) * 2) + (size_t)MT * MAX_CEP * 4 +
         W_STAGES_BYTES;
}
__host__ __device__ inline size_t back_operand_bytes(int H) {
  return align128((size_t)MT * ((H > KS ? H : KS) + A_PAD) * 2);
}
__host__ __device__ inline size_t back_smem(int H) {
  return back_operand_bytes(H) + (size_t)MT * DECN * 4 + W_STAGES_BYTES;
}

// ---- front: frames -> spectrum, feature, band log-energies, cepstral maxima
__global__ void __launch_bounds__(GEMM_THREADS, 1) front_kernel(const FusedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDF = FFT + A_PAD, LDK = KR + A_PAD;
  bf16* frame_s = reinterpret_cast<bf16*>(smem);         // [MT][LDF]: [hop t-1 | hop t]
  bf16* m2_s = frame_s + MT * LDF;                        // [MT][LDK]: power
  bf16* lm_s = m2_s + MT * LDK;                           // [MT][LDK]: log-magnitude
  bf16* w_s = lm_s + MT * LDK;
  float* cep_s = reinterpret_cast<float*>(smem);          // [MT][LAGP], once frame_s is done with

  const float* hops = static_cast<const float*>(a.hops);
  const float* carry0 = static_cast<const float*>(a.carry0);
  const bf16* fwd = static_cast<const bf16*>(a.fwd);
  float* spec = static_cast<float*>(a.spec);
  bf16* feat = static_cast<bf16*>(a.feat);
  float* lb = static_cast<float*>(a.lb);
  float* cg = static_cast<float*>(a.cg);
  const int B = a.B, T = a.T, nbp = a.nbp, M = B * T;
  const int tid = threadIdx.x, wn = (tid >> 5) & 3;
  const int m0 = blockIdx.x * MT;
  float acc[2][4][4];

  // the tile's frames, rounded to bf16 as the TPU kernel streams them
  for (int i = tid; i < MT * (FFT / 4); i += GEMM_THREADS) {
    const int r = i / (FFT / 4), n = (i % (FFT / 4)) * 4, m = m0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (m < M) {
      const int b = m / T, t = m - b * T;
      const float* src;
      if (n >= FRAME)
        src = hops + (size_t)b * a.hop_stride + (size_t)t * FRAME + (n - FRAME);
      else if (t > 0)
        src = hops + (size_t)b * a.hop_stride + (size_t)(t - 1) * FRAME + n;
      else
        src = carry0 + (size_t)b * a.carry_stride + n;
      v = __ldg(reinterpret_cast<const float4*>(src));
    }
    *reinterpret_cast<uint2*>(frame_s + r * LDF + n) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }

  // windowed DFT, BIN_CHUNK bins a pass: a warp's 32 columns are 16 re bins
  // and the im of the same bins, so power and log-magnitude come straight
  // from its accumulators
  for (int bin0 = 0; bin0 < KR; bin0 += BIN_CHUNK) {
    auto cols = [&](int g) {
      const int bin = bin0 + (g >> 2) * 16 + (g & 1) * 8;
      if ((g & 3) < 2) return bin < KR ? bin : -1;
      return bin < KI ? KR + bin : -1;
    };
    const bool active = bin0 + wn * 16 < KR;
    gemm_pass(acc, frame_s, LDF, FFT, fwd, KS, cols, w_s, active);
    if (!active) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = tile_row(mi, half), m = m0 + r;
          const int bin = bin0 + wn * 16 + ni * 8 + acc_col(tid & 31);
          const float re0 = acc[mi][ni][2 * half], re1 = acc[mi][ni][2 * half + 1];
          const float im0 = acc[mi][ni + 2][2 * half], im1 = acc[mi][ni + 2][2 * half + 1];
          const float p0 = re0 * re0 + im0 * im0, p1 = re1 * re1 + im1 * im1;
          const float l0 = 0.5f * logf(p0 + a.eps2), l1 = 0.5f * logf(p1 + a.eps2);
          *reinterpret_cast<unsigned*>(m2_s + r * LDK + bin) = pack_bf16(p0, p1);
          *reinterpret_cast<unsigned*>(lm_s + r * LDK + bin) = pack_bf16(l0, l1);
          if (m < M) {
            *reinterpret_cast<unsigned*>(feat + (size_t)m * KR + bin) = pack_bf16(
                (l0 + a.feat_shift) * a.feat_scale, (l1 + a.feat_shift) * a.feat_scale);
            *reinterpret_cast<float2*>(spec + (size_t)m * KS + bin) = make_float2(re0, re1);
            if (bin < KI)
              *reinterpret_cast<float2*>(spec + (size_t)m * KS + KR + bin) =
                  make_float2(im0, im1);
          }
        }
  }

  // band log-energies: power @ band
  for (int n0 = 0; n0 < nbp; n0 += NC) {
    auto cols = [&](int g) { return n0 + g * 8 < nbp ? n0 + g * 8 : -1; };
    const bool active = n0 + wn * 32 < nbp;
    gemm_pass(acc, m2_s, LDK, KR, static_cast<const bf16*>(a.band), nbp, cols, w_s, active);
    if (!active) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = m0 + tile_row(mi, half), j = n0 + tile_col(ni);
          if (m < M && j < nbp) {
            const int b = m / T, t = m - b * T;
            *reinterpret_cast<float2*>(lb + ((size_t)t * B + b) * nbp + j) = make_float2(
                logf(acc[mi][ni][2 * half] + a.eps2), logf(acc[mi][ni][2 * half + 1] + a.eps2));
          }
        }
  }

  // cepstral group maxima: log-magnitude @ cepb, then the maximum of each lag range
  if (a.cep) {
    for (int n0 = 0; n0 < LAGP; n0 += NC) {
      auto cols = [&](int g) { return n0 + g * 8 < LAGP ? n0 + g * 8 : -1; };
      const bool active = n0 + wn * 32 < LAGP;
      gemm_pass(acc, lm_s, LDK, KR, static_cast<const bf16*>(a.cepb), LAGP, cols, w_s, active);
      if (!active) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = n0 + tile_col(ni);
            if (q < LAGP)
              *reinterpret_cast<float2*>(cep_s + tile_row(mi, half) * LAGP + q) =
                  make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
          }
    }
    __syncthreads();
    for (int i = tid; i < MT * a.cep; i += GEMM_THREADS) {
      const int r = i / a.cep, g = i % a.cep, m = m0 + r;
      if (m >= M) continue;
      float mx = -1e30f;
      for (int q = a.cep_lo[g]; q < a.cep_hi[g]; ++q) mx = fmaxf(mx, cep_s[r * LAGP + q]);
      cg[(size_t)m * MAX_CEP + g] = fminf(fmaxf(mx * a.cep_scale, -1.0f), 4.0f);
    }
  }
}

// ---- encode: [feature | snr | level] @ wenc, + bias + cepstral rank-1 rows, GELU
__global__ void __launch_bounds__(GEMM_THREADS, 1) encode_kernel(const FusedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = a.B, T = a.T, H = a.H, nbp = a.nbp, M = B * T;
  const int enc_in = KR + 2 * nbp, lda = enc_in + A_PAD;
  bf16* a_s = reinterpret_cast<bf16*>(smem);                                  // [MT][lda]
  float* cg_s = reinterpret_cast<float*>(smem + align128((size_t)MT * lda * 2));  // [MT][8]
  bf16* w_s = reinterpret_cast<bf16*>(cg_s + MT * MAX_CEP);

  const bf16* feat = static_cast<const bf16*>(a.feat);
  const float* lb = static_cast<const float*>(a.lb);
  const float* floors = static_cast<const float*>(a.floors);
  const float* cg = static_cast<const float*>(a.cg);
  const float* benc = static_cast<const float*>(a.benc);
  const float* wcep = static_cast<const float*>(a.wcep);
  bf16* x = static_cast<bf16*>(a.x);
  const int tid = threadIdx.x, wn = (tid >> 5) & 3;
  const int m0 = blockIdx.x * MT;
  float acc[2][4][4];

  for (int i = tid; i < MT * (KR / 8); i += GEMM_THREADS) {
    const int r = i / (KR / 8), q = (i % (KR / 8)) * 8, m = m0 + r;
    const bool live = m < M;
    cp_async16(a_s + r * lda + q, feat + (live ? (size_t)m * KR + q : 0), live ? 16 : 0);
  }
  cp_async_commit();
  // posterior SNR and floor level of every band
  for (int i = tid; i < MT * nbp; i += GEMM_THREADS) {
    const int r = i / nbp, j = i % nbp, m = m0 + r;
    float snr = 0.0f, lvl = 0.0f;
    if (m < M) {
      const int b = m / T, t = m - b * T;
      const size_t at = ((size_t)t * B + b) * nbp + j;
      const float e = lb[at], f = floors[at];
      snr = fminf(fmaxf((e - f) * a.snr_scale, 0.0f), a.snr_clip);
      lvl = (f + 9.0f) * 0.15f;
    }
    a_s[r * lda + KR + j] = __float2bfloat16(snr);
    a_s[r * lda + KR + nbp + j] = __float2bfloat16(lvl);
  }
  for (int i = tid; i < MT * MAX_CEP; i += GEMM_THREADS) {
    const int m = m0 + i / MAX_CEP, g = i % MAX_CEP;
    cg_s[i] = (m < M && g < a.cep) ? cg[(size_t)m * MAX_CEP + g] : 0.0f;
  }
  cp_async_wait<0>();

  for (int n0 = 0; n0 < H; n0 += NC) {
    auto cols = [&](int g) { return n0 + g * 8 < H ? n0 + g * 8 : -1; };
    const bool active = n0 + wn * 32 < H;
    gemm_pass(acc, a_s, lda, enc_in, static_cast<const bf16*>(a.wenc), H, cols, w_s, active);
    if (!active) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = tile_row(mi, half), m = m0 + r, j = n0 + tile_col(ni);
          if (m >= M || j >= H) continue;
          float e0 = acc[mi][ni][2 * half] + benc[j];
          float e1 = acc[mi][ni][2 * half + 1] + benc[j + 1];
          for (int g = 0; g < a.cep; ++g) {
            e0 += cg_s[r * MAX_CEP + g] * wcep[g * H + j];
            e1 += cg_s[r * MAX_CEP + g] * wcep[g * H + j + 1];
          }
          const int b = m / T, t = m - b * T;
          *reinterpret_cast<unsigned*>(x + ((size_t)t * B + b) * H + j) =
              pack_bf16(gelu_tanh(e0), gelu_tanh(e1));
        }
  }
}

// ---- back: decoder mask and gate, masked inverse DFT, overlap-add
__global__ void __launch_bounds__(GEMM_THREADS, 1) back_kernel(const FusedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = a.B, T = a.T, H = a.H, M = B * T;
  const int ldy = H + A_PAD;
  constexpr int LDA = KS + A_PAD;
  bf16* y_s = reinterpret_cast<bf16*>(smem);              // [MT][ldy], then ...
  bf16* a_s = y_s;                                        // [MT][LDA]: the masked spectrum
  float* mask_s = reinterpret_cast<float*>(smem + back_operand_bytes(H));   // [MT][DECN]
  float* tail_s = mask_s;                                 // [MT][FRAME], once the mask is used
  bf16* w_s = reinterpret_cast<bf16*>(mask_s + MT * DECN);

  const bf16* y = static_cast<const bf16*>(a.y);
  const float* spec = static_cast<const float*>(a.spec);
  const float* bdec = static_cast<const float*>(a.bdec);
  const float* ola0 = static_cast<const float*>(a.ola0);
  float* out = static_cast<float*>(a.out);
  float* ola_out = static_cast<float*>(a.ola_out);
  const int tid = threadIdx.x, wn = (tid >> 5) & 3;
  // the tile's frames m_first .. m_first + 63; the first is only a predecessor
  const int m_first = blockIdx.x * BACK_ROWS - 1;
  auto live = [&](int m) { return m >= 0 && m < M; };
  float acc[2][4][4];

  for (int i = tid; i < MT * (H / 8); i += GEMM_THREADS) {
    const int r = i / (H / 8), q = (i % (H / 8)) * 8, m = m_first + r;
    const bool ok = live(m);
    const int b = ok ? m / T : 0, t = ok ? m - b * T : 0;
    cp_async16(y_s + r * ldy + q, y + ((size_t)t * B + b) * H + q, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();

  // decoder: sigmoid of every mask column and of the gate's (column KR)
  for (int n0 = 0; n0 < DECN; n0 += NC) {
    auto cols = [&](int g) { return n0 + g * 8 < DECN ? n0 + g * 8 : -1; };
    const bool active = n0 + wn * 32 < DECN;
    gemm_pass(acc, y_s, ldy, H, static_cast<const bf16*>(a.wdec), DECN, cols, w_s, active);
    if (!active) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = n0 + tile_col(ni);
          if (c < DECN)
            *reinterpret_cast<float2*>(mask_s + tile_row(mi, half) * DECN + c) =
                make_float2(sigmoidf(acc[mi][ni][2 * half] + bdec[c]),
                            sigmoidf(acc[mi][ni][2 * half + 1] + bdec[c + 1]));
        }
  }
  __syncthreads();

  // the spectrum times mask + gate (1 - mask), as bf16: the inverse DFT's operand
  for (int i = tid; i < MT * (KR / 2); i += GEMM_THREADS) {
    const int r = i / (KR / 2), k = (i % (KR / 2)) * 2, m = m_first + r;
    const float g = mask_s[r * DECN + KR];
    float k0 = mask_s[r * DECN + k], k1 = mask_s[r * DECN + k + 1];
    k0 = k0 + g * (1.0f - k0);
    k1 = k1 + g * (1.0f - k1);
    float2 re = make_float2(0.0f, 0.0f), im = make_float2(0.0f, 0.0f);
    if (live(m)) {
      re = *reinterpret_cast<const float2*>(spec + (size_t)m * KS + k);
      if (k < KI) im = *reinterpret_cast<const float2*>(spec + (size_t)m * KS + KR + k);
    }
    *reinterpret_cast<unsigned*>(a_s + r * LDA + k) = pack_bf16(re.x * k0, re.y * k1);
    if (k < KI)
      *reinterpret_cast<unsigned*>(a_s + r * LDA + KR + k) = pack_bf16(im.x * k0, im.y * k1);
  }
  __syncthreads();

  // inverse DFT: the tails (columns 256 .. 511) first, into shared memory;
  // then the heads, each added to the tail of the frame before it
  for (int pass = 0; pass < FFT / NC; ++pass) {
    const int n0 = (pass * NC + FRAME) % FFT;
    auto cols = [&](int g) { return n0 + g * 8; };
    gemm_pass(acc, a_s, LDA, KS, static_cast<const bf16*>(a.inv), FFT, cols, w_s, true);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = tile_row(mi, half), m = m_first + r, c = n0 + tile_col(ni);
          const float2 v = make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
          const bool writes = r >= 1 && live(m);
          const int b = writes ? m / T : 0, t = writes ? m - b * T : 0;
          if (c >= FRAME) {
            *reinterpret_cast<float2*>(tail_s + r * FRAME + c - FRAME) = v;
            if (writes && t == T - 1)
              *reinterpret_cast<float2*>(ola_out + (size_t)b * FRAME + c - FRAME) = v;
          } else if (writes) {
            const float2 prev = t == 0
                ? *reinterpret_cast<const float2*>(ola0 + (size_t)b * FRAME + c)
                : *reinterpret_cast<const float2*>(tail_s + (r - 1) * FRAME + c);
            *reinterpret_cast<float2*>(out + (size_t)b * a.out_stride + (size_t)t * FRAME + c) =
                make_float2(v.x + prev.x, v.y + prev.y);
          }
        }
  }
}

extern "C" int koala_gru_stack(const void* x, const void* h0, const void* wx, const void* bx,
                               const void* wh, const void* bh, void* y, void* hs, void* h_final,
                               void* exch, void* counters, int T, int B, int H, int L, int W,
                               int RB, int chunks, int groups, void* stream);

// The most dynamic shared memory that a stage's block asks for, for the gate.
extern "C" size_t koala_engine_fused_smem(int nbp, int H) {
  size_t m = front_smem();
  if (encode_smem(nbp) > m) m = encode_smem(nbp);
  if (back_smem(H) > m) m = back_smem(H);
  return m;
}

extern "C" int koala_engine_fused(const FusedArgs* args) {
  const FusedArgs& a = *args;
  if (a.B < 1 || a.T < 1 || a.H < 16 || a.H % 16 || a.nbp < 16 || a.nbp % 16 || a.cep < 0 ||
      a.cep > MAX_CEP || (size_t)a.B * a.T > (size_t)1 << 30)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)a.stream;
  const int M = a.B * a.T;
  const size_t smem_front = front_smem(), smem_enc = encode_smem(a.nbp), smem_back = back_smem(a.H);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_front)) != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_enc)) != cudaSuccess) return (int)err;
  if ((err = cudaFuncSetAttribute(back_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_back)) != cudaSuccess) return (int)err;

  // with stage_ms: an event before the first stage and after each of the five
  constexpr int STAGES = 5;
  cudaEvent_t ev[STAGES + 1] = {};
  int events = 0;
  int status = 0;
  auto mark = [&](int i) {
    if (a.stage_ms && status == 0 && i < events) status = (int)cudaEventRecord(ev[i], stream);
  };
  if (a.stage_ms)
    for (; events <= STAGES; ++events)
      if ((err = cudaEventCreate(&ev[events])) != cudaSuccess) { status = (int)err; break; }

  mark(0);
  if (status == 0) {
    front_kernel<<<(M + MT - 1) / MT, GEMM_THREADS, smem_front, stream>>>(a);
    status = (int)cudaGetLastError();
  }
  mark(1);
  if (status == 0)
    status = (int)launch_floor_scan((const float*)a.lb, (const float*)a.floor0, (float*)a.floors,
                                    (float*)a.floor_out, a.T, a.B * a.nbp, a.rise, stream);
  mark(2);
  if (status == 0) {
    encode_kernel<<<(M + MT - 1) / MT, GEMM_THREADS, smem_enc, stream>>>(a);
    status = (int)cudaGetLastError();
  }
  mark(3);
  if (status == 0)
    status = koala_gru_stack(a.x, a.h0, a.wx, a.bx, a.wh, a.bh, a.y, nullptr, a.h_out, a.exch,
                             a.counters, a.T, a.B, a.H, a.L, a.gru_w, a.gru_rb, a.gru_chunks,
                             a.gru_groups, a.stream);
  mark(4);
  if (status == 0) {
    back_kernel<<<(M + BACK_ROWS - 1) / BACK_ROWS, GEMM_THREADS, smem_back, stream>>>(a);
    status = (int)cudaGetLastError();
  }
  mark(5);
  if (a.stage_ms && status == 0) {
    status = (int)cudaEventSynchronize(ev[STAGES]);
    float* ms = static_cast<float*>(a.stage_ms);
    for (int i = 0; i < STAGES && status == 0; ++i)
      status = (int)cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
  }
  for (int i = 0; i < events; ++i) cudaEventDestroy(ev[i]);
  return status;
}
