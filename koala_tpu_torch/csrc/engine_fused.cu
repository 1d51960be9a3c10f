// The whole enhancement engine over T hops in one launch.
//
// Replaces the TPU kernel of the JAX package, ops/pallas/engine_fused.py
// (fused_sequence -> _fused_call -> _kernel). Per hop of every stream:
//   windowed DFT of [carry | hop] -> log-magnitude, band log-energy, floor
//   tracker, SNR and floor-level features, cepstral group maxima -> encoder +
//   tanh-GELU -> L-layer GRU -> decoder sigmoid mask + passthrough gate ->
//   masked inverse DFT -> overlap-add.
// Numerics are the TPU kernel's: bf16 product operands (bases included) with
// f32 sums, f32 elementwise math and state, the frame carry held as bf16.
//
// Bound on this card: operations at the main path's shapes (B = 64,
// T = 376): about 5.1 MFLOP of bf16 products per row and hop at the real
// widths, 124 GFLOP in all, about 125 us on the tensor cores; the bytes (hops in and audio out as
// f32, state and the ~5 MB of bf16 weights and bases once) take about 17 us.
// What limits this design is that every block reads all weights and bases
// from L2 once per hop.
// Design: streams never interact, so one block owns ROWS = 16 stream rows
// for the whole T loop, and every temporary (spectrum, features, hidden
// state, gate staging, overlap-add tail, floor) lives in its dynamic shared
// memory (about 216 KB at H = 384, L = 2; regions whose lifetimes do not
// overlap share memory). The products run on the tensor cores (WMMA) with
// the weights read as bf16 from device memory. The spectrum is computed on
// the 257 real bins padded to KR = 272 re and KI = 256 im columns (the im
// Nyquist bin is identically zero); padding carries exact zeros. Rows past B
// are zero and never stored, so any B >= 1 is taken, and there is no
// cross-block state: the multi-tile fault of the TPU kernel cannot occur.

#include "common.cuh"

using namespace koala;

constexpr int FUSED_WARPS = 12;
constexpr int FRAME = 256;
constexpr int FFT = 512;
constexpr int KR = 272;          // re bins (257 real, zero padded)
constexpr int KI = 256;          // im bins 0..255
constexpr int KS = KR + KI;      // spectrum width
constexpr int LAGP = 176;        // cepstral lags 40..200 (161, zero padded)
constexpr int MAX_CEP = 8;

// Field for field the ctypes structure _Args in ops/kernels/engine_fused.py.
struct FusedArgs {
  const void *hops, *fwd, *band, *cepb, *wenc, *benc, *wcep, *wx, *bx, *wh, *bh, *wdec, *bdec,
      *inv, *carry0, *ola0, *floor0, *h0;
  void *out, *ola_out, *floor_out, *h_out, *stream;
  int B, T, H, L, nb, cep;
  int cep_lo[MAX_CEP], cep_hi[MAX_CEP];
  float eps2, feat_shift, feat_scale, rise, snr_scale, snr_clip, cep_scale;
};

// Byte offsets of the shared-memory regions (the total is exported as
// koala_engine_fused_smem for the Python gate).
struct Carve {
  size_t frame, spec, a, uni, floor, cg, ola, xf, xbf, h, total;
};

__host__ __device__ inline size_t max4(size_t a, size_t b, size_t c, size_t d) {
  size_t m = a > b ? a : b;
  m = m > c ? m : c;
  return m > d ? m : d;
}

__host__ __device__ inline Carve carve(int nbp, int H, int L) {
  Carve c;
  size_t o = 0;
  c.frame = o; o += align128((size_t)ROWS * FFT * 2);    // [carry | hop] bf16
  c.spec = o;  o += align128((size_t)ROWS * KS * 4);     // re | im f32
  c.a = o;     o += align128((size_t)ROWS * KS * 2);     // product inputs bf16
  // union: GRU staging | band+cep outputs and inputs | decoder out | synthesis
  const size_t uni = max4((size_t)FUSED_WARPS * 4 * 256 * 4,
                          align128((size_t)ROWS * (nbp + LAGP) * 4) +
                              2 * align128((size_t)ROWS * KR * 2),
                          (size_t)ROWS * (KR + 16) * 4, (size_t)ROWS * FFT * 4);
  c.uni = o;   o += align128(uni);
  c.floor = o; o += align128((size_t)ROWS * nbp * 4);
  c.cg = o;    o += align128((size_t)ROWS * MAX_CEP * 4);
  c.ola = o;   o += align128((size_t)ROWS * FRAME * 4);
  c.xf = o;    o += align128((size_t)ROWS * H * 4);
  c.xbf = o;   o += align128((size_t)ROWS * H * 2);
  c.h = o;     o += align128((size_t)L * ROWS * H * 4);
  c.total = o;
  return c;
}

__global__ void __launch_bounds__(FUSED_WARPS * 32) engine_fused_kernel(const FusedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int B = a.B, T = a.T, H = a.H, L = a.L, nb = a.nb;
  const int nbp = (nb + 15) / 16 * 16;
  const int ENC_IN = KR + 2 * nbp, DECN = KR + 16, H3 = 3 * H;
  const Carve c = carve(nbp, H, L);
  bf16* frame_s = reinterpret_cast<bf16*>(smem + c.frame);
  float* spec_s = reinterpret_cast<float*>(smem + c.spec);
  bf16* a_s = reinterpret_cast<bf16*>(smem + c.a);
  float* uni = reinterpret_cast<float*>(smem + c.uni);
  float* floor_s = reinterpret_cast<float*>(smem + c.floor);
  float* cg_s = reinterpret_cast<float*>(smem + c.cg);
  float* ola_s = reinterpret_cast<float*>(smem + c.ola);
  float* xf_s = reinterpret_cast<float*>(smem + c.xf);
  bf16* xbf_s = reinterpret_cast<bf16*>(smem + c.xbf);
  float* h_s = reinterpret_cast<float*>(smem + c.h);
  bf16* hbf_s = a_s;                         // a_s is free during the GRU
  float* lbraw = uni;                        // [ROWS][nbp]
  float* cepc = uni + ROWS * nbp;            // [ROWS][LAGP]
  bf16* m2_s = reinterpret_cast<bf16*>(smem + c.uni + align128((size_t)ROWS * (nbp + LAGP) * 4));
  bf16* lm_s = m2_s + align128((size_t)ROWS * KR * 2) / 2;

  const float* hops = static_cast<const float*>(a.hops);
  const bf16* fwd = static_cast<const bf16*>(a.fwd);
  const bf16* band = static_cast<const bf16*>(a.band);
  const bf16* cepb = static_cast<const bf16*>(a.cepb);
  const bf16* wenc = static_cast<const bf16*>(a.wenc);
  const float* benc = static_cast<const float*>(a.benc);
  const float* wcep = static_cast<const float*>(a.wcep);
  const bf16* wx = static_cast<const bf16*>(a.wx);
  const float* bx = static_cast<const float*>(a.bx);
  const bf16* wh = static_cast<const bf16*>(a.wh);
  const float* bh = static_cast<const float*>(a.bh);
  const bf16* wdec = static_cast<const bf16*>(a.wdec);
  const float* bdec = static_cast<const float*>(a.bdec);
  const bf16* inv = static_cast<const bf16*>(a.inv);
  const float* carry0 = static_cast<const float*>(a.carry0);
  const float* ola0 = static_cast<const float*>(a.ola0);
  const float* floor0 = static_cast<const float*>(a.floor0);
  const float* h0 = static_cast<const float*>(a.h0);
  float* out = static_cast<float*>(a.out);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthreads / 32;
  const int row0 = blockIdx.x * ROWS;
  const int RH = ROWS * H;

  // ---- load the block's state
  for (int i = tid; i < ROWS * FRAME; i += nthreads) {
    const int r = i / FRAME, n = i % FRAME, b = row0 + r;
    frame_s[r * FFT + n] = __float2bfloat16(b < B ? carry0[(size_t)b * FRAME + n] : 0.0f);
    ola_s[i] = b < B ? ola0[(size_t)b * FRAME + n] : 0.0f;
  }
  for (int i = tid; i < ROWS * nbp; i += nthreads) {
    const int r = i / nbp, j = i % nbp, b = row0 + r;
    floor_s[i] = (b < B && j < nb) ? floor0[(size_t)b * nb + j] : 30.0f;
  }
  for (int i = tid; i < L * RH; i += nthreads) {
    const int l = i / RH, r = (i / H) % ROWS, j = i % H, b = row0 + r;
    h_s[i] = b < B ? h0[((size_t)b * L + l) * H + j] : 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    // ---- this hop into the frame's right half (bf16, as the TPU kernel streams it)
    for (int i = tid; i < ROWS * FRAME; i += nthreads) {
      const int r = i / FRAME, n = i % FRAME, b = row0 + r;
      frame_s[r * FFT + FRAME + n] =
          __float2bfloat16(b < B ? hops[((size_t)b * T + t) * FRAME + n] : 0.0f);
    }
    __syncthreads();
    // ---- windowed DFT: [carry | hop] @ fwd -> re | im
    mm_rows16(frame_s, FFT, fwd, KS, FFT, KS, spec_s, KS, warp, nwarps);
    __syncthreads();
    // ---- log-magnitude features; bf16 power and log-magnitude for the band
    //      and cepstral products
    for (int i = tid; i < ROWS * KR; i += nthreads) {
      const int r = i / KR, k = i % KR;
      const float re = spec_s[r * KS + k];
      const float im = k < KI ? spec_s[r * KS + KR + k] : 0.0f;
      const float m2 = re * re + im * im;
      const float lm = 0.5f * logf(m2 + a.eps2);
      a_s[r * KS + k] = __float2bfloat16((lm + a.feat_shift) * a.feat_scale);
      m2_s[r * KR + k] = __float2bfloat16(m2);
      lm_s[r * KR + k] = __float2bfloat16(lm);
    }
    __syncthreads();
    mm_rows16(m2_s, KR, band, nbp, KR, nbp, lbraw, nbp, warp, nwarps);
    if (a.cep) {
      // deal the cepstral tiles from the warps the band product left idle
      const int shift = (nbp / TILE) % nwarps;
      mm_rows16(lm_s, KR, cepb, LAGP, KR, LAGP, cepc, LAGP, (warp + nwarps - shift) % nwarps,
                nwarps);
    }
    __syncthreads();
    // ---- floor tracker, posterior-SNR and floor-level features, cepstral maxima
    for (int i = tid; i < ROWS * nbp; i += nthreads) {
      const int r = i / nbp, j = i % nbp;
      const float lb = logf(lbraw[i] + a.eps2);
      const float f = fminf(floor_s[i] + a.rise, lb);
      floor_s[i] = f;
      const float snr = fminf(fmaxf((lb - f) * a.snr_scale, 0.0f), a.snr_clip);
      const float lvl = (f + 9.0f) * 0.15f;
      a_s[r * KS + KR + j] = __float2bfloat16(snr);
      a_s[r * KS + KR + nbp + j] = __float2bfloat16(lvl);
    }
    for (int i = tid; i < ROWS * a.cep; i += nthreads) {
      const int r = i / a.cep, g = i % a.cep;
      float mx = -1e30f;
      for (int q = a.cep_lo[g]; q < a.cep_hi[g]; ++q) mx = fmaxf(mx, cepc[r * LAGP + q]);
      cg_s[r * MAX_CEP + g] = fminf(fmaxf(mx * a.cep_scale, -1.0f), 4.0f);
    }
    __syncthreads();
    // ---- encoder: [feat | snr | lvl] @ wenc, + bias + cepstral rank-1 rows, GELU
    mm_rows16(a_s, KS, wenc, H, ENC_IN, H, xf_s, H, warp, nwarps);
    __syncthreads();
    for (int i = tid; i < RH; i += nthreads) {
      const int r = i / H, j = i % H;
      float e = xf_s[i] + benc[j];
      for (int g = 0; g < a.cep; ++g) e += cg_s[r * MAX_CEP + g] * wcep[g * H + j];
      const float x = gelu_tanh(e);
      xf_s[i] = x;
      xbf_s[i] = __float2bfloat16(x);
    }
    // ---- GRU stack with residual adds
    for (int l = 0; l < L; ++l) {
      float* hl = h_s + (size_t)l * RH;
      for (int i = tid; i < RH; i += nthreads) hbf_s[i] = __float2bfloat16(hl[i]);
      __syncthreads();
      gru_layer16(xbf_s, hbf_s, hl, xf_s, wx + (size_t)l * H * H3, bx + (size_t)l * H3,
                  wh + (size_t)l * H * H3, bh + (size_t)l * H3, H, uni, warp, nwarps, lane);
      __syncthreads();
      for (int i = tid; i < RH; i += nthreads) xbf_s[i] = __float2bfloat16(xf_s[i]);
    }
    __syncthreads();
    // ---- decoder mask and passthrough gate (gate logit in column KR)
    float* dec_s = uni;
    mm_rows16(xbf_s, H, wdec, DECN, H, DECN, dec_s, DECN, warp, nwarps);
    __syncthreads();
    for (int i = tid; i < ROWS * KR; i += nthreads) {
      const int r = i / KR, k = i % KR;
      const float g = sigmoidf(dec_s[r * DECN + KR] + bdec[KR]);
      float m = sigmoidf(dec_s[r * DECN + k] + bdec[k]);
      m = m + g * (1.0f - m);
      a_s[r * KS + k] = __float2bfloat16(spec_s[r * KS + k] * m);
      if (k < KI) a_s[r * KS + KR + k] = __float2bfloat16(spec_s[r * KS + KR + k] * m);
    }
    __syncthreads();
    // ---- masked inverse DFT and overlap-add; this hop becomes the carry
    float* synth = uni;
    mm_rows16(a_s, KS, inv, FFT, KS, FFT, synth, FFT, warp, nwarps);
    __syncthreads();
    for (int i = tid; i < ROWS * FRAME; i += nthreads) {
      const int r = i / FRAME, n = i % FRAME, b = row0 + r;
      const float o = synth[r * FFT + n] + ola_s[i];
      ola_s[i] = synth[r * FFT + FRAME + n];
      if (b < B) out[((size_t)b * T + t) * FRAME + n] = o;
      frame_s[r * FFT + n] = frame_s[r * FFT + FRAME + n];
    }
  }
  __syncthreads();

  // ---- write the block's final state
  float* ola_out = static_cast<float*>(a.ola_out);
  float* floor_out = static_cast<float*>(a.floor_out);
  float* h_out = static_cast<float*>(a.h_out);
  for (int i = tid; i < ROWS * FRAME; i += nthreads) {
    const int r = i / FRAME, n = i % FRAME, b = row0 + r;
    if (b < B) ola_out[(size_t)b * FRAME + n] = ola_s[i];
  }
  for (int i = tid; i < ROWS * nbp; i += nthreads) {
    const int r = i / nbp, j = i % nbp, b = row0 + r;
    if (b < B && j < nb) floor_out[(size_t)b * nb + j] = floor_s[i];
  }
  for (int i = tid; i < L * RH; i += nthreads) {
    const int l = i / RH, r = (i / H) % ROWS, j = i % H, b = row0 + r;
    if (b < B) h_out[((size_t)b * L + l) * H + j] = h_s[i];
  }
}

// Dynamic shared memory one block needs for (nb, H, L).
extern "C" size_t koala_engine_fused_smem(int nb, int H, int L) {
  return carve((nb + 15) / 16 * 16, H, L).total;
}

extern "C" int koala_engine_fused(const FusedArgs* args) {
  const size_t smem = koala_engine_fused_smem(args->nb, args->H, args->L);
  cudaError_t err = cudaFuncSetAttribute(engine_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (args->B + ROWS - 1) / ROWS;
  engine_fused_kernel<<<blocks, FUSED_WARPS * 32, smem, (cudaStream_t)args->stream>>>(*args);
  return (int)cudaGetLastError();
}
