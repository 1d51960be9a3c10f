"""Engine constants, the same values as the JAX package's constants.py.

- 16 kHz mono, 16-bit linear PCM.
- One frame = 256 samples = 16 ms.
- 512-point DFT, 50% overlap, sqrt-Hann window on analysis and synthesis:
  perfect reconstruction with an algorithmic delay of exactly one hop.

The values must stay equal to the JAX package's: both packages load the
same model files and their streaming states are interchangeable.
"""

SAMPLE_RATE = 16000
FRAME_LENGTH = 256          # samples per process() call (= STFT hop)
FFT_SIZE = 512              # analysis window length (2 hops, 50% overlap)
NUM_BINS = FFT_SIZE // 2 + 1  # 257 rfft bins
DELAY_SAMPLE = FRAME_LENGTH   # the spectral kinds' latency (50%-overlap OLA); Engine.delay_sample

PCM_SCALE = 32768.0         # int16 <-> float fullscale convention

# Magic header of the model parameter files (same container as the JAX
# package's models/params_io.py).
MODEL_MAGIC = b"KOALATPU1\x00"
