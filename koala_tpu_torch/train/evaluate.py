"""Acceptance evaluation: the energy-parity harness + SI-SDR, STOI, fwSNRseg.

The harness semantics of the JAX package's ``train/evaluate.py``: stream an
utterance through the engine, compare each output frame's RMS against the
delay-shifted reference frame; the deviation must stay below 0.02 at
fullscale 1.0. Three cases: pure speech against itself, pure noise against
silence, speech + noise (sample-wise int16 sum) against the clean speech.
Plus SI-SDR, STOI and fwSNRseg of the delay-compensated enhanced mix.

Single-stream evaluation runs the scan branch (``use_pallas=False``). As every
entry point of the package it runs on the card unless the caller passes
``device="cpu"``, and raises the package's device error without a card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..constants import DELAY_SAMPLE, FRAME_LENGTH
from ..device import resolve_device
from ..engine.core import float_to_pcm, make_engine, pcm_to_float
from ..models.params_io import params_from_numpy
from .fwsnrseg import fwsnrseg
from .stoi import stoi


def _stream_enhance(engine, params, pcm_int16: np.ndarray, device) -> np.ndarray:
    """Enhance a whole int16 utterance through the sequence engine (equal to
    frame-by-frame streaming). Returns int16 of the same number of whole
    frames, still delayed."""
    n = (len(pcm_int16) // FRAME_LENGTH) * FRAME_LENGTH
    hops = torch.as_tensor(pcm_to_float(pcm_int16[:n]), device=device).reshape(-1, FRAME_LENGTH)
    with torch.no_grad():
        _, out = engine.sequence(params, engine.init_state((), device), hops)
    return float_to_pcm(out.reshape(-1))


def _rms(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64) / 32768.0
    return float(np.sqrt(np.mean(x * x)))


def rms_case(enhanced: np.ndarray, reference: Optional[np.ndarray],
             delay: int = DELAY_SAMPLE) -> float:
    """Max per-frame energy deviation. reference=None means 'expect silence'."""
    worst = 0.0
    for start in range(0, len(enhanced) - FRAME_LENGTH + 1, FRAME_LENGTH):
        frame = enhanced[start:start + FRAME_LENGTH]
        if reference is None or start < delay:
            dev = _rms(frame)
        else:
            ref = reference[start - delay:start - delay + FRAME_LENGTH]
            dev = abs(_rms(frame) - _rms(ref))
        worst = max(worst, dev)
    return worst


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SDR in dB."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    alpha = np.dot(est, ref) / (np.dot(ref, ref) + 1e-12)
    target = alpha * ref
    noise = est - target
    return float(10.0 * np.log10(
        (np.dot(target, target) + 1e-12) / (np.dot(noise, noise) + 1e-12)))


def evaluate(params, config: Dict[str, Any], speech: np.ndarray, noise: np.ndarray,
             device: str = "best") -> Dict[str, float]:
    """Run all three harness cases and the quality metrics; int16 fixture
    inputs. ``params`` is the port's module or a numpy tree."""
    dev = resolve_device(device)
    config = dict(config, use_pallas=False)
    engine = make_engine(config.get("kind", "mask_gru"), config)
    if not isinstance(params, torch.nn.Module):
        params = params_from_numpy(params, dev)
    params = params.to(dev)

    mixed = mix_pcm(speech, noise)
    out_speech = _stream_enhance(engine, params, speech, dev)
    out_noise = _stream_enhance(engine, params, noise, dev)
    out_mixed = _stream_enhance(engine, params, mixed, dev)
    return harness_results(speech, noise, out_speech, out_noise, out_mixed)


def mix_pcm(speech: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """The harness's third case: the sample-wise int16 sum, saturated."""
    mixed = speech.astype(np.int32) + noise.astype(np.int32)
    return np.clip(mixed, -32768, 32767).astype(np.int16)


def harness_results(speech: np.ndarray, noise: np.ndarray, out_speech: np.ndarray,
                    out_noise: np.ndarray, out_mixed: np.ndarray,
                    delay: int = DELAY_SAMPLE) -> Dict[str, float]:
    """The harness's metrics of one pair from the three cases' enhanced int16
    outputs, whatever surface made them. ``delay``: how far each output lags
    its input; 0 scores a delay-compensated output (``enhance``'s), every
    frame against its own reference frame and the mix's SI-SDR and STOI over
    all of ``out_mixed``."""
    mixed = mix_pcm(speech, noise)
    n = len(out_mixed) - delay
    results = {
        "dev_pure_speech": rms_case(out_speech, speech, delay),
        "dev_pure_noise": rms_case(out_noise, None, delay),
        "dev_mixed": rms_case(out_mixed, speech, delay),
        "si_sdr_mixed_db": si_sdr(out_mixed[delay:], speech[:n]),
        "si_sdr_input_db": si_sdr(mixed[:n], speech[:n]),
        "stoi_mixed": stoi(speech[:n], out_mixed[delay:]),
        "stoi_input": stoi(speech[:n], mixed[:n]),
        "fwsnrseg_mixed": fwsnrseg(speech[:n], out_mixed[delay:]),
        "fwsnrseg_input": fwsnrseg(speech[:n], mixed[:n]),
    }
    results["si_sdr_gain_db"] = results["si_sdr_mixed_db"] - results["si_sdr_input_db"]
    return results


__all__ = ["evaluate", "harness_results", "mix_pcm", "rms_case", "si_sdr", "stoi"]
