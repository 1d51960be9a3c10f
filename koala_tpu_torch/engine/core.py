"""Functional engine core: the (params, state, audio) transforms in PyTorch.

The same engine as the JAX package's ``engine/core.py``: STFT -> mask model
-> iSTFT, with all streaming state as an explicit tree of tensors:

    input_carry [*, 256]  last input hop (analysis window left half)
    ola         [*, 256]  synthesis overlap-add tail (the delayed samples)
    model       tree      model-specific recurrent state

A model returns a real mask [*, K] or a complex one, (mask_re, mask_im)
(``apply_mask``); a real mask is applied as it always was, re * mask and
im * mask.

A waveform model (its module declares ``domain = "waveform"``) takes hops
and returns hops with its own analysis and synthesis: its engine state is
``{"model": tree}`` alone, and the engine hands it the hops as they are.

Two execution shapes: ``step`` (one 256-sample hop per stream) and
``sequence`` ([*, T, 256] hops per call). ``sequence_fast`` sends the leading
hops that the model's ``fused_hops`` grants (a multiple of ``T_BLOCK``)
through the fused engine kernel (ops/kernels/engine_fused.py) and the rest
through ``sequence``. Every
function runs on the device its tensors lie on. Output is delayed by
``Engine.delay_sample`` = 256 x the model's ``delay_hops(config)`` samples
(one hop where the module declares none: the STFT's overlap-add). Under a
profiler ``sequence`` records the span ``engine.sequence`` (count ``hops``)
and, inside it, ``engine.model`` around the model's ``apply_sequence``
(count ``frames``); see ``profiling.span``.
"""

from __future__ import annotations

import functools
import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import profiling
from ..constants import FRAME_LENGTH
from ..models.registry import get_model
from ..ops import stft as stft_ops
from ..ops.kernels.engine_fused import fused_sequence


def apply_mask(re, im, mask):
    """The spectrum under a model's mask: a real mask [..., K] scales re and
    im; a complex one, (mask_re, mask_im), multiplies as a complex number."""
    if isinstance(mask, tuple):
        mr, mi = mask
        return mr * re - mi * im, mi * re + mr * im
    return re * mask, im * mask


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Engine:
    """The engine transforms for one (model kind, config)."""

    def __init__(self, kind: str, config: Dict[str, Any]):
        self.kind = kind
        self.config = dict(config)
        self.model = get_model(kind)
        self.waveform = getattr(self.model, "domain", "spectral") == "waveform"
        delay_hops = getattr(self.model, "delay_hops", None)
        self.delay_sample = FRAME_LENGTH * (delay_hops(self.config) if delay_hops else 1)

    def init_state(self, batch_shape: Tuple[int, ...], device):
        batch_shape = tuple(batch_shape)
        device = torch.device(device)
        if self.waveform:
            return {"model": self.model.init_state(batch_shape, self.config, device)}
        return {
            "input_carry": torch.zeros(batch_shape + (FRAME_LENGTH,), device=device),
            "ola": torch.zeros(batch_shape + (FRAME_LENGTH,), device=device),
            "model": self.model.init_state(batch_shape, self.config, device),
        }

    def step(self, params, state, hop):
        """hop [*, 256] float32 in [-1, 1] -> (state', out [*, 256])."""
        if self.waveform:
            model_state, out = self.model.step(params, state["model"], hop, self.config)
            return {"model": model_state}, out
        frame = torch.cat([state["input_carry"], hop], dim=-1)
        re, im = stft_ops.stft_frame(frame)
        model_state, mask = self.model.step(params, state["model"], re, im, self.config)
        synth = stft_ops.istft_frame(*apply_mask(re, im, mask))
        out = synth[..., :FRAME_LENGTH] + state["ola"]
        new_state = {"input_carry": hop, "ola": synth[..., FRAME_LENGTH:],
                     "model": model_state}
        return new_state, out

    def sequence_full(self, params, state, hops):
        """hops [*, T, 256] -> (state', out, mask, (re, im)); ``mask`` is the
        model's: a tensor, or (mask_re, mask_im) for a complex mask; a waveform
        model has neither (None, None)."""
        if self.waveform:
            with profiling.span("engine.model", frames=hops.shape[-2]):
                model_state, out = self.model.apply_sequence(params, state["model"], hops,
                                                             self.config)
            return {"model": model_state}, out, None, None
        t_axis = hops.dim() - 2
        prev = torch.cat([state["input_carry"].unsqueeze(t_axis),
                          hops.narrow(t_axis, 0, hops.shape[t_axis] - 1)], dim=t_axis)
        frames = torch.cat([prev, hops], dim=-1)                 # [*, T, 512]
        re, im = stft_ops.stft_frame(frames)
        with profiling.span("engine.model", frames=hops.shape[t_axis]):
            model_state, mask = self.model.apply_sequence(
                params, state["model"], re, im, self.config)
        synth = stft_ops.istft_frame(*apply_mask(re, im, mask))  # [*, T, 512]
        heads = synth[..., :FRAME_LENGTH]
        tails = synth[..., FRAME_LENGTH:]
        prev_tails = torch.cat([state["ola"].unsqueeze(t_axis),
                                tails.narrow(t_axis, 0, tails.shape[t_axis] - 1)],
                               dim=t_axis)
        out = heads + prev_tails
        new_state = {"input_carry": hops.select(t_axis, hops.shape[t_axis] - 1),
                     "ola": tails.select(t_axis, tails.shape[t_axis] - 1),
                     "model": model_state}
        return new_state, out, mask, (re, im)

    def sequence(self, params, state, hops):
        with profiling.span("engine.sequence", hops=hops.shape[-2]):
            new_state, out, _, _ = self.sequence_full(params, state, hops)
        return new_state, out

    def sequence_fast(self, params, state, hops):
        """Offline/batch fast path: the fused engine kernel over the leading
        hops that the model's ``fused_hops`` grants, the tail through
        ``sequence``; plain ``sequence`` where it grants none or the model
        has no fused entry. Its numerics are the fused kernel's own (bf16
        spectral rounding); chunking stays exact within the fused path."""
        fused_hops = getattr(self.model, "fused_hops", None)
        t8 = fused_hops(params, self.config, hops) if fused_hops is not None else 0
        if not t8:
            return self.sequence(params, state, hops)
        st, out = fused_sequence(params, state, hops[:, :t8], self.config)
        if t8 < hops.shape[1]:
            st, tail = self.sequence(params, st, hops[:, t8:])
            out = torch.cat([out, tail], dim=1)
        return st, out

    def step_masked(self, params, state, hop, active):
        """Lockstep pool step: compute for all streams, commit state only
        where ``active`` [*] (bool) is set; inactive state is bit-preserved."""
        new_state, out = self.step(params, state, hop)

        def select(new, old):
            m = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
            return torch.where(m, new, old)

        return _tree_map(select, new_state, state), out

    def chunk_masked(self, params, state, hops, counts):
        """Backlog-draining pool step: hops [B, k, 256] with each stream's
        valid frames front-packed, counts [B] in [0, k]. A fold of
        ``step_masked`` over the k frame slots."""
        outs = []
        for j in range(hops.shape[-2]):
            state, out = self.step_masked(params, state, hops[..., j, :], j < counts)
            outs.append(out)
        return state, torch.stack(outs, dim=-2)


@functools.lru_cache(maxsize=32)
def _make_engine_cached(kind: str, config_json: str) -> Engine:
    return Engine(kind, json.loads(config_json))


def make_engine(kind: str, config: Dict[str, Any]) -> Engine:
    """Engine factory, cached so all streams of one model share one Engine."""
    return _make_engine_cached(kind, json.dumps(config, sort_keys=True))


def pcm_to_float(pcm) -> np.ndarray:
    """int16 PCM -> float32 in [-1, 1) (scale 1/32768), on the host."""
    return np.asarray(pcm, np.float32) / 32768.0


def float_to_pcm(x) -> np.ndarray:
    """float [-1, 1) -> int16 PCM on the host: round half to even in float64,
    then saturate."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)


__all__ = ["Engine", "make_engine", "apply_mask", "pcm_to_float", "float_to_pcm"]
