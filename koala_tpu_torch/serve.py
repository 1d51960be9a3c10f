"""Streaming server: many live audio streams -> batched device steps.

The same service as the JAX package's ``serve.py``, on PyTorch:

  producers (audio callbacks)  --push-->  native StreamPool ring buffers
  dispatch thread: gather ready frames -> masked batched engine step on the
                   device -> int16 output copied to pinned host memory
  route thread:    wait for each step's event -> push the enhanced frames
                   into the native output rings
  consumers (playback callbacks)  <--pull--  native output ring buffers

The engine advances all slots of the pool in lockstep and commits state
only for the streams that gave a real frame (masked commit), so producers at
mixed rates stay exact. Push and pull never touch the device. Every device
operation, copies included, is issued by the dispatch thread: a thread's
current CUDA stream is the device's default stream, so work issued from a
second thread would queue behind the dispatch thread's later steps. The
route thread only waits on CUDA events and reads host memory.

Two kinds of round, chosen from the backlog:
- a full chunk (every stream has ``chunk_frames`` frames or none): the
  ``sequence`` engine (the floor and GRU kernels on a card) over the chunk,
  with the old state kept where a stream had no frames;
- any other backlog, down to one frame (the live case): ``chunk_masked``, a
  fold of ``step_masked`` over the frame slots up to the longest backlog.
On a card the masked step is captured once as a CUDA graph and replayed,
once a frame slot: the eager step is about a hundred launches, and Python
threads of the same process (clients, the route thread) contend with each
for the interpreter lock.

int16 crosses both device boundaries: the gathered frames are uploaded as
they are and converted on the device (``/ 32768``), and the output is
quantized on the device (round half to even, saturate), bit-equal to the
host's conversions because scaling by 32768 is exact in float32.

Scale-out: ``devices=N`` (or ``"all"``) splits the slots into N contiguous
sub-pools, each with its own parameters and state on its own card
(``cuda:0`` .. ``cuda:N-1``); with ``device="cpu"``, N shards on the CPU.
Each round issues every shard's step before the route thread waits on any.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .constants import DELAY_SAMPLE, FRAME_LENGTH, SAMPLE_RATE
from .device import device_scope, resolve_device
from .engine.batch import masked_reset
from .engine.stream import load_model, validate_access_key
from .errors import (
    ERROR_STACK,
    KoalaActivationLimitError,
    KoalaActivationThrottledError,
    KoalaInvalidArgumentError,
    KoalaRuntimeError,
    raise_with_stack,
)
from .hostlib import StreamPool
from .models import params_io
from .sdk import max_streams_quota

logger = logging.getLogger("koala_tpu_torch")


class _Shard:
    """One device's slice of the stream pool: slots [lo, hi). Its state
    tensors are updated in place, so that a captured step graph keeps
    reading and writing the live state."""

    def __init__(self, device: torch.device, lo: int, hi: int, params, state):
        self.device = device
        self.lo = lo
        self.hi = hi
        self.params = params
        self.state = state
        self.graph: Optional["_StepGraph"] = None


def _assign(state, new) -> None:
    """Copy a new state tree into the live state tensors, leaf by leaf."""
    if isinstance(state, dict):
        for k in state:
            _assign(state[k], new[k])
    else:
        state.copy_(new)


def capture_graph(body, device, warm_up=None) -> torch.cuda.CUDAGraph:
    """``body`` captured as a CUDA graph on ``device``. ``warm_up`` (``body``
    when not given) runs once on a side stream first, for the library
    handles and the allocator; it must leave the live buffers as they are."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        (warm_up or body)()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph


class _StepGraph:
    """A shard's masked single-frame step as a CUDA graph: int16 hop and
    active mask in, state committed in place, int16 output out. The eager
    step is about a hundred small launches, each a trip through Python that
    gives up and takes back the interpreter lock; a replay is one. Only the
    step path is captured: it launches none of the counted kernels."""

    def __init__(self, engine, shard: _Shard):
        n, dev = shard.hi - shard.lo, shard.device
        self.hop = torch.zeros((n, FRAME_LENGTH), dtype=torch.int16, device=dev)
        self.active = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.out = torch.zeros((n, FRAME_LENGTH), dtype=torch.int16, device=dev)

        def body():
            new_state, out = engine.step_masked(shard.params, shard.state,
                                                self.hop.to(torch.float32) / 32768.0,
                                                self.active)
            _assign(shard.state, new_state)
            self.out.copy_(_to_pcm(out))

        # the warm-up runs the body itself: no stream is active, so the state
        # is kept as it is
        self.graph = capture_graph(body, dev)

    def replay(self, hop: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        """One masked step on the current stream; returns the output buffer,
        which the next replay overwrites (read it on the same stream)."""
        self.hop.copy_(hop)
        self.active.copy_(active)
        self.graph.replay()
        return self.out


def _to_pcm(x: torch.Tensor) -> torch.Tensor:
    """float [-1, 1) -> int16 on the device: round half to even, saturate."""
    return torch.round(x * 32768.0).clamp_(-32768, 32767).to(torch.int16)


class StreamingServer:
    """Batched streaming enhancement service over ``num_streams`` slots."""

    def __init__(
            self,
            access_key: str,
            num_streams: int,
            model_path: Optional[str] = None,
            device: Optional[str] = None,
            devices: Union[int, str, None] = None,
            capacity_frames: int = 256,
            out_capacity_frames: Optional[int] = None,
            poll_interval_s: float = 0.002,
            chunk_frames: int = 32,
            pipeline_depth: int = 3):
        validate_access_key(access_key)
        quota = max_streams_quota()
        if quota and num_streams > quota:
            # the in-process analog of the reference's license usage limit
            ERROR_STACK.push("requested %d stream slots, AccessKey quota is %d"
                             % (num_streams, quota))
            raise_with_stack(KoalaActivationLimitError, "Initialization failed")
        model_path = model_path or params_io.default_model_path()
        if not os.path.exists(model_path):
            ERROR_STACK.push("could not find model file at `%s`" % model_path)
            raise_with_stack(KoalaInvalidArgumentError, "Initialization failed")

        self.num_streams = num_streams
        dev0 = resolve_device(device or "best")
        dev_list = self._resolve_device_list(dev0, devices, num_streams)

        # contiguous slot ranges, one per device (sizes differ by at most one)
        bounds = np.linspace(0, num_streams, len(dev_list) + 1).astype(int)
        self._shards: List[_Shard] = []
        for d, lo, hi in zip(dev_list, bounds[:-1], bounds[1:]):
            engine, params = load_model(model_path, d)
            self._shards.append(_Shard(d, int(lo), int(hi), params,
                                       engine.init_state((int(hi - lo),), d)))
        self._engine = engine

        self._pool = StreamPool(num_streams, FRAME_LENGTH, capacity_frames)
        # output rings absorb the client's pull cadence; overflow drops
        # (counted) rather than blocking the dispatch thread
        out_cap = out_capacity_frames or max(4 * capacity_frames, 4 * chunk_frames)
        self._out_pool = StreamPool(num_streams, FRAME_LENGTH, out_cap)
        self._chunk_frames = max(1, min(chunk_frames, capacity_frames))
        self._free_slots = list(range(num_streams))
        self._slot_lock = threading.Lock()
        self._out_lock = threading.Lock()
        self._reset_pending = np.zeros((num_streams,), bool)
        # Per-stream reset generation: routing drops in-flight output from
        # before a reset (the deferred routing would otherwise deliver up to
        # a chunk of stale pre-reset audio to a ring that the slot's next
        # client may already own).
        self._reset_gen = np.zeros((num_streams,), np.int64)
        self._reset_lock = threading.Lock()
        self._poll = poll_interval_s
        self._frames_processed = 0
        self._steps = 0
        self._failure: Optional[BaseException] = None

        # A bounded queue caps the device steps in flight: the dispatch
        # thread blocks on put() only when the device is behind, and the
        # state chain (step N's state feeds step N + 1) keeps results exact
        # at any depth.
        self._route_q: "queue.Queue" = queue.Queue(maxsize=max(1, pipeline_depth))
        self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._router = threading.Thread(target=self._route_loop, daemon=True)
        self._thread.start()
        self._router.start()

    @staticmethod
    def _resolve_device_list(dev0: torch.device, devices, num_streams: int):
        if devices in (None, 1):
            return [dev0]
        if dev0.type == "cuda":
            same = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            n = len(same) if devices == "all" else int(devices)
        else:
            # the CPU is one device: N shards of it are asked for explicitly
            n = 1 if devices == "all" else int(devices)
            same = [dev0] * max(n, 1)
        if n < 1 or n > len(same):
            ERROR_STACK.push("requested %s devices, %d available of type `%s`"
                             % (devices, len(same), dev0.type))
            raise_with_stack(KoalaInvalidArgumentError, "Invalid devices argument")
        if num_streams < n:
            ERROR_STACK.push("num_streams=%d < devices=%d" % (num_streams, n))
            raise_with_stack(KoalaInvalidArgumentError, "Invalid devices argument")
        return same[:n]

    # -- producer API (any thread) ----------------------------------------

    def acquire_slot(self) -> int:
        """Claim a free stream slot; raises KoalaActivationThrottledError
        when every slot is busy. Pair with release_slot()."""
        with self._slot_lock:
            if not self._free_slots:
                ERROR_STACK.push("all %d stream slots are busy" % self.num_streams)
                raise_with_stack(KoalaActivationThrottledError,
                                 "Stream admission throttled")
            return self._free_slots.pop()

    def release_slot(self, stream: int) -> None:
        """Reset and return a slot claimed with acquire_slot()."""
        self.reset(stream)
        with self._slot_lock:
            if stream not in self._free_slots:
                self._free_slots.append(stream)

    def push(self, stream: int, samples: np.ndarray) -> bool:
        """Append int16 samples to a stream. False on ring overflow."""
        return self._pool.push(stream, samples)

    def push_block(self, rows: np.ndarray, counts: np.ndarray,
                   first_stream: int = 0) -> int:
        """Batched producer hop: append counts[i] frames from rows[i]
        ([n, k, 256] int16) to streams first_stream + i in one native call.
        Returns the frames accepted (overflowing rings drop)."""
        return self._pool.push_rows(rows, counts, first_stream)

    def pull(self, stream: int, max_frames: Optional[int] = None) -> np.ndarray:
        """Fetch enhanced int16 samples queued for a stream (may be empty)."""
        with self._out_lock:
            ready = self._out_pool.frames_ready(stream)
            take = ready if max_frames is None else min(ready, max_frames)
            if take <= 0:
                return np.zeros((0,), np.int16)
            return self._out_pool.pull(stream, take * FRAME_LENGTH)

    def pull_block(self, max_frames: int):
        """Batched consumer hop: pop up to ``max_frames`` enhanced frames from
        every stream in one native call. Returns (rows [B, k, 256] int16,
        counts [B]); rows beyond counts[i] are zero. The returned buffers are
        reused by the next call; copy to retain."""
        with self._out_lock:
            rows, counts, _ = self._out_pool.gather_chunk(max_frames)
        return rows, counts

    def reset(self, stream: int) -> None:
        """Schedule a stream reset (applied before its next frame)."""
        self._pool.reset_stream(stream)
        with self._reset_lock:
            self._reset_pending[stream] = True
            self._reset_gen[stream] += 1
        # The generation bump above happens before the output-ring clear, so
        # routing (which re-checks generations under _out_lock) either sees
        # the bump and skips, or appends before this clear runs.
        with self._out_lock:
            self._out_pool.reset_stream(stream)

    # -- route thread -------------------------------------------------------

    def _route_loop(self) -> None:
        """Waits on each in-flight step's event and routes its output into
        the native output rings, while the dispatch thread issues the next
        steps."""
        try:
            while True:
                item = self._route_q.get()
                if item is None:                       # close() sentinel
                    return
                self._route(*item)
        except Exception as e:   # a failed route stops the server; close() reports it
            self._fail(e)

    def _route(self, outs, counts, gen) -> None:
        outs_np = []
        for host, event in outs:
            if event is not None:
                event.synchronize()
            outs_np.append(host.numpy())
        n = 0
        with self._out_lock:
            # Re-check generations inside _out_lock: a concurrent reset()
            # bumps the generation before clearing the ring, so either the
            # bump shows here (skip), or this append completes before its
            # clear runs (stale frames removed).
            with self._reset_lock:
                cur_gen = self._reset_gen.copy()
            valid = counts.copy()
            valid[cur_gen != gen] = 0
            for shard, out_np in zip(self._shards, outs_np):
                n += self._out_pool.push_rows(out_np, valid[shard.lo:shard.hi],
                                              first_stream=shard.lo)
        self._frames_processed += n
        self._steps += 1

    # -- dispatch thread ----------------------------------------------------

    def _dispatch_loop(self) -> None:
        # inference mode is per thread: this thread enters it itself
        try:
            with torch.inference_mode():
                while self._running:
                    self._dispatch_round()
        except Exception as e:   # a failed step stops the server; close() reports it
            self._fail(e)

    def _fail(self, e: BaseException) -> None:
        logger.error("streaming server stopped: %r", e, exc_info=e)
        self._failure = self._failure or e
        self._running = False

    def _upload(self, shard: _Shard, rows: np.ndarray) -> torch.Tensor:
        """A private host array -> the same array on the shard's device. On a
        card it goes through pinned memory without waiting: the allocator
        keeps the pinned block until the copy has run."""
        t = torch.from_numpy(rows)
        if shard.device.type != "cuda":
            return t
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        staged.copy_(t)
        return staged.to(shard.device, non_blocking=True)

    def _download(self, shard: _Shard, pcm: torch.Tensor):
        """Start the copy of a round's int16 output to the host. -> (host
        tensor, CUDA event to wait on, or None on the CPU)."""
        if shard.device.type != "cuda":
            return pcm, None
        host = torch.empty(pcm.shape, dtype=torch.int16, pin_memory=True)
        host.copy_(pcm, non_blocking=True)
        event = torch.cuda.Event(blocking=True)   # the waiting thread sleeps
        event.record()
        return host, event

    def _dispatch_round(self) -> None:
        eng = self._engine
        with self._reset_lock:
            pending = self._reset_pending.copy()
            self._reset_pending[:] = False
        for shard in self._shards:
            m = pending[shard.lo:shard.hi]
            if m.any():
                with device_scope(shard.device):
                    fresh = eng.init_state((shard.hi - shard.lo,), shard.device)
                    _assign(shard.state, masked_reset(shard.state, fresh,
                                                      self._upload(shard, m.copy())))

        batch, counts, total = self._pool.gather_chunk(self._chunk_frames)
        # The pool's gather buffers are reused on the next call, and a CPU
        # tensor made from an array shares its memory: every array handed to
        # a step below is a private copy.
        counts = counts.copy()
        # Snapshot generations after the gather, and void the frames of any
        # stream whose reset() landed between the pending snapshot above and
        # the gather: those frames are pre-reset audio already popped from
        # the ring, and reset() promises buffered audio is dropped.
        with self._reset_lock:
            gen_snapshot = self._reset_gen.copy()
            late = self._reset_pending.copy()
        if late.any():
            counts[late] = 0
            total = int(counts.sum())
        if total == 0:
            time.sleep(self._poll)
            return

        k = int(counts.max())
        # all-or-nothing full chunks -> the sequence engine
        full = (k == self._chunk_frames > 1
                and bool(np.all((counts == 0) | (counts == self._chunk_frames))))
        # frame slots past the longest backlog hold no frame: they are not sent
        rows = batch[:, :k].copy()
        outs = []
        for shard in self._shards:
            c = counts[shard.lo:shard.hi]
            with device_scope(shard.device):
                hops = self._upload(shard, rows[shard.lo:shard.hi])
                counts_dev = self._upload(shard, c.copy())
                if full:
                    new_state, out = eng.sequence(shard.params, shard.state,
                                                  hops.to(torch.float32) / 32768.0)
                    _assign(shard.state, masked_reset(shard.state, new_state, counts_dev > 0))
                    pcm = _to_pcm(out)
                elif shard.device.type == "cuda":
                    pcm = self._graphed_steps(shard, hops, counts_dev)
                else:
                    new_state, out = eng.chunk_masked(shard.params, shard.state,
                                                      hops.to(torch.float32) / 32768.0,
                                                      counts_dev)
                    _assign(shard.state, new_state)
                    pcm = _to_pcm(out)
                outs.append(self._download(shard, pcm))
        self._route_q.put((outs, counts, gen_snapshot))

    def _graphed_steps(self, shard: _Shard, hops: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
        """Single-frame and partial-backlog rounds on a card: the masked step
        replayed from a CUDA graph, once for each frame slot (``chunk_masked``
        is the same fold of ``step_masked``). ``hops`` [n, k, 256] int16 ->
        int16 output of the same shape."""
        if shard.graph is None:
            shard.graph = _StepGraph(self._engine, shard)
        g = shard.graph
        out = torch.empty_like(hops)
        for j in range(hops.shape[1]):
            out[:, j].copy_(g.replay(hops[:, j], counts > j))
        return out

    # -- lifecycle ----------------------------------------------------------

    @property
    def stats(self) -> Dict[str, float]:
        return {
            "frames_processed": self._frames_processed,
            "device_steps": self._steps,
            "audio_seconds": self._frames_processed * FRAME_LENGTH / SAMPLE_RATE,
            "dropped_samples": self._pool.dropped_samples,
            "dropped_output_samples": self._out_pool.dropped_samples,
            "devices": len(self._shards),
        }

    @property
    def delay_sample(self) -> int:
        return DELAY_SAMPLE

    @property
    def frame_length(self) -> int:
        return FRAME_LENGTH

    def close(self) -> None:
        """Stop the dispatch thread, route every step still in flight (close
        never drops enhanced audio), and release the input rings. Raises
        KoalaRuntimeError if a device step or a route failed while serving."""
        self._running = False
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if self._router.is_alive():
            self._route_q.put(None)
            self._router.join(timeout=10.0)
        self._pool.close()
        # The output pool stays alive: clients may still pull the audio that
        # close() just drained (it is freed with the server object).
        if self._failure is not None:
            ERROR_STACK.push("serving stopped on: %r" % (self._failure,))
            raise_with_stack(KoalaRuntimeError, "Streaming server failed")


__all__ = ["StreamingServer"]
