"""The corpus runner's upload: a batch's rows onto this process's devices,
overlapped with the kernels of the batch before.

On a CUDA device a block's copies run on a stream of their own, into one of
two device buffers used in turn (``_Lane``). A buffer is refilled only once
the kernels of the batch that last read it, two batches back, are done (the
event ``release`` records on the compute stream after their launch), and the
compute stream waits for a block's last copy before its kernels run. So the
upload does not wait for the previous batch's kernels.

Rows whose host memory is page-locked go to the card by DMA straight from
the caller's array. Pageable rows are staged chunk by chunk, with torch's
multi-threaded ``copy_``, into a ring of ``SLOTS`` page-locked slots of
``SLOT_BYTES`` (allocated at the first pageable upload), each sent by DMA as
soon as it is full; a slot is refilled only once its last DMA is done. The
host's copy of one chunk overlaps the DMA of the one before.

``upload`` returns once every byte of the caller's rows has been read
(staged into the ring, or, page-locked, copied by its DMA), so the caller
may overwrite them at once. The caller's memory is never page-locked in
place (no ``cudaHostRegister``). A CPU device takes its block by a plain
``.to()``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

# The ring: two 16 MiB slots staged 28.8 GB/s (median) on an H100's host,
# where rings of 128-256 MiB staged 18-19 GB/s; a ring small enough to stay in
# the host's cache seems to spare its memory a write and a read (PERF.md,
# section 6).
SLOT_BYTES = 16 << 20
SLOTS = 2


class _Lane:
    """One CUDA device's copy stream and its two input buffers, used in
    turn; ``released[i]`` follows the kernels that last read buffer ``i``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: List[torch.Tensor] = [None, None]
        self.released: List[torch.cuda.Event] = [None, None]
        self.turn = 0

    def buffer(self, shape, compute) -> torch.Tensor:
        """This turn's buffer, made on the compute stream at its first use:
        its memory may have been freed there by kernels still queued, so
        its first copy waits for them too."""
        buf = self.buffers[self.turn]
        if buf is None or buf.shape != shape:
            buf = torch.empty(shape, dtype=torch.float32, device=self.device)
            self.buffers[self.turn] = buf
            self.released[self.turn] = torch.cuda.Event()
            self.released[self.turn].record(compute)
        return buf


class Uploader:
    """Uploads this process's rows of each batch, one block a local device."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.lanes = [_Lane(d) if d.type == "cuda" else None for d in self.devices]
        self.ring: List[torch.Tensor] = []
        self.ring_done: List[torch.cuda.Event] = [None] * SLOTS
        self.next_slot = 0

    def upload(self, rows: np.ndarray) -> Tuple[List[torch.Tensor], Dict[str, int]]:
        """Contiguous float32 rows [B_local, ...] -> (one block a device,
        {``staged_bytes``: bytes that went through the ring, ``ring_waits``:
        times the host waited for a slot's DMA before refilling it})."""
        host = torch.from_numpy(rows)
        per = host.shape[0] // len(self.devices)
        pinned = any(self.lanes) and host.is_pinned()
        blocks, copied = [], []
        stats = {"staged_bytes": 0, "ring_waits": 0}
        for i, (d, lane) in enumerate(zip(self.devices, self.lanes)):
            part = host[i * per:(i + 1) * per]
            if lane is None:
                blocks.append(part.to(d))
                continue
            compute = torch.cuda.current_stream(d)
            buf = lane.buffer(part.shape, compute)
            with torch.cuda.device(d), torch.cuda.stream(lane.stream):
                if lane.released[lane.turn] is not None:
                    lane.stream.wait_event(lane.released[lane.turn])
                if pinned:
                    buf.copy_(part, non_blocking=True)
                else:
                    stats["ring_waits"] += self._stage(part.reshape(-1), buf.view(-1), lane.stream)
                    stats["staged_bytes"] += part.numel() * part.element_size()
                done = torch.cuda.Event()
                done.record(lane.stream)
            compute.wait_event(done)
            copied.append(done)
            blocks.append(buf)
        if pinned:
            for done in copied:         # the caller's bytes are read
                done.synchronize()
        return blocks, stats

    def release(self) -> None:
        """After the batch's kernels are launched: each device's buffer is
        free once they are done, and the next batch takes the other one."""
        for lane in self.lanes:
            if lane is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(lane.device))
                lane.released[lane.turn] = done
                lane.turn ^= 1

    def _stage(self, src: torch.Tensor, dst: torch.Tensor, stream) -> int:
        """Copy pageable ``src`` into card ``dst`` through the ring, on
        ``stream`` (current); -> the host's waits for a slot."""
        step = SLOT_BYTES // src.element_size()
        if not self.ring:
            self.ring = [torch.empty(step, dtype=src.dtype, pin_memory=True)
                         for _ in range(SLOTS)]
        waits = 0
        for off in range(0, src.numel(), step):
            n = min(step, src.numel() - off)
            k = self.next_slot
            self.next_slot = (k + 1) % SLOTS
            if self.ring_done[k] is not None and not self.ring_done[k].query():
                waits += 1
                self.ring_done[k].synchronize()
            slot = self.ring[k][:n]
            slot.copy_(src[off:off + n])
            dst[off:off + n].copy_(slot, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            self.ring_done[k] = done
        return waits


__all__ = ["Uploader", "SLOT_BYTES", "SLOTS"]
