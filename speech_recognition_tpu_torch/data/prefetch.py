"""Host-to-device streaming of training batches (port of
speech_recognition_tpu/data/prefetch.py), and the pinned host slots it
shares with ``infer/submission.py::predict_directory``.

The main data path keeps the whole corpus on the device
(``data/device_bank.py``). A corpus that does not fit streams: a
producer thread draws each batch's clip indices, decodes the WAVs with
the native decoder (``data/wav.py::decode_batch_int16``) into a pinned
int16 ``Slot`` and copies it to the card non-blocking on a side stream,
while the card trains on the previous batches. The batch stays int16 on
the wire (half the bytes of float32); ``Trainer._stream_step`` decodes
it on the card, inside the decode+augment kernel.

Reproducibility: the indices come from ``np.random.default_rng(seed)``
in the JAX loader's order, so one seed gives the JAX loader's batches;
the augmentation draws are made by the trainer, on the consumer side,
in step order. The producer touches no ``torch.Generator``.

Data parallelism: the loader keeps its rank's ``process_shard`` of the
files, as the JAX loader is given its process's.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.data.wav import decode_batch_int16

# queue sentinel marking a dead producer (see _produce/__next__)
_PRODUCER_FAILED = object()


class Slot:
    """One batch's host buffers (``streams`` int16 [batch, samples]
    arrays: the clips, and with speed TTA the slow clips), pinned when the
    device is a card, and the event of their last copy to the device: the
    buffers are not written again until that copy has completed."""

    def __init__(self, streams: int, batch_size: int, samples: int,
                 device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.host = [torch.zeros((batch_size, samples), dtype=torch.int16,
                                 pin_memory=self.cuda)
                     for _ in range(streams)]
        self.copied = None

    def fill(self, path_lists: Sequence[Sequence[str]], samples: int):
        if self.copied is not None:
            self.copied.synchronize()
        for buf, paths in zip(self.host, path_lists):
            rows = buf.numpy()
            decode_batch_int16(paths, samples, out=rows)
            rows[len(paths):] = 0

    def upload(self) -> List[torch.Tensor]:
        """Non-blocking copies of the buffers to the device on the
        current stream, then the event that guards the buffers."""
        on_device = [h.to(self.device, non_blocking=True, copy=True)
                     for h in self.host]
        if self.cuda:
            self.copied = torch.cuda.Event()
            self.copied.record()
        return on_device


Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class HostPrefetchLoader:
    """Random training batches from WAV files, decoded ahead on a thread.

    Yields ``(wav int16 [B, T], labels int64 [B], is_silence bool [B])``
    on ``device`` (default: the card). ``prefetch`` batches wait in the
    queue; ``prefetch + 1`` pinned slots take turns. Use it as a context
    manager. A failure in the producer (an unreadable WAV, say) is
    raised by ``next`` as a ``RuntimeError`` whose cause is the error;
    it never hangs the consumer. ``rank``/``world`` pick the loader's
    ``process_shard`` of the files (default: the process group's, or all
    files without one). ``timings`` accumulates host seconds:
    ``decode_s`` (the producer decoding), ``copy_s`` (the producer
    issuing the copies) and ``wait_s`` (the consumer waiting).
    """

    def __init__(self, paths: Sequence[str], labels: np.ndarray,
                 is_silence: np.ndarray, batch_size: int,
                 desired_samples: int = 16000, prefetch: int = 2,
                 seed: int = 0, device: Optional[torch.device] = None,
                 rank: Optional[int] = None, world: Optional[int] = None):
        from speech_recognition_tpu_torch.device import require_cuda
        from speech_recognition_tpu_torch.parallel.distributed import (
            process_shard,
        )

        keep = process_shard(range(len(paths)), rank, world)
        self.paths = [paths[i] for i in keep]
        self.labels = np.asarray(labels, np.int64)[keep]
        self.is_silence = np.asarray(is_silence, bool)[keep]
        self.batch_size = batch_size
        self.desired_samples = desired_samples
        self.prefetch = max(1, prefetch)
        self.device = require_cuda() if device is None else torch.device(
            device)
        self._rng = np.random.default_rng(seed)
        self._slots = [Slot(1, batch_size, desired_samples, self.device)
                       for _ in range(self.prefetch + 1)]
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.timings: Dict[str, float] = dict.fromkeys(
            ("decode_s", "copy_s", "wait_s"), 0.0)

    def _upload(self, slot: Slot, idx: np.ndarray):
        labels = torch.from_numpy(self.labels[idx])
        silence = torch.from_numpy(self.is_silence[idx])
        if self._stream is None:
            return (slot.upload()[0], labels.to(self.device),
                    silence.to(self.device), None)
        with torch.cuda.stream(self._stream):
            labels = labels.to(self.device, non_blocking=True)
            silence = silence.to(self.device, non_blocking=True)
            wav = slot.upload()[0]      # records the slot's event last
        return wav, labels, silence, slot.copied

    def _produce(self):
        try:
            i = 0
            while not self._stop.is_set():
                idx = self._rng.integers(0, len(self.paths),
                                         self.batch_size)
                slot = self._slots[i % len(self._slots)]
                i += 1
                t0 = time.perf_counter()
                slot.fill([[self.paths[j] for j in idx]],
                          self.desired_samples)
                t1 = time.perf_counter()
                item = self._upload(slot, idx)
                self.timings["decode_s"] += t1 - t0
                self.timings["copy_s"] += time.perf_counter() - t1
                self._enqueue(item)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            # a dead producer must not leave __next__ blocking forever:
            # record the error and wake the consumer with a sentinel
            self._error = e
            self._enqueue(_PRODUCER_FAILED)

    def _enqueue(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def __enter__(self):
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._stop.set()
        # drain so the producer can exit a blocking put
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if self._thread is None:
            raise RuntimeError("use as a context manager")
        if self._error is not None and self._queue.empty():
            raise RuntimeError(
                "prefetch producer thread failed") from self._error
        t0 = time.perf_counter()
        item = self._queue.get()
        self.timings["wait_s"] += time.perf_counter() - t0
        if item is _PRODUCER_FAILED:
            raise RuntimeError(
                "prefetch producer thread failed") from self._error
        *batch, copied = item
        if copied is not None:
            # the consumer's stream waits for the copies, and the
            # allocator learns that it uses the side stream's tensors
            current = torch.cuda.current_stream(self.device)
            current.wait_event(copied)
            for t in batch:
                t.record_stream(current)
        return tuple(batch)
