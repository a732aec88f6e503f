"""Host-side input pipeline: threaded sample assembly + batch prefetch.

The port's own copy of ``BatchLoader`` from
``vit_grid_model_tpu/data/pipeline.py``, with the options the port uses.
Assembly stays on host threads (numpy + file I/O, which release the GIL),
batches come from the dataset's ``collate``, and a bounded queue of ready
batches is prefetched so the device does not wait on the filesystem.
``device_prefetch`` keeps one batch's host->device copy in flight.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator

import numpy as np

from vit_grid_model_tpu_torch.data.bufferpool import POOL


class BatchLoader:
    """Map-style dataset -> batched numpy tuples, the last batch ragged.

    Deterministic order (``shuffle=False``, the eval loader) unless
    ``shuffle`` is set; every epoch draws from ``seed + epoch``.
    ``shuffle`` takes ``"batches"`` and ``"buffer"`` besides True/False:

    * ``"batches"``: the epoch is cut into CONSECUTIVE-index batches (at a
      per-epoch random rotation) and the batch ORDER is shuffled, which
      keeps the union-assembly fast path (``get_batch_collated``) at the
      cost of coarse SGD noise;
    * ``"buffer"``: union-assembled consecutive batches feed a reservoir
      of ``shuffle_buffer * batch_size`` samples, and emitted batches draw
      ``batch_size`` samples uniformly from it.
    """

    #: ready batches queued ahead of the consumer
    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, *, shuffle=False,
                 seed: int = 0, num_workers: int = 4, shuffle_buffer: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.collate = dataset.collate
        self.shuffle_buffer = max(2, shuffle_buffer)
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle in ("batches", "buffer"):
            # rotate the epoch (re-randomizes the cut points), chunk into
            # consecutive runs, shuffle the run order; the wrap-around chunk
            # takes the per-sample assembly path
            rng = np.random.default_rng(self.seed + self._epoch)
            idx = np.roll(idx, int(rng.integers(max(len(idx), 1))))
            starts = np.arange(0, len(idx), self.batch_size)
            rng.shuffle(starts)
            for s in starts:
                chunk = idx[s:s + self.batch_size]
                if len(chunk):
                    yield chunk
            return
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            yield idx[s:s + self.batch_size]

    def _buffer_shuffle(self, stream) -> Iterator:
        """Local (reservoir) shuffle over union-assembled source batches.
        Entries are (source_batch, row) references; the one copy happens at
        emission, into pooled output buffers.  The pool's retention cap per
        field shape ratchets to the observed number of pinned source batches
        (+6 for the emitted batches in flight), so released buffers are
        reused instead of re-allocated."""
        keyed: Dict[tuple, int] = {}

        def ensure_keys(fields, lead_n, retain):
            for f in fields:
                a = np.asarray(f)
                k = POOL.key((lead_n,) + a.shape[1:], a.dtype)
                if keyed.get(k, 0) < retain:
                    keyed[k] = retain
                    POOL.ensure_retention(retain, k)
        # a stream distinct from _batch_indices' default_rng(seed + epoch)
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, self._epoch, 0x5E5E)))
        cap = self.shuffle_buffer * self.batch_size
        entries: list = []                       # (batch_tuple, row)

        def emit(n):
            pick = rng.choice(len(entries), size=n, replace=False)
            chosen = [entries[t] for t in pick]
            for t in sorted(pick, reverse=True):
                entries.pop(t)
            ensure_keys(chosen[0][0], n, self.shuffle_buffer + 6)
            fields = []
            for f_idx in range(len(chosen[0][0])):
                proto = np.asarray(chosen[0][0][f_idx])
                buf = POOL.get((n,) + proto.shape[1:], proto.dtype)
                for j, (src, i) in enumerate(chosen):
                    buf[j] = src[f_idx][i]
                fields.append(buf)
            return tuple(fields)

        peak_pinned = 0
        for batch in stream:
            src_n = np.asarray(batch[0]).shape[0]
            for i in range(src_n):
                entries.append((batch, i))
            pinned = len({id(e[0]) for e in entries})
            if pinned > peak_pinned:
                peak_pinned = pinned
                ensure_keys(batch, src_n, peak_pinned + 6)
            while len(entries) >= cap:
                yield emit(self.batch_size)
        while entries:                               # epoch drain
            yield emit(min(self.batch_size, len(entries)))

    def __iter__(self) -> Iterator:
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(self.PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that abandons the iterator sets `stop`; a plain
            # blocking put would pin this thread and its batches forever
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def assembled():
            """Collated batches in epoch (chunk) order."""
            if getattr(self.dataset, "prefers_single_dispatch", False):
                # the native assembler's internal pool is the only
                # parallelism: get_batch_collated, else union assembly +
                # collate
                for chunk in self._batch_indices():
                    if stop.is_set():
                        return
                    batch = self.dataset.get_batch_collated(chunk)
                    if batch is None:
                        batch = self.collate(self.dataset.get_batch(chunk))
                    yield batch
            else:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in self._batch_indices():
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                chunk))
                        yield self.collate(samples)

        def produce():
            try:
                stream = assembled()
                if self.shuffle == "buffer":
                    stream = self._buffer_shuffle(stream)
                for batch in stream:
                    if not put(("batch", batch)):
                        return
            except BaseException as e:  # surface worker errors to consumer
                put(("error", e))
                return
            put(("done", None))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "batch":
                    yield payload
                elif kind == "error":
                    raise payload
                else:
                    return
        finally:
            stop.set()


def device_prefetch(batches: Iterator, put: Callable) -> Iterator:
    """Overlap host->device transfer with compute: keep one batch in flight.

    ``put`` stages one batch, typically a copy from page-locked memory with
    ``non_blocking=True`` to an explicit device; batch k+1's ``put`` runs
    before batch k is yielded, so its copy overlaps batch k's forward.
    """
    it = iter(batches)
    try:
        pending = put(next(it))
    except StopIteration:
        return
    for nxt in it:
        nxt_dev = put(nxt)
        yield pending
        pending = nxt_dev
    yield pending
