"""Worker processes for the host loader (the port's counterpart of
mtlx/data/grain_loader.py; it needs no `grain`).

    loader = make_grain_loader(dataset, batch_size=16, seed=0, worker_count=4)
    for batch in loader:  # numpy dicts, as data/loader.py `batches` gives them
        ...
    loader.close()

The parent process plans every batch as `batches` does (data/loader.py
`BatchPlan`: the epoch shuffles, the bucket grouping, the coalescer) and
hands batch k to worker k % worker_count; each worker maps the record
files anew, decodes the batch, draws its host geometry (seeded by seed,
epoch and record, so no draw depends on which process makes it), collates
and packs it, and sends it back in shared memory (torch.multiprocessing:
each array's bytes go into a shared segment and only its handle crosses
the pipe; pickling 50 MB a batch through the pipe instead slowed the
flagship's steps 2.4 times on an NVIDIA H100 80GB HBM3 at 700 W, the
reading thread taking the interpreter lock for every 64 KiB). The parent yields the
batches in plan order, so the loader yields exactly the batches of
`batches` for the same arguments, whatever the workers' timing. mtlx's
loader takes grain's sampler order instead; this one keeps `batches`'
order so a run with workers is the run without them.

Workers start by `spawn` (the training process already holds CUDA and
threads, where `fork` is unsafe). A worker that fails raises its
traceback in the parent, and a worker that dies raises there too: the
loader never falls back to loading in-process. `close()` (also on
garbage collection) stops and joins every worker.
"""

from __future__ import annotations

import queue as queue_lib
import traceback
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.multiprocessing as mp

from mtlx_torch.data.loader import BatchPlan, DetectionDataset, load_batch

# batches each worker holds ahead of the consumer (device_prefetch holds
# two more): more only adds a burst of decoding at the start that
# competes with the first steps for the host's cores
_AHEAD = 1
# seconds between liveness checks while the parent waits for a batch
_POLL_S = 0.5


def _worker(dataset: DetectionDataset, options: Dict, tasks, results) -> None:
    """A worker's loop: load each (seq, epoch, indices) task until None."""
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            seq, epoch, idx = task
            try:
                batch = load_batch(dataset, idx, epoch, **options)
            except BaseException:
                results.put((seq, None, traceback.format_exc()))
                break
            # tensors cross in shared memory (module docstring)
            results.put((seq, {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                               for k, v in batch.items()}, None))
    finally:
        dataset.close()


class GrainLoader:
    """Iterator over `batches`' batches, loaded by worker processes
    (module docstring). Use make_grain_loader."""

    def __init__(self, dataset: DetectionDataset, batch_size: int, seed: int,
                 shuffle: bool, worker_count: int, num_epochs: Optional[int],
                 drop_remainder: bool, decode_threads: int, pack_images: bool,
                 aspect_grouping: Optional[bool], bucket_multiple: int, host_geometry,
                 max_bucket_variants: int):
        if worker_count < 1:
            raise ValueError(f"worker_count must be >= 1 (loader.batches loads in-process), "
                             f"got {worker_count}")
        plan = BatchPlan(dataset, batch_size, pack_images, aspect_grouping, bucket_multiple,
                         host_geometry, max_bucket_variants)
        self._plan = plan.epochs(shuffle, seed, num_epochs, drop_remainder)
        options = dict(seed=seed, decode_threads=decode_threads, host_geometry=host_geometry,
                       pack_images=pack_images, bucket_multiple=bucket_multiple,
                       coalescer=plan.coalescer)
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(worker_count)]
        self._results = [ctx.Queue() for _ in range(worker_count)]
        self._procs = []
        self._sent = 0  # tasks handed out
        self._next = 0  # the next batch to yield
        self._planned_all = False
        self._closed = False
        try:
            for w in range(worker_count):
                proc = ctx.Process(target=_worker, name=f"mtlx-loader-{w}", daemon=True,
                                   args=(dataset, options, self._tasks[w], self._results[w]))
                proc.start()
                self._procs.append(proc)
            self._fill()
        except BaseException:
            self.close()
            raise

    def _fill(self) -> None:
        """Hand out tasks until every worker holds _AHEAD or the plan ends."""
        while not self._planned_all and self._sent - self._next < _AHEAD * len(self._procs):
            try:
                epoch, idx = next(self._plan)
            except StopIteration:
                self._planned_all = True
                return
            self._tasks[self._sent % len(self._procs)].put((self._sent, epoch, idx))
            self._sent += 1

    def __iter__(self) -> "GrainLoader":
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._closed or (self._planned_all and self._next == self._sent):
            self.close()
            raise StopIteration
        w = self._next % len(self._procs)
        while True:
            try:
                seq, batch, error = self._results[w].get(timeout=_POLL_S)
                break
            except queue_lib.Empty:
                if self._closed:
                    raise StopIteration from None
                if not self._procs[w].is_alive():
                    self._died(w, None)
            except (OSError, EOFError) as e:  # its shared memory went with it
                self._died(w, e)
        if error is not None:
            self.close()
            raise RuntimeError(f"loader worker {w} failed on batch {seq}:\n{error}")
        if seq != self._next:
            self.close()
            raise RuntimeError(f"loader worker {w} sent batch {seq}, expected {self._next}")
        self._next += 1
        self._fill()
        return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in batch.items()}

    def _died(self, w: int, cause: Optional[BaseException]) -> None:
        """Raise for worker w, which exited before sending the next batch."""
        self._procs[w].join(timeout=5)
        code = self._procs[w].exitcode
        self.close()
        raise RuntimeError(f"loader worker {w} exited with code {code} before sending batch "
                           f"{self._next}") from cause

    def close(self) -> None:
        """Stop and join every worker; idempotent."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        for q in self._tasks:
            try:
                q.put(None)
            except (ValueError, OSError):  # the queue is already closed
                pass
        for proc, results in zip(self._procs, self._results):
            # drain what the worker still sends, or its pipe may block its exit
            for _ in range(100):
                try:
                    results.get(timeout=0.05)
                except queue_lib.Empty:
                    if not proc.is_alive():
                        break
                except (OSError, EOFError):  # a batch of a worker that exited: dropped
                    pass
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        for q in self._tasks + self._results:
            q.close()
            q.cancel_join_thread()

    def __del__(self):
        self.close()


def make_grain_loader(
    dataset: DetectionDataset,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
    worker_count: int = 1,
    num_epochs: Optional[int] = None,
    pack_images: bool = False,
    aspect_grouping: Optional[bool] = None,
    host_geometry=None,
    max_bucket_variants: int = 0,
    bucket_multiple: int = 0,
    decode_threads: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """`batches(dataset, batch_size, shuffle, seed, num_epochs,
    drop_remainder, decode_threads, pack_images, aspect_grouping,
    bucket_multiple, host_geometry, max_bucket_variants)`'s batches,
    loaded by `worker_count` worker processes (module docstring)."""
    return GrainLoader(dataset, batch_size, seed, shuffle, worker_count, num_epochs,
                       drop_remainder, decode_threads, pack_images, aspect_grouping,
                       bucket_multiple, host_geometry, max_bucket_variants)
