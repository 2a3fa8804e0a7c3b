"""The overlap scheduler: per-bucket collectives issued from the backward.

Bagua overlaps communication with the backward: autograd hooks mark a
bucket ready once every gradient of it has accumulated, and a comm worker
runs the bucket's collective on a stream of its own while the backward goes
on (``bagua_tpu/core/backend.py:1-14``; the JAX package gets the same
overlap from XLA's latency-hiding scheduler on a step whose last microbatch
it peels out of the accumulation scan, ``backend.py:1425-1525``).

:class:`CommWorker` is that worker: one thread a trainer and, on the card,
one ``torch.cuda.Stream``.  :class:`OverlapStep` is one step's schedule.
The trainer's ``register_post_accumulate_grad_hook`` on every parameter calls
:meth:`OverlapStep.on_grad` during the last microbatch's backward; when a
bucket's last gradient arrives, the trainer finalizes its flat (the division
by ``accum_steps``, an armed ``grad.poison``, the error-feedback
compensation) and hands it to :meth:`OverlapStep.submit`, which records an
event on the backward's stream.  Buckets are issued in the launch order
(the plan's, or ``bucket_launch_order`` on two tiers), each one as soon as
it and every bucket before it in that order are ready, so that every rank
issues the same collectives in the same order whatever order its hooks fire
in: gloo and NCCL pair collectives by their order.  The worker waits for the
bucket's event on its stream, runs the family's ``reduce_bucket_grad``
there (codec kernels, host staging, the gloo or NCCL call) and records an
event of its own.  :meth:`OverlapStep.wait` (the main thread, after the
backward) waits for every bucket, raises the worker's exception if one
failed, and makes the current stream wait for each result's event.

Allocator.  A tensor used on a stream other than the one it was made on is
marked with ``record_stream``: each flat handed to the worker for the comm
stream, each result for the stream that waits for it, so that the caching
allocator never hands out its memory while the other stream may still read
it.  The main thread issues nothing on the trainer's process group while a
step's buckets are in flight: the loss allreduce and the guard's MIN run
after :meth:`OverlapStep.wait`.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..communication import BaguaAborted, is_aborted


def _serve(jobs: "queue.SimpleQueue", device_index: Optional[int]) -> None:
    """The worker thread: run jobs in the order they come until ``None``.
    A new thread has no current device until it sets one."""
    if device_index is not None:
        torch.cuda.set_device(device_index)
    while True:
        job = jobs.get()
        if job is None:
            return
        job()
        # a finished job must not keep its step (and through it the
        # trainer) alive while the thread waits for the next one
        del job


class CommWorker:
    """One comm thread (and on the card one comm stream) of a trainer; jobs
    run one at a time in submission order."""

    def __init__(self, device: torch.device):
        index = None
        self.stream = None
        if device.type == "cuda":
            index = torch.cuda.current_device() if device.index is None else device.index
            self.stream = torch.cuda.Stream(index)
        self._jobs: "queue.SimpleQueue" = queue.SimpleQueue()
        # the thread holds the queue, not this object: a trainer that goes
        # away closes its worker (weakref.finalize in the trainer)
        self._thread = threading.Thread(target=_serve, args=(self._jobs, index),
                                        name="bagua-comm-worker", daemon=True)
        self._thread.start()

    def submit(self, job: Callable[[], None]) -> None:
        self._jobs.put(job)

    def wait_for(self, event: threading.Event) -> None:
        """Block until ``event`` is set; raise if the thread ended first (its
        queued jobs would never run)."""
        while not event.wait(1.0):
            if not self._thread.is_alive():
                raise RuntimeError("the overlap scheduler's comm worker thread has ended")

    def flush(self) -> None:
        """Block until every job submitted so far has run."""
        done = threading.Event()
        self._jobs.put(done.set)
        self.wait_for(done)

    def close(self) -> None:
        """Stop the thread after the jobs already submitted."""
        self._jobs.put(None)

    def stream_context(self):
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()


class OverlapStep:
    """The schedule of one overlapped step over the buckets of ``plan``.

    ``finalize(i)`` returns bucket ``i``'s final flat (the trainer's
    division, poison and compensation, enqueued on the current stream);
    ``reduce(i, flat)`` is the family's ``reduce_bucket_grad``, run on the
    worker.  ``order`` is the launch order.  The hooks and the main thread
    call :meth:`on_grad` and :meth:`submit_pending` one at a time
    (autograd's backward thread while the main thread waits in
    ``backward()``, then the main thread); the worker writes the results,
    which the main thread reads after :meth:`wait`."""

    def __init__(self, worker: CommWorker, plan, order: Sequence[int],
                 finalize: Callable[[int], torch.Tensor],
                 reduce: Callable[[int, torch.Tensor], torch.Tensor]):
        self.worker = worker
        self.n = len(plan.buckets)
        if sorted(order) != list(range(self.n)):
            raise ValueError(f"launch order {list(order)} is not a permutation of "
                             f"{self.n} buckets")
        self.order = list(order)
        self._finalize = finalize
        self._reduce = reduce
        self._bucket_of: Dict[str, int] = {t.name: i for i, b in enumerate(plan.buckets)
                                           for t in b.tensors}
        self._remaining = [len(b.tensors) for b in plan.buckets]
        self._ready: Dict[int, Tuple[torch.Tensor, Optional[torch.cuda.Event]]] = {}
        self._submitted = [False] * self.n
        self._next = 0
        #: bucket indices in the order the worker issued them
        self.issued: List[int] = []
        self.results: List[Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event]]]] = \
            [None] * self.n
        self.error: Optional[BaseException] = None
        self._done = 0
        self._finished = threading.Event()

    # -- the backward's side ---------------------------------------------------

    def on_grad(self, name: str) -> None:
        """A parameter's gradient accumulated: its bucket goes when this
        was the bucket's last one."""
        i = self._bucket_of[name]
        self._remaining[i] -= 1
        if self._remaining[i] == 0:
            self.submit(i, self._finalize(i))

    def pending(self) -> List[int]:
        """The buckets not submitted yet, in plan order."""
        return [i for i in range(self.n) if not self._submitted[i]]

    def submit_pending(self) -> None:
        """After the backward: every bucket it did not finish (some of its
        parameters got no gradient), in plan order."""
        for i in self.pending():
            self.submit(i, self._finalize(i))

    def submit(self, i: int, flat: torch.Tensor) -> None:
        """Bucket ``i``'s final flat, written by work already enqueued on the
        current stream: queue every bucket whose turn in the launch order
        has come."""
        if self._submitted[i]:
            raise RuntimeError(f"bucket {i} was submitted twice in one step")
        self._submitted[i] = True
        written = None
        if self.worker.stream is not None:
            written = torch.cuda.Event()
            written.record()
            flat.record_stream(self.worker.stream)
        self._ready[i] = (flat, written)
        while self._next < self.n and self.order[self._next] in self._ready:
            j = self.order[self._next]
            self._next += 1
            flat_j, written_j = self._ready.pop(j)
            self.worker.submit(lambda j=j, f=flat_j, w=written_j: self._run(j, f, w))

    # -- the worker's side -------------------------------------------------------

    def _run(self, i: int, flat: torch.Tensor, written) -> None:
        try:
            if self.error is None:   # after a failure the rest is skipped
                if is_aborted():
                    raise BaguaAborted(f"aborted before bucket {i}'s collective")
                with self.worker.stream_context():
                    if written is not None:
                        self.worker.stream.wait_event(written)
                    out = self._reduce(i, flat)
                    done = None
                    if self.worker.stream is not None:
                        done = torch.cuda.Event()
                        done.record()
                self.results[i] = (out, done)
                self.issued.append(i)
        except BaseException as e:   # raised again on the main thread by wait()
            if self.error is None:
                self.error = e
        finally:
            self._done += 1
            if self._done == self.n:
                self._finished.set()

    # -- the main thread's side --------------------------------------------------

    def wait(self) -> List[torch.Tensor]:
        """Every bucket's result in plan order, ordered before the current
        stream's later work; raises the worker's exception if a bucket's
        collective failed.  Every bucket must have been submitted."""
        if self.pending():
            raise RuntimeError(f"buckets {self.pending()} were never submitted")
        self.worker.wait_for(self._finished)
        if self.error is not None:
            raise self.error
        out = []
        for result in self.results:
            t, done = result
            if done is not None:
                stream = torch.cuda.current_stream()
                stream.wait_event(done)
                t.record_stream(stream)
            out.append(t)
        return out

    def abandon(self, exc: BaseException) -> None:
        """The step failed before every bucket was submitted: skip the
        buckets still queued and return once the worker is idle."""
        if self.error is None:
            self.error = exc
        self.worker.flush()
