"""Dynamic-batching inference server.

Port of the JAX package's serve.py.  Callers ``submit`` single examples
or row blocks from any thread and get a ``Future``; a dispatcher thread
coalesces pending rows into one fixed-size zero-padded batch, runs the
pixels -> logits forward (the whole-network head kernel where the config
fuses, models/snn.py:forward_logits_pixels) and hands the result to a
completion thread, which copies it to the host and resolves each future
with its rows.  Padding rows never reach a caller; a request larger than
the batch is chunked across batches and re-assembled.

On the card the dispatcher stages each batch in one of a ring of pinned
host buffers and uploads it on its own stream; the forward runs on a
compute stream that waits for the upload, and the completion thread does
the device -> host copy, so batch i+1's upload and launch overlap batch
i's compute and fetch.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Tuple

import numpy as np
import torch

from ._device import resolve_device
from .data.datasets import EncodeConfig
from .models import snn as model_lib
from .models.config import SNNConfig

__all__ = ["InferenceServer", "ServerStats"]

_IN_FLIGHT = 4  # batches between dispatch and completion


class ServerStats:
    """Counters + a latency ring buffer (seconds, submit->resolve)."""

    def __init__(self, capacity: int, window: int = 1024):
        self._capacity = capacity
        self.requests = 0
        self.rows = 0
        self.batches = 0
        self.padded_rows = 0
        self._lat = deque(maxlen=window)
        self._lock = threading.Lock()

    def _record_batch(self, n_real: int, capacity: int) -> None:
        with self._lock:
            self.batches += 1
            self.padded_rows += capacity - n_real

    def _record_request(self, n_rows: int, latency_s: float) -> None:
        with self._lock:
            self.requests += 1
            self.rows += n_rows
            self._lat.append(latency_s)

    def occupancy(self) -> float:
        """Mean fraction of batch rows that were real requests."""
        with self._lock:
            if not self.batches:
                return 0.0
            total = self.batches * self._capacity
            return (total - self.padded_rows) / total

    def latency_percentiles(self, qs=(50, 99)) -> Tuple[float, ...]:
        with self._lock:
            if not self._lat:
                return tuple(0.0 for _ in qs)
            arr = np.asarray(self._lat)
        return tuple(float(np.percentile(arr, q)) for q in qs)

    def snapshot(self) -> dict:
        p50, p99 = self.latency_percentiles()
        return dict(
            requests=self.requests,
            rows=self.rows,
            batches=self.batches,
            occupancy=self.occupancy(),
            latency_p50_s=p50,
            latency_p99_s=p99,
        )


class _Pending:
    """One chunk of one request: resolve ``agg`` once all chunks land."""

    __slots__ = ("rows", "agg", "slot", "t_submit")

    def __init__(self, rows, agg, slot, t_submit):
        self.rows = rows
        self.agg = agg
        self.slot = slot
        self.t_submit = t_submit


class _Aggregator:
    """Re-assembles chunked requests and resolves the caller's Future."""

    def __init__(self, future: Future, n_chunks: int, single: bool,
                 n_rows: int):
        self.future = future
        self.single = single
        self.n_rows = n_rows
        self._parts: List[Optional[np.ndarray]] = [None] * n_chunks
        self._left = n_chunks
        self._lock = threading.Lock()

    def deliver(self, slot: int, part: np.ndarray) -> bool:
        """Store one chunk's logits; True when the request completed."""
        with self._lock:
            self._parts[slot] = part
            self._left -= 1
            done = self._left == 0
        if done:
            out = (self._parts[0] if len(self._parts) == 1
                   else np.concatenate(self._parts, axis=0))
            # set_result raises InvalidStateError if the caller cancelled
            # the future meanwhile; that must not kill the completion
            # thread.
            if not self.future.cancelled():
                try:
                    self.future.set_result(out[0] if self.single else out)
                except Exception:  # cancelled between check and set
                    pass
        return done

    def fail(self, exc: BaseException) -> None:
        try:
            if not self.future.done():
                self.future.set_exception(exc)
        except Exception:  # cancelled between the check and the set
            pass


class InferenceServer:
    """Coalesce concurrent pixel requests into fixed-shape device batches.

    Parameters
    ----------
    cfg, params:
        The model; ``params`` in the ``{layer: {leaf: tensor}}`` layout,
        copied to ``device`` once.
    batch_size:
        Rows per batch.  Larger batches amortize the serial T-chain.
    max_delay_s:
        How long the dispatcher waits for more rows after the first
        pending request before running a partial (padded) batch.
    encode_config:
        Spike encoding applied on the device (default: TTFS at
        ``cfg.int_time_steps``).
    forward_fn:
        Optional override of the per-batch forward: ``(params, x_f32) ->
        (batch, n_out)`` tensors on ``device``, applied after the wire
        normalization.  Default: ``forward_logits_pixels``.
    input_dtype, input_scale:
        Wire format.  ``np.uint8`` accepts raw bytes and normalizes on the
        device as ``x.float() / input_scale`` (default 255.0, the
        torchvision ``ToTensor`` contract) -- one float32 division,
        bit-equal to a float32 server fed ``x / 255``.  uint8 servers
        reject float submissions.
    device:
        "cuda" (default) or "cpu"; without CUDA only an explicit "cpu"
        is accepted.

    Usage::

        with InferenceServer(cfg, params, batch_size=256) as srv:
            logits = srv.submit(pixels).result()   # (O,) or (B, O)
            label = srv.classify(pixels)
    """

    def __init__(
        self,
        cfg: SNNConfig,
        params,
        *,
        batch_size: int = 256,
        max_delay_s: float = 0.002,
        encode_config: Optional[EncodeConfig] = None,
        forward_fn=None,
        input_dtype=np.float32,
        input_scale: Optional[float] = None,
        device="cuda",
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_s)
        self.enc = encode_config or EncodeConfig(n_steps=cfg.int_time_steps)
        self._in_dtype = np.dtype(input_dtype)
        if self._in_dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise ValueError(
                f"input_dtype must be float32 or uint8, got {self._in_dtype}"
            )
        if input_scale is None:
            input_scale = 255.0 if self._in_dtype == np.uint8 else 1.0
        input_scale = float(input_scale)
        if not np.isfinite(input_scale) or input_scale <= 0.0:
            raise ValueError(
                f"input_scale must be finite and > 0, got {input_scale}"
            )
        self.input_scale = input_scale
        # A copy: JAX arrays are immutable, torch tensors are not, and a
        # server built from ``Trainer.params`` must not follow its updates.
        self.params = {
            name: {k: v.detach().to(self.device).clone()
                   for k, v in group.items()}
            for name, group in params.items()}
        self._inner = forward_fn or (
            lambda p, x: model_lib.forward_logits_pixels(
                cfg, p, x, self.enc, device=self.device)
        )
        self._on_card = self.device.type == "cuda"
        if self._on_card:
            self._h2d = torch.cuda.Stream(self.device)
            self._compute = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
            shape = (self.batch_size, cfg.input_size)
            tdtype = torch.uint8 if self._in_dtype == np.uint8 \
                else torch.float32
            # One more buffer than batches in flight: the one being filled.
            self._pinned = [torch.empty(shape, dtype=tdtype, pin_memory=True)
                            for _ in range(_IN_FLIGHT + 2)]
            self._uploaded = [None] * len(self._pinned)
            self._next_buf = 0
        self.stats = ServerStats(self.batch_size)
        self._queue: deque = deque()
        self._queued_rows = 0
        self._cv = threading.Condition()
        self._closed = False
        self._done_q: deque = deque()
        self._done_cv = threading.Condition()
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="snn-serve-dispatch", daemon=True
        )
        self._completer = threading.Thread(
            target=self._completion_loop, name="snn-serve-complete",
            daemon=True,
        )
        self._thread.start()
        self._completer.start()

    # -- client surface ----------------------------------------------------
    def submit(self, x) -> Future:
        """Enqueue pixels ``(F,)`` or ``(B, F)``; returns a Future whose
        result is the logits ``(O,)`` / ``(B, O)``.  Thread-safe."""
        if self._in_dtype == np.uint8:
            x = np.asarray(x)
            if x.dtype.kind not in "ui":
                raise ValueError(
                    "this server's wire format is uint8 raw bytes; got "
                    f"dtype {x.dtype} (normalize-by-{self.input_scale:g} "
                    "happens on device -- submit the unnormalized "
                    "integer pixels)"
                )
            if x.dtype != np.uint8:
                if x.size and (x.min() < 0 or x.max() > 255):
                    raise ValueError(
                        "integer pixels out of uint8 range [0, 255]"
                    )
                x = x.astype(np.uint8)
        else:
            x = np.asarray(x, dtype=np.float32)
        single = x.ndim == 1
        rows = x[None] if single else x
        if rows.ndim != 2 or rows.shape[1] != self.cfg.input_size:
            raise ValueError(
                f"expected (F,) or (B, F) pixels with F="
                f"{self.cfg.input_size}, got shape {tuple(x.shape)}"
            )
        fut: Future = Future()
        chunks = [
            rows[i:i + self.batch_size]
            for i in range(0, rows.shape[0], self.batch_size)
        ] or [rows]
        agg = _Aggregator(fut, len(chunks), single, rows.shape[0])
        now = time.monotonic()
        with self._cv:
            if self._closed:
                raise RuntimeError("InferenceServer is closed")
            for slot, chunk in enumerate(chunks):
                self._queue.append(_Pending(chunk, agg, slot, now))
                self._queued_rows += chunk.shape[0]
            self._cv.notify()
        return fut

    def classify(self, x) -> np.ndarray:
        """Synchronous argmax labels for ``(F,)`` / ``(B, F)`` pixels."""
        return np.argmax(self.submit(x).result(), axis=-1)

    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher.  ``drain=True`` serves remaining queued
        requests first; ``False`` fails their futures."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._drain = drain
            self._cv.notify()
        self._thread.join()
        with self._done_cv:
            self._done_q.append(None)  # completion-thread sentinel
            self._done_cv.notify()
        self._completer.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher --------------------------------------------------------
    def _take_batch(self) -> List[_Pending]:
        """Pop pending chunks until the batch is full (holds the lock)."""
        taken, room = [], self.batch_size
        while self._queue and self._queue[0].rows.shape[0] <= room:
            p = self._queue.popleft()
            self._queued_rows -= p.rows.shape[0]
            room -= p.rows.shape[0]
            taken.append(p)
        return taken

    def _dispatch_loop(self) -> None:
        if self._on_card:
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and (not self._queue or not self._drain):
                    pending = list(self._queue)
                    self._queue.clear()
                    self._queued_rows = 0
                    for p in pending:
                        p.agg.fail(RuntimeError("InferenceServer closed"))
                    return
                # Wait (briefly) for a full batch unless closing.
                deadline = self._queue[0].t_submit + self.max_delay_s
                while (
                    self._queued_rows < self.batch_size
                    and not self._closed
                    and time.monotonic() < deadline
                ):
                    self._cv.wait(timeout=deadline - time.monotonic())
                    if not self._queue:
                        break
                if self._closed and not self._drain:
                    continue  # loop top fails the pending futures
                if not self._queue:
                    continue
                taken = self._take_batch()
            self._run_batch(taken)

    def _fill(self, out: np.ndarray, taken: List[_Pending]) -> list:
        """Copy the chunks into ``out`` (zero padding); returns spans."""
        off, spans = 0, []
        for p in taken:
            n = p.rows.shape[0]
            out[off:off + n] = p.rows
            spans.append((p, off, n))
            off += n
        out[off:] = 0
        return spans

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self._in_dtype == np.float32 and self.input_scale == 1.0):
            # The uint8 wire bytes become float32 pixels on the device.
            x = x.to(torch.float32) / self.input_scale
        return self._inner(self.params, x)

    def _launch_on_card(self, taken):
        """Stage in a pinned buffer, upload on the copy stream, run the
        forward on the compute stream; returns (logits, done event)."""
        i = self._next_buf
        self._next_buf = (i + 1) % len(self._pinned)
        if self._uploaded[i] is not None:
            self._uploaded[i].synchronize()  # its last upload has finished
        spans = self._fill(self._pinned[i].numpy(), taken)
        with torch.cuda.stream(self._h2d):
            x = self._pinned[i].to(self.device, non_blocking=True)
            up = torch.cuda.Event()
            up.record(self._h2d)
        self._uploaded[i] = up
        with torch.cuda.stream(self._compute):
            self._compute.wait_event(up)
            x.record_stream(self._compute)
            logits = self._forward(x)
            done = torch.cuda.Event()
            done.record(self._compute)
        return spans, (logits, done)

    def _run_batch(self, taken: List[_Pending]) -> None:
        """Dispatch one batch; its (unfetched) result goes to the
        completion thread."""
        n_real = sum(p.rows.shape[0] for p in taken)
        try:
            if self._on_card:
                spans, result = self._launch_on_card(taken)
            else:
                batch = np.empty((self.batch_size, self.cfg.input_size),
                                 self._in_dtype)
                spans = self._fill(batch, taken)
                result = (self._forward(torch.from_numpy(batch)), None)
        except Exception as exc:  # launch failure: fail the batch
            for p in taken:
                p.agg.fail(exc)
            return
        self.stats._record_batch(n_real, self.batch_size)
        with self._done_cv:
            # Backpressure: a small in-flight window overlaps upload and
            # compute without pinning unbounded buffers.
            while len(self._done_q) >= _IN_FLIGHT:
                self._done_cv.wait()
            self._done_q.append((result, spans))
            self._done_cv.notify()

    def _fetch(self, result) -> np.ndarray:
        logits, done = result
        if done is None:
            return logits.detach().numpy()
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(done)
            return logits.detach().to("cpu").numpy()

    def _completion_loop(self) -> None:
        if self._on_card:
            torch.cuda.set_device(self.device)
        while True:
            with self._done_cv:
                while not self._done_q:
                    self._done_cv.wait()
                item = self._done_q.popleft()
                self._done_cv.notify()  # release dispatcher backpressure
            if item is None:
                return
            result, spans = item
            try:
                logits = self._fetch(result)
            except Exception as exc:  # a device fault surfaces here
                for p, _, _ in spans:
                    p.agg.fail(exc)
                continue
            t_done = time.monotonic()
            for p, start, n in spans:
                try:
                    if p.agg.deliver(p.slot, logits[start:start + n]):
                        self.stats._record_request(
                            p.agg.n_rows, t_done - p.t_submit
                        )
                except Exception:  # one bad request must not kill the loop
                    p.agg.fail(RuntimeError("delivery failed"))
