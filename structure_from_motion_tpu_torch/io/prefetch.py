"""Frame ingest one step ahead: decode + host->device upload off-thread
(port of ``structure_from_motion_tpu/io/prefetch.py``).

Getting a frame's pixels into device memory is host work: file read,
decode, and the copy over PCIe. Feeding the engine from this prefetcher
overlaps frame N+1's decode and upload with frame N's compute.

On the card the worker thread decodes a frame, copies it into a PINNED host
buffer (one more host copy a frame: the loader returns its own array) and
uploads that with ``non_blocking=True`` on its own ``torch.cuda.Stream``,
then records an event. The consumer makes the current stream wait on that event before it
hands the tensor over, and calls ``record_stream`` on it, so the caching
allocator does not reuse the frame's memory while a kernel of the consumer's
stream may still read it. A pinned buffer is reused only after its upload's
event has completed. With ``device="cpu"`` the frames are CPU tensors and no
CUDA call is made. A consumer that stops early (``break``, an exception)
ends the worker through :meth:`DevicePrefetcher.close`, which leaving the
iteration calls.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class DevicePrefetcher:
    """Iterate ``(item, device_tensor)`` over ``paths``, staying ``depth``
    frames ahead on a daemon worker thread.

    ``loader``: path -> numpy array (e.g. ``load_image_grayscale``).
    Worker exceptions are re-raised in the consumer at the failing frame's
    position, so error behaviour matches the sequential loop. One pass:
    iterate it once; ``close()`` (also a context manager's exit) stops the
    worker and lets go of the pinned buffers.
    """

    _DONE = object()

    def __init__(self, paths, loader, depth: int = 2, device="cuda"):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._paths = list(paths)
        self._stop = threading.Event()
        self._device = torch.device(device)
        on_card = self._device.type == "cuda"
        if on_card and not torch.cuda.is_available():
            raise RuntimeError("DevicePrefetcher: no CUDA device (pass device='cpu')")
        stream = torch.cuda.Stream(self._device) if on_card else None
        # depth frames wait in the queue, one is with the consumer and one is
        # being filled: after depth + 2 frames a buffer's upload is long done,
        # so the wait before its reuse costs nothing
        ring: list = [None] * (max(1, depth) + 2)

        def upload(i: int, host: torch.Tensor):
            slot = ring[i % len(ring)]
            if slot is not None:
                slot[1].synchronize()  # its last upload has left the buffer
            if slot is None or slot[0].shape != host.shape or slot[0].dtype != host.dtype:
                pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            else:
                pinned = slot[0]
            pinned.copy_(host)
            with torch.cuda.stream(stream):
                buf = pinned.to(self._device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            ring[i % len(ring)] = (pinned, done)
            return buf, done

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has gone; False then."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def work():
            try:
                for i, p in enumerate(self._paths):
                    if self._stop.is_set():
                        return
                    try:
                        host = torch.from_numpy(np.ascontiguousarray(loader(p)))
                        got = upload(i, host) if on_card else (host, None)
                    except BaseException as exc:  # re-raised consumer-side
                        put((p, exc, None))
                        return
                    if not put((p, *got)):
                        return
                put(self._DONE)
            finally:
                ring.clear()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker, drop the frames still queued and wait for it."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        while not self._q.empty():
            self._q.get_nowait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        try:
            while True:
                got = self._q.get()
                if got is self._DONE:
                    return
                path, buf, done = got
                if isinstance(buf, BaseException):
                    raise buf
                if done is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(done)
                    buf.record_stream(current)
                yield path, buf
        finally:
            self.close()
