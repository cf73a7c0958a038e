"""Host-to-device prefetch for the streamed training path.

The port of the JAX package's ``data/prefetch.py``: a producer thread runs
the host-side batch iterator ``depth`` items ahead of the consumer, behind a
bounded queue. On the card each batch's tensors go through pinned memory
and ``non_blocking`` copies on a side stream, and an event recorded after
the copies orders the batch before the consumer's next kernel, so the
transfer overlaps the step before it. On the CPU the batch passes through
as it is.
"""

import queue
import threading
from typing import Iterator, Union

import torch

_END = object()


def prefetch_to_device(iterator: Iterator, depth: int = 3,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Iterator:
    """Wrap an iterator of ``(Batch, ...)`` tuples (or bare batches) so that
    element 0 arrives on ``device``.

    - ``depth``: the most items buffered ahead of the consumer.

    The generator is safe to abandon early: closing it (or letting it be
    garbage-collected) stops the producer thread. Exceptions raised by the
    source iterator are re-raised in the consumer.
    """
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place(item):
        """(the item, its batch on ``device``; the event after the copies,
        or None on the CPU)."""
        head = item[0] if isinstance(item, tuple) else item
        event = None
        if side is None:
            head = head.to(device)
        else:
            with torch.cuda.stream(side):
                head = type(head)(*(t.pin_memory().to(device,
                                                      non_blocking=True)
                                    for t in head))
                event = torch.cuda.Event()
                event.record(side)
        return ((head,) + item[1:] if isinstance(item, tuple) else head,
                head, event)

    def emit(payload) -> bool:
        """Blocking put that gives up when the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(payload, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not emit(place(item)):
                    return
            emit(_END)
        except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
            emit(exc)

    thread = threading.Thread(target=producer, daemon=True,
                              name="batch-prefetch")
    thread.start()
    try:
        while True:
            placed = q.get()
            if placed is _END:
                return
            if isinstance(placed, BaseException):
                raise placed
            item, head, event = placed
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for tensor in head:  # freed only after the consumer's use
                    tensor.record_stream(current)
            yield item
    finally:
        stop.set()
