"""Threaded write buffer: the analog of the reference's writer pthread +
block ring (codec_buf.c:542-631).

The reference overlaps sink latency (device/file writes) with processing via
a writer thread draining a block queue, with commands for drop/drain and a
short-write error latch that surfaces in the main event loop
(codec_buf.c:598-607, dsp.c:661-671). Here the producer is the device-fetch
loop; wrapping the OutputWriter in this thread overlaps host encode + file
I/O with the next device dispatch.
"""

import queue
import threading


class AsyncWriter:
    """Wraps an OutputWriter; same surface plus delay/drop/drain."""

    def __init__(self, writer, max_blocks=8):
        self.writer = writer
        self._q = queue.Queue(maxsize=max_blocks)
        self._error = None
        self._queued_frames = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # pass-throughs the CLI pokes at
    @property
    def codec(self):
        return self.writer.codec

    @codec.setter
    def codec(self, c):
        self.drain()
        self.writer.codec = c

    @property
    def add_dither(self):
        return self.writer.add_dither

    @add_dither.setter
    def add_dither(self, v):
        # drain first: queued blocks belong to the previous dither decision
        # (sequence mode changes this between input groups)
        self.drain()
        self.writer.add_dither = v

    @property
    def dither_mult(self):
        return self.writer.dither_mult

    @dither_mult.setter
    def dither_mult(self, v):
        self.drain()
        self.writer.dither_mult = v

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                if self._error is None:
                    self.writer.write(item)
            except Exception as e:  # error latch (codec_buf.c:598-607)
                self._error = e
            finally:
                with self._lock:
                    self._inflight -= 1
                    self._queued_frames -= len(item)
                    self._idle.notify_all()

    def write(self, buf):
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        with self._lock:
            self._inflight += 1
            self._queued_frames += len(buf)
        self._q.put(buf)

    def delay(self):
        """Buffered frames (queue + sink), for seek latency compensation."""
        with self._lock:
            q = self._queued_frames
        return q + self.writer.codec.delay()

    def drop(self):
        """Discard queued blocks and the sink's buffer (seek/flush)."""
        drained = []
        try:
            while True:
                drained.append(self._q.get_nowait())
        except queue.Empty:
            pass
        with self._lock:
            for b in drained:
                self._inflight -= 1
                self._queued_frames -= len(b)
            # a block the worker dequeued BEFORE the drain is still in
            # flight; wait for it so it can't land on the freshly flushed
            # sink after codec.drop() (stale pre-seek audio). Bounded: a
            # sink stalled mid-write (hung device) must not hang the event
            # loop — after ~5 s give up (one stale block beats a freeze)
            deadline = 10
            while self._inflight > 0 and deadline > 0:
                self._idle.wait(timeout=0.5)
                deadline -= 1
            self._idle.notify_all()
        self.writer.codec.drop()

    def drain(self):
        """Block until every queued block reached the sink."""
        with self._idle:
            while self._inflight > 0:
                self._idle.wait(timeout=5.0)
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def close(self):
        self.drain()
        self._q.put(None)
        self._thread.join(timeout=5.0)
