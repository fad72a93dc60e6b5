"""Threaded input read buffer with a command queue — the read side of the
reference's codec_buf (codec_buf.c:247-447), as dsp_tpu's cli/readbuf.py
has it. The interactive runtime reads its inputs through it.

One reader thread walks the input list and decodes ahead into a bounded
block queue. Commands are multiplexed with block production exactly like the
reference's single `pending` semaphore design:

  * SEEK   — seek the current input's codec and drop already-decoded stale
             blocks (codec_buf.c:268-279 analog); the consumer never sees
             pre-seek data
  * PAUSE / UNPAUSE — pause REALTIME input codecs and stop filling
  * SKIP   — abandon the rest of the current input and advance
  * TERM   — shut down

Other reference semantics reproduced:

  * repeats are handled by the reader seeking back on EOF
    (codec_buf.c:308-317)
  * a zero-frame block marks end-of-input (codec_buf.c:325)
  * the reader suspends AHEAD of an input with the REALTIME hint until the
    consumer has drained every earlier input's blocks, so a capture device
    doesn't start recording early (codec_buf.c:330-338)
  * `delay()` = queued-but-unconsumed frames + device delay
    (codec_buf.c:349-364)
  * unbuffered fast path when every input has NO_BUF or the buffer ratio is
    < 2: no thread, reads go straight to the codec (codec_buf.h:102-126)
"""

import threading
from collections import deque

import numpy as np

from dsp_tpu_torch.core import log
from dsp_tpu_torch.codecs.base import CODEC_HINT_NO_BUF, CODEC_HINT_REALTIME


class _EndOfInput:
    """Zero-frame marker block (codec_buf.c:325)."""

    __slots__ = ("input_idx",)

    def __init__(self, input_idx):
        self.input_idx = input_idx


class ReadBuffer:
    """inputs: list with .codec / .start_pos / .end_pos / .repeats
    (dsp_tpu_torch.cli.main._Input). The consumer drives one input at a time:
    read() until it returns an empty array, then next_input()."""

    def __init__(self, inputs, block_frames, n_blocks=8, force_thread=False):
        self.inputs = list(inputs)
        self.block_frames = int(block_frames)
        self.n_blocks = max(2, int(n_blocks))
        self.cur_idx = 0  # consumer-side input index
        self._consumer_eof = False
        self.error = None  # first reader-side exception (error latch)
        self.unbuffered = not force_thread and all(
            (inp.codec.hints & CODEC_HINT_NO_BUF) or getattr(inp.codec, "buf_ratio", 0) < 2
            for inp in self.inputs
        )
        if self.unbuffered:
            self._pos = [inp.start_pos for inp in self.inputs]
            self._repeats = [inp.repeats for inp in self.inputs]
            return
        self._mu = threading.Condition()
        self._queue = deque()  # ndarray blocks or _EndOfInput markers
        self._queued_frames = 0
        self._commands = deque()
        self._stop = False
        self._paused = False
        self._reader_idx = 0  # reader-side input index
        self._reader_pos = self.inputs[0].start_pos if self.inputs else 0
        self._reader_repeats = self.inputs[0].repeats if self.inputs else 0
        self._drained_through = -1  # consumer finished inputs <= this index
        self._thread = threading.Thread(target=self._worker, daemon=True, name="readbuf")
        self._thread.start()

    # --- reader thread ---

    def _worker(self):
        """Wrapper: any escaped exception latches an error and shuts the
        buffer down instead of silently killing the thread (which would
        leave read() blocked forever and _command callers hung). Mirrors
        the reference write-buffer error latch (codec_buf.c:598-607)."""
        try:
            self._worker_loop()
        except Exception as e:  # pragma: no cover - defense in depth
            log.error("readbuf: error: %s", e)
            with self._mu:
                self.error = self.error or e
                self._stop = True
                self._consumer_eof = True  # read() returns empty AND
                # end_of_input() is True, so the consumer exits instead of
                # spinning on empty reads
                for _, _, done in self._commands:
                    if done is not None:
                        done.set()
                self._commands.clear()
                self._mu.notify_all()

    def _worker_loop(self):
        while True:
            with self._mu:
                self._mu.wait_for(
                    lambda: self._stop
                    or self._commands
                    or (
                        not self._paused
                        and len(self._queue) < self.n_blocks
                        and self._reader_idx < len(self.inputs)
                        and not self._realtime_blocked_locked()
                    )
                )
                if self._stop:
                    return
                if self._commands:
                    cmd, arg, done = self._commands.popleft()
                    self._apply_command_locked(cmd, arg)
                    if done is not None:
                        done.set()
                    self._mu.notify_all()
                    continue
                if self._reader_idx >= len(self.inputs):
                    self._mu.wait_for(lambda: self._stop or self._commands)
                    continue
                idx = self._reader_idx
                inp = self.inputs[idx]
                pos = self._reader_pos
            # produce one block outside the lock (decode may be slow)
            want = self.block_frames
            if inp.end_pos >= 0:
                want = min(want, max(inp.end_pos - pos, 0))
            decode_error = None
            try:
                buf = inp.codec.read(want) if want > 0 else np.zeros((0, inp.codec.channels))
            except Exception as e:
                # a decode error ends this input (the reference's C codecs
                # report errors as short/zero reads -> end-of-codec); latch
                # it so the app can report a nonzero exit
                log.error("readbuf: %s: read error: %s", getattr(inp, "path", "?"), e)
                decode_error = e
                buf = np.zeros((0, inp.codec.channels))
            with self._mu:
                if self._stop:
                    return
                # a command may have arrived mid-decode; append the block
                # anyway (the codec consumed those frames) — seek/skip drop
                # stale blocks when the command is applied, like the
                # reference's read_queue_drop (codec_buf.c:177-192)
                self._reader_pos += len(buf)
                at_end = len(buf) < want or want == 0 or (
                    inp.end_pos >= 0 and self._reader_pos >= inp.end_pos
                )
                if len(buf):
                    self._queue.append(np.asarray(buf, dtype=np.float64))
                    self._queued_frames += len(buf)
                if decode_error is not None:
                    self.error = self.error or decode_error
                    self._queue.append(_EndOfInput(idx))
                    self._advance_reader_locked()
                elif at_end:
                    if self._reader_repeats != 0 and self._try_seek(inp, inp.start_pos) >= 0:
                        if self._reader_repeats > 0:
                            self._reader_repeats -= 1
                        self._reader_pos = inp.start_pos
                    else:
                        self._queue.append(_EndOfInput(idx))
                        self._advance_reader_locked()
                self._mu.notify_all()

    @staticmethod
    def _try_seek(inp, pos):
        try:
            return inp.codec.seek(pos)
        except Exception:
            return -1

    def _advance_reader_locked(self):
        self._reader_idx += 1
        if self._reader_idx < len(self.inputs):
            nxt = self.inputs[self._reader_idx]
            self._reader_pos = nxt.start_pos
            self._reader_repeats = nxt.repeats

    def _realtime_blocked_locked(self):
        """Suspend ahead of a REALTIME input until the consumer has drained
        every earlier input (codec_buf.c:330-338)."""
        idx = self._reader_idx
        if idx >= len(self.inputs):
            return False
        if not (self.inputs[idx].codec.hints & CODEC_HINT_REALTIME):
            return False
        return self._drained_through < idx - 1 or any(
            isinstance(b, _EndOfInput) or len(b) for b in self._queue
        )

    def _apply_command_locked(self, cmd, arg):
        if cmd == "seek":
            target = arg
            # seek the current input FIRST; queued audio is dropped only on
            # success (read_queue_seek drops via `if (*pos >= 0)
            # read_queue_drop`, codec_buf.c:216-218) — a failed seek on an
            # unseekable input must not discard buffered blocks (that would
            # skip several seconds of audio while staying "in place").
            # Simplification vs the reference's back-to-front walk: failure
            # is a total no-op here (the reference may have already rewound
            # later inputs when the current input's seek fails).
            rewound = self._reader_idx > self.cur_idx
            inp = self.inputs[self.cur_idx]
            got = self._try_seek(inp, target)
            self._seek_result = got
            if got >= 0:
                # rewind later inputs the reader pre-read, then drop the
                # queue (codec_buf.c:195-230 walks from the back doing this)
                for i in range(self.cur_idx + 1, min(self._reader_idx + 1, len(self.inputs))):
                    self._try_seek(self.inputs[i], self.inputs[i].start_pos)
                self._drop_queue_locked()
                self._reader_idx = self.cur_idx
                self._reader_pos = got
                if rewound:
                    # the reader already exhausted this input's repeats
                    # before advancing past it
                    self._reader_repeats = 0
                self._consumer_eof = False
        elif cmd == "pause":
            self._paused = arg
            for inp in self.inputs:
                if inp.codec.hints & CODEC_HINT_REALTIME:
                    try:
                        inp.codec.pause(arg)
                    except Exception:
                        pass
        elif cmd == "skip":
            # drop only the current input's blocks (read_queue_skip drops
            # the front input's blocks, codec_buf.c:233-246); later inputs'
            # prefetched blocks stay queued
            while self._queue:
                blk = self._queue[0]
                if isinstance(blk, _EndOfInput):
                    if blk.input_idx == self.cur_idx:
                        self._queue.popleft()
                    break
                self._queued_frames -= len(blk)
                self._queue.popleft()
            if self._reader_idx == self.cur_idx:
                self._advance_reader_locked()
            self._consumer_eof = True

    def _drop_queue_locked(self):
        self._queue.clear()
        self._queued_frames = 0

    def _command(self, cmd, arg=None, wait=True):
        if self.unbuffered:
            return self._command_unbuffered(cmd, arg)
        done = threading.Event() if wait else None
        with self._mu:
            self._commands.append((cmd, arg, done))
            self._mu.notify_all()
        if done is not None:
            done.wait()

    def _command_unbuffered(self, cmd, arg):
        if cmd == "seek":
            got = self._try_seek(self.inputs[self.cur_idx], arg)
            self._seek_result = got
            if got >= 0:
                self._pos[self.cur_idx] = got
                self._consumer_eof = False
        elif cmd == "pause":
            for inp in self.inputs:
                if inp.codec.hints & CODEC_HINT_REALTIME:
                    try:
                        inp.codec.pause(arg)
                    except Exception:
                        pass
        elif cmd == "skip":
            self._consumer_eof = True

    # --- consumer API ---

    def cur(self):
        return self.inputs[self.cur_idx]

    def read(self, want):
        """Up to `want` frames of the CURRENT input; empty array at its end."""
        ch = self.cur().codec.channels
        if self._consumer_eof or want <= 0:
            return np.zeros((0, ch))
        if self.unbuffered:
            return self._read_unbuffered(want)
        out = []
        got = 0
        while got < want:
            with self._mu:
                self._mu.wait_for(lambda: self._stop or self._queue)
                if self._stop:
                    break
                blk = self._queue[0]
                if isinstance(blk, _EndOfInput):
                    if got == 0:
                        self._queue.popleft()
                        self._consumer_eof = True
                        self._mu.notify_all()
                    break
                take = min(len(blk), want - got)
                if take == len(blk):
                    self._queue.popleft()
                else:
                    self._queue[0] = blk[take:]
                self._queued_frames -= take
                out.append(blk[:take])
                got += take
                self._mu.notify_all()
        return np.concatenate(out, axis=0) if out else np.zeros((0, ch))

    def _read_unbuffered(self, want):
        inp = self.cur()
        pos = self._pos[self.cur_idx]
        if inp.end_pos >= 0:
            want = min(want, max(inp.end_pos - pos, 0))
        buf = inp.codec.read(want) if want > 0 else np.zeros((0, inp.codec.channels))
        self._pos[self.cur_idx] = pos + len(buf)
        at_end = len(buf) < want or want == 0 or (
            inp.end_pos >= 0 and self._pos[self.cur_idx] >= inp.end_pos
        )
        if at_end:
            if self._repeats[self.cur_idx] != 0 and inp.codec.seek(inp.start_pos) >= 0:
                if self._repeats[self.cur_idx] > 0:
                    self._repeats[self.cur_idx] -= 1
                self._pos[self.cur_idx] = inp.start_pos
            else:
                self._consumer_eof = True
        return np.asarray(buf, dtype=np.float64)

    def end_of_input(self):
        return self._consumer_eof

    def next_input(self):
        """Advance the consumer to the next input; False when exhausted."""
        if not self.unbuffered:
            with self._mu:
                self._drained_through = max(self._drained_through, self.cur_idx)
                self._mu.notify_all()
        if self.cur_idx + 1 >= len(self.inputs):
            return False
        self.cur_idx += 1
        self._consumer_eof = False
        return True

    def seek(self, target):
        """Seek the current input (consumer-relative); drops stale blocks.
        Returns the codec's landing position or -1."""
        self._seek_result = -1
        self._command("seek", target, wait=True)
        return self._seek_result

    def skip(self):
        self._command("skip", wait=True)

    def pause(self, p):
        self._command("pause", bool(p), wait=True)

    def delay(self):
        """Buffered-but-unconsumed frames + device delay (codec_buf.c:349)."""
        dev = 0
        try:
            dev = int(self.cur().codec.delay())
        except Exception:
            dev = 0
        if self.unbuffered:
            return dev
        with self._mu:
            # only the current input's blocks count (codec_buf.c:355-360:
            # the walk stops at the first block of another input)
            frames = 0
            for b in self._queue:
                if isinstance(b, _EndOfInput):
                    break
                frames += len(b)
            return frames + dev

    def close(self):
        if self.unbuffered:
            return
        with self._mu:
            self._stop = True
            self._mu.notify_all()
        self._thread.join(timeout=5)
