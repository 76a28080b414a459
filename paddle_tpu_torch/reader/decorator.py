"""Reader decorators (counterpart of ``paddle_tpu/reader/decorator.py``;
reference python/paddle/reader/decorator.py): composable generators on
the host, the JAX package's code and behavior."""

from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = ["map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "cache", "batch", "xmap_readers", "ComposeNotAligned", "Fake", "PipeReader", "multiprocess_reader"]


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers, check_alignment=True):
    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        iterator = zip(*rs) if not check_alignment else \
            itertools.zip_longest(*rs)
        for outputs in iterator:
            if check_alignment and any(o is None for o in outputs):
                raise ComposeNotAligned("readers not aligned in compose")
            yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    class _End:
        pass

    def data_reader():
        q = queue.Queue(maxsize=size)

        def produce():
            for d in reader():
                q.put(d)
            q.put(_End)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return data_reader


def firstn(reader, n):
    def data_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return data_reader


def cache(reader):
    all_data = None

    def data_reader():
        nonlocal all_data
        if all_data is None:
            all_data = list(reader())
        yield from all_data

    return data_reader


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def xmap_readers(mapper, reader, process_num, buffer_size,
                 order=False):
    """Parallel map over a reader with worker threads (decorator.py
    xmap_readers)."""
    class _End:
        pass

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            for i, d in enumerate(reader()):
                in_q.put((i, d))
            for _ in range(process_num):
                in_q.put(_End)

        def work():
            while True:
                item = in_q.get()
                if item is _End:
                    out_q.put(_End)
                    break
                i, d = item
                out_q.put((i, mapper(d)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True)
                   for _ in range(process_num)]
        for w in workers:
            w.start()

        finished = 0
        pending = {}
        next_idx = 0
        while finished < process_num:
            item = out_q.get()
            if item is _End:
                finished += 1
                continue
            i, d = item
            if not order:
                yield d
            else:
                pending[i] = d
                while next_idx in pending:
                    yield pending.pop(next_idx)
                    next_idx += 1
        if order:
            for i in sorted(pending):
                yield pending[i]

    return data_reader


class ComposeNotAligned(ValueError):
    """reader/decorator.py ComposeNotAligned: composed readers produced
    different lengths under check_alignment."""


class Fake:
    """reader/decorator.py Fake: replay the FIRST batch forever — the
    input-pipeline-removal decorator for benchmarking compute."""

    def __init__(self):
        self._cached = None
        self._yield_num = 0  # cumulative across restarts (ref semantics)

    def __call__(self, reader, max_num):
        def fake_reader():
            if self._cached is None:
                try:
                    self._cached = next(reader())
                except StopIteration:
                    raise ValueError(
                        "Fake: the wrapped reader produced no data")
            # the reference's cap (reader/decorator.py:537-541) is
            # cumulative only across PARTIAL restarts: the count
            # advances AFTER each delivered yield and resets to 0 when
            # a pass runs the loop to completion, so each fresh full
            # pass yields max_num items again
            while self._yield_num < max_num:
                yield self._cached
                self._yield_num += 1
            self._yield_num = 0
        return fake_reader


class PipeReader:
    """reader/decorator.py PipeReader: stream a shell command's stdout
    and yield its output in chunks split by a delimiter (line-oriented
    external feeds — `cat`, `hadoop fs -cat`, ...)."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("PipeReader command must be a string")
        import subprocess
        self.process = subprocess.Popen(
            command.split(" "), bufsize=bufsize, stdout=subprocess.PIPE)
        if file_type == "gzip":
            import zlib
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        else:
            self.dec = None
        self.bufsize = bufsize

    def get_line(self, cut_lines=True, line_break="\n"):
        # split on the ENCODED delimiter and decode per complete line,
        # so a multi-byte UTF-8 char straddling a read boundary never
        # hits a partial-sequence decode; cut_lines=False STREAMS each
        # chunk through an incremental decoder (multi-GB feeds must not
        # accumulate)
        import codecs
        sep = line_break.encode()
        inc = codecs.getincrementaldecoder("utf-8")()
        remained = b""
        try:
            while True:
                buff = self.process.stdout.read(self.bufsize)
                if not buff:
                    break
                if self.dec is not None:
                    buff = self.dec.decompress(buff)
                if not cut_lines:
                    text = inc.decode(buff)
                    if text:
                        yield text
                    continue
                lines = (remained + buff).split(sep)
                remained = lines.pop()
                for line in lines:
                    yield line.decode()
            if self.dec is not None:
                # a gzip stream whose final block needs a flush would
                # otherwise silently drop its tail bytes at EOF
                tail = self.dec.flush()
                if tail:
                    if not cut_lines:
                        text = inc.decode(tail)
                        if text:
                            yield text
                    else:
                        lines = (remained + tail).split(sep)
                        remained = lines.pop()
                        for line in lines:
                            yield line.decode()
            if not cut_lines:
                tail = inc.decode(b"", final=True)
                if tail:
                    yield tail
            elif remained:
                yield remained.decode()
        finally:
            # reap the child; terminate it if the consumer stopped early
            if self.process.poll() is None:
                self.process.terminate()
            self.process.stdout.close()
            self.process.wait()

    def __del__(self):
        try:
            if self.process.poll() is None:
                self.process.terminate()
                self.process.wait(timeout=5)
        except Exception:
            pass


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """reader/decorator.py multiprocess_reader: run each sample reader
    in its own OS process, funnel samples through one queue (order
    interleaved). Samples AND the reader callables must be picklable
    (fork start method relaxes the latter; spawn platforms need
    module-level readers, as upstream). `use_pipe` is accepted for API
    parity; both transports are served by the queue here. None samples
    are rejected (they would be ambiguous with completion, the same
    contract upstream enforces), and a worker exception re-raises in
    the consumer instead of silently truncating the stream."""
    import multiprocessing as mp
    import pickle as _pickle
    import queue as _queue

    _DONE = "__mpr_done__"
    _ERR = "__mpr_error__"

    def reader():
        q = mp.Queue(queue_size)

        def worker(r):
            try:
                for sample in r():
                    if sample is None:
                        raise ValueError(
                            "multiprocess_reader: sample is None")
                    # pre-pickle HERE so an unpicklable sample raises
                    # in this try (mp.Queue's feeder thread would drop
                    # it with only a stderr note otherwise)
                    q.put(("", _pickle.dumps(sample)))
                q.put((_DONE, None))
            except BaseException as e:  # noqa: BLE001 — crosses procs
                q.put((_ERR, repr(e)))

        procs = [mp.Process(target=worker, args=(r,), daemon=True)
                 for r in readers]
        for p in procs:
            p.start()
        finished = 0
        try:
            while finished < len(readers):
                try:
                    tag, payload = q.get(timeout=5.0)
                except _queue.Empty:
                    # a hard-killed worker (OOM-killer, segfault) never
                    # enqueues its sentinel: fail instead of hanging
                    if not any(p.is_alive() for p in procs):
                        raise RuntimeError(
                            "multiprocess_reader: all workers exited "
                            f"but only {finished}/{len(readers)} "
                            "completed cleanly")
                    continue
                if tag == _DONE:
                    finished += 1
                elif tag == _ERR:
                    raise RuntimeError(
                        f"multiprocess_reader worker failed: {payload}")
                else:
                    yield _pickle.loads(payload)
        finally:
            # reaches here on normal completion, errors, AND an early-
            # stopping consumer (GeneratorExit): never leak workers
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
            q.close()

    return reader
