"""Directory-watching streaming reader, the ``StreamingReaders`` analog;
the port of ``transmogrifai_tpu/readers/streaming.py``.

``StreamingReaders.scala`` exposes ``avroStream`` / ``customStream``: a
Spark ``StreamingContext.fileStream`` that watches a directory and turns
every new file into a micro-batch. Here the same contract is a host-side
poll loop: snapshot the directory, yield each unseen file's records as
one batch, sleep, poll again. Batches feed ``readers.stream_score`` (the
StreamingScore run type) and the out-of-core fit
(``Workflow._stream_raw_store``); peak memory stays one file's records.

File formats route by extension: ``.avro`` through the port's container
codec (``readers/avro.py``; the columnar decode, ``read_avro_table``,
unless ``columnar=False`` or ``TMOG_PIPELINE=0``), ``.csv`` through the
header-driven ``CSVAutoReader``. Listing and reading ride
``resilience.READER_RETRY`` behind the ``stream.poll`` /
``stream.read_file`` fault sites; a file that cannot be read is
quarantined (``resilience.quarantine``) and the stream goes on.
``new_files_only`` matches Spark's flag (default True there; False here,
since a backfill-then-tail is the common local workflow).
"""
from __future__ import annotations

import glob
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["DirectoryStreamReader"]


class _NoReaderError(ValueError):
    """Unknown file extension — a configuration error, not a bad file."""


class DirectoryStreamReader:
    """Poll a directory and yield each new data file's records as a batch.

    ``stream(...)`` is a generator of ``List[dict]`` batches; it ends when
    ``max_batches`` or ``timeout_s`` is reached (both None = forever,
    Spark's awaitTermination). A file is only picked up once its mtime is
    at least ``settle_s`` old, so half-written files aren't read (the
    poor-host's analog of Spark's rename-into-place convention).
    """

    def __init__(self, path: str, pattern: str = "*",
                 reader_for: Optional[Callable[[str], List[Dict[str, Any]]]]
                 = None,
                 new_files_only: bool = False,
                 poll_interval_s: float = 1.0,
                 settle_s: float = 0.5,
                 columnar: bool = True):
        self.path = path
        self.pattern = pattern
        self.reader_for = reader_for
        self.new_files_only = new_files_only
        self.poll_interval_s = poll_interval_s
        self.settle_s = settle_s
        #: route Avro decode through the vectorized columnar fast path
        #: (avro.read_avro_table — bit-identical batches that iterate
        #: as the same dicts, but numpy-decoded so the pipeline's
        #: workers escape the GIL). False = the per-record Python
        #: decoder (the runner's ``pipeline: false``).
        self.columnar = columnar
        self._seen: set = set()
        #: files successfully read AND delivered — the rescan unit.
        #: Quarantined / no-reader files live only in ``_seen`` so a
        #: rescan never re-offers (and never re-quarantines) them.
        self._delivered: set = set()
        #: interruptible idle wait: ``stop()`` wakes a sleeping
        #: ``stream()`` immediately instead of blocking shutdown a full
        #: poll interval
        self._stop = threading.Event()
        if new_files_only:
            self._seen.update(self._snapshot())

    def stop(self) -> None:
        """Ask a running ``stream()`` to end now: the idle wait is an
        Event wait, so shutdown never blocks a full ``poll_interval_s``.
        The next ``stream()`` call on this reader starts fresh."""
        self._stop.set()

    def rescan(self) -> int:
        """Re-offer every file this reader has successfully DELIVERED, so
        a multi-pass consumer (out-of-core training) re-reads the same
        directory without reconstructing the reader. Returns the number
        of files re-offered. Quarantined and no-reader files stay seen —
        a bad file is quarantined (and counted) exactly once, never once
        per pass — and ``new_files_only`` pre-seeded files stay
        suppressed (they were never delivered)."""
        n = len(self._delivered)
        self._seen -= self._delivered
        self._delivered.clear()
        return n

    # -- format routing ----------------------------------------------------
    def _read_file(self, fp: str) -> List[Dict[str, Any]]:
        from .. import resilience
        resilience.inject("stream.read_file", path=fp)
        if self.reader_for is not None:
            return self.reader_for(fp)
        ext = os.path.splitext(fp)[1].lower()
        if ext == ".avro":
            from .. import pipeline
            from .avro import read_avro_records, read_avro_table
            return read_avro_table(fp) \
                if self.columnar and pipeline.PIPELINE_ENABLED \
                else read_avro_records(fp)
        if ext == ".csv":
            from .data_readers import CSVAutoReader
            return CSVAutoReader(fp).read_records()
        raise _NoReaderError(
            f"no reader for {fp!r} — pass reader_for= for custom formats "
            "(StreamingReaders.customStream analog)")

    def _snapshot(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.path, self.pattern)))

    def _poll_snapshot(self) -> List[str]:
        """One directory poll behind its fault site — a transient listing
        failure (network mount blip) rides ``READER_RETRY`` instead of
        killing the stream."""
        from .. import resilience
        resilience.inject("stream.poll", path=self.path)
        return self._snapshot()

    def _ready(self, fp: str) -> bool:
        try:
            # mtime comparison: MUST stay on the wall clock — file
            # mtimes and perf_counter share no epoch
            return (time.time() - os.path.getmtime(fp)) >= self.settle_s  # lint: wall-clock
        except OSError:
            return False        # vanished between glob and stat

    # -- the stream --------------------------------------------------------
    def _take_next(self) -> Optional[List[Dict[str, Any]]]:
        """Consume ONE settled unseen file (oldest first) — files are
        marked seen one at a time AFTER a successful read, so a consumer
        that stops at ``max_batches`` leaves later files re-offered on
        the next poll, never silently dropped. A file whose read RAISES
        gets the reader retry policy for transient IO (``OSError``);
        when retries exhaust — or the failure is non-transient (corrupt
        container) — the file is QUARANTINED to the dead-letter sink
        with its reason, counted (``resilience.quarantined_files``),
        marked seen and skipped: retrying it every poll would wedge the
        stream forever, and dropping it without trace loses data
        silently (the pre-resilience behavior)."""
        snapshot = self._retried_poll()
        for fp in snapshot:
            if fp in self._seen or not self._ready(fp):
                continue
            try:
                recs = self._retried_read(fp)
            except Exception as e:  # lint: broad-except — ANY read failure quarantines, never wedges the stream
                self._consume_error(fp, e)
                continue
            self._seen.add(fp)
            self._delivered.add(fp)
            return recs
        return None

    def _unseen_visible(self) -> bool:
        """Any file visible right now that this pass has not consumed?
        Settle state is ignored on purpose: an unseen-but-unsettled file
        means the pass is NOT drained yet (the caller idle-waits and
        re-polls). Plain snapshot — this runs once per drained poll, so
        it skips the retry/telemetry wrapping of the hot poll path."""
        try:
            snap = self._snapshot()
        except OSError:
            return False
        return any(fp not in self._seen for fp in snap)

    def _retried_poll(self) -> List[str]:
        """One retried directory listing + the backlog gauge."""
        from .. import resilience, telemetry
        snapshot = resilience.READER_RETRY.call(
            "stream.poll", self._poll_snapshot)
        if telemetry.enabled():
            # unconsumed files visible right now (including ones still
            # settling): the ingest backlog — a growing value means
            # scoring can't keep up with arrivals. Pure set arithmetic
            # off the listing this poll already does; no extra stat I/O.
            telemetry.gauge("stream.file_backlog").set(
                sum(1 for fp in snapshot if fp not in self._seen))
        return snapshot

    def _retried_read(self, fp: str) -> List[Dict[str, Any]]:
        """One file's records behind READER_RETRY — the decode unit the
        parallel workers run; the ``stream.read_file``/``avro.decode``/
        ``csv.decode`` fault sites all fire inside it, on whichever
        thread executes it."""
        from .. import resilience
        return resilience.READER_RETRY.call(
            "stream.read_file", self._read_file, fp)

    def _consume_error(self, fp: str, exc: BaseException) -> None:
        """The ONE poison-file policy both the serial and the parallel
        consumers apply, in file order: an unknown extension is a
        CONFIGURATION gap that re-raises (after marking seen so it
        cannot wedge the stream), anything else quarantines the file
        with its reason and the stream flows on."""
        import logging

        from .. import resilience
        if isinstance(exc, _NoReaderError):
            # the file must still be marked seen before raising or it
            # wedges the stream (every later poll re-hits it) and
            # blocks the readable files behind it
            self._seen.add(fp)
            raise exc
        logging.getLogger(__name__).warning(
            "stream reader quarantining unreadable file %s",
            fp, exc_info=exc)
        resilience.quarantine("stream.read_file", repr(exc),
                              kind="files", path=fp)
        self._seen.add(fp)

    def poll_once(self) -> List[List[Dict[str, Any]]]:
        """One poll: read every settled unseen file, oldest first."""
        batches = []
        while True:
            recs = self._take_next()
            if recs is None:
                return batches
            if recs:
                batches.append(recs)

    def _idle_wait(self, t0: float,
                   timeout_s: Optional[float]) -> bool:
        """Idle between polls; returns False when the stream should end
        (timeout elapsed or :meth:`stop` was called). The wait is an
        interruptible Event wait clamped to the REMAINING timeout — a
        ``timeout_s`` shorter than ``poll_interval_s`` is honored, and
        ``stop()``/``max_batches`` never block a full interval."""
        remaining = None
        if timeout_s is not None:
            remaining = timeout_s - (time.perf_counter() - t0)
            if remaining <= 0:
                return False
        wait = self.poll_interval_s if remaining is None \
            else min(self.poll_interval_s, remaining)
        return not self._stop.wait(wait)

    def stream(self, max_batches: Optional[int] = None,
               timeout_s: Optional[float] = None,
               workers: Optional[int] = None,
               passes: Optional[int] = None
               ) -> Iterator[List[Dict[str, Any]]]:
        """Yield per-file record batches as files appear.

        A productive poll is followed by another poll IMMEDIATELY (the
        stream only sleeps when a poll found nothing new), and the idle
        sleep is interruptible (:meth:`stop`) and clamped to the
        remaining ``timeout_s``.

        ``workers`` > 1 decodes the settled files of each poll on a
        parallel worker pool (pipeline.py) with DETERMINISTIC order:
        batches arrive in sorted-file order, bit-identical to the
        serial decode, and the ``stream.read_file``/``avro.decode``/
        ``csv.decode`` fault sites + READER_RETRY + poison-file
        quarantine run inside the workers unchanged.

        ``passes`` = N bounds the stream to N full scans of the
        directory (:meth:`rescan` runs between them): when a poll finds
        NOTHING unseen — not even a still-settling file — the pass is
        drained; the stream ends after pass N instead of idle-waiting
        for new arrivals. ``max_batches`` counts across all passes, and
        ``stop()``/``timeout_s`` keep their meaning. None (default) is
        the single-pass tail-forever behavior, unchanged."""
        self._stop.clear()
        if passes is not None:
            passes = int(passes)
            if passes < 1:
                raise ValueError("passes must be >= 1")
        if workers is not None:
            # an explicit count still rides the TMOG_PIPELINE=0 kill
            # switch (resolve_workers forces 1 — the incident lever is
            # not overridable); None keeps the serial default
            from .. import pipeline
            workers = pipeline.resolve_workers(int(workers))
        if workers is not None and workers > 1:
            yield from self._stream_parallel(workers, max_batches,
                                             timeout_s, passes)
            return
        t0 = time.perf_counter()
        n = 0
        pass_no = 1
        while True:
            if self._stop.is_set():
                return
            recs = self._take_next()
            if recs is not None:
                if recs:
                    yield recs
                    n += 1
                    if max_batches is not None and n >= max_batches:
                        return
                continue            # drain without sleeping
            if passes is not None and not self._unseen_visible():
                pass_no += 1        # directory drained: pass ends
                if pass_no > passes:
                    return
                self.rescan()
                continue
            if not self._idle_wait(t0, timeout_s):
                return

    def _stream_parallel(self, workers: int,
                         max_batches: Optional[int],
                         timeout_s: Optional[float],
                         passes: Optional[int] = None
                         ) -> Iterator[List[Dict[str, Any]]]:
        """Parallel-decode poll loop: each poll's settled unseen files
        fan out over the worker pool; the reorder buffer hands results
        back in sorted-file order. Files are marked seen one at a time
        AS THEIR RESULT IS CONSUMED, so a consumer that stops at
        ``max_batches`` leaves later files re-offered on the next poll,
        never silently dropped (the serial contract)."""
        from concurrent.futures import ThreadPoolExecutor

        from .. import pipeline

        t0 = time.perf_counter()
        n = 0
        pass_no = 1
        ex = None
        try:
            while True:
                if self._stop.is_set():
                    return
                snapshot = self._retried_poll()
                ready = [fp for fp in snapshot
                         if fp not in self._seen and self._ready(fp)]
                if ready:
                    if ex is None:
                        # one pool for the stream's lifetime, created
                        # lazily on the first productive poll: an idle
                        # watch never spins up threads, and productive
                        # polls never pay per-poll spin-up/teardown
                        ex = ThreadPoolExecutor(
                            max_workers=workers,
                            thread_name_prefix="stream-decode")
                    for fp, recs, exc in pipeline.map_ordered(
                            self._retried_read, ready, workers=workers,
                            name="stream-decode", executor=ex):
                        if exc is not None:
                            self._consume_error(fp, exc)
                            continue
                        self._seen.add(fp)
                        self._delivered.add(fp)
                        if recs:
                            yield recs
                            n += 1
                            if max_batches is not None \
                                    and n >= max_batches:
                                return
                        if self._stop.is_set():
                            return
                    continue        # productive poll: re-poll immediately
                if passes is not None \
                        and not any(fp not in self._seen
                                    for fp in snapshot):
                    pass_no += 1    # directory drained: pass ends
                    if pass_no > passes:
                        return
                    self.rescan()
                    continue
                if not self._idle_wait(t0, timeout_s):
                    return
        finally:
            if ex is not None:
                ex.shutdown(wait=False)

    # -- DataReader interop (batch fallback) -------------------------------
    def read_records(self) -> List[Dict[str, Any]]:
        """Drain everything currently visible — lets the same reader serve
        the batch run types (the reference's readers are likewise dual)."""
        out: List[Dict[str, Any]] = []
        for batch in self.poll_once():
            out.extend(batch)
        return out
