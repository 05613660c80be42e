"""Python driver for the native C++ extract engine.

Pipelined loop (default 8 batches in flight): the C++ engine reads, pairs
and packs each batch directly into the kernel's fused wire payload
(sio_ex_next_fused — one uint8 buffer per batch, ~51B per 160bp row on
N-free batches), and a
small worker-thread pool runs the device dispatch + result fetch so the
host→device transfer and the fetch round trips of in-flight batches overlap
each other AND the next batch's BGZF decode. Feeds stay FIFO (the C++ mate
cache is order-dependent).
"""

from __future__ import annotations

import ctypes as C
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from strling_tpu.core.tread import TREAD_DTYPE, TreadBatch
from strling_tpu.io.bam import Bam, _load


def _bind(lib):
    P = np.ctypeslib.ndpointer
    lib.sio_ex_create.restype = C.c_void_p
    lib.sio_ex_create.argtypes = [C.c_void_p, C.c_double, C.c_int, C.c_int64, C.c_int]
    lib.sio_ex_destroy.argtypes = [C.c_void_p]
    lib.sio_ex_set_index.argtypes = [C.c_void_p, C.c_int, P(np.int64), P(np.int64), C.c_int64]
    lib.sio_ex_next.restype = C.c_int64
    lib.sio_ex_next.argtypes = [
        C.c_void_p, C.c_int64, C.POINTER(C.c_int64), P(np.uint8), P(np.int32),
        P(np.float64), C.c_int64,
    ]
    lib.sio_ex_next_fused.restype = C.c_int64
    lib.sio_ex_next_fused.argtypes = [
        C.c_void_p, C.c_int64, C.POINTER(C.c_int64), P(np.uint8), P(np.uint8),
        P(np.int32), P(np.float64), C.c_int64, C.POINTER(C.c_int32),
    ]
    lib.sio_ex_feed.argtypes = [C.c_void_p, P(np.int32), P(np.int32), P(np.int32), C.c_int64]
    lib.sio_ex_done.argtypes = [C.c_void_p]
    lib.sio_ex_nreads.restype = C.c_int64
    lib.sio_ex_nreads.argtypes = [C.c_void_p]
    lib.sio_ex_n_treads.restype = C.c_int64
    lib.sio_ex_n_treads.argtypes = [C.c_void_p]
    lib.sio_ex_get_treads.restype = C.c_int64
    lib.sio_ex_get_treads.argtypes = [
        C.c_void_p, P(np.int32), P(np.uint32), P(np.uint8), P(np.uint16),
        P(np.uint8), P(np.uint8), P(np.uint8), P(np.uint8), C.c_char_p,
        C.c_int64, P(np.int64),
    ]
    lib.sio_frag_hist.argtypes = [
        C.c_void_p, C.c_int64, C.c_int64, P(np.uint32), C.POINTER(C.c_int32),
    ]
    lib.sio_ex_set_shard.restype = C.c_int
    lib.sio_ex_set_shard.argtypes = [C.c_void_p, P(np.int32), C.c_int64, C.c_int]
    lib.sio_ex_set_prefilter.argtypes = [C.c_void_p, C.c_int]
    lib.sio_ex_set_median.argtypes = [C.c_void_p, C.c_int64]
    lib.sio_ex_max_len.restype = C.c_int64
    lib.sio_ex_max_len.argtypes = [C.c_void_p]
    lib.sio_peek_max_len.restype = C.c_int64
    lib.sio_peek_max_len.argtypes = [C.c_void_p, C.c_int64]
    lib.sio_ex_get_keys.restype = C.c_int64
    lib.sio_ex_get_keys.argtypes = [
        C.c_void_p, C.c_int, P(np.uint8), P(np.int32), P(np.int64),
        P(np.uint8),
    ]
    lib.sio_ex_n_spill.restype = C.c_int64
    lib.sio_ex_n_spill.argtypes = [C.c_void_p]
    lib.sio_ex_get_spill.restype = C.c_int64
    lib.sio_ex_get_spill.argtypes = [
        C.c_void_p, P(np.int32), P(np.uint32), P(np.uint8), P(np.uint16),
        P(np.uint8), P(np.uint8), P(np.uint8), P(np.uint8), C.c_char_p,
        C.c_int64, P(np.int64),
    ]
    lib.sio_ex_error.restype = C.c_char_p
    lib.sio_ex_error.argtypes = [C.c_void_p]
    lib.sio_ex_set_hist_tee.restype = C.c_int
    lib.sio_ex_set_hist_tee.argtypes = [C.c_void_p, C.c_int64, C.c_int64]
    lib.sio_ex_hist_ready.restype = C.c_int
    lib.sio_ex_hist_ready.argtypes = [C.c_void_p]
    lib.sio_ex_get_hist.restype = C.c_int
    lib.sio_ex_get_hist.argtypes = [C.c_void_p, P(np.uint32),
                                    C.POINTER(C.c_int32)]


_bound = False


def _lib():
    global _bound
    lib = _load()
    if not _bound:
        _bind(lib)
        _bound = True
    return lib


def peek_max_len(bam: Bam, n_records: int = 10_000) -> int:
    """Max l_seq over the first records (cheap Lmax probe; the engine
    reports its true max after the run so a longer late read triggers an
    exact re-run)."""
    return int(_lib().sio_peek_max_len(bam._h, n_records))


def native_frag_hist(bam: Bam, skip_reads: int = 100_000,
                     n_reads: int = 2_000_000,
                     return_max_len: bool = False):
    lib = _lib()
    hist = np.zeros(4096, np.uint32)
    maxlen = C.c_int32(0)
    lib.sio_frag_hist(bam._h, skip_reads, n_reads, hist, C.byref(maxlen))
    if return_max_len:
        return hist, int(maxlen.value)
    return hist


class NativeExtractor:
    #: fixed scan row shapes: rows pad up to the smallest covering tier, so
    #: each (tier, width, layout) compiles once and lands in the persistent
    #: compile cache.
    BUCKETS = (4096, 16384, 32768, 65536)

    def __init__(self, bam: Bam, proportion_repeat: float, min_mapq: int,
                 median_fragment_length: int, genome_index=None,
                 batch_records: int = 200_000, Lmax: int | None = None,
                 prefilter: bool = True, rows_per_batch: int = 4096,
                 frag_tee: bool = False):
        self.lib = _lib()
        self.bam = bam
        # transfer width: the max read length (rounded up) bounds the packed
        # row width; 150bp data moves 160-byte rows instead of 256
        self.Lmax = min(bam.Lmax, Lmax) if Lmax else bam.Lmax
        self.proportion_repeat = proportion_repeat
        self.batch_records = batch_records
        # batches are ROWS-driven: the engine cuts a batch when the next
        # record would push scan rows past rows_cap, so every device batch
        # fills its jit bucket almost exactly — bucket padding is transfer
        # and scan work for no result
        # (with the ~2-3% post-exact-filter row rate one 4096-row batch
        # carries ~100-200k records; batch_records is a memory backstop —
        # a Pending record is ~110B + a qname, so the cap bounds a
        # row-starved stretch at ~25MB buffered per produced batch)
        self.rows_cap = max(8, min(rows_per_batch, self.BUCKETS[-1]))
        self._e = self.lib.sio_ex_create(
            bam._h, proportion_repeat, min_mapq, median_fragment_length, self.Lmax
        )
        if not prefilter:
            self.lib.sio_ex_set_prefilter(self._e, 0)
        if frag_tee:
            # fragment-length histogram accumulated on the engine's OWN
            # record stream (same predicate/stream as native_frag_hist) —
            # one BGZF decode pass for the whole extract instead of two
            rc = self.lib.sio_ex_set_hist_tee(self._e, 100_000, 2_000_000)
            if rc != 0:
                raise RuntimeError("hist tee must be enabled before reading"
                                   " (and never in sharded mode)")
        if genome_index is not None:
            name_to_tid = {t.name: t.tid for t in bam.targets}
            for chrom, (starts, pmax) in genome_index.by_chrom.items():
                tid = name_to_tid.get(chrom)
                if tid is None:
                    continue
                self.lib.sio_ex_set_index(
                    self._e, tid, np.ascontiguousarray(starts, np.int64),
                    np.ascontiguousarray(pmax, np.int64), len(starts),
                )

    def __del__(self):
        try:
            if self._e:
                self.lib.sio_ex_destroy(self._e)
                self._e = None
        except Exception:
            pass

    def _next(self):
        bases = np.empty((self.rows_cap, self.Lmax), np.uint8)
        lengths = np.empty(self.rows_cap, np.int32)
        props = np.empty(self.rows_cap, np.float64)
        n_records = C.c_int64(0)
        rows = self.lib.sio_ex_next(
            self._e, self.batch_records, C.byref(n_records),
            bases.reshape(-1), lengths, props, self.rows_cap,
        )
        if rows < 0:
            raise IOError(self.lib.sio_ex_error(self._e).decode())
        return int(rows), int(n_records.value), bases, lengths, props

    def _next_fused(self):
        """Fused-payload batch: returns (rows, n_records, payload|None,
        layout, ascii-tuple|None). The payload buffer is pre-zeroed and
        rows_cap tall, so the scan can use it as an already-padded bucket
        directly (zero rows scan as empty reads — no Python-side pad copy).
        The engine picks the smallest wire layout per batch (fb=2 -> "n8",
        N-free; fb=0 -> "w8"/"w16"); the ascii tuple is only filled on the
        rare IUPAC fallback (fb=1)."""
        # widest possible layout bounds the flat buffer; the engine writes
        # rows at the chosen layout's stride and the buffer is re-viewed
        meta8 = self.Lmax <= 248 and self.proportion_repeat <= 1.0
        maxW = 3 * self.Lmax // 8 + (11 if meta8 else 22)
        buf = np.zeros(self.rows_cap * maxW, np.uint8)
        bases = np.empty((self.rows_cap, self.Lmax), np.uint8)
        lengths = np.empty(self.rows_cap, np.int32)
        props = np.empty(self.rows_cap, np.float64)
        n_records = C.c_int64(0)
        fb = C.c_int32(0)
        rows = self.lib.sio_ex_next_fused(
            self._e, self.batch_records, C.byref(n_records),
            buf, bases.reshape(-1), lengths, props,
            self.rows_cap, C.byref(fb),
        )
        if rows < 0:
            raise IOError(self.lib.sio_ex_error(self._e).decode())
        rows = int(rows)
        if fb.value == 1:
            return rows, int(n_records.value), None, None, (
                bases, lengths, props)
        if fb.value == 2:
            layout, rowW = "n8", self.Lmax // 4 + 11
        else:
            layout, rowW = ("w8", maxW) if meta8 else ("w16", maxW)
        payload = buf[: self.rows_cap * rowW].reshape(self.rows_cap, rowW)
        return rows, int(n_records.value), payload, layout, None

    def _feed(self, result):
        lib = _lib()
        empty = np.zeros(0, np.int32)
        if result is None:
            lib.sio_ex_feed(self._e, empty, empty, empty, 0)
        else:
            code, ulen, cnt = result
            lib.sio_ex_feed(
                self._e, np.ascontiguousarray(code, np.int32),
                np.ascontiguousarray(ulen, np.int32),
                np.ascontiguousarray(cnt, np.int32), len(code),
            )

    def set_median(self, median: int):
        """Set the fragment-length median (deferred-median mode); must run
        before the first feed — adjust_by is its only consumer."""
        self.lib.sio_ex_set_median(self._e, int(median))

    @property
    def hist_ready(self) -> bool:
        """True once the teed fragment histogram is frozen (2M-record budget
        consumed or main stream ended)."""
        return bool(self.lib.sio_ex_hist_ready(self._e))

    def get_hist(self):
        """(hist[4096] uint32, max_read_len) from the engine tee; raises if
        not yet ready (see hist_ready / run(hold_drain=...))."""
        hist = np.zeros(4096, np.uint32)
        ml = C.c_int32(0)
        if self.lib.sio_ex_get_hist(self._e, hist, C.byref(ml)) != 0:
            raise RuntimeError("fragment histogram not ready")
        return hist, int(ml.value)

    @property
    def max_len_seen(self) -> int:
        return int(self.lib.sio_ex_max_len(self._e))

    def run(self, depth: int = 8,
            buckets: tuple[int, ...] | None = None,
            devices: list | None = None, pre_feed_hook=None,
            stats: dict | None = None, hold_drain=None) -> TreadBatch:
        """Pipelined loop. Each batch comes out of the C++ engine already in
        the kernel's fused wire layout; a pool of `depth` worker threads runs
        the blocking transfer→scan→fetch chain so up to `depth` device round
        trips are in flight while the main thread decodes/pairs the next
        batch. Feeds are FIFO (the C++ mate-cache state machine is
        order-dependent; futures are drained in submission order), so with
        `devices` the batches round-robin over the local chips and the
        output is byte-identical to single-device runs.

        `stats`, when given, accumulates transfer attribution for the run:
        n_batches, h2d/d2h bytes, summed in-flight scan seconds (overlapped
        across workers), and total feed-wait seconds on the main thread."""
        import time as _time
        from collections import deque

        from strling_tpu.ops.kmer import scan_codes, scan_payload

        lib = _lib()
        buckets = buckets or self.BUCKETS
        if devices:
            depth = max(depth, 2 * len(devices))
        if stats is not None:
            stats.setdefault("n_batches", 0)
            stats.setdefault("h2d_bytes", 0)
            stats.setdefault("d2h_bytes", 0)
            stats.setdefault("scan_s", 0.0)   # summed over workers (overlaps)
            stats.setdefault("wait_s", 0.0)   # main-thread feed-drain wait
        EMPTY = "empty"  # sentinel for fast-path-only batches (no scan rows)

        import threading

        slock = threading.Lock()

        def _acc(t0, h2d, d2h):
            with slock:
                stats["n_batches"] += 1
                stats["h2d_bytes"] += h2d
                stats["d2h_bytes"] += d2h
                stats["scan_s"] += _time.perf_counter() - t0

        def scan_job(payload, layout, ascii_rows, rows, bucket, dev):
            t0 = _time.perf_counter()
            if payload is not None:
                # the buffer is pre-zeroed and rows_cap tall: slicing to the
                # bucket IS the padding (no copy); short slices are padded
                # inside scan_payload
                out = scan_payload(payload[:bucket], rows, bucket=bucket,
                                   device=dev, layout=layout)
                if stats is not None:
                    _acc(t0, bucket * payload.shape[1], bucket * 4)
                return out
            b, l, p = ascii_rows
            out = scan_codes(b[:rows], l[:rows], p[:rows], bucket=bucket)
            if stats is not None:
                bkt = max(bucket, ((rows + bucket - 1) // bucket) * bucket)
                _acc(t0, bkt * (b.shape[1] + 16), bkt * 12)
            return out

        batch_i = 0
        inflight: deque = deque()
        with ThreadPoolExecutor(max_workers=depth) as pool:
            while True:
                rows, n_records, payload, layout, ascii_rows = \
                    self._next_fused()
                if n_records > 0:
                    if rows > 0:
                        bucket = next(
                            (b for b in buckets if b >= rows), self.rows_cap
                        )
                        dev = (devices[batch_i % len(devices)]
                               if devices else None)
                        batch_i += 1
                        inflight.append(
                            pool.submit(scan_job, payload, layout, ascii_rows,
                                        rows, bucket, dev)
                        )
                    else:
                        inflight.append(EMPTY)
                done = n_records == 0 and bool(lib.sio_ex_done(self._e))
                if not done and hold_drain is not None and hold_drain():
                    # feeds are gated (e.g. the teed fragment median isn't
                    # derivable yet): keep producing/dispatching — scans fly,
                    # inflight grows past depth, nothing is fed. Memory cost
                    # is the buffered Pending records (~150B each, so the 2M
                    # hist budget tops out around ~300MB transiently).
                    continue
                limit = 0 if done else max(0, depth - 1)
                while len(inflight) > limit:
                    if pre_feed_hook is not None:
                        pre_feed_hook()
                        pre_feed_hook = None
                    f = inflight.popleft()
                    if f is EMPTY:
                        self._feed(None)
                    else:
                        tw = _time.perf_counter()
                        res = f.result()
                        if stats is not None:
                            stats["wait_s"] += _time.perf_counter() - tw
                        self._feed(res)
                if done:
                    break
        if pre_feed_hook is not None:
            pre_feed_hook()
        return self.treads()

    def set_shard(self, tids, include_unplaced: bool):
        """Restrict this engine to a tid shard (multi-host extract); must be
        called before the first batch. Requires an index on the input."""
        rc = self.lib.sio_ex_set_shard(
            self._e, np.ascontiguousarray(tids, np.int32), len(tids),
            1 if include_unplaced else 0,
        )
        if rc != 0:
            raise RuntimeError("set_shard must be called before reading")

    def spill(self) -> TreadBatch:
        """Treads whose mates live in other shards (sharded mode only)."""
        lib = _lib()
        n = int(lib.sio_ex_n_spill(self._e))
        tid = np.empty(n, np.int32)
        position = np.empty(n, np.uint32)
        repeat6 = np.empty(n * 6, np.uint8)
        flag = np.empty(n, np.uint16)
        split = np.empty(n, np.uint8)
        mapq = np.empty(n, np.uint8)
        repeat_count = np.empty(n, np.uint8)
        align_length = np.empty(n, np.uint8)
        qcap = n * 256 + 16
        qbuf = C.create_string_buffer(qcap)
        qoff = np.empty(n + 1, np.int64)
        rc = lib.sio_ex_get_spill(
            self._e, tid, position, repeat6, flag, split, mapq, repeat_count,
            align_length, qbuf, qcap, qoff,
        )
        if rc < 0:
            raise IOError("qname buffer overflow")
        data = np.zeros(n, TREAD_DTYPE)
        data["tid"] = tid
        data["position"] = position
        data["repeat"] = repeat6.reshape(n, 6).view("S6").reshape(n)
        data["flag"] = flag
        data["split"] = split
        data["mapping_quality"] = mapq
        data["repeat_count"] = repeat_count
        data["align_length"] = align_length
        blob = qbuf.raw
        qnames = [blob[qoff[i]: qoff[i + 1]].decode() for i in range(n)]
        return TreadBatch(data=data, qnames=qnames)

    @property
    def nreads(self) -> int:
        return int(_lib().sio_ex_nreads(self._e))

    def emission_keys(self, which: int = 0):
        """(seg, tid, rank, sub) emission-order key arrays for the output
        (which=0) or spill (which=1) treads; sorting gathered shard treads
        by this key reproduces the sequential bin order exactly."""
        lib = _lib()
        n = int(lib.sio_ex_n_spill(self._e) if which
                else lib.sio_ex_n_treads(self._e))
        seg = np.empty(n, np.uint8)
        ktid = np.empty(n, np.int32)
        krank = np.empty(n, np.int64)
        ksub = np.empty(n, np.uint8)
        lib.sio_ex_get_keys(self._e, which, seg, ktid, krank, ksub)
        return seg, ktid, krank, ksub

    def treads(self) -> TreadBatch:
        lib = _lib()
        n = int(lib.sio_ex_n_treads(self._e))
        tid = np.empty(n, np.int32)
        position = np.empty(n, np.uint32)
        repeat6 = np.empty(n * 6, np.uint8)
        flag = np.empty(n, np.uint16)
        split = np.empty(n, np.uint8)
        mapq = np.empty(n, np.uint8)
        repeat_count = np.empty(n, np.uint8)
        align_length = np.empty(n, np.uint8)
        qcap = n * 256 + 16
        qbuf = C.create_string_buffer(qcap)
        qoff = np.empty(n + 1, np.int64)
        rc = lib.sio_ex_get_treads(
            self._e, tid, position, repeat6, flag, split, mapq, repeat_count,
            align_length, qbuf, qcap, qoff,
        )
        if rc < 0:
            raise IOError("qname buffer overflow")
        data = np.zeros(n, TREAD_DTYPE)
        data["tid"] = tid
        data["position"] = position
        data["repeat"] = repeat6.reshape(n, 6).view("S6").reshape(n)
        data["flag"] = flag
        data["split"] = split
        data["mapping_quality"] = mapq
        data["repeat_count"] = repeat_count
        data["align_length"] = align_length
        blob = qbuf.raw
        qnames = [
            blob[qoff[i]: qoff[i + 1]].decode() for i in range(n)
        ]
        return TreadBatch(data=data, qnames=qnames)
