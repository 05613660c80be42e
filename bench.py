"""Benchmarks: one JSON line per metric on stdout (flagship metric last).

Metrics (BASELINE.md):
  extract_kmer_scan_reads_per_sec  - PRODUCTION fused scan path
                                     (ops/kmer._fused_xla_jit: one u8 payload
                                     in, one packed i32 out — exactly what
                                     extract dispatches), reads/s/device
  call_loci_per_sec                - loci genotyped per second (call stage)
  index_windows_per_sec            - genome STR index stage, windows/s
                                     (genome_strs.nim:61-92 equivalent)
  extract_host_engine_reads_per_sec- the extract stage run host-only (cpu
                                     jax, in a subprocess): the rate the
                                     same code path reaches with no
                                     accelerator in the loop
  extract_engine_loop_reads_per_sec- the native engine's host loop alone
                                     (no device in the loop): the host-side
                                     ceiling for the e2e stage
  extract_e2e_reads_per_sec        - full native-engine->device->treads
                                     stage on the default device

Baseline context: the reference prints reads/s at runtime but publishes no
number; a single Nim thread on production hardware runs the extract scan at
roughly 70k reads/s (8GB/4h slurm budget for a ~1e9-read 30x WGS BAM,
pipelines/bpipe.config:13-15). vs_baseline uses that 70k estimate for the
extract metrics and for index windows (the reference scans index windows
through the same get_repeat hot loop, genome_strs.nim:74). For call, the
reference genotypes a few loci/s (per-locus random-access BAM window
queries, collect.nim:130-182); vs_baseline uses a 10 loci/s estimate.

Every result line names the device it ran on (platform, device_kind,
count), and a comment line gives the card's name and power limit. Outside
`--smoke` a missing GPU is an error. `--smoke` runs tiny sizes on whatever
backend is active (used by scripts/check.sh as a does-it-run gate, not a
measurement). A failed phase makes the exit code non-zero.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

NIM_BASELINE_READS_PER_SEC = 70_000.0
NIM_BASELINE_LOCI_PER_SEC = 10.0
#: generated inputs, kept inside the checkout (listed in .gitignore)
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")


def emit(metric, value, unit, vs):
    from strling_tpu.utils.device import device_info

    print(json.dumps({
        "metric": metric, "value": round(value, 1), "unit": unit,
        "vs_baseline": round(vs, 2), "device": device_info(),
    }), flush=True)


def _kernel_batch(B: int, L: int):
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases_np = alphabet[rng.integers(0, 4, (B, L))]
    # realistic mix: ~10% of scanned reads are STR-like
    units = [b"CAG", b"A", b"AT", b"AAGGG", b"ATTCT"]
    for i in range(0, B, 10):
        u = units[i % len(units)]
        bases_np[i] = np.frombuffer((u * (L // len(u) + 1))[:L], np.uint8)
    lengths_np = np.full(B, L, np.int32)
    return bases_np, lengths_np


def bench_kernel(smoke: bool):
    """Times the PRODUCTION dispatch: the fused single-transfer jit
    (payload u8 in, packed i32 out) that extract actually runs
    (ops/kmer.py scan_payload -> _fused_xla_jit), after checking a sample
    of its rows against the oracle."""
    import jax

    from strling_tpu.ops import oracle
    from strling_tpu.ops.kmer import (
        _fused_xla_jit,
        fuse_payload,
        unpack_result,
        unpack_unit_codes,
    )

    B, L = (4096, 152) if smoke else (32768, 152)
    bases_np, lengths_np = _kernel_batch(B, L)
    payload, layout = fuse_payload(bases_np, lengths_np, np.full(B, 0.8),
                                   return_layout=True)
    dev = jax.devices()[0]
    arr = jax.device_put(payload, dev)

    code, ulen, cnt = unpack_result(_fused_xla_jit(arr, layout))
    units = unpack_unit_codes(code[:512], ulen[:512])
    for i in range(512):
        want = oracle.get_repeat(bases_np[i].tobytes().decode(), 0.8)
        if (units[i], int(cnt[i])) != want:
            raise AssertionError(f"scan row {i} disagrees with the oracle: "
                                 f"{(units[i], int(cnt[i]))} != {want}")

    iters = 5 if smoke else 50
    for _ in range(3):
        _fused_xla_jit(arr, layout).block_until_ready()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fused_xla_jit(arr, layout).block_until_ready()
        times.append(time.perf_counter() - t0)
    per_batch = float(np.median(times))
    rps = B / per_batch
    emit("extract_kmer_scan_reads_per_sec", rps, "reads/s/device",
         rps / NIM_BASELINE_READS_PER_SEC)
    print(f"# kernel(fused {layout}) B={B} L={L} median={per_batch*1e3:.4f}"
          f"ms/batch min={min(times)*1e3:.4f}ms over {iters} "
          "block_until_ready calls (payload already on the device)",
          file=sys.stderr)


def _bench_bam(n_pairs: int, seed: int = 7) -> str:
    """Synthetic WGS-like BAM for the e2e stage bench (cached on disk):
    150bp proper pairs, ~5% STR-read pairs, the rest random sequence."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"bench_{n_pairs}.bam")
    if os.path.exists(path) and os.path.exists(path + ".bai"):
        return path
    from strling_tpu.io.bamwrite import BamRecord, write_bam

    rng = np.random.default_rng(seed)
    L, G = 150, 50_000_000
    alphabet = np.array(list("ACGT"))
    units = ["CAG", "A", "AT", "AAGGG", "ATTCT"]
    recs = []
    pos = np.sort(rng.integers(0, G - 2000, n_pairs))
    isizes = rng.integers(300, 500, n_pairs)
    seqs = alphabet[rng.integers(0, 4, (n_pairs, 2, L))]
    for i in range(n_pairs):
        p = int(pos[i])
        isz = int(isizes[i])
        s1 = "".join(seqs[i, 0])
        s2 = "".join(seqs[i, 1])
        if i % 20 == 0:
            u = units[i % len(units)]
            s2 = (u * (L // len(u) + 1))[:L]
        q = f"r{i}"
        mq = 60
        recs.append(BamRecord(q, 0x63, 0, p, mq, [(L, 0)], 0, p + isz - L,
                              isz, s1))
        recs.append(BamRecord(q, 0x93, 0, p + isz - L, mq, [(L, 0)], 0, p,
                              -isz, s2))
    recs.sort(key=lambda r: r.pos)
    hdr = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrB\tLN:%d\n" % G
    write_bam(path, hdr, [("chrB", G)], recs)
    return path



def bench_engine_loop(smoke: bool):
    """The native extract engine's host loop alone (pop fused batches, feed
    zero results — no device in the loop): the host-side ceiling for the
    e2e stage. Distinct metric so the ledger never conflates it with
    extract_e2e_reads_per_sec or extract_host_engine_reads_per_sec."""
    import ctypes as C

    from strling_tpu.io.bam import Bam
    from strling_tpu.io.extract_native import (
        NativeExtractor,
        _lib,
        native_frag_hist,
    )
    from strling_tpu.utils import fraglen

    n_pairs = 5_000 if smoke else 250_000
    path = _bench_bam(n_pairs)
    lib = _lib()
    best = 0.0
    for _ in range(1 if smoke else 3):
        bam = Bam(path)
        hist, maxlen = native_frag_hist(bam, return_max_len=True)
        med = fraglen.median(hist)
        t0 = time.perf_counter()
        ne = NativeExtractor(bam, 0.8, 40, med, Lmax=((maxlen + 7) // 8) * 8)
        ne.set_median(med)
        while True:
            rows, nrec, payload, layout, ascii_rows = ne._next_fused()
            if nrec > 0:
                z = np.zeros(rows, np.int32)
                lib.sio_ex_feed(ne._e, z, z, z, rows)
            elif lib.sio_ex_done(ne._e):
                break
        best = max(best, 2 * n_pairs / (time.perf_counter() - t0))
    emit("extract_engine_loop_reads_per_sec", best, "reads/s",
         best / NIM_BASELINE_READS_PER_SEC)


def bench_extract_e2e(smoke: bool):
    from strling_tpu.core.extract import extract_native
    from strling_tpu.io.bam import Bam

    n_pairs = 5_000 if smoke else 250_000
    path = _bench_bam(n_pairs)
    best = 0.0
    best_line = ""
    # best-of-5 spaced runs: the stage is host-bound (device_wait ~0 in the
    # attribution) and host-clock numbers swing with other load
    for r in range(1 if smoke else 5):
        if r:
            time.sleep(3)
        bam = Bam(path)
        stats = {}
        t0 = time.perf_counter()
        tb, frag, opts = extract_native(bam, None, None, stats=stats)
        dt = time.perf_counter() - t0
        nreads = 2 * n_pairs
        if nreads / dt > best:
            best = nreads / dt
            mb = (stats.get("h2d_bytes", 0) + stats.get("d2h_bytes", 0)) / 1e6
            # wait_s: main-thread stall on in-flight device results = the
            # part of wall the host loop could NOT hide behind decode/pack;
            # scan_s: summed in-flight transfer+scan+fetch time (workers
            # overlap, so >> wall when the pipeline is healthy)
            best_line = (
                f"# e2e attribution: wall={dt:.2f}s batches="
                f"{stats.get('n_batches', 0)} h2d="
                f"{stats.get('h2d_bytes', 0)/1e6:.2f}MB d2h="
                f"{stats.get('d2h_bytes', 0)/1e6:.2f}MB xfer={mb/dt:.1f}MB/s "
                f"device_wait={stats.get('wait_s', 0.0):.2f}s "
                f"inflight_scan={stats.get('scan_s', 0.0):.2f}s "
                f"host_loop={dt - stats.get('wait_s', 0.0):.2f}s"
            )
    emit("extract_e2e_reads_per_sec", best, "reads/s",
         best / NIM_BASELINE_READS_PER_SEC)
    print(f"# e2e n_reads={2*n_pairs} treads={len(tb)}", file=sys.stderr)
    if best_line:
        print(best_line, file=sys.stderr)


def _bench_call_inputs(n_loci: int, depth: int = 20, gap: int = 25_000):
    """Synthetic call-stage workload at WGS-realistic volume: n_loci novel
    CAG clusters `gap` apart on one chromosome, BAM coverage only within
    ±1150bp of each locus (reads between windows never reach the call
    stage), and the evidence treads written directly to the bin. Cached on
    disk — generation is one-time."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    bam_path = os.path.join(CACHE_DIR, f"call_{n_loci}_{depth}.bam")
    bin_path = os.path.join(CACHE_DIR, f"call_{n_loci}_{depth}.bin")
    if (os.path.exists(bam_path) and os.path.exists(bam_path + ".bai")
            and os.path.exists(bin_path)):
        return bam_path, bin_path
    from strling_tpu.core.tread import TREAD_DTYPE, Soft, TreadBatch
    from strling_tpu.io.bamwrite import BamRecord, write_bam
    from strling_tpu.io.binfmt import write_bin
    from strling_tpu.utils.fraglen import NBINS

    rng = np.random.default_rng(11)
    G = gap * (n_loci + 1) + 20_000
    L = 150
    half = 1_150
    n_pairs = int(2 * half * depth / (2 * L))
    lut = np.frombuffer(b"ACGT", np.uint8)

    # coverage pairs per locus (vectorized; sequences are random non-STR)
    loci_pos = (np.arange(n_loci, dtype=np.int64) + 1) * gap
    starts = (
        loci_pos[:, None]
        + rng.integers(-half, half - 420, (n_loci, n_pairs))
    ).ravel()
    isz = rng.integers(330, 470, n_loci * n_pairs)
    codes = rng.integers(0, 4, (n_loci * n_pairs, 2, L), dtype=np.uint8)
    recs = []
    for j in range(n_loci * n_pairs):
        p = int(starts[j])
        i = int(isz[j])
        s1 = lut[codes[j, 0]].tobytes().decode()
        s2 = lut[codes[j, 1]].tobytes().decode()
        q = f"r{j}"
        recs.append(BamRecord(q, 0x63, 0, p, 60, [(L, 0)], 0, p + i - L,
                              i, s1))
        recs.append(BamRecord(q, 0x93, 0, p + i - L, 60, [(L, 0)], 0, p,
                              -i, s2))
    recs.sort(key=lambda r: r.pos)
    hdr = "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrC\tLN:%d\n" % G
    write_bam(bam_path, hdr, [("chrC", G)], recs)

    # evidence treads: per locus ~12 anchored + 6 left-clip + 6 right-clip
    per = 24
    data = np.zeros(n_loci * per, TREAD_DTYPE)
    qnames = []
    k = 0
    for li in range(n_loci):
        p = int(loci_pos[li])
        anchors = np.sort(rng.integers(p - 350, p - 40, 12))
        for a in anchors:
            data[k] = (0, a, b"CAG", 0x63, int(Soft.none), 60,
                       int(rng.integers(25, 50)), L, -1)
            qnames.append(f"t{li}_{k % per}")
            k += 1
        for _ in range(6):
            data[k] = (0, p, b"CAG", 0x63, int(Soft.left), 60, 45, L, -1)
            qnames.append(f"t{li}_{k % per}")
            k += 1
        for _ in range(6):
            data[k] = (0, p + 40, b"CAG", 0x63, int(Soft.right), 60, 45, L,
                       -1)
            qnames.append(f"t{li}_{k % per}")
            k += 1
    hist = np.zeros(NBINS, np.uint32)
    np.add.at(hist, isz, 1)
    tb = TreadBatch(data=data, qnames=qnames)
    write_bin(bin_path, tb, hist,
              "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrC\tLN:%d\n" % G,
              0.8, 40)
    return bam_path, bin_path


_DIST_CALL_WORKER = """
import os, sys, time
pid, n, port, out_prefix, bam_p, binp = sys.argv[1:7]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from strling_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=int(n), process_id=int(pid))
from strling_tpu.parallel.call_dist import run_call_dist
t0 = time.perf_counter()
run_call_dist(bam_p, binp, output_prefix=out_prefix)
print(f"DIST_CALL_SECONDS={time.perf_counter()-t0:.3f}", flush=True)
"""


def _call_dist_2proc(d, bam_path, bin_path):
    """Time `call --distributed` with 2 jax.distributed (Gloo) processes on
    the same workload (scripts/sim_sweep.py:_dist_check mechanism); returns
    (post-init call seconds: max over workers — interpreter + Gloo startup
    excluded so the number measures the sharded call path, wall seconds
    including startup, output prefix)."""
    worker = os.path.join(d, "dist_worker.py")
    with open(worker, "w") as fh:
        fh.write(_DIST_CALL_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    dp = os.path.join(d, "dist")
    port = 12000 + os.getpid() % 2000
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), dp, bam_path,
             bin_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    secs = []
    for pr in procs:
        out, err = pr.communicate(timeout=900)
        if pr.returncode != 0:
            raise RuntimeError(f"dist worker failed: {err.decode()[-1200:]}")
        for line in out.decode().splitlines():
            if line.startswith("DIST_CALL_SECONDS="):
                secs.append(float(line.split("=")[1]))
    wall = time.perf_counter() - t0
    if len(secs) != 2:
        raise RuntimeError("dist workers reported no timing")
    return max(secs), wall, dp


def bench_call(smoke: bool):
    """The call stage at cohort-realistic volume: n>=5000 novel clusters
    through the full run_call (read bin, cluster, batched support
    collection over the BAM, genotype, percentile, write), with per-stage
    attribution, plus a 2-process `call --distributed` timing on the same
    workload (byte-equality asserted against the single-process outputs)."""
    import tempfile

    from strling_tpu.core.call import run_call

    n_loci = 40 if smoke else 5000
    bam_path, bin_path = _bench_call_inputs(n_loci)
    with tempfile.TemporaryDirectory() as d:
        dt = float("inf")
        best = {}
        for _ in range(1 if smoke else 2):
            stats = {}
            t0 = time.perf_counter()
            run_call(bam_path, bin_path, output_prefix=os.path.join(d, "out"),
                     stats=stats)
            cur = time.perf_counter() - t0
            if cur < dt:
                dt, best = cur, stats
        lines = open(os.path.join(d, "out-genotype.txt")).read().splitlines()
        n_called = len(lines) - 1
        if n_called < n_loci * 9 // 10:
            print(f"# WARNING: call bench genotyped {n_called}/{n_loci} "
                  "planted loci — metric unreliable", file=sys.stderr)
        lps = n_called / dt
        emit("call_loci_per_sec", lps, "loci/s",
             lps / NIM_BASELINE_LOCI_PER_SEC)
        print(f"# call n_called={n_called} dt={dt:.2f}s", file=sys.stderr)
        print("# call attribution: " + " ".join(
            f"{k.removesuffix('_s')}={v:.2f}s"
            for k, v in best.items()), file=sys.stderr)
        if smoke:
            return
        dt2, wall2, dp = _call_dist_2proc(d, bam_path, bin_path)
        for sfx in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
            a = open(os.path.join(d, "out") + sfx, "rb").read()
            b = open(dp + sfx, "rb").read()
            if a != b:
                raise AssertionError(f"distributed call diverged on {sfx}")
        lps2 = n_called / dt2
        emit("call_dist2_loci_per_sec", lps2, "loci/s",
             lps2 / NIM_BASELINE_LOCI_PER_SEC)
        print(f"# call 2-process distributed (Gloo CPU processes): "
              f"call={dt2:.2f}s (max over workers, post-init) "
              f"wall={wall2:.2f}s incl. startup; speedup={dt/dt2:.2f}x vs "
              f"single-process {dt:.2f}s on {os.cpu_count()} host cores; "
              "outputs byte-identical", file=sys.stderr)


def bench_outliers(smoke: bool):
    """Cohort outlier estimation: per-locus Huber proposal-2 location/scale
    over a [loci x samples] matrix (strling-outliers.py:115-136,300-314 runs
    this as a per-locus statsmodels loop — the reference's cohort-scale hot
    spot; baseline estimate ~1k loci/s for that loop)."""
    L, S = (500, 20) if smoke else (20_000, 100)
    rng = np.random.default_rng(3)
    X = rng.normal(-3.0, 0.7, (L, S))
    X[rng.random((L, S)) < 0.02] = np.nan       # missing calls
    X[: L // 20] = X[: L // 20, :1]             # constant rows -> MAD path
    out_idx = rng.integers(0, L, L // 10)
    X[out_idx, 0] += rng.uniform(3, 10, len(out_idx))  # expansions
    from strling_tpu.core.outliers import hubers_est_batch

    hubers_est_batch(X[: min(L, 256)])  # warm numpy
    # min-of-N protocol: the host is shared, and a burst of other load
    # during a single timed run moves the number by ~20% on an unchanged
    # code path. Min over ten spaced runs reports the path's achievable rate.
    reps = 1 if smoke else 10
    dt = float("inf")
    for r in range(reps):
        if r:
            time.sleep(1)
        t0 = time.perf_counter()
        mu, sd, method = hubers_est_batch(X)
        dt = min(dt, time.perf_counter() - t0)
    lps = L / dt
    emit("outliers_loci_per_sec", lps, "loci/s", lps / 1000.0)
    print(f"# outliers L={L} S={S} dt={dt*1e3:.0f}ms min-of-{reps} huber="
          f"{int((method == 'Huber').sum())}", file=sys.stderr)


def _bench_fasta(n_mbp: int, seed: int = 11) -> str:
    """Synthetic chromosome with planted STR regions, cached on disk."""
    os.makedirs(CACHE_DIR, exist_ok=True)
    path = os.path.join(CACHE_DIR, f"bench_ref_{n_mbp}mbp.fa")
    if os.path.exists(path) and os.path.exists(path + ".fai"):
        return path
    rng = np.random.default_rng(seed)
    G = n_mbp * 1_000_000
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    seq = alphabet[rng.integers(0, 4, G)]
    units = [b"CAG", b"AT", b"AAGGG", b"A", b"ATTCT", b"CCG"]
    n_loci = max(20, G // 50_000)
    for i, p in enumerate(np.linspace(5_000, G - 5_000, n_loci).astype(np.int64)):
        u = units[i % len(units)]
        rep = np.frombuffer((u * (300 // len(u) + 1))[:250], np.uint8)
        seq[p : p + len(rep)] = rep
    from strling_tpu.io.fasta import write_fasta

    write_fasta(path, {"chrI": seq.tobytes().decode()})
    return path


def bench_index(smoke: bool):
    """Genome STR index stage (genome_strs.nim:61-92 equivalent): windows
    prefiltered on host (native dimer bound), candidates scanned on device,
    merged/trimmed regions written."""
    import tempfile

    from strling_tpu.core.genome_index import genome_repeats
    from strling_tpu.utils.options import Options

    n_mbp = 2 if smoke else 100
    fasta = _bench_fasta(n_mbp)
    opts = Options()
    n_windows = (n_mbp * 1_000_000 + 59) // 60
    with tempfile.TemporaryDirectory() as d:
        bed = os.path.join(d, "ref.str.bed")
        # min-of-2: the first run may pay the scan's compile at the index's
        # batch tier; the second run measures the stage. The bed must be
        # REMOVED between reps — genome_repeats
        # reuses an existing bed (reference behavior, genome_strs.nim:110),
        # which would otherwise make the second run a file load.
        dt = float("inf")
        for _ in range(1 if smoke else 2):
            if os.path.exists(bed):
                os.unlink(bed)
            t0 = time.perf_counter()
            gi = genome_repeats(fasta, opts, bed)
            dt = min(dt, time.perf_counter() - t0)
        n_regions = sum(len(v[0]) for v in gi.by_chrom.values())
    wps = n_windows / dt
    emit("index_windows_per_sec", wps, "windows/s",
         wps / NIM_BASELINE_READS_PER_SEC)
    print(f"# index {n_mbp}Mbp n_windows={n_windows} regions={n_regions} "
          f"dt={dt:.2f}s", file=sys.stderr)


def bench_host_engine(smoke: bool):
    """The extract stage with no accelerator in the loop: same native
    engine + scan code path, cpu jax, in a subprocess."""
    if "--host-engine-child" in sys.argv:
        from strling_tpu.core.extract import extract_native
        from strling_tpu.io.bam import Bam

        n_pairs = 5_000 if smoke else 250_000
        path = _bench_bam(n_pairs)
        best = 0.0
        for _ in range(1 if smoke else 3):
            bam = Bam(path)
            t0 = time.perf_counter()
            tb, frag, opts = extract_native(bam, None, None)
            dt = time.perf_counter() - t0
            best = max(best, 2 * n_pairs / dt)
        emit("extract_host_engine_reads_per_sec", best, "reads/s",
             best / NIM_BASELINE_READS_PER_SEC)
        return
    cmd = [sys.executable, os.path.abspath(__file__), "--host-engine-child"]
    if smoke:
        cmd.append("--smoke")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=1200,
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            print(line, flush=True)
    if r.returncode != 0:
        raise RuntimeError(f"host-engine child failed: {r.stderr[-500:]}")


def main():
    from strling_tpu.utils.compile_cache import enable_compile_cache
    from strling_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    smoke = "--smoke" in sys.argv
    enable_compile_cache()
    if "--host-engine-child" in sys.argv:
        bench_host_engine(smoke)
        return 0
    if not smoke:
        require_gpu()
        print(f"# card: {gpu_name_and_power_limit()}", file=sys.stderr)

    # flagship (extract e2e) runs last so the driver-parsed line is the lead
    # metric; secondary metrics must not mask it
    failed = []
    for fn in (bench_kernel, bench_call, bench_outliers, bench_index,
               bench_host_engine, bench_engine_loop, bench_extract_e2e):
        try:
            fn(smoke)
        except Exception:
            traceback.print_exc()
            failed.append(fn.__name__)
    if failed:
        print(f"# failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
