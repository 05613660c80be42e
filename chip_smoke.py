#!/usr/bin/env python
"""Bring-up check: strling_tpu's main path on one GPU, through the CLI.

    python chip_smoke.py                 # one card, every phase below
    python chip_smoke.py --four-cards    # the multi-device paths on 4 cards
    python chip_smoke.py --rehearse      # tiny sizes on any backend, no result

Phases (one process; any failure exits non-zero and prints no result):

  environment  JAX version and devices, the card's name and power limit,
               host cores, the native library and whether its AVX-512
               prefilter is compiled in, the compile-cache directory. A
               default device that is not a GPU is a failure.
  kernel       the fused scan (ops/kmer) at every extract bucket, at L=152
               (n8 and w8 wire layouts) and L=256 (w16), plus an IUPAC batch
               on the ASCII path: byte-equal to the same jit on the CPU
               backend, and to ops/oracle on a sample per shape. Times each
               bucket warm, with block_until_ready.
  pipeline     `index` a seeded 100 Mbp reference; `extract -f -g` and
               `call -l` on a 2x150 BAM (1M background pairs plus planted
               expansions with bwa-style mismapping) and a 2x250 BAM; the
               planted loci must be called, and every output must be
               byte-identical to the same commands run in a JAX_PLATFORMS=cpu
               child. Then a warm extract of each BAM is timed.
  golden       the frozen extract -> merge -> call chain (tests/golden).

--four-cards runs only `extract --devices all`, `merge --distributed` and
`call --distributed` over 4 local devices, each compared byte for byte with
its one-device run. The last stdout line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# a process that picks its platforms keeps the CPU backend for the
# in-process reference runs (the default device stays the first platform)
_plats = os.environ.get("JAX_PLATFORMS")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

#: planted reference STRs (one every 50 kb, 250 bp), as in bench.py
REF_UNITS = ("CAG", "AT", "AAGGG", "A", "ATTCT", "CCG")
#: planted expansions: (chrom, position as a fraction of the chromosome,
#: unit, allele repeat counts); the reference holds 8 units at each
EXPANSIONS = (("chr1", 0.2, "CAG", (0, 120)), ("chr2", 0.4, "CAG", (0, 120)),
              ("chr3", 0.6, "AAGGG", (0, 60)), ("chr4", 0.8, "CCG", (0, 100)))
MISMAP_RATE = 0.7
DEPTH = 30
FLANK = 20_000


@dataclass(frozen=True)
class Sizes:
    chrom_len: int          # 4 chromosomes
    pairs_150: int          # background pairs, 2x150 BAM
    pairs_250: int          # background pairs, 2x250 BAM
    buckets: tuple          # kernel-phase row counts
    n_oracle: int           # oracle sample per shape
    four_chrom_len: int     # --four-cards reference
    four_pairs: int         # --four-cards background pairs per sample


FULL = Sizes(25_000_000, 1_000_000, 200_000, (4096, 16384, 32768, 65536),
             4096, 5_000_000, 100_000)
REHEARSE = Sizes(1_000_000, 20_000, 5_000, (256, 512), 256, 1_000_000, 5_000)


def say(*a):
    print(*a, flush=True)


# ------------------------------------------------------------- environment


def avx512_prefilter_compiled() -> bool:
    """The engine's AVX-512 dimer bound is built when -march=native defines
    both macros it tests (io/csrc/extract_engine.cc)."""
    r = subprocess.run(["g++", "-march=native", "-dM", "-E", "-x", "c++",
                        os.devnull], capture_output=True, text=True,
                       check=True)
    return "__AVX512BW__" in r.stdout and "__AVX512VBMI__" in r.stdout


def check_environment(allow_cpu: bool = False) -> dict:
    """Print what runs where; raise unless the default device is a GPU."""
    import jax

    from strling_tpu.utils.device import (
        device_info,
        gpu_name_and_power_limit,
        require_gpu,
    )

    info = device_info()
    say(f"jax {jax.__version__}; devices {jax.devices()}")
    say(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    if not allow_cpu:
        require_gpu()
    from strling_tpu.io.build import lib_path
    from strling_tpu.utils.compile_cache import enable_compile_cache

    say(f"card: {gpu_name_and_power_limit()}")
    say(f"host cores: {os.cpu_count()}")
    say(f"native library: {lib_path()}")
    say(f"AVX-512 prefilter compiled in: {avx512_prefilter_compiled()}")
    say(f"compile cache: {enable_compile_cache()}")
    return info


# ------------------------------------------------------------------ kernel


def seeded_batch(B: int, L: int, seed: int, n_rate: float = 0.0,
                 iupac: bool = False):
    """[B, L] reads: random sequence with ~1 in 7 reads a (noisy) repeat,
    lengths L/2..L, optional N and IUPAC bytes."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (B, L))]
    units = [b"CAG", b"A", b"AT", b"AAGGG", b"ATTCT", b"CCTGGG", b"CCG"]
    for i in range(0, B, 7):
        u = units[(i // 7) % len(units)]
        ph = int(rng.integers(0, len(u)))
        bases[i] = np.frombuffer((u * (L // len(u) + 2))[ph:ph + L], np.uint8)
    noisy = rng.random((B, L)) < 0.02
    bases[noisy] = alphabet[rng.integers(0, 4, int(noisy.sum()))]
    if n_rate:
        bases[rng.random((B, L)) < n_rate] = ord("N")
    if iupac:
        odd = np.frombuffer(b"RYSWKMBDHV", np.uint8)
        m = rng.random((B, L)) < 0.002
        bases[m] = odd[rng.integers(0, len(odd), int(m.sum()))]
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    bases[np.arange(L)[None, :] >= lengths[:, None]] = 0
    return bases, lengths, np.where(np.arange(B) % 3 == 0, 0.6, 0.8)


def check_oracle(bases, lengths, props, code, ulen, cnt, n: int, label: str):
    from strling_tpu.ops import oracle
    from strling_tpu.ops.kmer import unpack_unit_codes

    units = unpack_unit_codes(code[:n], ulen[:n])
    bad = 0
    for i in range(n):
        read = bases[i, :lengths[i]].tobytes().decode()
        if (units[i], int(cnt[i])) != oracle.get_repeat(read, float(props[i])):
            bad += 1
    if bad:
        raise AssertionError(f"{label}: {bad}/{n} reads disagree with oracle")
    say(f"  {label}: {n} reads equal to ops/oracle")


def kernel_phase(sizes: Sizes):
    import jax

    from strling_tpu.ops import kmer as K

    cpu = jax.devices("cpu")[0]
    dev = jax.devices()[0]
    say(f"== kernel phase: buckets {sizes.buckets}")
    shapes = ((152, "n8", 0.0), (152, "w8", 0.001), (256, "w16", 0.001))
    for si, (L, layout_want, n_rate) in enumerate(shapes):
        for bi, B in enumerate(sizes.buckets):
            bases, lengths, props = seeded_batch(B, L, 1000 * si + bi, n_rate)
            payload, layout = K.fuse_payload(bases, lengths, props,
                                             return_layout=True)
            if layout != layout_want:
                raise AssertionError(f"L={L}: layout {layout} != {layout_want}")
            t0 = time.perf_counter()
            got = K.scan_payload(payload, B, layout, bucket=B)
            first = time.perf_counter() - t0
            want = K.unpack_result(
                K._fused_xla_jit(jax.device_put(payload, cpu), layout))
            for g, w in zip(got, want):
                if g.tobytes() != w.tobytes():
                    raise AssertionError(
                        f"B={B} L={L} {layout}: device result differs from "
                        "the CPU backend")
            arr = jax.device_put(payload, dev)
            times = []
            for _ in range(20):
                t0 = time.perf_counter()
                K._fused_xla_jit(arr, layout).block_until_ready()
                times.append(time.perf_counter() - t0)
            say(f"  B={B} L={L} {layout}: byte-equal to CPU backend; "
                f"first call {first:.3f}s; warm median "
                f"{np.median(times) * 1e3:.4f} ms min {min(times) * 1e3:.4f} "
                f"ms ({B / np.median(times):.4g} rows/s)")
            if bi == 0:
                check_oracle(bases, lengths, props, *got,
                             min(B, sizes.n_oracle), f"L={L} {layout}")
    # IUPAC batch: no wire layout fits, so the ASCII dispatch runs
    B = sizes.buckets[0]
    bases, lengths, props = seeded_batch(B, 152, 7, iupac=True)
    if K.fuse_payload(bases, lengths, props) is not None:
        raise AssertionError("IUPAC batch did not take the ASCII path")
    got = K.scan_codes(bases, lengths, props, bucket=B)
    te, tp = K._host_thresholds(lengths, props)
    unit, ul, cnt = K._get_repeat_jit(
        *(jax.device_put(x, cpu) for x in (bases, lengths, te, tp)))
    want = (K.ascii_to_codes(np.asarray(unit), np.asarray(ul)),
            np.asarray(ul), np.asarray(cnt))
    for g, w in zip(got, want):
        if g.tobytes() != w.tobytes():
            raise AssertionError("IUPAC ASCII path differs from the CPU backend")
    say(f"  B={B} L=152 ascii (IUPAC): byte-equal to CPU backend")
    check_oracle(bases, lengths, props, *got, min(B, sizes.n_oracle),
                 "L=152 ascii")
    # device memory of the largest program
    B = sizes.buckets[-1]
    bases, lengths, props = seeded_batch(B, 256, 99, 0.001)
    payload, layout = K.fuse_payload(bases, lengths, props, return_layout=True)
    compiled = K._fused_xla_jit.lower(jax.device_put(payload, dev),
                                      layout).compile()
    say(f"  memory_analysis B={B} L=256 {layout}: "
        f"{compiled.memory_analysis()}")


# ---------------------------------------------------------------- pipeline


def make_reference(path: str, chrom_len: int, seed: int):
    """Four seeded chromosomes with a 250 bp STR every 50 kb and 8 units at
    each planted expansion locus. Returns ({chrom: uint8 seq}, loci, sites)
    with loci [(chrom, pos, unit, counts)] and sites {unit: [(chrom, pos)]},
    the same-unit decoy sites for mismapped reads."""
    from strling_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    chroms, sites = {}, {}
    for c in range(4):
        name = f"chr{c + 1}"
        seq = alphabet[rng.integers(0, 4, chrom_len)]
        for i, p in enumerate(range(10_000, chrom_len - 10_000, 50_000)):
            u = REF_UNITS[(c + i) % len(REF_UNITS)]
            seq[p:p + 250] = np.frombuffer(
                (u * (250 // len(u) + 1))[:250].encode(), np.uint8)
            sites.setdefault(u, []).append((name, p))
        chroms[name] = seq
    loci = []
    for chrom, frac, unit, counts in EXPANSIONS:
        pos = int(chrom_len * frac) // 50_000 * 50_000 + 35_000
        chroms[chrom][pos:pos + 8 * len(unit)] = np.frombuffer(
            (unit * 8).encode(), np.uint8)
        loci.append((chrom, pos, unit, counts))
    write_fasta(path, {n: s.tobytes().decode() for n, s in chroms.items()})
    return chroms, loci, sites


def write_loci_bed(path: str, loci):
    with open(path, "w") as fh:
        for chrom, pos, unit, _ in loci:
            fh.write(f"{chrom}\t{pos}\t{pos + 8 * len(unit)}\t{unit}\t"
                     f"{chrom}_{unit}\n")


def make_bam(path: str, ref: str, chroms: dict, loci, sites, n_pairs: int,
             rl: int, seed: int, counts_of=None) -> int:
    """Coordinate-sorted paired BAM: `n_pairs` WGS-like background pairs
    drawn from the reference (insert ~ N(400, 50), 0.1% of mates carry an
    N), plus the planted expansions at depth 30 through the simulator, with
    pure-STR reads mismapped to same-unit decoys. Returns the record count."""
    from strling_tpu.core.simulate import Allele, normal_hist, simulate_allele
    from strling_tpu.io.bamwrite import BamRecord, write_bam
    from strling_tpu.io.fasta import Fasta

    rng = np.random.default_rng(seed)
    names = list(chroms)
    tid_of = {n: i for i, n in enumerate(names)}
    lens = np.array([len(chroms[n]) for n in names], np.float64)
    which = rng.choice(len(names), n_pairs, p=lens / lens.sum())
    isz_all = np.clip(np.rint(rng.normal(400, 50, n_pairs)), rl, 1000)
    recs = []
    cig = [(rl, 0)]
    for t, name in enumerate(names):
        m = which == t
        k = int(m.sum())
        seq = chroms[name]
        pos = np.sort(rng.integers(0, len(seq) - 1001, k))
        isz = isz_all[m].astype(np.int64)
        r1 = seq[pos[:, None] + np.arange(rl)]
        r2 = seq[(pos + isz - rl)[:, None] + np.arange(rl)]
        nm = rng.random(k) < 0.001
        r2[nm, rng.integers(0, rl, int(nm.sum()))] = ord("N")
        s1, s2 = r1.tobytes().decode(), r2.tobytes().decode()
        for i in range(k):
            p, z = int(pos[i]), int(isz[i])
            q = f"bg{t}_{i}"
            recs.append(BamRecord(q, 0x63, t, p, 60, cig, t, p + z - rl, z,
                                  s1[i * rl:(i + 1) * rl]))
            recs.append(BamRecord(q, 0x93, t, p + z - rl, 60, cig, t, p, -z,
                                  s2[i * rl:(i + 1) * rl]))
    fai = Fasta(ref)
    frag = normal_hist(400, 50)
    for chrom, pos, unit, counts in loci:
        allele = Allele(chrom, pos, counts_of(chrom) if counts_of else counts,
                        unit)
        simulate_allele(
            fai, allele, frag, FLANK, DEPTH, rl, rng, recs, tid_of[chrom],
            max(0, pos - FLANK),
            decoy_sites=[(tid_of[c], p) for c, p in sites.get(unit, [])],
            mismap_rate=MISMAP_RATE)
    recs.sort(key=lambda r: (r.tid if r.tid >= 0 else 1 << 30, r.pos))
    targets = [(n, len(chroms[n])) for n in names]
    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in targets) + "@RG\tID:sim\tSM:sim\n"
    write_bam(path, header, targets, recs)
    return len(recs)


PIPE_OUTPUTS = ("ref.str", "s150.bin", "s150-genotype.txt", "s150-bounds.txt",
                "s150-unplaced.txt", "s250.bin", "s250-genotype.txt",
                "s250-bounds.txt", "s250-unplaced.txt")


def run_pipeline(data: str, out: str):
    """index -> extract -> call through cli.main, outputs under `out`."""
    from strling_tpu.cli import main as cli

    os.makedirs(out, exist_ok=True)
    ref = os.path.join(data, "ref.fa")
    bed = os.path.join(out, "ref.str")
    cli(["index", "-g", bed, ref])
    for s in ("s150", "s250"):
        bam = os.path.join(data, s + ".bam")
        binp = os.path.join(out, s + ".bin")
        cli(["extract", "-f", ref, "-g", bed, bam, binp])
        cli(["call", "-f", ref, "-l", os.path.join(data, "loci.bed"),
             "-o", os.path.join(out, s), bam, binp])


def check_called(prefix: str, loci):
    """A bounds line and a genotype with sum_str_counts > 0 at each locus."""
    def rows(path):
        with open(path) as fh:
            return [ln.rstrip("\n").split("\t") for ln in fh
                    if not ln.startswith("#")]
    gts, bounds = rows(prefix + "-genotype.txt"), rows(prefix + "-bounds.txt")
    for chrom, pos, unit, _ in loci:
        near = [r for r in gts if r[0] == chrom and abs(int(r[1]) - pos) < 500]
        if not any(float(r[-1]) > 0 for r in near):
            raise AssertionError(f"{prefix}: no genotype with sum_str_counts "
                                 f"> 0 at {chrom}:{pos} {unit}")
        if not any(r[0] == chrom and abs(int(r[1]) - pos) < 500
                   for r in bounds):
            raise AssertionError(f"{prefix}: no bounds line at {chrom}:{pos}")
        best = max(near, key=lambda r: float(r[-1]))
        say(f"  {os.path.basename(prefix)} {chrom}:{pos} {unit}: "
            f"allele2_est={best[5]} anchored={best[6]} "
            f"sum_str_counts={best[-1]}")


def timed_extract(data: str, out: str, name: str, n_records: int):
    from strling_tpu.core.extract import extract_native
    from strling_tpu.io.bam import Bam

    stats = {}
    t0 = time.perf_counter()
    extract_native(Bam(os.path.join(data, name + ".bam")),
                   os.path.join(data, "ref.fa"), os.path.join(out, "ref.str"),
                   stats=stats)
    wall = time.perf_counter() - t0
    say(f"  warm extract {name}: wall={wall:.3f}s reads={n_records} "
        f"reads/s={n_records / wall:.6g} batches={stats['n_batches']} "
        f"h2d={stats['h2d_bytes'] / 1e6:.3f}MB "
        f"device_wait={stats['wait_s']:.4f}s "
        f"device_wait_share={stats['wait_s'] / wall:.4f}")


def pipeline_phase(sizes: Sizes, work: str):
    say("== pipeline phase")
    data = os.path.join(work, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    ref = os.path.join(data, "ref.fa")
    chroms, loci, sites = make_reference(ref, sizes.chrom_len, seed=11)
    write_loci_bed(os.path.join(data, "loci.bed"), loci)
    n150 = make_bam(os.path.join(data, "s150.bam"), ref, chroms, loci, sites,
                    sizes.pairs_150, 150, seed=150)
    n250 = make_bam(os.path.join(data, "s250.bam"), ref, chroms, loci, sites,
                    sizes.pairs_250, 250, seed=250)
    del chroms
    say(f"  generated {4 * sizes.chrom_len / 1e6:.0f} Mbp reference, "
        f"2x150 BAM ({n150} records), 2x250 BAM ({n250} records) in "
        f"{time.perf_counter() - t0:.1f}s")

    # the CPU child runs the same commands meanwhile; it never opens a card
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
    child_log = open(os.path.join(work, "cpu_child.log"), "w")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-child", data,
         os.path.join(work, "cpu")], env=env, stdout=child_log,
        stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        run_pipeline(data, os.path.join(work, "dev"))
        say(f"  device pipeline (index, extract, call x2; compiles "
            f"included): {time.perf_counter() - t0:.1f}s")
        child.wait(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        child_log.close()
    if child.returncode != 0:
        with open(os.path.join(work, "cpu_child.log")) as fh:
            tail = fh.read()[-3000:]
        raise RuntimeError(f"CPU child failed (rc={child.returncode}):\n{tail}")
    for f in PIPE_OUTPUTS:
        with open(os.path.join(work, "dev", f), "rb") as a, \
                open(os.path.join(work, "cpu", f), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{f}: device run differs from CPU child")
    say(f"  byte-identical to the CPU child: {', '.join(PIPE_OUTPUTS)}")
    for s in ("s150", "s250"):
        check_called(os.path.join(work, "dev", s), loci)
    timed_extract(data, os.path.join(work, "dev"), "s150", n150)
    timed_extract(data, os.path.join(work, "dev"), "s250", n250)


def golden_phase():
    say("== golden phase")
    sys.path.insert(0, REPO)
    from __graft_entry__ import _full_chain_vs_goldens

    t0 = time.perf_counter()
    _full_chain_vs_goldens()
    say(f"  extract -> merge -> call chain byte-identical to tests/golden "
        f"({time.perf_counter() - t0:.1f}s)")


# --------------------------------------------------------------- 4 devices


def four_cards_phase(sizes: Sizes, work: str):
    import jax

    from strling_tpu.cli import main as cli

    n = len(jax.devices())
    if n != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, JAX sees {n}")
    say("== four-device phase")
    t0 = time.perf_counter()
    ref = os.path.join(work, "ref.fa")
    chroms, loci, sites = make_reference(ref, sizes.four_chrom_len, seed=44)
    bams, bins1, binsN = [], [], []
    for s in range(4):
        bam = os.path.join(work, f"c{s}.bam")
        make_bam(bam, ref, chroms, loci, sites, sizes.four_pairs, 150,
                 seed=400 + s, counts_of=lambda c, s=s: (0, 40 * (s + 1)))
        bams.append(bam)
    del chroms
    bed = os.path.join(work, "ref.str")
    cli(["index", "-g", bed, ref])
    say(f"  generated 4-sample cohort in {time.perf_counter() - t0:.1f}s")

    def same(a, b, what):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{what}: 4-device run differs from "
                                     "the one-device run")

    t0 = time.perf_counter()
    for s, bam in enumerate(bams):
        b1, bN = os.path.join(work, f"c{s}.1.bin"), os.path.join(work, f"c{s}.N.bin")
        cli(["extract", "-f", ref, "-g", bed, bam, b1])
        cli(["extract", "-f", ref, "-g", bed, "--devices", "all", bam, bN])
        same(b1, bN, f"extract --devices all, sample {s}")
        bins1.append(b1)
        binsN.append(bN)
    say(f"  extract --devices all: 4 bins byte-identical "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    j1, jN = os.path.join(work, "joint1"), os.path.join(work, "jointN")
    cli(["merge", "-f", ref, "-o", j1, *bins1])
    cli(["merge", "-f", ref, "--distributed", "-o", jN, *bins1])
    same(j1 + "-bounds.txt", jN + "-bounds.txt", "merge --distributed")
    with open(j1 + "-bounds.txt") as fh:
        n_bounds = sum(1 for ln in fh if not ln.startswith("#"))
    say(f"  merge --distributed: {n_bounds} bounds byte-identical "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    for s, (bam, b1) in enumerate(zip(bams, bins1)):
        p1, pN = os.path.join(work, f"c{s}.1"), os.path.join(work, f"c{s}.N")
        cli(["call", "-f", ref, "-b", j1 + "-bounds.txt", "-o", p1, bam, b1])
        cli(["call", "-f", ref, "-b", j1 + "-bounds.txt", "--distributed",
             "-o", pN, bam, b1])
        for sfx in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
            same(p1 + sfx, pN + sfx, f"call --distributed {sfx}, sample {s}")
    check_called(os.path.join(work, "c3.1"), loci)
    say(f"  call --distributed: genotype, bounds, unplaced byte-identical "
        f"for 4 samples ({time.perf_counter() - t0:.1f}s)")


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-device paths and their 1-device runs")
    p.add_argument("--rehearse", action="store_true",
                   help="tiny sizes on any backend; prints no result line")
    p.add_argument("--cpu-child", nargs=2, metavar=("DATA", "OUT"),
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.cpu_child:
        run_pipeline(*a.cpu_child)
        return 0
    sizes = REHEARSE if a.rehearse else FULL
    t_start = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        info = check_environment(allow_cpu=a.rehearse)
        if a.four_cards:
            four_cards_phase(sizes, work)
        else:
            kernel_phase(sizes)
            pipeline_phase(sizes, work)
            golden_phase()
    except Exception:
        traceback.print_exc()
        say("chip_smoke: FAILED")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    if a.rehearse:
        return 0
    say(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
