#!/usr/bin/env python
"""Cohort-scale joint-merge demo: N samples, single-process vs distributed.

Builds an N-sample cohort (simulated BAMs at shared + private STR loci,
native extract -> bin each), then runs joint locus discovery twice:
  1. single-process `run_merge`
  2. multi-process `merge --distributed` (jax.distributed, Gloo on CPU)
and asserts the two -bounds.txt files are BYTE-IDENTICAL (including line
order — both paths write the canonical order). Reports wall time and peak
RSS against the reference's slurm budget for the merge stage
(120 GB / 48 h, pipelines/bpipe.config:16-18).

Usage: python scripts/cohort_demo.py --out /tmp/cohort [--n 100] [--procs 2]
"""

from __future__ import annotations

import argparse
import os
import resource
import subprocess
import sys
import textwrap
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from strling_tpu.core.extract import extract_native  # noqa: E402
from strling_tpu.core.merge import run_merge  # noqa: E402
from strling_tpu.core.simulate import Allele, normal_hist, simulate_str_bam  # noqa: E402
from strling_tpu.io.bam import Bam  # noqa: E402
from strling_tpu.io.binfmt import write_bin  # noqa: E402
from strling_tpu.io.fasta import build_fai, write_fasta  # noqa: E402

WORKER = textwrap.dedent("""
    import os, sys
    pid, n, port, out_prefix = sys.argv[1:5]
    bins = sys.argv[5:]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=int(n), process_id=int(pid))
    import resource, time
    from strling_tpu.parallel.merge_dist import run_merge_dist
    t0 = time.perf_counter()
    run_merge_dist(bins, output_prefix=out_prefix)
    dt = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[p{pid}] wall={dt:.1f}s peak_rss={rss:.2f}GB", file=sys.stderr)
""")


def build_cohort(out: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    G = 120_000
    g = "".join(np.array(list("ACGT"))[rng.integers(0, 4, G)])
    # three shared reference STR loci + room for private novel ones
    shared = [(30_000, "CAG"), (60_000, "AT"), (90_000, "AAGGG")]
    parts, cur = [], 0
    for pos, unit in shared:
        parts.append(g[cur:pos])
        parts.append(unit * 10)
        cur = pos
    parts.append(g[cur:])
    fa = os.path.join(out, "ref.fa")
    write_fasta(fa, {"chr1": "".join(parts)})
    build_fai(fa, fa + ".fai")
    hist = normal_hist(400, 50)
    bins = []
    for s in range(n):
        binp = os.path.join(out, f"s{s:03d}.bin")
        bins.append(binp)
        if os.path.exists(binp):
            continue
        alleles = []
        for i, (pos, unit) in enumerate(shared):
            exp = int(rng.integers(60, 200)) if rng.random() < 0.4 else 0
            if exp:
                alleles.append(Allele("chr1", pos + 10 * len(unit) * i, (0, exp), unit))
        if not alleles:
            alleles = [Allele("chr1", 30_000, (0, int(rng.integers(80, 160))), "CAG")]
        bam_p = os.path.join(out, f"s{s:03d}.bam")
        simulate_str_bam(fa, alleles, bam_p, hist, depth=20, flank=10_000,
                         seed=int(rng.integers(0, 1 << 31)))
        bam = Bam(bam_p)
        tb, frag, _ = extract_native(bam, None, None)
        write_bin(binp, tb, frag, bam.header_text, 0.8, 40)
        os.unlink(bam_p)
        if os.path.exists(bam_p + ".bai"):
            os.unlink(bam_p + ".bai")
        print(f"[cohort] sample {s}: {len(tb)} treads", file=sys.stderr)
    return bins


def build_cohort_synthetic(out: str, n: int, treads_per_sample: int,
                           n_loci: int, seed: int):
    """Heavy-cohort mode: bins written directly with generated treads
    (clustered around n_loci shared loci across 22 chromosomes), stressing
    merge at WGS-cohort scale without simulating reads."""
    from strling_tpu.core.tread import TREAD_DTYPE, TreadBatch

    rng = np.random.default_rng(seed)
    targets = [(f"chr{c+1}", 50_000_000) for c in range(22)]
    header = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{ln}\n" for name, ln in targets)
    units = np.array([b"AGC", b"AT", b"AAGGG", b"A", b"AAG", b"AATGG"],
                     dtype="S6")
    loci_tid = rng.integers(0, 22, n_loci)
    loci_pos = rng.integers(100_000, 49_000_000, n_loci)
    loci_unit = rng.integers(0, len(units), n_loci)
    hist = normal_hist(400, 50)
    bins = []
    for s in range(n):
        binp = os.path.join(out, f"y{s:03d}.bin")
        bins.append(binp)
        if os.path.exists(binp):
            continue
        m = treads_per_sample
        li = rng.integers(0, n_loci, m)
        data = np.zeros(m, TREAD_DTYPE)
        data["tid"] = loci_tid[li]
        data["position"] = (loci_pos[li]
                            + rng.integers(-300, 300, m)).astype(np.uint32)
        data["repeat"] = units[loci_unit[li]]
        data["flag"] = 97
        data["split"] = 3  # Soft.none (anchored)
        data["mapping_quality"] = 60
        data["repeat_count"] = rng.integers(20, 50, m)
        data["align_length"] = 150
        order = np.lexsort((data["position"], data["tid"]))
        data = data[order]
        tb = TreadBatch(data=data, qnames=[f"q{s}_{i}" for i in range(m)])
        write_bin(binp, tb, hist, header, 0.8, 40)
        if s % 20 == 0:
            print(f"[cohort] synthetic sample {s}", file=sys.stderr)
    return bins


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=100)
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--synthetic-treads", type=int, default=0,
                   help="per-sample tread count: skip read simulation and "
                        "write synthetic bins at WGS-cohort scale")
    p.add_argument("--loci", type=int, default=2000)
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic_treads:
        bins = build_cohort_synthetic(args.out, args.n, args.synthetic_treads,
                                      args.loci, args.seed)
    else:
        bins = build_cohort(args.out, args.n, args.seed)

    sp_prefix = os.path.join(args.out, "joint_sp")
    t0 = time.perf_counter()
    run_merge(bins, output_prefix=sp_prefix)
    sp_wall = time.perf_counter() - t0
    sp_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[cohort] single-process merge: wall={sp_wall:.1f}s "
          f"peak_rss={sp_rss:.2f}GB")

    dp_prefix = os.path.join(args.out, "joint_dp")
    worker = os.path.join(args.out, "worker.py")
    with open(worker, "w") as fh:
        fh.write(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(args.procs), "12653",
             dp_prefix] + bins,
            env=env, stderr=subprocess.PIPE,
        )
        for i in range(args.procs)
    ]
    for pr in procs:
        _, err = pr.communicate(timeout=1800)
        sys.stderr.write(err.decode()[-500:])
        assert pr.returncode == 0, err.decode()[-2000:]
    dp_wall = time.perf_counter() - t0
    print(f"[cohort] {args.procs}-process distributed merge: "
          f"wall={dp_wall:.1f}s")

    a = open(sp_prefix + "-bounds.txt", "rb").read()
    b = open(dp_prefix + "-bounds.txt", "rb").read()
    assert a == b, "distributed merge output differs from single-process!"
    n_loci = len(a.splitlines()) - 1
    print(f"[cohort] OK: {args.n} samples, {n_loci} joint loci, outputs "
          "byte-identical (incl. order). Reference merge budget: "
          "120 GB / 48 h (bpipe.config:16-18).")


if __name__ == "__main__":
    main()
