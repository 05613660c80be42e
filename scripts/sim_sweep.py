#!/usr/bin/env python
"""STR-allele simulation sweeps with truth-vs-call aggregation.

Reimplements the reference's offline accuracy-evaluation protocol
(/root/reference/sim/simulate_random.groovy:16-24, sim/random_str_alleles.py,
sim/combine_random_sim_results.py, sim/disease_loci_sims_minpath.bed) against
this framework:

  random   N samples at one locus, allele1 fixed, allele2 uniform in
           [--min-units, --max-units] (reference: 300 samples, 0..600 units,
           simulate_random.groovy:16-24). Joint protocol exactly as the
           reference pipeline: per-sample extract -> joint merge -> per-sample
           call with the merged bounds -> combined truth-vs-called CSV.
  disease  the reference's 22 disease-locus allele configs
           (sim/disease_loci_sims_minpath.bed: same units + allele counts,
           incl. deletion alleles) planted at synthetic loci, since no hg38
           FASTA exists in this environment; single-sample extract -> call.
  Both modes write <out>/sweep_results.csv plus a size-binned sensitivity /
  concordance summary to stdout and <out>/summary.md.

Usage:
  python scripts/sim_sweep.py random  --out sweep/ [--n-samples 60]
  python scripts/sim_sweep.py disease --out dis/   [--depth 30]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from strling_tpu.core.call import run_call  # noqa: E402
from strling_tpu.core.extract import extract  # noqa: E402
from strling_tpu.core.merge import run_merge  # noqa: E402
from strling_tpu.core.simulate import Allele, normal_hist, simulate_str_bam  # noqa: E402
from strling_tpu.io.bam import Bam  # noqa: E402
from strling_tpu.io.binfmt import write_bin  # noqa: E402
from strling_tpu.io.fasta import Fasta, build_fai, write_fasta  # noqa: E402
from strling_tpu.ops.encode import min_rotation, reverse_complement  # noqa: E402


def unit_key(u: str) -> str:
    """Rotation- and strand-invariant repeat-unit key (the detector reports
    min-rotation units, e.g. AGC for a CAG run; canonical_repeat is not
    rotation-invariant on the forward strand)."""
    return min(min_rotation(u), min_rotation(reverse_complement(u)))

# the reference's 22 minimal-pathogenic disease-locus simulation configs
# (sim/disease_loci_sims_minpath.bed): (unit, allele1, allele2). Positions are
# synthetic here (no hg38 in this environment); units and allele counts match.
DISEASE_CONFIGS = [
    ("GCC", 5, 11), ("CAG", 0, 31), ("CAGG", 0, 56), ("CAG", 0, 30),
    ("CGG", -25, 151), ("GAA", 12, 61), ("GCCCCG", 0, 52), ("CGG", 0, 182),
    ("CAG", -5, 12), ("GCT", 0, 28), ("CGG", 3, 6), ("CAG", -10, 5),
    ("CTG", 0, 10), ("ATTCT", 0, 850), ("CAG", 10, 42), ("CAG", -5, 13),
    ("CTG", 0, 11), ("CTG", 5, 45), ("GGCCTG", 0, 650), ("CTG", -2, 8),
    ("CAG", 0, 28), ("CTG", 20, 57),
]

SLOP = 500


def _rand_genome(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def _read_call(prefix, chrom, pos, unit):
    """Find the call for (chrom, pos+-SLOP, canonical unit) in a genotype
    file; returns dict or None."""
    canon = unit_key(unit)
    with open(prefix + "-genotype.txt") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            f = dict(zip(header, line.rstrip("\n").split("\t")))
            if f["#chrom"] != chrom:
                continue
            if abs(int(f["left"]) - pos) > SLOP:
                continue
            if unit_key(f["repeatunit"]) != canon:
                continue
            return f
    return None


def _summarize(rows, out_dir, read_len=150):
    """Size-binned sensitivity + allele2 concordance, like the aggregation
    the reference does offline from combine_random_sim_results.py output."""
    bins = [(0, 50), (50, 150), (150, 400), (400, 10**9)]
    lines = [
        "| expansion (bp) | n | called | sensitivity | median allele2 err (units) |",
        "|---|---|---|---|---|",
    ]
    for lo, hi in bins:
        sel = [r for r in rows if lo <= r["true_units"] * len(r["repeatunit"]) < hi]
        if not sel:
            continue
        called = [r for r in sel if r["called"]]
        errs = sorted(
            abs(r["allele2_est"] - r["true_units"])
            for r in called
            if r["allele2_est"] == r["allele2_est"]  # not NaN
        )
        med = errs[len(errs) // 2] if errs else float("nan")
        lines.append(
            f"| {lo}-{hi if hi < 10**9 else 'inf'} | {len(sel)} | "
            f"{len(called)} | {len(called)/len(sel):.2f} | {med:.1f} |"
        )
    # the key clinical metric: reads-longer-than-the-read-length expansions
    big = [r for r in rows if r["true_units"] * len(r["repeatunit"]) >= read_len]
    bigc = sum(1 for r in big if r["called"])
    lines.append("")
    lines.append(
        f"Large-expansion (>= read length {read_len}bp) sensitivity: "
        f"{bigc}/{len(big)}" + (f" = {bigc/len(big):.2f}" if big else "")
    )
    text = "\n".join(lines)
    with open(os.path.join(out_dir, "summary.md"), "w") as fh:
        fh.write(text + "\n")
    print(text)


def _write_csv(rows, out_dir):
    out_csv = os.path.join(out_dir, "sweep_results.csv")
    with open(out_csv, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"[sweep] wrote {out_csv} ({len(rows)} rows)", file=sys.stderr)


def _genome_with_locus(out_dir, rng, unit, ref_units, glen=60_000,
                       n_decoys=0, decoy_units=15):
    """Synthetic genome with `ref_units` copies of `unit` planted mid-chrom.
    With n_decoys, also plants same-unit decoy repeat runs on a SECOND
    chromosome — the other genomic STR sites bwa mismaps pure-repeat reads
    to (simulate_reads.nim:178-179 gets these from real bwa)."""
    pos = glen // 2
    g = _rand_genome(rng, glen)
    g = g[:pos] + unit * ref_units + g[pos:]
    fa = os.path.join(out_dir, "ref.fa")
    chroms = {"chr1": g}
    decoys = []
    if n_decoys:
        g2 = _rand_genome(rng, glen)
        step = glen // (n_decoys + 1)
        placed = []
        off = 0
        for di in range(n_decoys):
            dpos = (di + 1) * step
            placed.append(dpos + off)
            g2 = g2[: dpos + off] + unit * decoy_units + g2[dpos + off:]
            off += len(unit) * decoy_units
        chroms["chr2"] = g2
        decoys = [("chr2", dp) for dp in placed]
    write_fasta(fa, chroms)
    build_fai(fa, fa + ".fai")
    return fa, "chr1", pos, {unit: decoys}


def run_random(args):
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    hist = normal_hist(400, 60)
    # reference: one locus, CAG, allele1 fixed 0, allele2 uniform 0..600
    # (random_str_alleles.py --min 0 --max 600 --fixed 0)
    fa, chrom, pos, decoys = _genome_with_locus(
        args.out, rng, args.unit, 10,
        n_decoys=3 if args.mismap > 0 else 0)
    truth = []
    bins = []
    for s in range(args.n_samples):
        a2 = int(rng.integers(args.min_units, args.max_units + 1))
        tag = f"s{s:03d}"
        bam_path = os.path.join(args.out, tag + ".bam")
        simulate_str_bam(
            fa, [Allele(chrom, pos, (args.fixed, a2), args.unit)], bam_path,
            hist, depth=args.depth, flank=args.flank,
            seed=int(rng.integers(0, 1 << 31)),
            decoys=decoys if args.mismap > 0 else None,
            mismap_rate=args.mismap,
        )
        bam = Bam(bam_path)
        treads, frag_dist, _ = extract(bam, None, None)
        bin_path = os.path.join(args.out, tag + ".bin")
        write_bin(bin_path, treads, frag_dist, bam.header_text, 0.8, 40)
        truth.append((tag, bam_path, bin_path, a2))
        bins.append(bin_path)
        print(f"[sweep] simulated {tag}: allele2={a2}", file=sys.stderr)

    # joint discovery across the cohort, then per-sample call with the merged
    # bounds (the reference pipeline: str_merge + "%.bin" * [str_call])
    merged_prefix = os.path.join(args.out, "joint")
    run_merge(bins, output_prefix=merged_prefix)

    rows = []
    for tag, bam_path, bin_path, a2 in truth:
        prefix = os.path.join(args.out, tag)
        run_call(bam_path, bin_path, bounds_path=merged_prefix + "-bounds.txt",
                 output_prefix=prefix)
        f = _read_call(prefix, chrom, pos, args.unit)
        rows.append(
            dict(sample=tag, chrom=chrom, pos=pos, repeatunit=args.unit,
                 true_a1=args.fixed, true_units=a2,
                 called=int(f is not None),
                 allele1_est=float(f["allele1_est"]) if f else float("nan"),
                 allele2_est=float(f["allele2_est"]) if f else float("nan"),
                 sum_str_counts=int(f["sum_str_counts"]) if f else 0)
        )
    _write_csv(rows, args.out)
    _summarize(rows, args.out)




_DIST_WORKER = """
import os, sys
pid, n, port, out_prefix, bam_p, binp = sys.argv[1:7]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=int(n), process_id=int(pid))
from strling_tpu.parallel.call_dist import run_call_dist
run_call_dist(bam_p, binp, output_prefix=out_prefix)
"""


def _dist_check(d, bam_path, bin_path, prefix, port):
    """Run `call --distributed` with 2 jax.distributed (Gloo) processes on
    this config and assert all three outputs are byte-identical to the
    single-process run (the equality must hold on the
    full sweep, not just unit fixtures)."""
    import subprocess

    worker = os.path.join(d, "dist_worker.py")
    with open(worker, "w") as fh:
        fh.write(_DIST_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..")
    env.pop("JAX_PLATFORMS", None)
    dp = os.path.join(d, "dist")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port), dp, bam_path,
             bin_path],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for i in range(2)
    ]
    for pr in procs:
        _, err = pr.communicate(timeout=600)
        if pr.returncode != 0:
            raise RuntimeError(f"dist worker failed: {err.decode()[-1500:]}")
    for sfx in ("-genotype.txt", "-bounds.txt", "-unplaced.txt"):
        a = open(prefix + sfx, "rb").read()
        b = open(dp + sfx, "rb").read()
        assert a == b, f"distributed call diverged on {sfx} in {d}"

def run_disease(args):
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    hist = normal_hist(400, 60)
    rows = []
    for i, (unit, a1, a2) in enumerate(DISEASE_CONFIGS):
        d = os.path.join(args.out, f"cfg{i:02d}_{unit}_{a1}_{a2}")
        os.makedirs(d, exist_ok=True)
        # reference repeat run long enough that deletion alleles can remove
        # |a| units and still leave sequence (the real disease loci carry
        # reference repeat runs)
        ref_units = max(5, -a1 + 5, -a2 + 5, 30)
        fa, chrom, pos, decoys = _genome_with_locus(
            d, rng, unit, ref_units,
            n_decoys=3 if args.mismap > 0 else 0)
        bam_path = os.path.join(d, "s.bam")
        simulate_str_bam(
            fa, [Allele(chrom, pos, (a1, a2), unit)], bam_path, hist,
            depth=args.depth, flank=args.flank,
            seed=int(rng.integers(0, 1 << 31)),
            decoys=decoys if args.mismap > 0 else None,
            mismap_rate=args.mismap,
        )
        bam = Bam(bam_path)
        treads, frag_dist, _ = extract(bam, None, None)
        bin_path = os.path.join(d, "s.bin")
        write_bin(bin_path, treads, frag_dist, bam.header_text, 0.8, 40)
        prefix = os.path.join(d, "out")
        run_call(bam_path, bin_path, output_prefix=prefix)
        if args.dist_check:
            _dist_check(d, bam_path, bin_path, prefix, 12800 + i)
        f = _read_call(prefix, chrom, pos, unit)
        rows.append(
            dict(sample=f"cfg{i:02d}", chrom=chrom, pos=pos, repeatunit=unit,
                 true_a1=a1, true_units=a2,
                 called=int(f is not None),
                 allele1_est=float(f["allele1_est"]) if f else float("nan"),
                 allele2_est=float(f["allele2_est"]) if f else float("nan"),
                 sum_str_counts=int(f["sum_str_counts"]) if f else 0)
        )
        print(f"[sweep] cfg{i:02d} {unit}_{a1}/{a2}: "
              f"called={rows[-1]['called']} est={rows[-1]['allele2_est']}",
              file=sys.stderr)
    _write_csv(rows, args.out)
    _summarize(rows, args.out)


def main():
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)

    pr = sub.add_parser("random", help="random-allele sweep at one locus")
    pr.add_argument("--out", required=True)
    pr.add_argument("--n-samples", type=int, default=60)
    pr.add_argument("--min-units", type=int, default=0)
    pr.add_argument("--max-units", type=int, default=600)
    pr.add_argument("--fixed", type=int, default=0)
    pr.add_argument("--unit", default="CAG")
    pr.add_argument("--depth", type=int, default=30)
    pr.add_argument("--flank", type=int, default=10_000)
    pr.add_argument("--seed", type=int, default=7)
    pr.add_argument("--mismap", type=float, default=0.0,
                    help="probability a mismapped pure-STR read lands at a "
                         "same-unit decoy locus instead of the event "
                         "(emulates bwa multi-mapping; 0 = idealized)")
    pr.set_defaults(fn=run_random)

    pd = sub.add_parser("disease", help="22 reference disease-locus configs")
    pd.add_argument("--out", required=True)
    pd.add_argument("--depth", type=int, default=30)
    pd.add_argument("--flank", type=int, default=10_000)
    pd.add_argument("--seed", type=int, default=11)
    pd.add_argument("--mismap", type=float, default=0.0,
                    help="see `random --mismap`")
    pd.add_argument("--dist-check", action="store_true",
                    help="also run every config through `call --distributed`"
                         " (2 Gloo processes) and assert the outputs are"
                         " byte-identical to single-process call")
    pd.set_defaults(fn=run_disease)

    args = p.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
