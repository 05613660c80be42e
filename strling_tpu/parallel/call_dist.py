"""Distributed `call` — locus-space sharding of per-sample genotyping.

The reference `call` is single-threaded with two global barriers that need
*all* calls before output (SURVEY.md §3.2): the spanning O/E percentile
ranking (call.nim:29-47,264) and the unique-large-expansion unplaced
refinement (call.nim:268-277). The sharded layout:

- every process reads the same (bam, bin) pair and replays the cheap,
  order-dependent locus bookkeeping identically — `assign_reads_locus`
  mutates the tread table (callclusters.nim:14-50) and clustering consumes
  what remains, so the enumeration of work items is bit-identical on every
  process;
- the expensive per-locus work (`spanners` BAM window queries + genotype,
  collect.nim:130-182) is round-robin sharded over processes;
- the O/E percentile barrier runs ON the device mesh: per-shard O/E ratios
  are padded into fixed rows and ranked with an all_gather + sort +
  searchsorted inside one shard_map (f32 semantics identical to
  core.call.add_percentile);
- Call records are exchanged via a process allgather and re-assembled in the
  exact single-process order, so `-genotype.txt`, `-bounds.txt` and
  `-unplaced.txt` are byte-identical to `run_call`'s, including line order.

Runs identically with 1 process (the mesh collective spans local devices)
or N jax.distributed processes (Gloo on CPU test meshes, NCCL on GPUs).
"""

from __future__ import annotations

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, PartitionSpec as P

from strling_tpu.core.call import oe_ratio
from strling_tpu.core.callclusters import TreadGroups, assign_reads_locus
from strling_tpu.core.cluster import BOUNDS_HEADER, Bounds, parse_bed, parse_bounds
from strling_tpu.core.cluster_batched import cluster_group_batched
from strling_tpu.core.collect_batched import collect_many, collect_many_native
from strling_tpu.core.genotyper import GT_HEADER, genotype_ls, update_genotype
from strling_tpu.io.bam import Bam
from strling_tpu.io.binfmt import read_bin, same_targets
from strling_tpu.ops.encode import canonical_repeat
from strling_tpu.utils import fraglen
from strling_tpu.utils.options import Options


def _oe_rank_fn(mesh: Mesh, n_max: int):
    """shard_map: per-device padded O/E rows -> global percentile per row.

    all_gather the [1, n_max] f32 rows (pads are +inf so they sort past
    every real ratio and never shift a searchsorted-left rank), sort once,
    then rank = searchsorted(sorted, v, left) / (n_total - 1) in f32 —
    exactly core.call.add_percentile (call.nim:38-47). n_total==1 yields
    0/0 = nan, as in the single-process path."""

    def step(oes, count):
        all_oes = jax.lax.all_gather(oes[0], "d").reshape(-1)  # [S * n_max]
        n_total = jax.lax.psum(count[0, 0], "d")
        s = jnp.sort(all_oes)
        lb = jnp.searchsorted(s, oes[0], side="left").astype(jnp.float32)
        pct = lb / (n_total - 1).astype(jnp.float32)
        return pct[None]

    return jax.jit(
        jax.shard_map(
            step, mesh=mesh,
            in_specs=(P("d", None), P("d", None)),
            out_specs=P("d", None),
            check_vma=False,
        )
    )


def rank_oes_on_mesh(oes_by_local_dev: list[np.ndarray], mesh: Mesh) -> list[np.ndarray]:
    """Global O/E percentiles for ragged per-LOCAL-device ratio lists, via
    the mesh collective. Each process passes one list per local device;
    returns matching per-local-device percentile arrays. n_max (the padded
    row width) is agreed across processes so every shard_map participant
    traces the same shapes."""
    pid = jax.process_index()
    mesh_devs = list(mesh.devices.flat)
    local_rows = [i for i, d in enumerate(mesh_devs)
                  if d.process_index == pid]
    n_local = len(oes_by_local_dev)
    assert n_local == len(local_rows), (n_local, len(local_rows))
    local_max = max(1, max((len(o) for o in oes_by_local_dev), default=1))
    if jax.process_count() > 1:
        n_max = int(multihost_utils.process_allgather(
            np.array([local_max])).max())
    else:
        n_max = local_max
    buf = np.full((n_local, n_max), np.inf, np.float32)
    cnt = np.zeros((n_local, 1), np.int32)
    for s, o in enumerate(oes_by_local_dev):
        buf[s, : len(o)] = o
        cnt[s, 0] = len(o)
    buf_g = multihost_utils.host_local_array_to_global_array(buf, mesh, P("d"))
    cnt_g = multihost_utils.host_local_array_to_global_array(cnt, mesh, P("d"))
    pct_g = _oe_rank_fn(mesh, n_max)(buf_g, cnt_g)
    # reassemble this process's local rows (mesh order)
    rows = {}
    for shard in pct_g.addressable_shards:
        rows[(shard.index[0].start or 0)] = np.asarray(shard.data)[0]
    return [rows[local_rows[s]][: len(o)]
            for s, o in enumerate(oes_by_local_dev)]


def _gather_blobs(blob: bytes, nproc: int) -> list[bytes]:
    """All-gather variable-length byte blobs across processes (shared with
    the distributed extract)."""
    from strling_tpu.parallel.extract_dist import _allgather_blobs

    return _allgather_blobs(blob)


def run_call_dist(bam_path: str, bin_path: str, fasta: str | None = None,
                  min_support: int = 5, min_clip: int = 0,
                  min_clip_total: int = 0, min_mapq: int = 40,
                  loci: str | None = None, bounds_path: str | None = None,
                  output_prefix: str = "strling", verbose: bool = False):
    """Distributed call_main (call.nim:50-303). Every process calls this with
    the same arguments; per-locus spanners/genotype work is sharded, the two
    global barriers run as collectives, and process 0 writes files that are
    byte-identical to single-process `run_call`'s. Returns the genotype
    lines (identical on every process)."""
    pid = jax.process_index()
    nproc = jax.process_count()
    mesh = Mesh(np.array(jax.devices()), ("d",))
    n_local = len(jax.local_devices())

    if loci and not os.path.exists(loci):
        raise SystemExit("couldn't open loci file")
    if bounds_path and not os.path.exists(bounds_path):
        raise SystemExit("couldn't open bounds file")

    bam = Bam(bam_path, fasta=fasta)
    from strling_tpu.io.extract_native import native_frag_hist

    frag_dist = native_frag_hist(bam)  # byte-equal to the Python pass
    frag_median = fraglen.median(frag_dist)
    opts = Options(
        median_fragment_length=frag_median, min_clip=min_clip,
        min_clip_total=min_clip_total, min_support=min_support,
        min_mapq=min_mapq, window=fraglen.median(frag_dist, 0.99),
        targets=bam.targets,
    )

    extracted = read_bin(bin_path)
    assert same_targets(extracted.targets, bam.targets)
    groups = TreadGroups.from_batch(extracted.reads)

    loci_list: list[Bounds] = []
    if loci:
        loci_list = parse_bed(loci, opts.targets, opts.window)
        if pid == 0:
            print(f"Read {len(loci_list)} loci from {loci}", file=sys.stderr)
    bounds_list: list[Bounds] = []
    if bounds_path:
        bounds_list = parse_bounds(bounds_path, opts.targets)
        if pid == 0:
            print(f"Read {len(bounds_list)} bounds from {bounds_path}",
                  file=sys.stderr)
    for bound in bounds_list:
        for i, locus in enumerate(loci_list):
            if locus.overlaps(bound):
                bound.name = locus.name
                bound.left = locus.left
                bound.right = locus.right
                del loci_list[i]
                break
    bounds_list.extend(loci_list)

    # --- enumerate work items identically everywhere; shard the heavy part --
    # (order_key, Call-or-None, bounds_line-or-None, canon_repeat)
    unplaced_counts: dict[str, int] = {}
    my_calls: list[tuple[int, object, str, str]] = []
    work_i = 0

    def mine() -> bool:
        return work_i % nproc == pid

    # PASS A — provided loci (call.nim:189-218). assign_reads_locus mutates
    # `groups`, so every process must replay every locus in order; only the
    # heavy support collection + genotype is sharded (and batched: one
    # native collect over this process's share of loci).
    my_work: list[tuple[int, Bounds, np.ndarray, object]] = []
    for bound in bounds_list:
        str_reads, str_qnames = assign_reads_locus(bound, groups)
        if bound.right - bound.left > 1000:
            if pid == 0:
                print(f"large bounds:{bound} skipping", file=sys.stderr)
            continue
        wi = work_i
        work_i += 1
        if mine():
            my_work.append((wi, bound, str_reads, str_qnames))

    # PASS B — novel clusters (call.nim:221-262). The segmented clustering
    # (cluster_batched) is deterministic and replayed everywhere; the
    # per-locus collection is sharded.
    max_clip_dist = int(0.5 * float(fraglen.median(frag_dist, 0.5)))
    for (tid, repeat), (treads, names) in groups.items():
        if len(treads) == 0:
            continue
        if treads["tid"][0] < 0:
            unplaced_counts[treads["repeat"][0].decode()] = len(treads)
            continue
        for b, rv, qv in cluster_group_batched(
            treads, opts.window, opts.min_support, min_clip, min_clip_total,
            max_clip_dist, names,
        ):
            wi = work_i
            work_i += 1
            if mine():
                my_work.append((wi, b, rv, qv))

    # batched support collection over this shard's loci, then genotype
    my_bounds = [w[1] for w in my_work]
    ls_map = collect_many_native(bam, my_bounds, opts.window, frag_dist,
                                 opts.min_mapq)
    if ls_map is None:
        ls_map = collect_many(bam, my_bounds, opts.window, frag_dist,
                              opts.min_mapq, with_rc=False)
    for j, (wi, b, rv, qv) in enumerate(my_work):
        ls = ls_map[j]
        if ls.n_support > 5_000 or ls.med_depth == -1:
            continue
        gt = genotype_ls(b, rv, qv, ls, opts, float(ls.med_depth))
        gt.expected_spanning_fragments = ls.expected
        my_calls.append((wi, gt, b.tostring(opts.targets) + "\t" +
                         str(ls.med_depth), canonical_repeat(b.repeat)))

    # --- barrier 1: global O/E percentile on the mesh (call.nim:264) --------
    # split this process's calls round-robin over its local device slots so
    # the collective really spans the mesh
    slots: list[list] = [[] for _ in range(n_local)]
    for j, item in enumerate(my_calls):
        slots[j % n_local].append(item)
    oes_by_dev = [
        np.array([oe_ratio(it[1]) for it in sl], np.float32) for sl in slots
    ]
    pct_by_dev = rank_oes_on_mesh(oes_by_dev, mesh)
    for s, sl in enumerate(slots):
        for r, it in enumerate(sl):
            it[1].spanning_fragments_oe_percentile = np.float32(
                pct_by_dev[s][r])

    # --- gather Call records; rebuild the single-process order --------------
    blob = pickle.dumps(my_calls, protocol=pickle.HIGHEST_PROTOCOL)
    all_items: list[tuple[int, object, str, str]] = []
    for b in _gather_blobs(blob, nproc):
        all_items.extend(pickle.loads(b))
    all_items.sort(key=lambda t: t[0])

    # genotypes_by_repeat insertion order == call order (canon first seen)
    genotypes_by_repeat: dict[str, list] = {}
    bounds_lines = []
    for _, gt, bline, canon in all_items:
        genotypes_by_repeat.setdefault(canon, []).append(gt)
        bounds_lines.append(bline)

    # --- barrier 2: unique-large-expansion refinement (call.nim:268-277) ----
    # unplaced_counts were computed identically on every process (clustering
    # is replayed), so no exchange is needed — assert that invariant cheaply.
    gt_lines = []
    for repeat, genotypes in genotypes_by_repeat.items():
        gt_expanded = []
        for gt in genotypes:
            if gt.is_large:
                gt_expanded.append(gt)
                if len(gt_expanded) > 1:
                    break
        if len(gt_expanded) == 1:
            update_genotype(gt_expanded[0], unplaced_counts.get(repeat, 0))
        for gt in genotypes:
            gt_lines.append(gt.tostring())

    if pid == 0:
        with open(output_prefix + "-genotype.txt", "w") as fh:
            fh.write(GT_HEADER + "\n")
            for line in gt_lines:
                fh.write(line + "\n")
        with open(output_prefix + "-bounds.txt", "w") as fh:
            fh.write(BOUNDS_HEADER + "\tdepth\n")
            for line in bounds_lines:
                fh.write(line + "\n")
        with open(output_prefix + "-unplaced.txt", "w") as fh:
            for repeat, count in unplaced_counts.items():
                fh.write(f"{repeat}\t{count}\n")
        if verbose:
            print(f"wrote genotypes to {output_prefix}-genotype.txt",
                  file=sys.stderr)
    return gt_lines
