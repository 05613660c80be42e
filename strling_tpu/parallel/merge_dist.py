"""Distributed joint locus discovery (multi-host / multi-chip `merge`).

The reference scales merge only by per-chromosome process fan-out over files
(merge.nim:52,89; pipelines/strling-joint-bychrom.groovy:12-19). The
device-mesh equivalent (SURVEY.md §2 parallelism table):

- samples are read in parallel, one subset per process (per-sample data
  parallelism);
- fragment-length histograms are combined with a `psum` over the device mesh
  (the reference's element-wise sum at merge.nim:112-115);
- treads are packed into fixed-width int32 rows and resharded by
  (tid, repeat-unit) hash with an `all_to_all` over the mesh, so each device
  owns a disjoint slice of locus space (the reference's `--chromosome`
  sharding, generalized);
- each process clusters the shards of its local devices (the greedy,
  order-dependent trcluster logic stays host-side, as in the reference);
- candidate bounds are all-gathered and written once, deterministically
  sorted.

Runs identically single-process over N local devices or multi-process under
`jax.distributed` (one process per host; collectives ride NCCL on GPUs,
Gloo on CPU test meshes). Output is byte-identical to single-process
`run_merge` including line order: both paths write the canonical order
(bed loci in bed order, then cluster bounds sorted by (tid, left, repeat)).
"""

from __future__ import annotations

import sys

import jax
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, PartitionSpec as P

from strling_tpu.core.callclusters import TreadGroups, assign_reads_locus, bounds_checked
from strling_tpu.core.cluster import BOUNDS_HEADER, Bounds, cluster, parse_bed
from strling_tpu.core.merge import get_tid_from_fasta, has_per_sample_reads
from strling_tpu.core.tread import TREAD_DTYPE, TreadBatch
from strling_tpu.io.binfmt import read_bin, same_targets
from strling_tpu.utils import fraglen
from strling_tpu.utils.options import Options

PACK_W = 6  # int32 columns per packed tread


def pack_treads(data: np.ndarray) -> np.ndarray:
    """TREAD_DTYPE records -> [N, 6] int32 wire rows (field-exact)."""
    n = len(data)
    out = np.zeros((n, PACK_W), np.int32)
    out[:, 0] = data["tid"]
    out[:, 1] = np.ascontiguousarray(data["position"]).view(np.int32)
    rep = np.ascontiguousarray(data["repeat"]).view(np.uint8).reshape(n, 6).astype(np.uint32)
    out[:, 2] = (rep[:, 0] | (rep[:, 1] << 8) | (rep[:, 2] << 16)
                 | (rep[:, 3] << 24)).view(np.int32).astype(np.int32)
    out[:, 3] = (rep[:, 4] | (rep[:, 5] << 8)).astype(np.int32)
    out[:, 4] = np.ascontiguousarray(
        data["flag"].astype(np.uint32)
        | (data["split"].astype(np.uint32) << 16)
        | (data["mapping_quality"].astype(np.uint32) << 24)).view(np.int32)
    out[:, 5] = np.ascontiguousarray(
        data["repeat_count"].astype(np.uint32)
        | (data["align_length"].astype(np.uint32) << 8)
        | (data["sample"].astype(np.uint32) << 16)).view(np.int32)
    return out


def unpack_treads(rows: np.ndarray) -> np.ndarray:
    n = len(rows)
    data = np.zeros(n, TREAD_DTYPE)
    data["tid"] = rows[:, 0]
    data["position"] = rows[:, 1].view(np.uint32)
    rep = np.zeros((n, 6), np.uint8)
    c2 = rows[:, 2].view(np.uint32)
    c3 = rows[:, 3].view(np.uint32)
    rep[:, 0] = c2 & 0xFF
    rep[:, 1] = (c2 >> 8) & 0xFF
    rep[:, 2] = (c2 >> 16) & 0xFF
    rep[:, 3] = (c2 >> 24) & 0xFF
    rep[:, 4] = c3 & 0xFF
    rep[:, 5] = (c3 >> 8) & 0xFF
    data["repeat"] = rep.view("S6").reshape(n)
    c4 = rows[:, 4].view(np.uint32)
    data["flag"] = (c4 & 0xFFFF).astype(np.uint16)
    data["split"] = ((c4 >> 16) & 0xFF).astype(np.uint8)
    data["mapping_quality"] = ((c4 >> 24) & 0xFF).astype(np.uint8)
    c5 = rows[:, 5].view(np.uint32)
    data["repeat_count"] = (c5 & 0xFF).astype(np.uint8)
    data["align_length"] = ((c5 >> 8) & 0xFF).astype(np.uint8)
    data["sample"] = (c5 >> 16).astype(np.int32)
    return data


def shard_of(tid: np.ndarray, repeat: np.ndarray, n_shards: int) -> np.ndarray:
    """Deterministic (tid, repeat-unit) -> shard id (locus-space hash)."""
    rep = np.ascontiguousarray(repeat).view(np.uint8).reshape(len(repeat), 6).astype(np.uint64)
    h = tid.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    for i in range(6):
        h = (h ^ (rep[:, i] + np.uint64(1))) * np.uint64(0x100000001B3)
    return (h % np.uint64(n_shards)).astype(np.int64)


def _shard_key(tid: int, repeat: str, n_shards: int) -> int:
    rep = np.zeros(1, "S6")
    rep[0] = repeat.encode()
    return int(shard_of(np.array([tid], np.int32), rep, n_shards)[0])


def _to_global(local: np.ndarray, mesh: Mesh) -> jax.Array:
    """Host-local [local_devices, ...] -> global array sharded on axis 0."""
    return multihost_utils.host_local_array_to_global_array(local, mesh, P("d"))


def _alltoall_fn(mesh: Mesh):
    def step(buf):
        recv = jax.lax.all_to_all(buf[0], "d", split_axis=0, concat_axis=0)
        return recv[None]

    return jax.jit(
        jax.shard_map(
            step, mesh=mesh,
            in_specs=P("d", None, None, None),
            out_specs=P("d", None, None, None),
            check_vma=False,
        )
    )


def _psum_fn(mesh: Mesh):
    def step(frag):
        return jax.lax.psum(frag[0], "d")

    return jax.jit(
        jax.shard_map(step, mesh=mesh, in_specs=P("d", None), out_specs=P(),
                      check_vma=False)
    )


#: per-round exchange buffer budget. The all_to_all pads every (src, dst)
#: bucket to the round capacity, so a skewed cohort (one dominant repeat
#: unit hashing to one shard) would otherwise allocate O(S^2 * cmax) — up
#: to S x the actual data (the reference's whole-cohort-in-RAM merge has
#: the same worst case against its 120GB budget, bpipe.config:16-18).
#: Chunked rounds bound memory at O(S^2 * C_ROUND) regardless of skew.
EXCHANGE_BUDGET_BYTES = 64 << 20


def run_merge_dist(bins: list[str], fasta: str | None = None, window: int = -1,
                   min_support: int = 5, chromosome: str | None = None,
                   min_clip: int = 0, min_clip_total: int = 0,
                   min_mapq: int = 40, bed: str | None = None,
                   output_prefix: str = "strling", verbose: bool = False):
    """Distributed merge_main. Every process calls this with the full bin
    list; sample reading, clustering and output are partitioned internally.
    Returns the bounds lines (identical, sorted, on every process)."""
    pid = jax.process_index()
    nproc = jax.process_count()
    devs = jax.devices()
    S = len(devs)
    n_local = len(jax.local_devices())
    mesh = Mesh(np.array(devs), ("d",))

    requested_tid = None
    if chromosome is not None:
        requested_tid = get_tid_from_fasta(fasta, chromosome)

    # --- per-process sample reads (per-sample data parallelism) -------------
    frag_local = np.zeros(4096, np.uint64)
    rows = []
    targets = None
    for sample_i, binfile in enumerate(bins):
        if sample_i % nproc != pid:
            continue
        ex = read_bin(binfile, drop_unplaced=True, verbose=verbose,
                      requested_tid=requested_tid, skip_qnames=True)
        if targets is None:
            targets = ex.targets
        elif not same_targets(ex.targets, targets):
            raise SystemExit(
                f"[strling] Error: inconsistent bam header for {binfile}. "
                "Were all samples run on the same reference genome?")
        frag_local += ex.fragment_distribution.astype(np.uint64)
        data = ex.reads.data.copy()
        data["sample"] = sample_i
        rows.append(data)
        if verbose:
            print(f"[strling p{pid}] read {len(data)} STR reads from {binfile}",
                  file=sys.stderr)
    if targets is None:  # more processes than samples: still need the header
        targets = read_bin(bins[0], drop_unplaced=True).targets
    data = np.concatenate(rows) if rows else np.zeros(0, TREAD_DTYPE)

    # --- pack + route: shard = hash(tid, repeat-unit) % S -------------------
    packed = pack_treads(data)
    dest = shard_of(data["tid"], data["repeat"], S)
    # split local treads over local source devices (round-robin for balance)
    src_local = np.arange(len(data)) % n_local
    counts_local = np.zeros((n_local, S), np.int64)
    for sl in range(n_local):
        m = src_local == sl
        counts_local[sl] = np.bincount(dest[m], minlength=S)
    for i, ld in enumerate(jax.local_devices()):
        assert devs[pid * n_local + i] == ld, "unexpected global device order"
    counts_global = multihost_utils.process_allgather(counts_local)
    counts_global = counts_global.reshape(S, S)  # [src_dev, dst_dev]
    cmax = max(1, int(counts_global.max()))

    # per-source-device buckets, sorted by destination (order preserved
    # within a destination, so chunked rounds concatenate back losslessly)
    bucket_rows: list[list[np.ndarray]] = []
    for sl in range(n_local):
        m = src_local == sl
        psl, dsl = packed[m], dest[m]
        order = np.argsort(dsl, kind="stable")
        psl, dsl = psl[order], dsl[order]
        starts = np.searchsorted(dsl, np.arange(S))
        ends = np.searchsorted(dsl, np.arange(S) + 1)
        bucket_rows.append([psl[starts[s]:ends[s]] for s in range(S)])

    frag_dev = np.zeros((n_local, 4096), np.int64)
    frag_dev[0] = frag_local.astype(np.int64)
    frag_g = _psum_fn(mesh)(_to_global(frag_dev, mesh))
    frag32 = np.asarray(jax.device_get(frag_g)).astype(np.uint32)

    # chunked all_to_all: the round capacity bounds the padded buffer at
    # EXCHANGE_BUDGET_BYTES however skewed the (src, dst) counts are;
    # each round moves rows [r*C, (r+1)*C) of every bucket
    C = max(1, min(cmax,
                   EXCHANGE_BUDGET_BYTES // max(1, n_local * S * PACK_W * 4)))
    n_rounds = (cmax + C - 1) // C
    exchange = _alltoall_fn(mesh)
    recv_parts: dict[int, list[list[np.ndarray]]] = {}
    for rnd in range(n_rounds):
        lo = rnd * C
        buf_local = np.zeros((n_local, S, C, PACK_W), np.int32)
        for sl in range(n_local):
            for s in range(S):
                part = bucket_rows[sl][s][lo: lo + C]
                if len(part):
                    buf_local[sl, s, : len(part)] = part
        recv_g = exchange(_to_global(buf_local, mesh))
        for shard in recv_g.addressable_shards:
            dev_idx = shard.index[0].start or 0
            arr = np.asarray(shard.data)[0]  # [S, C, W]
            dst_parts = recv_parts.setdefault(
                dev_idx, [[] for _ in range(S)])
            for s in range(S):
                have = int(counts_global[s, dev_idx])
                k = min(max(0, have - lo), C)
                if k:
                    dst_parts[s].append(arr[s, :k])

    # --- per-shard host clustering (each process handles its local devices) -
    opts = Options(median_fragment_length=fraglen.median(frag32, 0.98),
                   min_support=min_support, min_mapq=min_mapq, targets=targets)
    if window < 0:
        window = fraglen.median(frag32, 0.98)
    max_clip_dist = int(0.5 * float(fraglen.median(frag32, 0.5)))

    loci: list[Bounds] = []
    if bed:
        loci = parse_bed(bed, targets, window, tid=requested_tid)

    local_bounds: list[tuple] = []  # (sort_key, line)
    for dev_idx in sorted(recv_parts):
        dst_parts = recv_parts[dev_idx]
        parts = [np.concatenate(p) for p in dst_parts if p]
        got = np.concatenate(parts) if parts else np.zeros((0, PACK_W), np.int32)
        sdata = unpack_treads(got)
        tb = TreadBatch(data=sdata, qnames=sdata["sample"].copy())
        groups = TreadGroups.from_batch(tb)

        for li, locus in enumerate(loci):
            if _shard_key(locus.tid, locus.repeat, S) != dev_idx:
                continue
            assign_reads_locus(locus, groups)
            local_bounds.append((0, li, "", locus.tostring(targets)))
        for (tid, repeat), (treads, names) in groups.items():
            for c in cluster(treads, max_dist=window,
                             min_supporting_reads=opts.min_support,
                             qnames=names):
                if c.reads["tid"][0] == -1:
                    continue
                if not has_per_sample_reads(c, opts.min_support):
                    continue
                b, good = bounds_checked(c, min_clip, min_clip_total,
                                         max_clip_dist)
                if not good:
                    continue
                key = f"{b.tid:06d}\x01{b.left:012d}\x01{b.repeat}"
                local_bounds.append((1, 0, key, b.tostring(targets)))

    # --- gather bounds lines (tag-prefixed) to every process, write once ----
    blob = "\x00".join(
        f"{grp}\x01{li:06d}\x01{key}\x02{line}"
        for grp, li, key, line in local_bounds
    ).encode()
    n_max = int(multihost_utils.process_allgather(
        np.array([len(blob)])).max())
    padded = np.zeros(n_max + 1, np.uint8)
    padded[:len(blob)] = np.frombuffer(blob, np.uint8)
    lens = np.asarray(multihost_utils.process_allgather(
        np.array([len(blob)]))).reshape(nproc)
    blobs = np.asarray(multihost_utils.process_allgather(padded)).reshape(nproc, -1)
    tagged: list[tuple[str, str]] = []
    for p in range(nproc):
        s = bytes(blobs[p, :lens[p]]).decode()
        if s:
            for item in s.split("\x00"):
                tag, line = item.split("\x02", 1)
                tagged.append((tag, line))
    # deterministic output: bed loci first (bed order), then sorted clusters
    out_lines = [line for _, line in sorted(tagged)]

    if pid == 0:
        with open(output_prefix + "-bounds.txt", "w") as fh:
            fh.write(BOUNDS_HEADER + "\n")
            for line in out_lines:
                fh.write(line + "\n")
        if verbose:
            print(f"[strling] Wrote merged str bounds to "
                  f"{output_prefix}-bounds.txt", file=sys.stderr)
    return out_lines
