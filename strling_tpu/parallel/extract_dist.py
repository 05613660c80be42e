"""Multi-host distributed `extract`: shard one sample's read stream.

The reference parallelizes extract only per-SAMPLE (one bpipe task per BAM,
pipelines/strling-joint.groovy:8-13). This module adds intra-sample
parallelism for jax.distributed runs: each process owns a subset of
chromosomes (tid % nproc == pid, mirroring merge's --chromosome sharding,
merge.nim:89,125; the no-coor block goes to process 0), runs the full native
engine + device scan over its shard, and resolves the only coupling between
shards — read pairs whose mates map to different chromosomes — with one
allgather of "spilled" treads followed by a deterministic cross-shard
pairing pass that replays the reference's mate logic
(extract.nim:192-248) on each process identically.

Output equivalence vs single-process extract: BYTE-IDENTICAL bins. Every
tread carries the (segment, record tid, record rank, push slot) key of the
record whose processing emitted it (extract_engine.cc Tread key fields);
sequential extract appends treads exactly in that key order, so a stable
sort of the gathered shard treads (cross-shard pairs keyed by their later
mate) reproduces the single-process bin, including order.
"""

from __future__ import annotations

import sys

import numpy as np

from strling_tpu.core.extract import adjust_by, unplaced_pair
from strling_tpu.core.tread import TREAD_DTYPE, Tread, TreadBatch
from strling_tpu.io.bam import Bam
from strling_tpu.io.extract_native import NativeExtractor, native_frag_hist
from strling_tpu.ops.encode import canonical_repeat
from strling_tpu.utils import fraglen
from strling_tpu.utils.options import Options

ROW_BYTES = TREAD_DTYPE.itemsize


KEY_DTYPE = np.dtype([("seg", np.uint8), ("ktid", np.int32),
                      ("krank", np.int64), ("ksub", np.uint8)])


def _keys_struct(keys) -> np.ndarray:
    seg, ktid, krank, ksub = keys
    out = np.zeros(len(seg), KEY_DTYPE)
    out["seg"] = seg
    out["ktid"] = ktid
    out["krank"] = krank
    out["ksub"] = ksub
    return out


def _pack_batch(tb: TreadBatch, keys: np.ndarray) -> bytes:
    """(TreadBatch, keys) -> bytes blob (fixed rows + keys + qnames)."""
    rows = np.ascontiguousarray(tb.data).tobytes()
    kb = np.ascontiguousarray(keys).tobytes()
    qn = "\x00".join(tb.qnames).encode()
    head = np.array([len(tb.data), len(qn)], np.int64).tobytes()
    return head + rows + kb + qn


def _unpack_batch(blob: bytes) -> tuple[TreadBatch, np.ndarray]:
    n, qlen = np.frombuffer(blob[:16], np.int64)
    n, qlen = int(n), int(qlen)
    rows = np.frombuffer(
        blob[16:16 + n * ROW_BYTES], TREAD_DTYPE
    ).copy()
    koff = 16 + n * ROW_BYTES
    keys = np.frombuffer(blob[koff:koff + n * KEY_DTYPE.itemsize],
                         KEY_DTYPE).copy()
    qblob = blob[koff + n * KEY_DTYPE.itemsize:
                 koff + n * KEY_DTYPE.itemsize + qlen]
    qnames = qblob.decode().split("\x00") if n else []
    return TreadBatch(data=rows, qnames=qnames), keys


def _allgather_blobs(blob: bytes) -> list[bytes]:
    """Gather one bytes blob from every process (padded u8 allgather)."""
    import jax
    from jax.experimental import multihost_utils

    nproc = jax.process_count()
    if nproc == 1:
        return [blob]
    n_max = int(
        multihost_utils.process_allgather(np.array([len(blob)])).max()
    )
    padded = np.zeros(max(1, n_max), np.uint8)
    padded[:len(blob)] = np.frombuffer(blob, np.uint8)
    lens = np.asarray(
        multihost_utils.process_allgather(np.array([len(blob)]))
    ).reshape(nproc)
    blobs = np.asarray(
        multihost_utils.process_allgather(padded)
    ).reshape(nproc, -1)
    return [bytes(blobs[p, :lens[p]]) for p in range(nproc)]


def pair_spills(spills: list[tuple[TreadBatch, np.ndarray]],
                opts: Options) -> tuple[list[Tread], np.ndarray]:
    """Deterministic cross-shard mate pairing (the reference's pairing
    sequence, extract.nim:199-231, applied to the spilled treads; qnames
    processed in sorted order on every process identically). Returns the
    emitted treads plus their emission keys: the later mate's record key
    with push slots 2/3, exactly as the sequential feed assigns them."""
    groups: dict[str, list[tuple[Tread, np.void]]] = {}
    for tb, keys in spills:
        for i, t in enumerate(tb.to_treads()):
            groups.setdefault(t.qname, []).append((t, keys[i]))
    out: list[Tread] = []
    out_keys: list[tuple] = []
    for qname in sorted(groups):
        g = groups[qname]
        if len(g) != 2:
            if len(g) > 2:
                print(
                    "[strling] warning. bad read (this happens with bwa-kit "
                    f"alignments):{qname} already in table",
                    file=sys.stderr,
                )
            continue
        (a, ka), (b, kb) = g
        # the "after mate" side is the one later in stream order (its
        # emission-key is larger); cross-shard pairs always differ in tid
        later_a = (int(ka["seg"]), int(ka["ktid"]), int(ka["krank"])) > (
            int(kb["seg"]), int(kb["ktid"]), int(kb["krank"]))
        (tr, kt), (mate, km) = ((a, ka), (b, kb)) if later_a else ((b, kb), (a, ka))
        ek = (int(kt["seg"]), int(kt["ktid"]), int(kt["krank"]))
        if mate.repeat_count == 0 and tr.repeat_count == 0:
            continue
        if unplaced_pair(tr, mate, opts):
            if tr.repeat == "" or mate.repeat == "":
                continue
            tr.repeat = canonical_repeat(tr.repeat)
            tr.position = 0
            tr.tid = -1
            mate.repeat = canonical_repeat(mate.repeat)
            mate.position = 0
            mate.tid = -1
            out.append(tr)
            out_keys.append(ek + (2,))
            out.append(mate)
            out_keys.append(ek + (3,))
            continue
        mp = mate.position
        if adjust_by(mate, tr, opts, tr.position):
            out.append(mate)
            out_keys.append(ek + (2,))
        if adjust_by(tr, mate, opts, mp):
            out.append(tr)
            out_keys.append(ek + (3,))
    karr = np.zeros(len(out_keys), KEY_DTYPE)
    for i, (s, t, r, u) in enumerate(out_keys):
        karr[i] = (s, t, r, u)
    return out, karr


def run_extract_dist(bam_path: str, fasta: str | None = None,
                     genome_repeats_path: str | None = None,
                     proportion_repeat: float = 0.8, min_mapq: int = 40,
                     output_bin: str | None = None, verbose: bool = False):
    """Distributed extract_main. Every process calls this with the same
    arguments; the read stream is sharded by chromosome internally. Returns
    (TreadBatch, frag_dist, opts) of the COMBINED result on every process;
    process 0 writes the bin if output_bin is given."""
    import jax

    pid = jax.process_index()
    nproc = jax.process_count()

    bam = Bam(bam_path, fasta=fasta)
    frag_dist, max_read_len = native_frag_hist(bam, return_max_len=True)
    frag_median = fraglen.median(frag_dist)
    opts = Options(
        median_fragment_length=frag_median,
        proportion_repeat=proportion_repeat,
        min_mapq=min_mapq,
    )
    genome_index = None
    if fasta:
        from strling_tpu.core.genome_index import genome_repeats as build_gi

        genome_index = build_gi(fasta, opts, genome_repeats_path or "")

    my_tids = [t.tid for t in bam.targets if t.tid % nproc == pid]
    Lcap = max(32, ((max_read_len + 7) // 8) * 8) if max_read_len else None
    ne = NativeExtractor(
        bam, proportion_repeat, min_mapq, frag_median,
        genome_index=genome_index, Lmax=Lcap,
    )
    ne.set_shard(my_tids, include_unplaced=(pid == 0))
    if verbose:
        print(f"[strling p{pid}] extracting tids {my_tids}", file=sys.stderr)
    tb_local = ne.run()
    keys_local = _keys_struct(ne.emission_keys(0))
    sp_local = ne.spill()
    sp_keys = _keys_struct(ne.emission_keys(1))

    spill_blobs = _allgather_blobs(_pack_batch(sp_local, sp_keys))
    spills = [_unpack_batch(b) for b in spill_blobs]
    extra, extra_keys = pair_spills(spills, opts)

    local_blobs = _allgather_blobs(_pack_batch(tb_local, keys_local))
    parts = [_unpack_batch(b) for b in local_blobs]
    all_data = np.concatenate(
        [p.data for p, _ in parts]
        + [TreadBatch.from_treads(extra).data]
    )
    all_keys = np.concatenate([k for _, k in parts] + [extra_keys])
    all_qnames: list[str] = []
    for p, _ in parts:
        all_qnames.extend(p.qnames)
    all_qnames.extend(t.qname for t in extra)
    # stable sort by emission key == the sequential append order, so the
    # sharded bin is byte-identical to single-process extract's
    order = np.lexsort((all_keys["ksub"], all_keys["krank"],
                        all_keys["ktid"], all_keys["seg"]))
    tb = TreadBatch(data=all_data[order],
                    qnames=[all_qnames[i] for i in order])

    if output_bin and pid == 0:
        from strling_tpu.io.binfmt import write_bin

        write_bin(output_bin, tb, frag_dist, bam.header_text,
                  proportion_repeat, min_mapq)
        if verbose:
            print(f"[strling] wrote {output_bin} ({len(tb)} treads)",
                  file=sys.stderr)
    return tb, frag_dist, opts
