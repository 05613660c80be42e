"""Native C++ extract engine vs the Python reference extractor."""

import numpy as np
import pytest

from strling_tpu.core.extract import extract, extract_native
from strling_tpu.core.genome_index import GenomeIndex
from strling_tpu.io.bam import Bam
from strling_tpu.io.extract_native import native_frag_hist
from strling_tpu.utils import fraglen

from test_extract import _str_bam


@pytest.fixture(scope="module")
def str_bam(tmp_path_factory):
    p = tmp_path_factory.mktemp("exn") / "str.bam"
    _str_bam(str(p))
    return str(p)


def test_native_frag_hist_matches(str_bam):
    h1 = native_frag_hist(Bam(str_bam))
    h2 = fraglen.fragment_length_distribution(Bam(str_bam))
    np.testing.assert_array_equal(h1, h2)


def _cmp(tb1, tb2):
    assert len(tb1) == len(tb2), (len(tb1), len(tb2))
    t1 = tb1.to_treads()
    t2 = tb2.to_treads()
    for a, b in zip(t1, t2):
        assert a == b, (a, b)


def test_native_matches_python(str_bam):
    tb_py, fd_py, _ = extract(Bam(str_bam), None, None)
    tb_nat, fd_nat, _ = extract_native(Bam(str_bam), None, None)
    np.testing.assert_array_equal(fd_py, fd_nat)
    _cmp(tb_nat, tb_py)


def test_native_matches_python_with_index(str_bam):
    gi = GenomeIndex({"chr1": [(49000, 52000)]})
    tb_py, _, _ = extract(Bam(str_bam), None, None, genome_index=gi)
    tb_nat, _, _ = extract_native(Bam(str_bam), None, None, genome_index=gi)
    _cmp(tb_nat, tb_py)


def test_native_small_batches(str_bam):
    """Batch boundaries must not change pairing results."""
    from strling_tpu.io.extract_native import NativeExtractor

    bam = Bam(str_bam)
    fd = native_frag_hist(bam)
    med = fraglen.median(fd)
    ne = NativeExtractor(bam, 0.8, 40, med, batch_records=64)
    tb_small = ne.run(buckets=(256,))
    tb_py, _, _ = extract(Bam(str_bam), None, None)
    _cmp(tb_small, tb_py)


def test_fused_payload_matches_python_fuse(str_bam):
    """sio_ex_next_fused must emit rows byte-identical to ops.kmer's
    fuse_payload over the same ASCII rows (2-bit codes, N bitmask, and the
    double-precision te/tp thresholds)."""
    from strling_tpu.io.extract_native import NativeExtractor
    from strling_tpu.ops.kmer import fuse_payload

    med = fraglen.median(native_frag_hist(Bam(str_bam)))
    # ascii rows via the legacy path
    ne1 = NativeExtractor(Bam(str_bam), 0.8, 40, med)
    rows1, n1, bases, lengths, props = ne1._next()
    # fused rows via the new path
    ne2 = NativeExtractor(Bam(str_bam), 0.8, 40, med)
    rows2, n2, payload, layout, ascii_rows = ne2._next_fused()
    assert (rows1, n1) == (rows2, n2) and rows1 > 0
    assert ascii_rows is None, "ACGT-only data must not fall back"
    want, want_layout = fuse_payload(bases[:rows1], lengths[:rows1],
                                     props[:rows1], return_layout=True)
    assert layout == want_layout
    np.testing.assert_array_equal(payload[:rows1], want)
    assert not payload[rows1:].any()  # pre-padded tail stays zero


def test_fused_payload_iupac_fallback(tmp_path):
    """A batch containing a non-ACGTN base must fall back to ASCII rows (the
    2-bit code of e.g. 'R' is not recoverable; parity requires the raw
    bytes)."""
    from test_extract import HEADER, TARGETS
    from strling_tpu.io.bamwrite import BamRecord, write_bam
    from strling_tpu.io.extract_native import NativeExtractor

    rng = np.random.default_rng(3)
    alphabet = np.array(list("ACGT"))
    recs = []
    for i in range(50):
        pos = 1000 + i * 37
        s = "".join(alphabet[rng.integers(0, 4, 100)])
        if i == 25:
            s = s[:50] + "R" + s[51:]
        isz = 300
        recs.append(BamRecord(f"p{i}", 99, 0, pos, 60, "100M", 0, pos + 200,
                              isz, s))
        recs.append(BamRecord(f"p{i}", 147, 0, pos + 200, 60, "100M", 0, pos,
                              -isz, "".join(alphabet[rng.integers(0, 4, 100)])))
    recs.sort(key=lambda r: r.pos)
    p = tmp_path / "iupac.bam"
    write_bam(str(p), HEADER, TARGETS, recs)
    # prefilter off: random reads (incl. the R one) are provably zero and
    # would never reach the wire — this test exercises the fallback layout
    ne = NativeExtractor(Bam(str(p)), 0.8, 40, 350, prefilter=False)
    rows, n, payload, layout, ascii_rows = ne._next_fused()
    assert rows > 0 and payload is None and ascii_rows is not None
    bases, lengths, props = ascii_rows
    assert any(b"R" in bytes(bases[r, : lengths[r]]) for r in range(rows))
    # and the full engine still produces results equal to the Python path
    tb_nat, _, _ = extract_native(Bam(str(p)), None, None)
    tb_py, _, _ = extract(Bam(str(p)), None, None)
    _cmp(tb_nat, tb_py)


def test_fused_payload_n_plane_layouts(tmp_path):
    """Batches with any N must use the w8 layout (N bitmask plane); N-free
    batches drop the plane (n8). Both must match Python fuse_payload
    byte-for-byte and produce identical treads."""
    from test_extract import HEADER, TARGETS
    from strling_tpu.io.bamwrite import BamRecord, write_bam
    from strling_tpu.io.extract_native import NativeExtractor
    from strling_tpu.ops.kmer import fuse_payload

    rng = np.random.default_rng(4)
    alphabet = np.array(list("ACGT"))
    for with_n, want_layout in ((False, "n8"), (True, "w8")):
        recs = []
        for i in range(40):
            pos = 1000 + i * 53
            s = "".join(alphabet[rng.integers(0, 4, 104)])
            if with_n and i == 11:
                s = s[:30] + "NNN" + s[33:]
            recs.append(BamRecord(f"p{i}", 99, 0, pos, 60, "104M", 0,
                                  pos + 200, 304, s))
            recs.append(BamRecord(f"p{i}", 147, 0, pos + 200, 60, "104M", 0,
                                  pos, -304, "".join(
                                      alphabet[rng.integers(0, 4, 104)])))
        recs.sort(key=lambda r: r.pos)
        p = tmp_path / f"n{int(with_n)}.bam"
        write_bam(str(p), HEADER, TARGETS, recs)
        # prefilter off: this test pins the wire layouts, which need the
        # random/N rows that the prefilter would (correctly) drop
        ne = NativeExtractor(Bam(str(p)), 0.8, 40, 350, Lmax=104,
                             prefilter=False)
        rows, n, payload, layout, ascii_rows = ne._next_fused()
        assert rows > 0 and ascii_rows is None
        assert layout == want_layout
        ne2 = NativeExtractor(Bam(str(p)), 0.8, 40, 350, Lmax=104,
                              prefilter=False)
        rows2, n2, bases, lengths, props = ne2._next()
        want, wl = fuse_payload(bases[:rows], lengths[:rows], props[:rows],
                                return_layout=True)
        assert wl == want_layout
        np.testing.assert_array_equal(payload[:rows], want)
        # end-to-end equality through the scan
        tb_nat, _, _ = extract_native(Bam(str(p)), None, None)
        tb_py, _, _ = extract(Bam(str(p)), None, None)
        _cmp(tb_nat, tb_py)


def _max_dimer(s: str) -> int:
    cnt = {}
    for j in range(len(s) - 1):
        d = s[j:j + 2]
        cnt[d] = cnt.get(d, 0) + 1
    return max(cnt.values(), default=0)


def test_prefilter_bound_sound_vs_oracle():
    """The engine's dimer-count bound (extract_engine.cc provably_zero) must
    never filter a read the oracle detector reports a repeat for: for every
    k in 2..6, exact_k <= max dimer count, and tp[k] >= tp[6], so
    max_dimer <= trunc(L*prop/6) implies count == 0 (utils.nim:251,259)."""
    from strling_tpu.ops.oracle import get_repeat as oracle_get_repeat

    rng = np.random.default_rng(123)
    alphabet = np.array(list("ACGT"))
    units = ["CAG", "AT", "AAGGG", "ATTCT", "A", "AAC", "CCG", "TTTA"]
    for prop in (0.8, 0.6, 0.73, 0.5):
        for i in range(300):
            L = int(rng.integers(10, 152))
            s = "".join(alphabet[rng.integers(0, 4, L)])
            mode = i % 4
            if mode == 1:  # borderline: half repeat, half random
                u = units[i % len(units)]
                rep = (u * (L // len(u) + 1))[:L // 2]
                s = rep + s[len(rep):]
            elif mode == 2:  # full repeat with noise
                u = units[i % len(units)]
                arr = list((u * (L // len(u) + 1))[:L])
                for _ in range(int(rng.integers(0, max(1, L // 6)))):
                    arr[int(rng.integers(0, L))] = alphabet[
                        int(rng.integers(0, 4))]
                s = "".join(arr)
            elif mode == 3 and L > 4:  # N-spiked
                arr = list(s)
                for _ in range(int(rng.integers(0, 5))):
                    arr[int(rng.integers(0, L))] = "N"
                s = "".join(arr)
            if _max_dimer(s) <= int(L * prop / 6.0):
                unit, cnt = oracle_get_repeat(s, prop)
                assert cnt == 0, (s, prop, unit, cnt)


def test_prefilter_equivalence(tmp_path):
    """NativeExtractor output must be byte-identical with the prefilter on
    and off, on input mixing random, repeat, borderline, N-rich and
    soft-clipped reads."""
    from test_extract import HEADER, TARGETS
    from strling_tpu.io.bamwrite import BamRecord, write_bam
    from strling_tpu.io.extract_native import NativeExtractor

    rng = np.random.default_rng(17)
    alphabet = np.array(list("ACGT"))
    units = ["CAG", "AT", "AAGGG", "A"]
    recs = []
    for i in range(120):
        pos = 1000 + i * 61
        L = 120
        s1 = "".join(alphabet[rng.integers(0, 4, L)])
        s2 = "".join(alphabet[rng.integers(0, 4, L)])
        u = units[i % len(units)]
        if i % 5 == 0:  # full STR read
            s2 = (u * (L // len(u) + 1))[:L]
        elif i % 5 == 1:  # borderline half-repeat
            rep = (u * (L // len(u) + 1))[:L // 2]
            s2 = rep + s2[L // 2:]
        elif i % 5 == 2:  # N-rich
            arr = list(s2)
            for j in range(0, 30, 3):
                arr[j] = "N"
            s2 = "".join(arr)
        cig1, cig2 = f"{L}M", f"{L}M"
        if i % 7 == 0:  # repeat-y left clip on the anchored mate
            clip = ("CAG" * 12)[:30]
            s1 = clip + s1[30:]
            cig1 = f"30S{L-30}M"
        elif i % 7 == 1:  # random clip (should be filtered, count 0)
            cig1 = f"25S{L-25}M"
        isz = 300
        recs.append(BamRecord(f"q{i}", 0x63, 0, pos, 60, cig1, 0,
                              pos + isz - L, isz, s1))
        recs.append(BamRecord(f"q{i}", 0x93, 0, pos + isz - L,
                              int(rng.integers(0, 61)), cig2, 0, pos, -isz,
                              s2))
    recs.sort(key=lambda r: r.pos)
    p = tmp_path / "mix.bam"
    write_bam(str(p), HEADER, TARGETS, recs)
    outs = []
    for pf in (True, False):
        ne = NativeExtractor(Bam(str(p)), 0.8, 40, 350, prefilter=pf)
        outs.append(ne.run())
    _cmp(outs[0], outs[1])
    # the filter must actually fire: with it on, fewer device rows
    ne_on = NativeExtractor(Bam(str(p)), 0.8, 40, 350, prefilter=True)
    rows_on = ne_on._next_fused()[0]
    ne_off = NativeExtractor(Bam(str(p)), 0.8, 40, 350, prefilter=False)
    rows_off = ne_off._next_fused()[0]
    assert rows_on < rows_off // 2, (rows_on, rows_off)


def test_hist_tee_custom_budget_matches_standalone(str_bam):
    """The engine tee with non-default skip/count budgets must reproduce
    the standalone pass with the same budgets exactly (early stop, skip
    window, fallback behavior all live in both implementations)."""
    import ctypes as C

    from strling_tpu.io.extract_native import NativeExtractor, _lib

    lib = _lib()
    for skip, n in [(0, 50), (10, 100), (5, 10**6), (10**6, 10**6)]:
        hist1 = np.zeros(4096, np.uint32)
        ml1 = C.c_int32(0)
        bam0 = Bam(str_bam)  # must outlive the call (temporaries GC early)
        lib.sio_frag_hist(bam0._h, skip, n, hist1, C.byref(ml1))

        bam = Bam(str_bam)
        ne = NativeExtractor(bam, 0.8, 40, 400)
        assert lib.sio_ex_set_hist_tee(ne._e, skip, n) == 0
        # drain the engine (no device in the loop)
        while True:
            rows, nrec, payload, layout, ascii_rows = ne._next_fused()
            if nrec > 0:
                z = np.zeros(rows, np.int32)
                lib.sio_ex_feed(ne._e, z, z, z, rows)
            elif lib.sio_ex_done(ne._e):
                break
        assert ne.hist_ready
        hist2, ml2 = ne.get_hist()
        np.testing.assert_array_equal(hist1, hist2, err_msg=f"{skip}/{n}")
        # standalone stops tracking max at its early-stop record; the tee's
        # max can only be >= over the same prefix — equal when no early stop
        if n >= 10**6:
            assert int(ml1.value) == ml2


def test_hist_tee_rejected_after_start_and_in_sharded_mode(str_bam):
    from strling_tpu.io.extract_native import NativeExtractor, _lib

    lib = _lib()
    ne = NativeExtractor(Bam(str_bam), 0.8, 40, 400)
    ne._next_fused()  # starts the producer
    assert lib.sio_ex_set_hist_tee(ne._e, 0, 100) != 0
    ne2 = NativeExtractor(Bam(str_bam), 0.8, 40, 400)
    ne2.set_shard(np.array([0], np.int32), True)
    assert lib.sio_ex_set_hist_tee(ne2._e, 0, 100) != 0


def test_extract_native_stats_attribution(str_bam):
    stats = {}
    extract_native(Bam(str_bam), None, None, stats=stats)
    assert stats["n_batches"] >= 1
    assert stats["h2d_bytes"] > 0 and stats["d2h_bytes"] > 0
    assert stats["scan_s"] > 0 and stats["wait_s"] >= 0


def test_dimer_bound_simd_matches_scalar():
    """The vectorized packed-nibble dimer bound (when compiled in) must
    equal the scalar reference exactly — random bytes, repeated patterns,
    odd/even lengths, chunk boundaries (len 127/128/129 bases)."""
    import ctypes as C

    from strling_tpu.io.bam import _load

    lib = _load()
    lib.sio_max_dimer_nib.restype = C.c_int
    lib.sio_max_dimer_nib.argtypes = [
        np.ctypeslib.ndpointer(np.uint8), C.c_int, C.c_int]
    rng = np.random.default_rng(42)
    lens = ([int(x) for x in rng.integers(1, 300, 400)]
            + [1, 2, 3, 126, 127, 128, 129, 130, 255, 256, 257])
    for ln in lens:
        nb = (ln + 1) // 2
        for seq4 in (rng.integers(0, 256, nb, dtype=np.uint8),
                     np.full(nb, int(rng.integers(0, 256)), np.uint8)):
            seq4 = np.ascontiguousarray(seq4)
            a = lib.sio_max_dimer_nib(seq4, ln, 0)
            b = lib.sio_max_dimer_nib(seq4, ln, 1)
            assert a == b, (ln, a, b)


@pytest.mark.gpu
def test_gpu_extract_bin_matches_cpu(gpu_device, str_bam, tmp_path):
    """`extract` with its scans on the card writes the same bin, byte for
    byte, as the same command in a CPU-only child process."""
    import os
    import subprocess
    import sys

    from strling_tpu.cli import main

    gpu_bin, cpu_bin = tmp_path / "gpu.bin", tmp_path / "cpu.bin"
    main(["extract", str_bam, str(gpu_bin)])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": repo}
    subprocess.run([sys.executable, "-m", "strling_tpu.cli", "extract",
                    str_bam, str(cpu_bin)], env=env, check=True, timeout=600)
    assert gpu_bin.read_bytes() == cpu_bin.read_bytes()
