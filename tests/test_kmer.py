"""Repeat-detector tests: oracle fixtures from reference tests plus
oracle-vs-device cross validation on random reads."""

import jax.numpy as jnp
import numpy as np
import pytest

from strling_tpu.ops import oracle
from strling_tpu.ops.kmer import get_repeat_batch, units_to_strings

# SAM fixture sequences from reference tests/test_strling.nim
MONOMER = "A" * 150  # test_strling.nim:46-66 (cigar 20S127M3S)
TRIPLET = "TGC" * 50 + "T"  # test_strling.nim:68-89 (cigar 60S91M, 151bp)


def test_oracle_monomer():
    unit, count = oracle.get_repeat(MONOMER, 0.6)
    assert unit == "A"
    assert count == 150


def test_oracle_triplet():
    unit, count = oracle.get_repeat(TRIPLET, 0.8)
    assert unit == "CTG"
    assert count == 49


def test_oracle_nonrepeat():
    rng = np.random.default_rng(0)
    read = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 150)])
    unit, count = oracle.get_repeat(read, 0.8)
    assert unit == ""
    assert count == 0


def test_oracle_n_heavy():
    unit, count = oracle.get_repeat("N" * 30 + "AT" * 60, 0.8)
    assert unit == ""
    assert count == 0


def test_oracle_short_read():
    assert oracle.get_repeat("A", 0.8) == ("", 0)
    assert oracle.get_repeat("", 0.8) == ("", 0)


def _batch(reads, props, L=160):
    B = len(reads)
    bases = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        b = r.encode()
        bases[i, : len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    return bases, lengths, np.asarray(props, np.float64)


def test_batch_matches_fixtures():
    reads = [MONOMER, TRIPLET, "ACGTAC" * 25, "N" * 30 + "AT" * 60]
    props = [0.6, 0.8, 0.8, 0.8]
    unit, ulen, count = get_repeat_batch(*_batch(reads, props))
    units = units_to_strings(unit, ulen)
    for i, (r, p) in enumerate(zip(reads, props)):
        exp_unit, exp_count = oracle.get_repeat(r, p)
        assert units[i] == exp_unit, (i, units[i], exp_unit)
        assert count[i] == exp_count, (i, count[i], exp_count)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_batch_matches_oracle_random(seed):
    rng = np.random.default_rng(seed)
    reads = []
    props = []
    alphabet = np.array(list("ACGTN"))
    units = ["AT", "CAG", "AAGGG", "GGGGCC", "A", "ATTCT", "TG"]
    for _ in range(64):
        mode = rng.integers(0, 4)
        L = int(rng.integers(1, 153))
        if mode == 0:  # random
            read = "".join(alphabet[rng.integers(0, 4, L)])
        elif mode == 1:  # pure repeat with random phase
            u = units[rng.integers(0, len(units))]
            ph = int(rng.integers(0, len(u)))
            read = ((u * (L // len(u) + 2))[ph : ph + L])
        elif mode == 2:  # repeat with noise
            u = units[rng.integers(0, len(units))]
            r = list((u * (L // len(u) + 2))[:L])
            for _ in range(max(1, L // 12)):
                r[rng.integers(0, L)] = alphabet[rng.integers(0, 5)]
            read = "".join(r)
        else:  # half repeat, half random
            u = units[rng.integers(0, len(units))]
            h = L // 2
            read = (u * (h // len(u) + 2))[:h] + "".join(
                alphabet[rng.integers(0, 4, L - h)]
            )
        reads.append(read)
        props.append(float(rng.choice([0.8, 0.73, 0.6, 0.4])))

    unit, ulen, count = get_repeat_batch(*_batch(reads, props))
    got = units_to_strings(unit, ulen)
    for i, (r, p) in enumerate(zip(reads, props)):
        exp_unit, exp_count = oracle.get_repeat(r, p)
        assert got[i] == exp_unit, (i, r, p, got[i], exp_unit)
        assert count[i] == exp_count, (i, r, p, int(count[i]), exp_count)


# ------------------------------------------------------ 2-bit packed transfer


def test_pack_unpack_roundtrip():
    from strling_tpu.ops.kmer import pack_bases, unpack_ascii

    rng = np.random.default_rng(11)
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (64, 96))
    bases[5, 40:] = 0  # padded tail
    pk = pack_bases(bases)
    assert pk is not None
    rec = np.asarray(unpack_ascii(jnp.asarray(pk[0]), jnp.asarray(pk[1])))
    # reconstruction is exact except padding zeros (decoded as 'A'; every
    # kernel consumer is gated by `lengths` past which bytes are unused)
    keep = bases != 0
    assert (rec[keep] == bases[keep]).all()
    assert (rec[~keep] == ord("A")).all()


def test_pack_rejects_iupac():
    from strling_tpu.ops.kmer import pack_bases

    bases = np.full((4, 32), ord("A"), np.uint8)
    bases[2, 7] = ord("R")
    assert pack_bases(bases) is None
    assert pack_bases(np.full((4, 30), ord("A"), np.uint8)) is None  # L%8


def test_scan_codes_packed_equals_ascii():
    from strling_tpu.ops.kmer import scan_codes

    rng = np.random.default_rng(3)
    reads = []
    for i in range(300):
        u = ["CAG", "A", "AT", "AAGGG", "ATTCT", "ACGT"][i % 6]
        n = rng.integers(30, 152)
        if i % 3 == 0:
            s = (u * 60)[:n]
        else:
            s = "".join(rng.choice(list("ACGTN" if i % 7 else "N"))
                        for _ in range(n))
        reads.append(s)
    L = 152
    bases = np.zeros((len(reads), L), np.uint8)
    lengths = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    props = np.full(len(reads), 0.8)
    got = scan_codes(bases, lengths, props, bucket=512, pack=True)
    want = scan_codes(bases, lengths, props, bucket=512, pack=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fused_n8_layout_equals_w8():
    """The N-free wire layout (no N-plane) must scan identically to the
    with-N layout on the same N-free batch."""
    import strling_tpu.ops.kmer as K

    rng = np.random.default_rng(9)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (64, 96))]
    bases[3] = np.frombuffer(b"CAG" * 32, np.uint8)
    lengths = np.full(64, 96, np.int32)
    props = np.full(64, 0.8)
    pl, layout = K.fuse_payload(bases, lengths, props, return_layout=True)
    assert layout == "n8"
    r1 = np.asarray(K._fused_xla_jit(jnp.asarray(pl), "n8"))
    # force the with-N layout by adding (then masking out) an N row copy
    b2 = bases.copy()
    b2[0, 0] = ord("N")
    pl2, layout2 = K.fuse_payload(b2, lengths, props, return_layout=True)
    assert layout2 == "w8"
    r2 = np.asarray(K._fused_xla_jit(jnp.asarray(pl2), "w8"))
    np.testing.assert_array_equal(r1[1:], r2[1:])  # row 0 differs (the N)


# ------------------------------------------- the scan dispatch vs the oracle
# (fixtures, tie-breaks, IUPAC and wire-layout cases through the production
# dispatch: scan_codes/scan_payload)


def _scan_units(reads, props, L=160, bucket=64, pack=True):
    from strling_tpu.ops.kmer import scan_codes, unpack_unit_codes

    bases, lengths, props = _batch(reads, props, L)
    code, ulen, cnt = scan_codes(bases, lengths, props, bucket=bucket,
                                 pack=pack)
    return unpack_unit_codes(code, ulen), cnt


def _assert_oracle(reads, props, units, cnt):
    for i, (r, p) in enumerate(zip(reads, props)):
        exp_unit, exp_count = oracle.get_repeat(r, float(p))
        assert units[i] == exp_unit, (i, r, units[i], exp_unit)
        assert int(cnt[i]) == exp_count, (i, r, int(cnt[i]), exp_count)


def _random_reads(rng, n, max_len, units=("AT", "CAG", "AAGGG", "GGGGCC",
                                          "A", "ATTCT", "TG"),
                  min_len=1):
    alphabet = np.array(list("ACGTN"))
    reads = []
    for _ in range(n):
        mode = rng.integers(0, 4)
        L = int(rng.integers(min_len, max_len + 1))
        u = units[rng.integers(0, len(units))]
        if mode == 0:
            read = "".join(alphabet[rng.integers(0, 4, L)])
        elif mode == 1:
            ph = int(rng.integers(0, len(u)))
            read = (u * (L // len(u) + 2))[ph : ph + L]
        elif mode == 2:
            r = list((u * (L // len(u) + 2))[:L])
            for _ in range(max(1, L // 12)):
                r[rng.integers(0, L)] = alphabet[rng.integers(0, 5)]
            read = "".join(r)
        else:
            h = L // 2
            read = (u * (h // len(u) + 2))[:h] + "".join(
                alphabet[rng.integers(0, 4, L - h)])
        reads.append(read)
    return reads


@pytest.mark.parametrize("seed", [1, 4])
def test_scan_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    reads = _random_reads(rng, 48, 152)
    props = [float(rng.choice([0.8, 0.73, 0.6])) for _ in reads]
    units, cnt = _scan_units(reads, props)
    _assert_oracle(reads, props, units, cnt)


def test_scan_fixtures():
    units, cnt = _scan_units(["TGC" * 50 + "T", "A" * 150, "N" * 30 + "AT" * 60],
                             [0.8, 0.6, 0.8])
    assert units == ["CTG", "A", ""]
    assert cnt.tolist() == [49, 150, 0]


def test_scan_modal_tiebreak_adversarial():
    """Reads engineered so two window codes tie on count: the winner must be
    the code whose LAST occurrence comes earliest (the reference CountTable
    running-argmax semantics, utils.nim:192-211)."""
    reads = [
        # k=3 windows alternate CAG/TTG: equal counts, CAG's last
        # occurrence earlier in one phase, later in the other
        "CAGTTG" * 25,
        "TTGCAG" * 25,
        # trailing singleton breaks the tie asymmetrically
        "CAGTTG" * 24 + "CAG",
        "TTGCAG" * 24 + "TTG",
        # three-way tie among k=2 and k=4 candidates
        "ATGC" * 30,
        "ACGTAACC" * 15,
        # tie between k=5 codes
        ("AAGGG" + "CCTTT") * 15,
        # short reads right at window-count boundaries
        "CAGCAG",
        "CAGCAGC",
        "ATATAT",
    ]
    props = [0.3] * len(reads)  # low threshold so ties actually report
    units, cnt = _scan_units(reads, props)
    _assert_oracle(reads, props, units, cnt)


def test_scan_iupac_bytes_match_oracle():
    """IUPAC bytes share 2-bit codes with real bases ('R' encodes like 'C')
    but must never satisfy the exact-recount ASCII compare (utils.nim:254);
    such batches take the ASCII dispatch."""
    from strling_tpu.ops.kmer import fuse_payload

    reads = [
        "CAG" * 20 + "R" + "CAG" * 20,    # R interrupts the run
        ("CAR" * 30)[:90],                # R inside every unit
        "AT" * 30 + "RYSWKM" + "AT" * 30,
        "R" * 60,                          # all-IUPAC read
    ]
    props = [0.5] * len(reads)
    assert fuse_payload(*_batch(reads, props)) is None
    units, cnt = _scan_units(reads, props)
    _assert_oracle(reads, props, units, cnt)


def test_scan_n8_layout_equals_ascii():
    """The N-free n8 wire layout must scan identically to the ASCII path,
    including short lengths and planted repeats."""
    import strling_tpu.ops.kmer as K

    rng = np.random.default_rng(9)
    B, L = 64, 104
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (B, L))]
    units = [b"CAG", b"A", b"AT", b"AAGGG", b"ATTCT", b"ACGTCG"]
    for i in range(0, B, 3):
        u = units[i % len(units)]
        bases[i] = np.frombuffer((u * (L // len(u) + 1))[:L], np.uint8)
    lengths = rng.integers(8, L + 1, B).astype(np.int32)
    for i, l in enumerate(lengths):
        bases[i, l:] = 0
    props = np.full(B, 0.8)
    payload, layout = K.fuse_payload(bases, lengths, props, return_layout=True)
    assert layout == "n8"
    got = K.scan_payload(payload, B, layout, bucket=B)
    want = K.scan_codes(bases, lengths, props, bucket=B, pack=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_scan_256bp_matches_oracle():
    """Reads up to the extractor's 256bp limit (core/extract.py) scan
    exactly, on the w16 wire layout that L > 248 selects."""
    from strling_tpu.ops.kmer import fuse_payload

    rng = np.random.default_rng(256)
    reads = _random_reads(rng, 64, 256, min_len=193)
    reads[0] = ("CAG" * 90)[:256]
    reads[1] = ("AAGGG" * 60)[:250]
    props = [float(rng.choice([0.8, 0.6])) for _ in reads]
    assert fuse_payload(*_batch(reads, props, 256),
                        return_layout=True)[1] == "w16"
    units, cnt = _scan_units(reads, props, L=256)
    _assert_oracle(reads, props, units, cnt)
    assert cnt[0] == 85 and units[0] == "AGC"


@pytest.mark.parametrize("n_rows", [1, 63, 65, 130])
def test_scan_payload_bucket_padding(n_rows):
    """Row counts that are not a multiple of the bucket pad with zero rows
    (empty reads) and return exactly the first n_rows results."""
    import strling_tpu.ops.kmer as K

    rng = np.random.default_rng(n_rows)
    reads = _random_reads(rng, n_rows, 152, min_len=40)
    props = [0.8] * n_rows
    bases, lengths, p = _batch(reads, props)
    payload, layout = K.fuse_payload(bases, lengths, p, return_layout=True)
    code, ulen, cnt = K.scan_payload(payload, n_rows, layout, bucket=64)
    assert code.shape == ulen.shape == cnt.shape == (n_rows,)
    _assert_oracle(reads, props, K.unpack_unit_codes(code, ulen), cnt)


# ------------------------------------------------- on the card (marker: gpu)


def _kernel_batch(B, L, seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    bases = alphabet[rng.integers(0, 4, (B, L))]
    units = [b"CAG", b"A", b"AT", b"AAGGG", b"ATTCT", b"CCTGGG"]
    for i in range(0, B, 7):
        u = units[i % len(units)]
        bases[i] = np.frombuffer((u * (L // len(u) + 1))[:L], np.uint8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    for i, l in enumerate(lengths):
        bases[i, l:] = 0
    return bases, lengths, np.full(B, 0.8)


@pytest.mark.gpu
@pytest.mark.parametrize("L", [152, 256])
def test_gpu_scan_matches_cpu(gpu_device, L):
    """The scan compiled for the card equals the CPU backend's byte for byte
    at the 32768-row bucket (all device arithmetic is int32)."""
    import jax

    import strling_tpu.ops.kmer as K

    bases, lengths, props = _kernel_batch(32768, L, L)
    payload, layout = K.fuse_payload(bases, lengths, props, return_layout=True)
    gpu = np.asarray(K._fused_xla_jit(jax.device_put(payload, gpu_device),
                                      layout))
    cpu = np.asarray(K._fused_xla_jit(
        jax.device_put(payload, jax.devices("cpu")[0]), layout))
    np.testing.assert_array_equal(gpu, cpu)
