"""Batched repeat-unit detection — the device compute path for `extract`/`index`.

The reference detects the repeat unit of one read at a time in Nim
(src/strpkg/utils.nim:236-271, flagged "the bottleneck for run time",
utils.nim:235). Here the same computation runs over a whole [B, L] batch of
reads as one XLA program:

  1. per-k (k=2..6) non-overlapping window codes with min-rotation
     canonicalization (utils.nim:10-35) — vectorized base-4 dot products;
  2. modal window code per read, reproducing the reference's running-argmax
     tie-break (utils.nim:192-198) via an occurrence/total matrix instead of a
     sequential histogram;
  3. exact non-overlapping substring recount of the decoded modal kmer
     (utils.nim:254) as a length-L masked scan;
  4. the k-selection state machine with early exit (utils.nim:249-269),
     vectorized over the batch with per-read thresholds;
  5. homopolymer reduction (utils.nim:220-233,271).

Float-sensitive thresholds (int(len*0.12/k), int(len*proportion/k)) are
precomputed host-side in float64 so device logic is pure-integer and matches
the Nim doubles bit-for-bit.

Inputs are raw ASCII bytes, so non-ACGT bases behave exactly as in the
reference: they 2-bit-encode via (b>>1)&3 for the kmer scan, but never match
a decoded ACTG unit in the exact recount.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

KS = (2, 3, 4, 5, 6)
DECODE_ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)


def _window_min_rotation(codes: jnp.ndarray, lengths: jnp.ndarray, k: int):
    """Min-rotation codes for non-overlapping width-k windows.

    codes: [B, L] int32 in 0..3. Returns (wmin [B, W] int32, valid [B, W] bool)
    where W = L // k and window j covers bases [j*k, (j+1)*k)
    (utils.nim:10-35: windows at stride k, min over the k cyclic rotations).
    """
    B, L = codes.shape
    W = L // k
    w = codes[:, : W * k].reshape(B, W, k)
    # rotation r value: sum_m w[..., (m + r) % k] * 4^(k-1-m)
    weights = np.array([4 ** (k - 1 - m) for m in range(k)], dtype=np.int32)
    vals = []
    for r in range(k):
        idx = [(m + r) % k for m in range(k)]
        vals.append((w[:, :, idx] * weights).sum(axis=-1))
    wmin = jnp.min(jnp.stack(vals, axis=-1), axis=-1)
    win_end = (jnp.arange(W, dtype=jnp.int32) + 1) * k
    valid = win_end[None, :] <= lengths[:, None]
    return wmin, valid


def _modal_code(wmin: jnp.ndarray, valid: jnp.ndarray):
    """Modal window code with the reference tie-break.

    Reference semantics (utils.nim:192-198): the winner is the code whose
    final (maximal) count was reached first in window order. Equivalently:
    among windows j that are the M-th occurrence of their code (occ == M,
    total == M, M = max total), the smallest j wins.

    Returns (code [B] int32, count [B] int32); code is -1 when no valid
    windows (count==0), mirroring imax == -1 (utils.nim:210).
    """
    B, W = wmin.shape
    # NEG-premask invalid windows: they never equal a valid code, and
    # NEG-vs-NEG hits are filtered by the valid gate on candidates
    wminm = jnp.where(valid, wmin, -1)
    eq = wminm[:, :, None] == wminm[:, None, :]  # [B, i, j]
    total = eq.sum(axis=1, dtype=jnp.int32)  # [B, W]
    idx = jnp.arange(W, dtype=jnp.int32)
    # last occurrence of each code: occ == total  <=>  lastmax == own index
    lastmax = jnp.max(jnp.where(eq, idx[None, :, None], -1), axis=1)
    M = jnp.max(jnp.where(valid, total, 0), axis=1)  # [B]
    cand = (valid & (total == M[:, None]) & (lastmax == idx[None, :])
            & (M[:, None] > 0))
    jstar = jnp.argmax(cand, axis=1)  # first True
    code = jnp.take_along_axis(wminm, jstar[:, None], axis=1)[:, 0]
    code = jnp.where(M > 0, code, -1)
    return code, M


def _modal_code_by_value(wmin: jnp.ndarray, valid: jnp.ndarray, k: int):
    """Same contract as _modal_code, counting each possible code directly
    (4^k columns instead of the O(W^2) pairwise tensor; used when 4^k < W)."""
    B, W = wmin.shape
    V = 1 << (2 * k)
    wminm = jnp.where(valid, wmin, -1)
    eq = wminm[:, :, None] == jnp.arange(V, dtype=wmin.dtype)[None, None, :]
    tot = eq.sum(axis=1, dtype=jnp.int32)  # [B, V]
    idx = jnp.arange(W, dtype=jnp.int32)
    last = jnp.max(jnp.where(eq, idx[None, :, None], -1), axis=1)  # [B, V]
    # winner = max count, ties -> earliest last occurrence (same tie-break
    # as the pairwise form; equal (tot, last) across codes is impossible).
    # int32 is ample: tot*(W+1) <= (L/2)*(L/2+1) << 2^31
    score = tot * jnp.int32(W + 1) - last
    score = jnp.where(tot > 0, score, jnp.int32(-1))
    v = jnp.argmax(score, axis=1)
    M = jnp.take_along_axis(tot, v[:, None], axis=1)[:, 0]
    code = jnp.where(M > 0, v.astype(jnp.int32), -1)
    return code, M


def _decode_ascii(code: jnp.ndarray, k: int) -> jnp.ndarray:
    """Decode [B] codes to [B, k] ASCII bytes; code -1 decodes as 'G'*k.

    Matches Nim: imax = -1 becomes uint64 all-ones before decode
    (utils.nim:197,246), and "ACTG"[3] == 'G'.
    """
    code = jnp.where(code < 0, (1 << (2 * k)) - 1, code)
    shifts = np.array([2 * (k - 1 - m) for m in range(k)], dtype=np.int32)
    digits = (code[:, None] >> shifts[None, :]) & 3
    return jnp.asarray(DECODE_ASCII)[digits]


def _match_mask(bases, lengths, kmer_ascii, k):
    """match[b, j]: the read's kmer matches at offset j (within the read)."""
    B, L = bases.shape
    m = jnp.ones((B, L), dtype=bool)
    for off in range(k):
        shifted = jnp.pad(bases[:, off:], ((0, 0), (0, off)))
        m = m & (shifted == kmer_ascii[:, off][:, None])
    pos_ok = (jnp.arange(L, dtype=jnp.int32)[None, :] + k) <= lengths[:, None]
    return m & pos_ok


def _exact_count(bases: jnp.ndarray, lengths: jnp.ndarray, kmer_ascii: jnp.ndarray, k: int):
    """Non-overlapping occurrences of each read's kmer in its read.

    Nim strutils.count semantics (utils.nim:254): greedy left-to-right scan
    advancing by k after a match, by 1 otherwise — an L-step lax.scan with a
    [B] carry.
    """
    B, L = bases.shape
    m = _match_mask(bases, lengths, kmer_ascii, k)

    def step(carry, mj):
        count, next_free, j = carry
        can = mj & (j >= next_free)
        count = count + can.astype(jnp.int32)
        next_free = jnp.where(can, j + k, next_free)
        return (count, next_free, j + 1), None

    init = (jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32), jnp.int32(0))
    (count, _, _), _ = jax.lax.scan(step, init, m.T)
    return count


def get_repeat_device(bases, lengths, thresh_early, thresh_prop):
    """Traceable device kernel (shard_map-able). Shapes: bases [B, L] uint8,
    lengths [B] i32, thresh_* [B, 5] i32 (host-precomputed float64 floors).

    Returns (unit_ascii [B,6] u8, unit_len [B] i32, repeat_count [B] i32).
    """
    B, L = bases.shape
    codes = (bases.astype(jnp.int32) >> 1) & 3
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    in_read = pos < lengths[:, None]
    n_count = ((bases == ord("N")) & in_read).sum(axis=1)
    skip = n_count > 20  # utils.nim:238

    kmer_counts, exact_counts, kmer_ascii_by_k, kmer_code_by_k = [], [], [], []
    for k in KS:
        wmin, valid = _window_min_rotation(codes, lengths, k)
        if (1 << (2 * k)) < wmin.shape[1]:
            code, cnt = _modal_code_by_value(wmin, valid, k)
        else:
            code, cnt = _modal_code(wmin, valid)
        ka = _decode_ascii(code, k)
        ex = _exact_count(bases, lengths, ka, k)
        kmer_counts.append(cnt)
        exact_counts.append(ex)
        kmer_ascii_by_k.append(ka)
        kmer_code_by_k.append(code)

    # k-selection state machine (utils.nim:243-269), vectorized
    best = jnp.full(B, -1, jnp.int32)
    done = jnp.zeros(B, bool)
    res_ki = jnp.full(B, -1, jnp.int32)  # index into KS of the winning k
    res_count = jnp.zeros(B, jnp.int32)
    for ki, k in enumerate(KS):
        cnt = kmer_counts[ki]
        ex = exact_counts[ki]
        score_est = cnt * k
        gate1_fail = score_est <= best
        newly_done = (~done) & gate1_fail & (cnt < thresh_early[:, ki])
        proceed = (~done) & (~gate1_fail)
        done = done | newly_done
        score_ex = ex * k
        upd = proceed & (score_ex >= best)
        best = jnp.where(upd, score_ex, best)
        set_res = upd & (ex > thresh_prop[:, ki])
        res_ki = jnp.where(set_res, ki, res_ki)
        res_count = jnp.where(set_res, ex, res_count)

    # gather the winning kmer's ASCII into a fixed [B, 6] buffer
    unit = jnp.zeros((B, 6), jnp.uint8)
    for ki, k in enumerate(KS):
        sel = (res_ki == ki)[:, None]
        padded = jnp.pad(kmer_ascii_by_k[ki], ((0, 0), (0, 6 - k)))
        unit = jnp.where(sel, padded, unit)
    unit_len = jnp.where(res_ki >= 0, jnp.array(KS, jnp.int32)[jnp.maximum(res_ki, 0)], 0)

    # homopolymer reduction (utils.nim:220-233,271)
    first = unit[:, 0]
    is_homo = res_ki >= 0
    for i in range(1, 6):
        col_active = jnp.arange(6)[i] < unit_len
        is_homo = is_homo & (~col_active | (unit[:, i] == first))
    mult = jnp.where(is_homo, unit_len, 1)
    res_count = res_count * mult
    unit_len = jnp.where(is_homo, jnp.minimum(unit_len, 1), unit_len)
    keep = jnp.arange(6)[None, :] < unit_len[:, None]
    unit = jnp.where(keep, unit, 0)

    # N-heavy reads produce nothing (utils.nim:238)
    res_count = jnp.where(skip, 0, res_count)
    unit = jnp.where(skip[:, None], 0, unit)
    unit_len = jnp.where(skip, 0, unit_len)
    return unit, unit_len, res_count


_get_repeat_jit = jax.jit(get_repeat_device)

# ------------------------------------------------------ 2-bit packed transfer
# Host->device transfer is 1 byte/base in ASCII; for ACGTN-only batches (all
# real sequencing data) the host packs 4 bases/byte plus an N bitmask and the
# device reconstructs ASCII inside the jit, cutting the transfer ~3.6x. Rows
# whose batch contains any other IUPAC byte fall back to the ASCII path so
# kernel semantics stay bit-identical (the (c>>1)&3 code of e.g. 'R' is not
# recoverable from 2 bits).

_ASCII_OK = np.zeros(256, np.bool_)
_ASCII_OK[[0, ord("A"), ord("C"), ord("G"), ord("T"), ord("N")]] = True


def pack_bases(bases: np.ndarray):
    """[B, L] ASCII -> ([B, L/4] 2-bit codes, [B, L/8] N bitmask), or None
    if the batch has non-ACGTN bytes (caller falls back to ASCII). L%8==0."""
    if bases.shape[1] % 8 or not _ASCII_OK[bases].all():
        return None
    codes = (bases >> 1) & 3
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
              | (codes[:, 3::4] << 6)).astype(np.uint8)
    nbits = np.packbits(bases == ord("N"), axis=1, bitorder="little")
    return packed, nbits


def unpack_ascii(packed: jnp.ndarray, nbits: jnp.ndarray | None) -> jnp.ndarray:
    """Device-side inverse of pack_bases (runs fused inside the jit).
    nbits None means the batch is N-free (the "n8" wire layout)."""
    B, L4 = packed.shape
    d = (packed[:, :, None].astype(jnp.int32)
         >> (jnp.arange(4, dtype=jnp.int32) * 2)) & 3
    d = d.reshape(B, L4 * 4)
    a = 65 + 2 * d + 15 * (d == 2).astype(jnp.int32)  # A/C/T/G ASCII
    if nbits is None:
        return a.astype(jnp.uint8)
    bits = (nbits[:, :, None].astype(jnp.int32)
            >> jnp.arange(8, dtype=jnp.int32)) & 1
    nm = bits.reshape(B, -1)[:, :L4 * 4]
    return jnp.where(nm == 1, ord("N"), a).astype(jnp.uint8)


@jax.jit
def _get_repeat_packed_jit(packed, nbits, lengths, te, tp):
    return get_repeat_device(unpack_ascii(packed, nbits), lengths, te, tp)


# ------------------------------------------------------- fused single-buffer
# The production dispatch fuses everything a batch needs (2-bit bases, N
# bitmask, per-row thresholds + length) into ONE uint8 host->device copy and
# returns ONE packed [B] int32 result: one copy each way per batch.
# Wire layouts (static per jit):
#   "w8"  [R, 3L/8 + 11]: 2-bit codes + N bitmask + u8 meta (L <= 248 ->
#         te <= 14, tp <= 124, length <= 248 — i.e. all short-read data)
#   "n8"  [R, L/4 + 11]:  2-bit codes + u8 meta, NO N plane — used when the
#         whole batch is N-free (the common case; ~48B per 160bp row)
#   "w16" [R, 3L/8 + 22]: 2-bit codes + N bitmask + u16 LE meta (L > 248)
# "auto" infers w8/w16 from the row width mod 3 (3L/8 is a multiple of 3,
# 11 % 3 == 2, 22 % 3 == 1); "n8" is ambiguous by width alone and must be
# passed explicitly.

FUSE_META8 = 11   # 5x te u8 + 5x tp u8 + length u8
FUSE_META16 = 22  # 5x te u16 + 5x tp u16 + length u16, little-endian
META8_MAX_L = 248


def fuse_payload(bases: np.ndarray, lengths: np.ndarray, props: np.ndarray,
                 return_layout: bool = False):
    """[R, L] ASCII + lengths + props -> u8 single buffer in the smallest
    applicable wire layout, or None if the batch needs the ASCII fallback
    (non-ACGTN bytes, L%8, or values exceeding u16). With return_layout,
    returns (payload, layout)."""
    R, L = bases.shape
    if L % 8 or L > 65535 or not _ASCII_OK[bases].all():
        return (None, None) if return_layout else None
    te, tp = _host_thresholds(lengths, props)
    if tp.max(initial=0) > 65535 or tp.min(initial=0) < 0:
        return (None, None) if return_layout else None
    codes = (bases >> 1) & 3
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
              | (codes[:, 3::4] << 6)).astype(np.uint8)
    n_mask = bases == ord("N")
    meta8 = L <= META8_MAX_L
    if meta8:
        meta = np.empty((R, 11), np.uint8)
        meta[:, :5] = te
        meta[:, 5:10] = tp
        meta[:, 10] = lengths
        mbytes = meta
    else:
        meta = np.empty((R, 11), np.uint16)
        meta[:, :5] = te
        meta[:, 5:10] = tp
        meta[:, 10] = lengths
        mbytes = meta.view(np.uint8)
    if meta8 and not n_mask.any():
        layout = "n8"
        parts = [packed, mbytes]
    else:
        layout = "w8" if meta8 else "w16"
        nbits = np.packbits(n_mask, axis=1, bitorder="little")
        parts = [packed, nbits, mbytes]
    out = np.concatenate(parts, axis=1, dtype=np.uint8)
    return (out, layout) if return_layout else out


def _meta_from_payload(payload: jnp.ndarray, meta_off: int, meta_w: int):
    """Device-side meta extraction shared by unfuse_payload and the packed
    n8 kernel path: (lengths [R], te [R,5], tp [R,5]) from the trailing
    meta bytes."""
    R, Wp = payload.shape
    meta = jax.lax.slice(payload, (0, meta_off), (R, Wp))
    if meta_w == FUSE_META8:
        m = meta.astype(jnp.int32)
    else:
        m = jax.lax.bitcast_convert_type(
            meta.reshape(R, 11, 2), jnp.uint16
        ).astype(jnp.int32)
    return m[:, 10], m[:, :5], m[:, 5:10]


def unfuse_payload(payload: jnp.ndarray, layout: str):
    """Device-side inverse of fuse_payload (fused into the jit). `layout`
    is static and must be the layout the producer reported ("w8"/"w16"/
    "n8") — row widths are ambiguous between n8 and w8/w16 (e.g. L=96 n8
    and L=64 w8 are both width 35), so there is no safe inference."""
    R, Wp = payload.shape
    if layout not in ("w8", "w16", "n8"):
        raise ValueError(
            f"layout must be the producer-reported 'w8'/'w16'/'n8', got "
            f"{layout!r}: widths are ambiguous between layouts")
    if layout == "n8":
        L = (Wp - FUSE_META8) * 4
        pb = jax.lax.slice(payload, (0, 0), (R, L // 4))
        nb = None
        meta_off, meta_w = L // 4, FUSE_META8
    else:
        meta_w = FUSE_META8 if layout == "w8" else FUSE_META16
        L = (Wp - meta_w) * 8 // 3
        pb = jax.lax.slice(payload, (0, 0), (R, L // 4))
        nb = jax.lax.slice(payload, (0, L // 4), (R, 3 * L // 8))
        meta_off = 3 * L // 8
    lengths, te, tp = _meta_from_payload(payload, meta_off, meta_w)
    return unpack_ascii(pb, nb), lengths, te, tp


def pack_result(code: jnp.ndarray, ulen: jnp.ndarray, cnt: jnp.ndarray):
    """Device-side: (code<=4095, len<=6, count<=255) -> one i32 per read
    (quarters the result transfer)."""
    return cnt | (ulen << 8) | (code << 11)


def unpack_result(r: np.ndarray):
    r = np.asarray(r)
    return (r >> 11).astype(np.int32), ((r >> 8) & 7).astype(np.int32), \
        (r & 0xFF).astype(np.int32)


def _unit_to_code_device(unit: jnp.ndarray, unit_len: jnp.ndarray):
    """Device-side ascii_to_codes: [B, 6] ASCII + len -> base-4 packed i32."""
    code = jnp.zeros(unit.shape[0], jnp.int32)
    for i in range(6):
        active = i < unit_len
        code = jnp.where(active, code * 4 + ((unit[:, i].astype(jnp.int32) >> 1) & 3), code)
    return code


@partial(jax.jit, static_argnums=(1,))
def _fused_xla_jit(payload, layout):
    bases, lengths, te, tp = unfuse_payload(payload, layout)
    unit, ulen, cnt = get_repeat_device(bases, lengths, te, tp)
    return pack_result(_unit_to_code_device(unit, ulen), ulen, cnt)


def _host_thresholds(lengths: np.ndarray, props: np.ndarray):
    """float64 thresholds, exactly as Nim computes them (utils.nim:251,259)."""
    lengths = lengths.astype(np.float64)
    te = np.empty((len(lengths), len(KS)), np.int32)
    tp = np.empty((len(lengths), len(KS)), np.int32)
    for ki, k in enumerate(KS):
        te[:, ki] = (lengths * 0.12 / float(k)).astype(np.int64).astype(np.int32)
        tp[:, ki] = (lengths * props / float(k)).astype(np.int64).astype(np.int32)
    return te, tp


def _committed(x) -> jnp.ndarray:
    """Host array -> a COMMITTED array on the default device.

    Every dispatch entry funnels through this so all callers (extract,
    genome index, benches) share ONE pjit cache entry per shape: committed
    and uncommitted inputs of the same shape compile as separate programs,
    which costs a full compile for no reason.

    local_devices, not devices: in a multi-process (jax.distributed) run
    the global list starts with another process's non-addressable device.
    """
    return jax.device_put(x, jax.local_devices()[0])


def get_repeat_batch(bases: np.ndarray, lengths: np.ndarray,
                     proportion_repeat: np.ndarray):
    """Detect repeat units for a batch of reads.

    Args:
      bases: uint8 [B, L] ASCII bases, zero-padded.
      lengths: int32 [B] read lengths.
      proportion_repeat: float64 [B] per-read proportion threshold (the
        reference varies this between the main read and soft-clip re-scans,
        extract.nim:206-211,241-243).

    Returns (unit uint8 [B, 6] ASCII zero-padded, unit_len int32 [B],
    repeat_count int32 [B]) as numpy arrays.
    """
    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    props = np.asarray(proportion_repeat, dtype=np.float64)
    if props.ndim == 0:
        props = np.full(len(lengths), float(props))
    te, tp = _host_thresholds(lengths, props)
    unit, unit_len, count = _get_repeat_jit(
        _committed(bases), _committed(lengths), _committed(te), _committed(tp)
    )
    return np.asarray(unit), np.asarray(unit_len), np.asarray(count)


def units_to_strings(unit: np.ndarray, unit_len: np.ndarray) -> list[str]:
    return [bytes(unit[i, : unit_len[i]]).decode() for i in range(len(unit_len))]


def unpack_unit_codes(code: np.ndarray, klen: np.ndarray) -> list[str]:
    """Base-4 packed unit code -> ACTG string (host-side)."""
    DEC = "ACTG"
    out = []
    for c, l in zip(code.tolist(), klen.tolist()):
        out.append(
            "".join(DEC[(c >> (2 * (l - 1 - i))) & 3] for i in range(l))
        )
    return out


def ascii_to_codes(unit: np.ndarray, unit_len: np.ndarray) -> np.ndarray:
    """[B, 6] ASCII unit + lengths -> base-4 packed int32 codes."""
    code = np.zeros(len(unit_len), np.int64)
    for i in range(6):
        active = i < unit_len
        code = np.where(
            active, code * 4 + ((unit[:, i].astype(np.int64) >> 1) & 3), code
        )
    return code.astype(np.int32)


def scan_codes_dispatch(bases: np.ndarray, lengths: np.ndarray,
                        props: np.ndarray, bucket: int = 4096,
                        pack: bool = True):
    """Asynchronously dispatch the repeat detector; returns a zero-arg fetch
    closure producing packed (code, len, count) int32 numpy arrays.

    Rows are padded to `bucket` multiples so jit shapes stay bounded; the
    dispatch returns immediately (device work overlaps host work until the
    closure is called). With `pack` (default), ACGTN-only batches move to the
    device 2-bit packed (~3.6x less transfer); others fall back to ASCII."""
    R = len(lengths)
    padded = max(bucket, ((R + bucket - 1) // bucket) * bucket)
    if padded != R:
        bases = np.vstack([bases, np.zeros((padded - R, bases.shape[1]), np.uint8)])
        lengths = np.concatenate([lengths, np.zeros(padded - R, np.int32)])
        props = np.concatenate([props, np.full(padded - R, 0.8)])
    if pack:
        payload, layout = fuse_payload(bases, lengths, props,
                                       return_layout=True)
        if payload is not None:
            out = _fused_xla_jit(_committed(payload), layout)

            def fetch():
                code, ulen, cnt = unpack_result(out)
                return code[:R], ulen[:R], cnt[:R]

            return fetch
    te, tp = _host_thresholds(lengths, props)
    pk = pack_bases(bases) if pack else None
    if pk is not None:
        unit, ulen, cnt = _get_repeat_packed_jit(
            _committed(pk[0]), _committed(pk[1]), _committed(lengths),
            _committed(te), _committed(tp)
        )
    else:
        unit, ulen, cnt = _get_repeat_jit(
            _committed(bases), _committed(lengths), _committed(te),
            _committed(tp)
        )

    def fetch():
        u = np.asarray(unit)[:R]
        ul = np.asarray(ulen)[:R]
        return ascii_to_codes(u, ul), ul, np.asarray(cnt)[:R]

    return fetch


def scan_codes(bases: np.ndarray, lengths: np.ndarray, props: np.ndarray,
               bucket: int = 4096, pack: bool = True):
    """Synchronous scan_codes_dispatch."""
    return scan_codes_dispatch(bases, lengths, props, bucket, pack)()


def scan_payload(payload: np.ndarray, n_rows: int, layout: str,
                 bucket: int = 4096, device=None):
    """Scan a pre-fused payload (rows already in a fuse_payload wire layout,
    e.g. produced by the C++ engine's sio_ex_next_fused). Pads rows to
    `bucket` multiples (zero rows scan as empty reads), runs the fused jit,
    returns packed (code, len, count) int32 numpy arrays for the first
    `n_rows` rows. Blocking; thread-safe (used by the pipelined extract's
    worker threads so transfer/fetch round-trips overlap). `device` pins the
    dispatch to a specific device (multi-device round-robin extract)."""
    R = len(payload)
    padded = max(bucket, ((R + bucket - 1) // bucket) * bucket)
    if padded != R:
        payload = np.vstack(
            [payload, np.zeros((padded - R, payload.shape[1]), np.uint8)]
        )
    arr = (jax.device_put(payload, device) if device is not None
           else _committed(payload))
    out = _fused_xla_jit(arr, layout)
    code, ulen, cnt = unpack_result(out)
    return code[:n_rows], ulen[:n_rows], cnt[:n_rows]
