"""The two hand-written kernels of the device main path, their wrappers and
their plain PyTorch versions.

Counterpart of ``malva_tpu/ops/pallas_kernels.py``.  Each wrapper takes
the plain version for tensors on the CPU, and for CUDA tensors launches
its kernel (``csrc/``, built by ``ops/_build.py``) or raises; it never
falls back.  ``LAUNCHES`` counts kernel launches per wrapper.

* K1 ``callstep`` (``csrc/callstep.cu``) replaces
  ``pallas_kernels.py:125 make_callstep_hash_fn`` and the rest of
  ``index/device.py:400 make_call_step_packed``.  On the card it is bound
  by one random 8-byte row gather per lane from the GiB-sized word+rank
  array; the kernel does everything else in registers and touches the
  context filter and the exact map only for the few interesting lanes.
* K2 ``ref_scan`` (``csrc/ref_scan.cu``) replaces
  ``pallas_kernels.py:222 make_window_hash_fn`` and the rest of
  ``index/device.py:697 make_ref_scan_step_pallas``.  It is bound by the
  hashing of two canonical strings per reference position plus one
  random 4-byte alt-filter read; hits end in one ``atomicOr``.

``callstep_hash`` / ``window_hash`` are the kernels' hash-only modes,
which write exactly the TPU kernels' outputs so the card can check them
against the TPU kernels' contract.

Device arrays are int32 tensors holding uint32 bit patterns (ops.bloom).
Hash-only outputs are returned as int64 lanes in [0, 2^32).
"""

from __future__ import annotations

import torch

from malva_tpu.index.device import RANK_BITS, RANK_MASK
from malva_tpu.index.kmap_table import SLOTS

from . import _build
from .bloom import bloom_set, lanes, scatter_add_u32
from .packed import canonical_center, decode_byte_cols, popcount32
from .seq import canonical_decision, complement
from .xxh3 import check_bloom_size, xxh3_64_cols, xxh3_mod_size

LAUNCHES = {"callstep": 0, "ref_scan": 0}
MAX_LEN = 240  # csrc/lanes.cuh kMaxLen


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or
    any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all lie on one CPU or CUDA device, got {kinds}")


def _check(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor, got {t.dtype}"
                         f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_lengths(k: int, ref_k: int) -> None:
    if not (1 <= k <= ref_k <= MAX_LEN):
        raise ValueError(f"kernels need 1 <= k <= ref_k <= {MAX_LEN}, got k={k} ref_k={ref_k}")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")


# -- K1: call step ------------------------------------------------------------


def callstep_hash_plain(ctx_packed: torch.Tensor, k: int, ref_k: int, with_ctx: bool):
    """Plain K1 front end: ``[ctx_hi, ctx_lo,] c_hi, c_lo, can_0..`` of
    (B, wc) packed contexts, as int64 lanes."""
    words = [lanes(ctx_packed[:, j]) for j in range(ctx_packed.shape[1])]
    out = []
    if with_ctx:
        out += list(xxh3_64_cols(decode_byte_cols(words, ref_k)))
    can = canonical_center(words, k, ref_k)
    out += list(xxh3_64_cols(decode_byte_cols(can, k)))
    return out + can


def callstep_hash(ctx_packed: torch.Tensor, k: int, ref_k: int, with_ctx: bool):
    """K1 in hash-only mode; same outputs as :func:`callstep_hash_plain`."""
    if not _on_cuda(ctx_packed):
        return callstep_hash_plain(ctx_packed, k, ref_k, with_ctx)
    _check(ctx_packed, torch.int32, "ctx_packed")
    _check_lengths(k, ref_k)
    B, wc = ctx_packed.shape
    if wc != (ref_k + 15) // 16:
        raise ValueError(f"ctx_packed has {wc} words a row; ref_k={ref_k} needs "
                         f"{(ref_k + 15) // 16}")
    n_out = (4 if with_ctx else 2) + (k + 15) // 16
    out = torch.empty((n_out, B), dtype=torch.int32, device=ctx_packed.device)
    _launch("malva_callstep_hash", ctx_packed.device, ctx_packed.data_ptr(), B, wc, k, ref_k,
            int(with_ctx), out.data_ptr())
    LAUNCHES["callstep"] += 1
    return [lanes(o) for o in out]


def callstep_plain(bf_packed, ctx_words, kmap_keys, state, ctx_packed, counters, *,
                   k: int, ref_k: int, size_bits: int, n_buckets: int,
                   minifilter: bool) -> None:
    """Plain call step over packed contexts, updating ``state`` in place.

    The full-batch spec of ``malva_tpu/index/device.py:195 make_call_step``
    over packed input.  ``state`` is ``[bf_counts | kmap_vals]``;
    ``counters`` of 0 are exact no-ops (padding)."""
    counts_len = state.shape[0] - n_buckets * SLOTS
    w_k = (k + 15) // 16
    words = [lanes(ctx_packed[:, j]) for j in range(ctx_packed.shape[1])]
    can = canonical_center(words, k, ref_k)
    c_hi, c_lo = xxh3_64_cols(decode_byte_cols(can, k))
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    row = lanes(bf_packed[bw])
    word, aux = row[:, 0], row[:, 1]
    is_set = ((word >> bb) & 1).bool()
    rank = aux & RANK_MASK if minifilter else aux
    cnt_idx = rank + popcount32(word & ((1 << bb) - 1))

    x_hi, x_lo = xxh3_64_cols(decode_byte_cols(words, ref_k))
    cw, cb = xxh3_mod_size(x_hi, x_lo, size_bits)
    ctx_known = ((lanes(ctx_words[cw]) >> cb) & 1).bool()
    scatter_add_u32(state, cnt_idx, counters, is_set & ~ctx_known)

    if minifilter and n_buckets > 1:
        cand = (((aux >> RANK_BITS) >> ((c_hi >> 28) & 3)) & 1).bool()
    else:
        cand = torch.ones_like(is_set)
    from ..index.kmap_table import probe_bucket_table

    slot, found = probe_bucket_table(kmap_keys, n_buckets, w_k, can, c_hi, c_lo)
    scatter_add_u32(state, counts_len + slot, counters, found & cand)


def callstep(bf_packed, ctx_words, kmap_keys, state, ctx_packed, counters, *,
             k: int, ref_k: int, size_bits: int, n_buckets: int, minifilter: bool) -> None:
    """K1: one call step over (B, wc) packed canonical contexts and their
    (B,) counters, updating ``state`` in place.  All arrays are int32
    storage; ``bf_packed`` is (W, 2) [word, rank | mini-filter << 28]."""
    args = (bf_packed, ctx_words, kmap_keys, state, ctx_packed, counters)
    if not _on_cuda(*args):
        return callstep_plain(*args, k=k, ref_k=ref_k, size_bits=size_bits,
                              n_buckets=n_buckets, minifilter=minifilter)
    names = ("bf_packed", "ctx_words", "kmap_keys", "state", "ctx_packed", "counters")
    for t, name in zip(args, names):
        _check(t, torch.int32, name)
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    B, wc = ctx_packed.shape
    W = size_bits // 32
    if (wc != (ref_k + 15) // 16 or counters.shape != (B,) or bf_packed.shape != (W, 2)
            or ctx_words.shape != (W,)
            or kmap_keys.shape != (n_buckets, SLOTS * ((k + 15) // 16))
            or state.shape[0] < n_buckets * SLOTS):
        raise ValueError("callstep: array shapes do not match k, ref_k, size_bits and n_buckets")
    counts_len = state.shape[0] - n_buckets * SLOTS
    _launch("malva_callstep", state.device, ctx_packed.data_ptr(), counters.data_ptr(), B, wc,
            k, ref_k, bf_packed.data_ptr(), ctx_words.data_ptr(), kmap_keys.data_ptr(),
            state.data_ptr(), counts_len, n_buckets, size_bits, int(minifilter))
    LAUNCHES["callstep"] += 1


# -- K2: reference context scan ----------------------------------------------


def _window_cols(seq: torch.Tensor, n_pos: int, start: int, length: int):
    return [seq[start + j : start + j + n_pos].to(torch.int64) for j in range(length)]


def _canonical_cols(cols):
    """strcmp/RCN canonical form of per-position byte columns
    (pallas_kernels.py:198 _canonical_cols)."""
    rc = [complement(c.to(torch.uint8)).to(torch.int64) for c in reversed(cols)]
    keep = canonical_decision(cols, rc)
    return [torch.where(keep, a, b) for a, b in zip(cols, rc)]


def window_hash_plain(seq: torch.Tensor, n_pos: int, k: int, ref_k: int):
    """Plain K2 front end: (c_hi, c_lo, x_hi, x_lo) for the first n_pos
    windows of a uint8 sequence, as int64 lanes."""
    cols = _window_cols(seq, n_pos, 0, ref_k)
    off = (ref_k - k) // 2
    c = xxh3_64_cols(_canonical_cols(cols[off : off + k]))
    x = xxh3_64_cols(_canonical_cols(cols))
    return [*c, *x]


def _check_seq(seq: torch.Tensor, n_pos: int, ref_k: int) -> None:
    if seq.dim() != 1 or seq.shape[0] < n_pos + ref_k - 1:
        raise ValueError(f"seq must be 1-D with at least n_pos + ref_k - 1 = "
                         f"{n_pos + ref_k - 1} bytes, got shape {tuple(seq.shape)}")


def window_hash(seq: torch.Tensor, n_pos: int, k: int, ref_k: int):
    """K2 in hash-only mode; same outputs as :func:`window_hash_plain`."""
    _check_seq(seq, n_pos, ref_k)
    if not _on_cuda(seq):
        return window_hash_plain(seq, n_pos, k, ref_k)
    _check(seq, torch.uint8, "seq")
    _check_lengths(k, ref_k)
    out = torch.empty((4, n_pos), dtype=torch.int32, device=seq.device)
    _launch("malva_window_hash", seq.device, seq.data_ptr(), n_pos, k, ref_k, out.data_ptr())
    LAUNCHES["ref_scan"] += 1
    return [lanes(o) for o in out]


def ref_scan_plain(bf_words, ctx_words, seq, n_pos: int, *, k: int, ref_k: int,
                   size_bits: int) -> None:
    """Plain ref scan: for each of the first n_pos windows of ``seq``
    whose canonical center hits ``bf_words``, set the canonical window's
    bit in ``ctx_words`` (in place)."""
    c_hi, c_lo, x_hi, x_lo = window_hash_plain(seq, n_pos, k, ref_k)
    bw, bb = xxh3_mod_size(c_hi, c_lo, size_bits)
    hit = ((lanes(bf_words[bw]) >> bb) & 1).bool()
    cw, cb = xxh3_mod_size(x_hi, x_lo, size_bits)
    bloom_set(ctx_words, cw, cb, hit)


def ref_scan(bf_words, ctx_words, seq, n_pos: int, *, k: int, ref_k: int,
             size_bits: int) -> None:
    """K2: context scan of the first n_pos windows of a uint8 sequence
    (at least n_pos + ref_k - 1 bytes), OR-ing into ``ctx_words``."""
    _check_seq(seq, n_pos, ref_k)
    if not _on_cuda(bf_words, ctx_words, seq):
        return ref_scan_plain(bf_words, ctx_words, seq, n_pos, k=k, ref_k=ref_k,
                              size_bits=size_bits)
    _check(seq, torch.uint8, "seq")
    _check(bf_words, torch.int32, "bf_words")
    _check(ctx_words, torch.int32, "ctx_words")
    _check_lengths(k, ref_k)
    check_bloom_size(size_bits)
    if bf_words.shape != (size_bits // 32,) or ctx_words.shape != bf_words.shape:
        raise ValueError("ref_scan: Bloom word arrays do not match size_bits")
    _launch("malva_ref_scan", seq.device, seq.data_ptr(), n_pos, k, ref_k, bf_words.data_ptr(),
            ctx_words.data_ptr(), size_bits)
    LAUNCHES["ref_scan"] += 1
