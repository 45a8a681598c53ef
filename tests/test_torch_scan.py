"""The port's sharded context scan (K8 scan_pack, K9 scan_set and the
slot blocks between them) on CPU meshes, against numpy, the host scan and
the JAX package's ``build_context_sharded``.

The port's kernels run their plain versions here (CPU tensors); the
kernels' partition is held against the same plain version by
tests/test_torch_route_tiles.py (g++).  Bit indices and words are
integers, so the tolerance is zero throughout.
"""

import re

import numpy as np
import pytest
import torch

from malva_tpu.utils.config import Config
from malva_tpu_torch.ops import kernels
from malva_tpu_torch.parallel import sharded_index
from malva_tpu_torch.parallel.sharded_index import ScanRouter, build_context_sharded
from test_sharded import _index

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _cfg():
    return Config(k=35, ref_k=43, bf_size=1 << 20)


def _partition_case(S, case):
    """Sources of 0-40 positions and their hits' owners: ``spread`` over
    every shard (the last source empty), ``gaps`` over the even shards only
    (every other owner receives nothing), ``one`` all to the last shard,
    ``drop`` a third with no hit.  Each hit's shard-local bit index holds
    its source and position, so that the order shows."""
    rng = np.random.default_rng(S * 10 + len(case))
    dests = []
    for s in range(S):
        n = 0 if case == "spread" and s == S - 1 else int(rng.integers(0, 41))
        if case == "one":
            dests.append(np.full(n, S - 1))
        elif case == "gaps":
            dests.append(rng.integers(0, (S + 1) // 2, n) * 2)
        else:
            dests.append(rng.integers(0, S + (case == "drop"), n))
    return dests


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("case", ["spread", "gaps", "one", "drop"])
@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_scan_partition_matches_numpy(S, case, parity):
    """K8's partition (plain) into a ScanRouter's slot blocks of either
    parity (the receive buffers of the even and of the odd chunks) on a
    CPU mesh of S shards, then the router's copies of that parity, against
    numpy: each owner receives the hits sent to it, source after source, in
    position order; a position with no hit goes nowhere; an empty source and
    an owner that receives nothing give empty blocks; the other parity's
    buffers stay empty; the tallies count the rows each owner got; nothing
    is read to the host."""
    dests = _partition_case(S, case)
    size_bits = 32 * 24 * 1024  # 24 Ki words: shards of 1, 2, 3 and 8 of them
    router = ScanRouter([CPU] * S, [torch.zeros(24 * 1024 // S, dtype=torch.int32)] * S,
                        {CPU: torch.zeros(24 * 1024, dtype=torch.int32)}, 35, 43, size_bits,
                        slice_rows=64, cap=64)
    wps, W = router.wps, router.W
    reads = sharded_index.HOST_READS[0]
    locals_ = []
    for s, dest in enumerate(dests):
        local = s * 64 + np.arange(dest.shape[0])
        codes = np.where(dest < S, dest * 32 * wps + local, -1)
        locals_.append(local)
        kernels.scan_partition_plain(torch.from_numpy(codes), router.out[parity][s],
                                     router.overflow[s], router.tally[s], wps=wps, cap=router.cap)
    router._copy(parity)
    assert sharded_index.HOST_READS[0] == reads
    w = kernels.scan_slot_words(router.cap, W)
    for d in range(S):
        assert not router.recv[1 - parity][d].any()
        got = torch.cat([kernels.slot_rows(b, router.cap, 0, W)
                         for b in router.recv[parity][d].view(S, w)])
        want = np.concatenate([loc[dst == d] for loc, dst in zip(locals_, dests)])
        np.testing.assert_array_equal(got[:, 0].numpy(), want)
        assert sum(int(t[1 + d]) for t in router.tally) == want.shape[0]
    assert all(int(t[0]) == 0 for t in router.tally)


def _setup(kind: str, seed: int):
    """(refs, host index, port index) with the host scan done on the host
    index: ``sparse``, random contigs with N bytes and a short one and a few
    planted alt k-mers; ``dense``, a 900-base contig whose positions 100-399
    all hit; ``long``, a 1500-base contig whose positions 100-1299 all hit."""
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
        refs = [alpha[rng.integers(0, 5, size=n)] for n in (3000, 37, 900)]
        plant = [ref[p + 4 : p + 39][None, :] for ref in refs for p in (20, 400, 850)
                 if p + 39 <= len(ref)]
    else:
        n, hits = (900, (100, 400)) if kind == "dense" else (1500, (100, 1300))
        refs = [ACGT[rng.integers(0, 4, size=n)]]
        windows = np.lib.stride_tricks.sliding_window_view(refs[0], cfg.ref_k)
        plant = [np.ascontiguousarray(windows[hits[0] : hits[1], 4:39])]
    host_idx, port_idx = (_index(cfg, seed=seed)[0] for _ in range(2))
    for keys in plant:
        for ix in (host_idx, port_idx):
            ix.bf.add_keys(keys)
    off = cfg.center_off
    for ref in refs:
        if len(ref) < cfg.ref_k:
            if len(ref) > off and host_idx.bf.test_keys(ref[off : off + cfg.k][None, :])[0]:
                host_idx.context_bf.add_keys(ref[: cfg.ref_k][None, :])
            continue
        windows = np.lib.stride_tricks.sliding_window_view(ref, cfg.ref_k)
        hits = host_idx.bf.test_keys(np.ascontiguousarray(windows[:, off : off + cfg.k]))
        host_idx.context_bf.add_keys(np.ascontiguousarray(windows[hits]))
    return refs, host_idx, port_idx


# (setup, slice positions, slot rows or None for scan_capacity's): no row
# spills; rows spill to the overflow lists, which hold them; the lists
# overflow and the scan runs again with slots of a whole slice
SCANS = {"slots": ("sparse", 256, None), "spills": ("dense", 512, 16),
         "rescans": ("long", 64, 1)}


@pytest.mark.parametrize("scan", list(SCANS))
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_scan_reads_host_only_at_the_end(S, scan, capfd):
    """The sharded context scan on a CPU mesh of S shards, over many chunks,
    reads nothing to the host while the chunks scan and once at the end
    (the tallies; once for each pass where the lists overflowed, which
    takes a second pass), and its words equal the host scan's, where rows
    spill to the overflow lists and where the lists overflow too."""
    kind, slice_chunk, cap = SCANS[scan]
    refs, host_idx, port_idx = _setup(kind, seed=40 + S)
    calls = []
    real = sharded_index.read_host
    monkey = pytest.MonkeyPatch()
    monkey.setattr(sharded_index, "read_host", lambda t: calls.append(1) or real(t))
    if cap is not None:
        monkey.setattr(sharded_index, "scan_capacity", lambda rows, n_shards: cap)
    try:
        build_context_sharded(port_idx, refs, _cfg(), [CPU] * S, slice_chunk=slice_chunk)
    finally:
        monkey.undo()
    line = [ln for ln in capfd.readouterr().err.splitlines() if "sharded context scan:" in ln][0]
    m = re.search(r"in (\d+) chunks .* (\d+) rows through the overflow lists(, scanned 1 times "
                  r"more)?; host reads (\d+) in the chunks, (\d+) at the end", line)
    chunks, spilled, again, in_chunks, at_end = m.groups()
    passes = 2 if scan == "rescans" else 1
    assert int(chunks) >= passes and int(in_chunks) == 0
    assert int(at_end) == len(calls) == passes and bool(again) == (passes == 2)
    assert (int(spilled) > 0) == (scan != "slots")
    assert host_idx.context_bf.words.any()
    np.testing.assert_array_equal(port_idx.context_bf.words, host_idx.context_bf.words)


@pytest.mark.parametrize("S", [1, 4])
def test_sharded_scan_one_and_four_shards_match_jax(S):
    """On meshes of one shard and of four, the sharded scan equals JAX's
    build_context_sharded and the host scan (two and eight shards:
    tests/test_torch_sharded.py)."""
    import jax

    from malva_tpu.parallel.mesh import make_mesh as jax_mesh
    from malva_tpu.parallel.sharded_index import build_context_sharded as jax_scan

    refs, host_idx, port_idx = _setup("sparse", seed=60 + S)
    _, _, jax_idx = _setup("sparse", seed=60 + S)
    jax_scan(jax_idx, refs, _cfg(), jax_mesh(min(S, len(jax.devices()))), slice_chunk=256)
    build_context_sharded(port_idx, refs, _cfg(), [CPU] * S, slice_chunk=256)
    assert host_idx.context_bf.words.any()
    np.testing.assert_array_equal(port_idx.context_bf.words, host_idx.context_bf.words)
    np.testing.assert_array_equal(port_idx.context_bf.words, jax_idx.context_bf.words)


def test_scan_pack_and_set_plain_on_a_chunk():
    """Plain K8 on a chunk (N and IUPAC bytes) of a two-shard index, then
    plain K9 on each owner over the block K8 wrote for it, set the bits
    the one-device scan sets (``ref_scan_plain``), shard by shard."""
    rng = np.random.default_rng(71)
    alpha = np.frombuffer(b"ACGTACGTNRY", dtype=np.uint8)
    n, size_bits = 3000, 1 << 20
    seq = torch.from_numpy(alpha[rng.integers(0, alpha.shape[0], n + 42)])
    wps = size_bits // 32 // 2
    bf = torch.from_numpy(rng.integers(-2**31, 2**31, size_bits // 32).astype(np.int32))
    want = torch.zeros(size_bits // 32, dtype=torch.int32)
    kernels.ref_scan_plain(bf, want, seq, n, k=35, ref_k=43, size_bits=size_bits)
    cap = 2000
    blocks = [torch.zeros(kernels.scan_slot_words(cap, 1), dtype=torch.int32) for _ in range(2)]
    tally = torch.zeros(3, dtype=torch.int64)
    kernels.scan_pack(seq, n, bf, blocks, torch.zeros(20, dtype=torch.int32), tally, k=35,
                      ref_k=43, size_bits=size_bits, wps=wps, cap=cap)
    assert int(tally[0]) == 0 and int(tally[1:].sum()) > 100
    for d, b in enumerate(blocks):
        words = torch.zeros(wps, dtype=torch.int32)
        kernels.scan_set(words, b, n_blocks=1, cap=cap, W=1)
        np.testing.assert_array_equal(words.numpy(), want[d * wps : (d + 1) * wps].numpy())


# (shards, chunks, case): how many chunks of S x DEFERRED_SLICE positions
# the contig takes, and its hits: a few planted in every chunk; none in
# the middle chunk; a run of hits in every chunk, more than the slots
# hold (DEFERRED_SPILL_CAP rows), so that rows spill to the overflow lists
DEFERRED = [(2, 1, "hits"), (2, 2, "hits"), (2, 3, "hits"), (4, 3, "hits"),
            (2, 3, "no hit in the middle"), (2, 2, "spill"), (2, 3, "spill")]
DEFERRED_SLICE = 96
DEFERRED_SPILL_CAP = 4


def _deferred_setup(S: int, chunks: int, case: str):
    """(contig, host index, port index, JAX index) for a DEFERRED case, the
    host scan done on the host index."""
    cfg = _cfg()
    rng = np.random.default_rng(100 * S + 10 * chunks + len(case))
    span = S * DEFERRED_SLICE
    n_pos = chunks * span - 17  # the last chunk short
    ref = ACGT[rng.integers(0, 4, size=n_pos + cfg.ref_k - 1)]
    windows = np.lib.stride_tricks.sliding_window_view(ref, cfg.ref_k)
    at = []
    for c in range(chunks):
        if case == "no hit in the middle" and c == 1:
            continue
        first = c * span
        if case == "spill":  # a run of 3 x cap hits on every slice
            at += [first + s * DEFERRED_SLICE + j for s in range(S)
                   for j in range(3 * DEFERRED_SPILL_CAP)]
        else:
            at += list(rng.integers(first, min(first + span, n_pos), 3))
    keys = np.ascontiguousarray(windows[np.array(at), 4:39])
    host_idx, port_idx, jax_idx = (_index(cfg, seed=S + chunks)[0] for _ in range(3))
    for ix in (host_idx, port_idx, jax_idx):
        ix.bf.add_keys(keys)
    off = cfg.center_off
    hits = host_idx.bf.test_keys(np.ascontiguousarray(windows[:, off : off + cfg.k]))
    host_idx.context_bf.add_keys(np.ascontiguousarray(windows[hits]))
    return ref, n_pos, host_idx, port_idx, jax_idx


@pytest.mark.parametrize("S,chunks,case", DEFERRED)
def test_deferred_set_matches_every_chunk_at_once_and_jax(S, chunks, case):
    """The sharded scan sets each chunk's rows on their owners only as the
    next chunk's K8 begins (its prologue, plain here) and the last chunk's
    with one K9 an owner (``ScanRouter.flush``), the receive buffers
    alternating by the chunk's parity.  After each chunk the context words
    equal every earlier chunk's received rows set at once, and after the
    flush every chunk's (an independent replay of the same plain partition,
    no deferral); after the overflow lists (``finish``) they equal the host
    scan's and JAX's ``build_context_sharded`` on the virtual CPU mesh,
    over 1, 2 and 3 chunks, with a chunk of no hit, and with rows that
    spill past ``cap``."""
    from malva_tpu.parallel.mesh import make_mesh as jax_mesh
    from malva_tpu.parallel.sharded_index import build_context_sharded as jax_scan

    cfg = _cfg()
    ref, n_pos, host_idx, port_idx, jax_idx = _deferred_setup(S, chunks, case)
    cap = DEFERRED_SPILL_CAP if case == "spill" else None
    wps = cfg.bf_size // 32 // S
    start_words = port_idx.context_bf.words.copy()
    ctx = [torch.from_numpy(start_words[s * wps : (s + 1) * wps].view(np.int32).copy())
           for s in range(S)]
    bf = torch.from_numpy(port_idx.bf.words.view(np.int32).copy())
    router = ScanRouter([CPU] * S, ctx, {CPU: bf}, cfg.k, cfg.ref_k, cfg.bf_size,
                        DEFERRED_SLICE, cap=cap)
    W, cap = router.W, router.cap
    seq = torch.from_numpy(ref)
    # the replay: every chunk's blocks, as each owner receives them
    want = [c.clone() for c in ctx]
    stats = {"positions": 0, "slot_bytes": 0, "hits": [0] * S, "overflow_rows": 0,
             "host_reads_end": 0}
    for c in range(chunks):
        start = c * S * DEFERRED_SLICE
        assert router.parity == c % 2
        router.step({CPU: seq}, start, n_pos, stats)
        for d in range(S):
            assert torch.equal(ctx[d], want[d]), f"chunk {c}: owner {d} before its prologue"
        received = [[] for _ in range(S)]
        for s in range(S):
            p0, n = router._slice(s, start, n_pos)
            blocks = [torch.zeros(kernels.scan_slot_words(cap, W), dtype=torch.int32)
                      for _ in range(S)]
            kernels.scan_pack_plain(seq[p0 : p0 + n + cfg.ref_k - 1], n, bf, blocks,
                                    torch.zeros(max(1, n) * (W + 1), dtype=torch.int32),
                                    torch.zeros(1 + S, dtype=torch.int64), k=cfg.k,
                                    ref_k=cfg.ref_k, size_bits=cfg.bf_size, wps=wps, cap=cap)
            for d in range(S):
                received[d].append(blocks[d])
        for d in range(S):  # the live rows (a reused buffer keeps stale rows past them)
            got = router.recv[c % 2][d].view(S, -1)
            for b, r in zip(got, received[d]):
                assert torch.equal(kernels.slot_rows(b, cap, 0, W),
                                   kernels.slot_rows(r, cap, 0, W)), f"chunk {c}: owner {d}"
            kernels.scan_set_plain(want[d], torch.cat(received[d]), n_blocks=S, cap=cap, W=W)
    router.flush()
    for d in range(S):
        assert torch.equal(ctx[d], want[d]), f"owner {d} after the flush"
    assert router.finish(stats)
    assert (stats["overflow_rows"] > 0) == (case == "spill")
    port_words = np.concatenate([c.numpy().view(np.uint32) for c in ctx])
    assert not np.array_equal(port_words, start_words)
    np.testing.assert_array_equal(port_words, host_idx.context_bf.words)
    # the same scan through the entry point, and JAX's on its CPU mesh
    monkey = pytest.MonkeyPatch()
    if case == "spill":
        monkey.setattr(sharded_index, "scan_capacity", lambda rows, n_shards: DEFERRED_SPILL_CAP)
    try:
        build_context_sharded(port_idx, [ref], cfg, [CPU] * S, slice_chunk=DEFERRED_SLICE)
    finally:
        monkey.undo()
    jax_scan(jax_idx, [ref], cfg, jax_mesh(S), slice_chunk=DEFERRED_SLICE)
    np.testing.assert_array_equal(port_idx.context_bf.words, host_idx.context_bf.words)
    np.testing.assert_array_equal(jax_idx.context_bf.words, host_idx.context_bf.words)
