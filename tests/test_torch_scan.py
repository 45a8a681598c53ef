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


@pytest.mark.parametrize("case", ["spread", "gaps", "one", "drop"])
@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_scan_partition_matches_numpy(S, case):
    """K8's partition (plain) into a ScanRouter's slot blocks on a CPU mesh
    of S shards, then the router's copies, against numpy: each owner
    receives the hits sent to it, source after source, in position order;
    a position with no hit goes nowhere; an empty source and an owner that
    receives nothing give empty blocks; the tallies count the rows each
    owner got; nothing is read to the host."""
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
        kernels.scan_partition_plain(torch.from_numpy(codes), router.out[s], router.overflow[s],
                                     router.tally[s], wps=wps, cap=router.cap)
    router._copy()
    assert sharded_index.HOST_READS[0] == reads
    w = kernels.scan_slot_words(router.cap, W)
    for d in range(S):
        got = torch.cat([kernels.slot_rows(b, router.cap, 0, W)
                         for b in router.recv[d].view(S, w)])
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
