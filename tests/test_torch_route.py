"""The routed sharded call step's partitions (K6, K7, K4's slot entry) and
its session, on the CPU with the kernels' plain versions.

K6 and K7 are held against a numpy transcription of JAX's ``pack_dests``
(malva_tpu/parallel/sharded_index.py:326-347: a stable sort of the lanes by
owner, each owner's first ``cap`` rows into its slots, the rest flagged as
overflow) with JAX's capacity rule; the routed session against JAX's
routed step on its 8-device CPU mesh and the host apply.  Hashes, keys and
counters are integers, so the tolerance is zero throughout.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from malva_tpu.ops.seq import canonical
from malva_tpu.pipeline import apply_sample_counts
from malva_tpu.utils.config import Config
from malva_tpu_torch.index.device import pack2bit_u32_np
from malva_tpu_torch.ops import kernels
from malva_tpu_torch.ops.kernels import HOP1_COLS, HOP2_COLS, SLOT_HEAD, slot_words
from malva_tpu_torch.parallel import sharded_index
from malva_tpu_torch.parallel.sharded_index import (
    Router,
    ShardedCallSession,
    apply_sample_counts_sharded,
    capacity,
    shard_index_routed,
)
from test_sharded import _index

CPU = torch.device("cpu")
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)
WC = 3  # ref_k 43
CASES = ["spread", "clumped", "one", "empty"]


def np_pack_dests(owner, payload, valid, D, cap):
    """JAX's pack_dests in numpy: the (D * cap, F) slot matrix, each
    owner's row count in its slots (JAX's slots carry a valid flag
    instead), and the rows past the capacity in lane order (JAX flags
    them as one overflow bit)."""
    b = owner.shape[0]
    key = np.where(valid, owner, D)
    perm = np.lexsort((np.arange(b), key))
    sk = key[perm]
    first = np.concatenate([[True], sk[1:] != sk[:-1]]) if b else np.zeros(0, bool)
    pos = np.arange(b)
    rank = pos - np.maximum.accumulate(np.where(first, pos, 0)) if b else pos
    ok = (sk < D) & (rank < cap)
    slots = np.zeros((D * cap, payload.shape[1]), np.int64)
    slots[sk[ok] * cap + rank[ok]] = payload[perm][ok]
    counts = np.array([min(int((key == d).sum()), cap) for d in range(D)])
    over = np.sort(perm[(sk < D) & (rank >= cap)])
    return slots, counts, payload[over]


def block_slots(block: torch.Tensor, cap: int, cols: int) -> tuple[int, np.ndarray]:
    """A slot block as (its header's row count, its (cap, WC + cols) rows)."""
    b = block.numpy().astype(np.int64) & 0xFFFFFFFF
    assert (b[1:SLOT_HEAD] == 0).all()
    planes = b[SLOT_HEAD:]
    ctx = planes[: cap * WC].reshape(cap, WC)
    more = planes[cap * WC :].reshape(cols, cap).T
    return int(b[0]), np.concatenate([ctx, more], axis=1)


def route_buffers(D, cap, cols, ovf_cap):
    blocks = [torch.zeros(slot_words(cap, WC, cols), dtype=torch.int32) for _ in range(D)]
    overflow = torch.zeros(ovf_cap * (WC + 1), dtype=torch.int32)
    return blocks, overflow, torch.zeros(1 + 2 * D, dtype=torch.int64)


def overflow_rows(overflow, tally, ovf_cap):
    n = int(tally[0])
    o = overflow.numpy().astype(np.int64) & 0xFFFFFFFF
    return np.concatenate([o[: ovf_cap * WC].reshape(ovf_cap, WC)[:n],
                           o[ovf_cap * WC :][:n, None]], axis=1)


def owners(rng, n, D, case):
    """Destination shard of each of n lanes: spread evenly, clumped (runs
    of one shard, most lanes to shard 0), all to the last shard."""
    if case == "spread":
        return rng.integers(0, D, n)
    if case == "one":
        return np.full(n, D - 1)
    runs = np.repeat(rng.integers(0, D, -(-n // 37)), 37)[:n]
    return np.where(rng.random(n) < 0.6, 0, runs)


def hash_words(rng, word, size_bits):
    """(hi, lo) XXH3 halves whose Bloom index has word ``word`` (and a
    random bit), for either of the index's size rules (ops/xxh3.py
    xxh3_mod_size)."""
    bit = rng.integers(0, 32, word.shape[0])
    if size_bits < 1 << 33:
        hi = rng.integers(0, 1 << 32, word.shape[0])
        return hi, (word << 5) | bit
    hi = ((word >> 28) << 1) | ((word >> 27) & 1)
    return hi, ((word & ((1 << 27) - 1)) << 5) | bit


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_route_pack_matches_pack_dests(D, case):
    """K6's plain version over a source slice: the hop-1 slot blocks (rows
    [context, counter, context word less the owner's first, context bit,
    Bloom-word owner]), their headers, the overflow list and the tally
    equal JAX's pack_dests with JAX's capacity for the slice; a tenth of the
    lanes have a zero counter and go nowhere.  D = 3 runs at 3 * 2^33 bits
    (the index's n_gib rule)."""
    rng = np.random.default_rng(D * 10 + CASES.index(case))
    size_bits = 3 << 33 if D == 3 else 1 << 20
    W = size_bits // 32
    wps = W // D
    n = 0 if case == "empty" else 700
    dest = owners(rng, n, D, case)
    cw = dest * wps + rng.integers(0, wps, n)
    bdest = owners(rng, n, D, "spread")
    bw = bdest * wps + rng.integers(0, wps, n)
    x_hi, x_lo = hash_words(rng, cw, size_bits)
    c_hi, c_lo = hash_words(rng, bw, size_bits)
    ctx = rng.integers(0, 1 << 32, (n, WC))
    counters = np.where(rng.random(n) < 0.1, 0, rng.integers(1, 1 << 32, n))
    cb = x_lo & 31
    cap = capacity(n, D)
    ovf_cap = n + 1
    blocks, overflow, tally = route_buffers(D, cap, HOP1_COLS, ovf_cap)
    hx = torch.from_numpy(np.stack([x_hi, x_lo, c_hi, c_lo]).astype(np.uint32).view(np.int32))
    kernels.route_pack(hx, torch.from_numpy(ctx.astype(np.uint32).view(np.int32)),
                       torch.from_numpy(counters.astype(np.uint32).view(np.int32)), blocks,
                       overflow, tally, size_bits=size_bits, wps=wps, cap=cap)

    payload = np.concatenate([ctx, np.stack([counters, cw - dest * wps, cb, bdest], 1)], 1)
    slots, counts, over = np_pack_dests(dest, payload, counters > 0, D, cap)
    for d in range(D):
        rows, got = block_slots(blocks[d], cap, HOP1_COLS)
        assert rows == counts[d]
        np.testing.assert_array_equal(got, slots[d * cap : (d + 1) * cap])
    np.testing.assert_array_equal(overflow_rows(overflow, tally, ovf_cap), over[:, : WC + 1])
    assert tally[1 : 1 + D].tolist() == counts.tolist() and not tally[1 + D :].any()
    if case == "one" and D in (3, 8):
        assert over.shape[0] > 0
    elif case in ("spread", "empty") or D == 1:
        assert over.shape[0] == 0


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_route_probe_matches_pack_dests(D, case):
    """K7's plain version over D received hop-1 blocks (some full, some
    empty, the rest part full, with stale rows past their counts): the live
    rows, in block and row order, tested against the shard's context
    words, give the hop-2 blocks [context, counter, known], headers,
    overflow list and tally of JAX's pack_dests by Bloom-word owner."""
    rng = np.random.default_rng(100 + D * 10 + CASES.index(case))
    cap = capacity(300, D)
    n_ctx_words = 500
    ctx_words = rng.integers(0, 1 << 32, n_ctx_words)
    fill = [0 if case == "empty" else int(rng.choice([0, cap, rng.integers(1, cap)]))
            for _ in range(D)]
    if case != "empty" and max(fill) == 0:
        fill[0] = cap
    w1 = slot_words(cap, WC, HOP1_COLS)
    received = torch.zeros(D * w1, dtype=torch.int32)
    live = []
    for b in range(D):
        rows = np.concatenate([rng.integers(0, 1 << 32, (cap, WC + 1)),
                               rng.integers(0, n_ctx_words, (cap, 1)),
                               rng.integers(0, 32, (cap, 1)),
                               owners(rng, cap, D, "spread" if case == "empty" else case)[:, None]],
                              axis=1)
        blk = np.zeros(w1, np.int64)
        blk[0] = fill[b]
        blk[SLOT_HEAD : SLOT_HEAD + cap * WC] = rows[:, :WC].reshape(-1)
        blk[SLOT_HEAD + cap * WC :] = rows[:, WC:].T.reshape(-1)
        received[b * w1 : (b + 1) * w1] = torch.from_numpy(blk.astype(np.uint32).view(np.int32))
        live.append(rows[: fill[b]])
    live = np.concatenate(live)
    ovf_cap = D * cap
    blocks, overflow, tally = route_buffers(D, cap, HOP2_COLS, ovf_cap)
    kernels.route_probe(received, torch.from_numpy(ctx_words.astype(np.uint32).view(np.int32)),
                        blocks, overflow, tally, wc=WC, cap_in=cap, cap=cap)

    known = (ctx_words[live[:, WC + 1]] >> live[:, WC + 2]) & 1
    payload = np.concatenate([live[:, : WC + 1], known[:, None]], axis=1)
    slots, counts, over = np_pack_dests(live[:, WC + 3], payload, np.ones(len(live), bool), D,
                                        cap)
    for d in range(D):
        rows, got = block_slots(blocks[d], cap, HOP2_COLS)
        assert rows == counts[d]
        np.testing.assert_array_equal(got, slots[d * cap : (d + 1) * cap])
    np.testing.assert_array_equal(overflow_rows(overflow, tally, ovf_cap), over[:, : WC + 1])
    assert not tally[1 : 1 + D].any() and tally[1 + D :].tolist() == counts.tolist()
    assert known.any() and (1 - known).any() if len(live) > 20 else True


@pytest.mark.parametrize("minifilter", [True, False])
def test_shard_update_slots_plain_is_shard_update(minifilter):
    """K4's slot entry over hop-2 blocks (stale rows past the counts) is
    K4 over the blocks' live rows, compacted in block and row order."""
    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    index, keys = _index(cfg, seed=3)
    mesh = [CPU] * 2
    sharded = shard_index_routed(index, cfg, mesh)
    sh = sharded.shards[1]
    if not minifilter:
        sh.bf_packed[:, 1] &= (1 << 28) - 1
    rng = np.random.default_rng(4)
    contexts, counters = _contexts(keys, rng, 600)
    packed = pack2bit_u32_np(contexts, 43).view(np.int32)
    cap, n_blocks = 400, 2
    w2 = slot_words(cap, WC, HOP2_COLS)
    slots = torch.from_numpy(rng.integers(-1 << 31, 1 << 31, n_blocks * w2).astype(np.int32))
    fill = [250, 350]
    at, rows = 0, []
    for b, n in enumerate(fill):
        blk = slots[b * w2 : (b + 1) * w2]
        blk[:SLOT_HEAD] = torch.tensor([n, 0, 0, 0], dtype=torch.int32)
        part = np.concatenate([packed[at : at + n], counters[at : at + n, None].view(np.int32),
                               rng.integers(0, 2, (n, 1)).astype(np.int32)], axis=1)
        blk[SLOT_HEAD : SLOT_HEAD + n * WC] = torch.from_numpy(part[:, :WC].reshape(-1).copy())
        for j in range(HOP2_COLS):
            blk[SLOT_HEAD + cap * (WC + j) :][:n] = torch.from_numpy(part[:, WC + j].copy())
        rows.append(part)
        at += n
    rows = np.concatenate(rows)
    args = dict(k=35, ref_k=43, size_bits=cfg.bf_size, n_buckets=sharded.nbs,
                word_base=sharded.words_per_shard, counts_len=sharded.cmax,
                minifilter=minifilter)
    got, want = sh.state.clone(), sh.state.clone()
    kernels.shard_update_slots(sh.bf_packed, sh.kmap_keys, got, slots, n_blocks=n_blocks, cap=cap,
                               **args)
    kernels.shard_update(sh.bf_packed, sh.kmap_keys, want, torch.from_numpy(rows[:, :WC].copy()),
                         torch.from_numpy(rows[:, WC].copy()),
                         torch.from_numpy(rows[:, WC + 1] != 0), **args)
    assert not torch.equal(got, sh.state)
    assert torch.equal(got, want)


def _contexts(keys, rng, n):
    """Canonical contexts, a third centred on alt keys, a third on map
    keys, the rest random; counters 1..2^31."""
    alt, ref, _ = keys
    contexts = ALPHA[rng.integers(0, 4, size=(n, 43))]
    third = n // 3
    contexts[:third, 4:39] = alt[rng.integers(0, len(alt), third)]
    contexts[third : 2 * third, 4:39] = ref[rng.integers(0, len(ref), third)]
    return canonical(contexts), rng.integers(1, 1 << 31, size=n).astype(np.uint32)


def _batch(keys, case, seed):
    """A batch of 2048 contexts: spread (random), skewed (every lane the
    same context: one owner per hop) or clumped (three lanes in four, at
    random places, the same context; the rest spread)."""
    rng = np.random.default_rng(seed)
    contexts, counters = _contexts(keys, rng, 2048)
    if case == "skewed":
        contexts = np.repeat(contexts[:1], 2048, axis=0)
    elif case == "clumped":
        contexts[rng.random(2048) < 0.75] = contexts[0]
    return contexts, counters


@pytest.mark.parametrize("case", ["spread", "skewed", "clumped"])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_routed_session_matches_jax_and_host(n_shards, case):
    """bf.counts and the exact map after the port's routed session equal
    JAX's routed step on its CPU mesh (which reruns an overflowing batch
    through its all-gather) and the host apply, on spread, skewed and
    clumped batches in steps of 1024 rows; the skewed and clumped batches
    overflow the slots, and every row is applied once all the same."""
    from malva_tpu.parallel.mesh import make_mesh as jax_mesh
    from malva_tpu.parallel.sharded_index import apply_sample_counts_sharded as jax_apply

    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    (host_idx, keys), (jax_idx, _), (port_idx, _) = (_index(cfg, seed=21) for _ in range(3))
    contexts, counters = _batch(keys, case, seed=22 + n_shards)
    apply_sample_counts(host_idx, contexts, counters, cfg)
    jax_apply(jax_idx, contexts, counters, cfg, jax_mesh(n_shards), batch=1024, routed=True)
    stats = apply_sample_counts_sharded(port_idx, contexts, counters, cfg, [CPU] * n_shards,
                                        batch=1024)
    assert stats["steps"] == 2 and stats["slot_rows"] == capacity(1024 // n_shards, n_shards)
    # the slots hold a whole source slice (cap >= slice here), so rows spill
    # only past hop 2's slots, and those crossed hop 1 twice
    assert sum(stats["hop2_rows"]) == 2048
    assert sum(stats["hop1_rows"]) == 2048 + stats["overflow_rows"]
    assert (stats["overflow_rows"] > 0) == (case != "spread")
    assert host_idx.bf.counts.any()
    for other in (jax_idx, host_idx):
        np.testing.assert_array_equal(port_idx.bf.counts, np.asarray(other.bf.counts))
        assert port_idx.ref_bf.kmers == other.ref_bf.kmers


@pytest.mark.parametrize("n_shards", [2, 8])
def test_routed_steps_make_no_host_read(n_shards, monkeypatch):
    """A session's routed steps read nothing from the devices (no
    read_host, Tensor.tolist or Tensor.item), also on a batch that
    overflows its slots; its finish reads the tallies once (one read_host),
    then once more for the rerun of the overflow lists."""
    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    (host_idx, keys), (port_idx, _) = (_index(cfg, seed=31) for _ in range(2))
    spread = _batch(keys, "spread", 32)
    skewed = _batch(keys, "skewed", 33)
    mesh = [CPU] * n_shards
    sess = ShardedCallSession(port_idx, cfg, mesh, batch=1024)
    calls = {"read_host": [], "tolist": [], "item": []}
    real_read = sharded_index.read_host
    monkeypatch.setattr(sharded_index, "read_host",
                        lambda t: calls["read_host"].append(1) or real_read(t))
    for name in ("tolist", "item"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, _r=real, _n=name: calls[_n].append(1) or _r(self))
    for contexts, counters in (spread, skewed):
        sess.step(pack2bit_u32_np(contexts, 43), counters)
    assert calls == {"read_host": [], "tolist": [], "item": []}
    stats = sess.finish()
    assert len(calls["read_host"]) == 2 and len(calls["tolist"]) == 2 and not calls["item"]
    assert stats["host_reads"] == 2 and stats["overflow_rows"] > 0
    for contexts, counters in (spread, skewed):
        apply_sample_counts(host_idx, contexts, counters, cfg)
    np.testing.assert_array_equal(port_idx.bf.counts, host_idx.bf.counts)
    assert port_idx.ref_bf.kmers == host_idx.ref_bf.kmers


def test_small_batches_and_empty_slices():
    """A batch of fewer rows than D x 128 (some source slices empty, one
    step of no rows at all) on 8 virtual shards gives the host apply's
    state; the slots keep JAX's floor of 128 rows."""
    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    (host_idx, keys), (port_idx, _) = (_index(cfg, seed=41) for _ in range(2))
    contexts, counters = _contexts(keys, np.random.default_rng(42), 5)
    sess = ShardedCallSession(port_idx, cfg, [CPU] * 8, batch=700)
    sess.step(pack2bit_u32_np(contexts, 43), counters)
    sess.step(pack2bit_u32_np(contexts[:0], 43), counters[:0])
    stats = sess.finish()
    apply_sample_counts(host_idx, contexts, counters, cfg)
    assert stats["slot_rows"] == 128 and stats["steps"] == 2
    assert sum(stats["hop2_rows"]) == 5
    np.testing.assert_array_equal(port_idx.bf.counts, host_idx.bf.counts)
    assert port_idx.ref_bf.kmers == host_idx.ref_bf.kmers


def test_overflow_lists_drain_when_they_could_fill(monkeypatch):
    """Where the host's bound says a step could fill an overflow list, the
    router drains the lists first (one host read and a rerun), and the
    state stays the host apply's."""
    monkeypatch.setattr(sharded_index, "OVERFLOW_STEPS", 1)
    cfg = Config(k=35, ref_k=43, bf_size=1 << 20)
    (host_idx, keys), (port_idx, _) = (_index(cfg, seed=51) for _ in range(2))
    steps = [_batch(keys, "skewed", 52), _batch(keys, "clumped", 53)]
    mesh = [CPU] * 4
    sharded = shard_index_routed(port_idx, cfg, mesh)
    router = Router(sharded, mesh, 512)
    stats = sharded_index.row_stats(True, 4)
    for contexts, counters in steps:
        packed = pack2bit_u32_np(contexts, 43)
        sl = [slice(s * 512, (s + 1) * 512) for s in range(4)]
        router.step([torch.from_numpy(packed[i].view(np.int32)) for i in sl],
                    [torch.from_numpy(counters[i].view(np.int32)) for i in sl], stats)
    assert stats["host_reads"] >= 2
    router.drain(stats)
    sharded.write_back(port_idx)
    for contexts, counters in steps:
        apply_sample_counts(host_idx, contexts, counters, cfg)
    assert sum(stats["hop2_rows"]) == 4096 and stats["overflow_rows"] > 0
    np.testing.assert_array_equal(port_idx.bf.counts, host_idx.bf.counts)
    assert port_idx.ref_bf.kmers == host_idx.ref_bf.kmers


CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"


def test_slot_format_and_plan_names_match_the_sources():
    """The CUDA sources own the slot format (csrc/launch.cuh) and the
    plan's column order (csrc/route.cu kPlanNames); ops/kernels.py's copy
    of the one and its names of the other agree with them."""
    launch = (CSRC / "launch.cuh").read_text()
    consts = {m[0]: int(m[1]) for m in re.findall(r"\b(kSlotHead|kHop1Cols|kHop2Cols) = (\d+)",
                                                  launch)}
    assert consts == {"kSlotHead": SLOT_HEAD, "kHop1Cols": HOP1_COLS, "kHop2Cols": HOP2_COLS}
    route = (CSRC / "route.cu").read_text()
    table = route[route.index("kPlanNames[] = {"):]
    names = re.findall(r'\{"(\w+)", k\w+\}', table[: table.index("};")])
    assert names == list(kernels.PLAN_NAMES)


class _FakeLibrary:
    """The two layout queries of the kernel library, with a given answer."""

    def __init__(self, slots, cols):
        self.slots, self.cols = slots, cols

    def malva_slot_layout(self, what):
        return self.slots[what]

    def malva_route_plan_col(self, name):
        return self.cols.get(name.decode(), -1)


GOOD_COLS = {name: i for i, name in enumerate(kernels.PLAN_NAMES)}


@pytest.mark.parametrize("fault", ["none", "slot head", "hop-2 columns", "missing column"])
def test_route_layout_is_read_from_the_library(fault, monkeypatch):
    """route_layout takes the plan's columns from the library and refuses
    one whose slot format or plan names differ from the Python side's."""
    slots = [SLOT_HEAD, HOP1_COLS, HOP2_COLS]
    cols = dict(GOOD_COLS, out1=40, width=77)
    if fault == "slot head":
        slots[0] += 1
    elif fault == "hop-2 columns":
        slots[2] += 1
    elif fault == "missing column":
        del cols["ev_upd1"]
    lib = _FakeLibrary(slots, cols)
    monkeypatch.setattr(kernels._build, "library", lambda: lib)
    monkeypatch.setattr(kernels, "_route_layout", None)
    if fault == "none":
        assert kernels.route_layout() == (lib, cols)
    else:
        with pytest.raises(RuntimeError,
                           match="no column" if fault == "missing column" else "slot blocks"):
            kernels.route_layout()
