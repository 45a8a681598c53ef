"""The port's sharded index over virtual CPU shards, against the JAX package.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py;
the port's mesh repeats the CPU device (``[cpu] * S``), so its kernels run
their plain versions.  Integer hashes, keys and counters are exact, so
the tolerance is zero throughout.
"""

import io
import os
import re

import numpy as np
import pytest
import torch

from malva_tpu.ops.seq import canonical
from malva_tpu.pipeline import apply_sample_counts
from malva_tpu.utils.config import Config
from malva_tpu_torch import pipeline as tp
from malva_tpu_torch.index.device import RANK_BITS, RANK_MASK, pack2bit_u32_np
from malva_tpu_torch.ops.bloom import to_u32
from malva_tpu_torch.parallel.mesh import make_mesh
from malva_tpu_torch.parallel.sharded_index import (
    apply_sample_counts_sharded,
    build_context_sharded,
    shard_index_routed,
)
from test_sharded import _index

CPU = torch.device("cpu")
D = os.path.join(os.path.dirname(__file__), "data", "diploid")
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def _cfg():
    return Config(k=35, ref_k=43, bf_size=1 << 20)


def _contexts(keys, seed=42, n=3000):
    alt, ref, ctxk = keys
    rng = np.random.default_rng(seed)
    contexts = ALPHA[rng.integers(0, 4, size=(n, 43))]
    contexts[:300, 4:39] = alt[:300]
    contexts[300:600, 4:39] = ref[:300]
    contexts[600:900] = ctxk[:300]
    return canonical(contexts), rng.integers(1, 255, size=n).astype(np.uint32)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_routed_step_matches_jax_and_host(n_shards):
    """bf.counts and the exact map after the port's routed step equal
    JAX's routed step on its 8-device CPU mesh and the host apply."""
    from malva_tpu.parallel.mesh import make_mesh as jax_mesh
    from malva_tpu.parallel.sharded_index import apply_sample_counts_sharded as jax_apply

    cfg = _cfg()
    host_idx, keys = _index(cfg)
    jax_idx, _ = _index(cfg)
    port_idx, _ = _index(cfg)
    contexts, counters = _contexts(keys)

    apply_sample_counts(host_idx, contexts, counters, cfg)
    jax_apply(jax_idx, contexts, counters, cfg, jax_mesh(n_shards), batch=1024, routed=True)
    stats = apply_sample_counts_sharded(port_idx, contexts, counters, cfg, [CPU] * n_shards,
                                        batch=1024)
    assert stats["steps"] == 3 and sum(stats["hop2_rows"]) == contexts.shape[0]
    assert host_idx.bf.counts.any()
    for other in (jax_idx, host_idx):
        np.testing.assert_array_equal(port_idx.bf.counts, np.asarray(other.bf.counts))
        assert port_idx.ref_bf.kmers == other.ref_bf.kmers


def test_skewed_input_all_to_one_shard():
    """Every lane routed to one shard (identical contexts; JAX's capacity
    overflow case, test_sharded.py:63): the lanes past each slot block's
    capacity go to the overflow lists and are rerun at the session's end,
    and the state is the host apply's."""
    cfg = _cfg()
    host_idx, (alt, _, _) = _index(cfg)
    port_idx, _ = _index(cfg)
    one = ALPHA[np.random.default_rng(7).integers(0, 4, size=(1, 43))]
    one[:, 4:39] = alt[:1]
    contexts = np.repeat(canonical(one), 2048, axis=0)
    counters = np.ones(2048, np.uint32)
    apply_sample_counts(host_idx, contexts, counters, cfg)
    stats = apply_sample_counts_sharded(port_idx, contexts, counters, cfg, [CPU] * 8,
                                        batch=2048)
    assert sorted(stats["hop2_rows"])[-2:] == [0, 2048]
    assert stats["overflow_rows"] > 0
    np.testing.assert_array_equal(host_idx.bf.counts, port_idx.bf.counts)
    assert host_idx.ref_bf.kmers == port_idx.ref_bf.kmers
    assert port_idx.bf.counts.max() == 2048


@pytest.mark.parametrize("n_shards", [2, 8])
def test_routed_arrays_match_jax(n_shards):
    """The routed layout the port builds on its shards equals JAX's
    shard_index_routed array for array and bucket for bucket, but for the
    port's exact-map mini-filter in the rank's top 4 bits; the same state
    carried across through convert.py places shard s on mesh[s] as the
    port's own build does, without the mini-filter."""
    from malva_tpu.parallel.sharded_index import shard_index_routed as jax_shard

    from malva_tpu_torch.convert import sharded_index_from_arrays
    from malva_tpu_torch.ops.bloom import to_u32

    cfg = _cfg()
    index, _ = _index(cfg, seed=3)
    own = shard_index_routed(index, cfg, [CPU] * n_shards)
    st = jax_shard(index, cfg, n_shards)
    jax_arrays = {n: np.asarray(getattr(st, n)) for n in
                  ("bf_packed", "bf_counts", "ctx_words", "kmap_keys", "kmap_vals")}
    assert own.counts_len == st.counts_len and own.nbs == st.nbs
    assert own.cmax == jax_arrays["bf_counts"].shape[1]
    assert len(own.tables) == len(st.tables) == n_shards
    assert own.minifilter
    for s, sh in enumerate(own.shards):
        rows = to_u32(sh.bf_packed)
        assert (rows[:, 1] >> RANK_BITS).any()
        rows[:, 1] &= RANK_MASK
        np.testing.assert_array_equal(rows, jax_arrays["bf_packed"][s], err_msg="bf_packed")
        for name in ("ctx_words", "kmap_keys"):
            np.testing.assert_array_equal(to_u32(getattr(sh, name)), jax_arrays[name][s],
                                          err_msg=name)
        np.testing.assert_array_equal(
            to_u32(sh.state), np.concatenate([jax_arrays["bf_counts"][s],
                                              jax_arrays["kmap_vals"][s]]))
    assert jax_arrays["bf_packed"][:, :, 1].any() and jax_arrays["kmap_keys"].any()

    jax_arrays.update(counts_len=st.counts_len, nbs=st.nbs, size_bits=st.size_bits,
                      k=cfg.k, ref_k=cfg.ref_k)
    carried = sharded_index_from_arrays(jax_arrays, [CPU] * n_shards, st.tables)
    assert not carried.minifilter
    for a, b in zip(carried.shards, own.shards):
        for name in ("ctx_words", "kmap_keys", "state"):
            np.testing.assert_array_equal(to_u32(getattr(a, name)), to_u32(getattr(b, name)))
        np.testing.assert_array_equal(to_u32(a.bf_packed), to_u32(b.bf_packed) & [~0, RANK_MASK])
    with pytest.raises(KeyError):
        sharded_index_from_arrays({"bf_packed": jax_arrays["bf_packed"]}, [CPU] * n_shards)


def test_carried_jax_state_steps_like_host():
    """A routed step over JAX's state (carried through convert.py) and
    written back with JAX's tables gives the host apply's counters."""
    from malva_tpu.parallel.sharded_index import shard_index_routed as jax_shard

    from malva_tpu_torch.convert import sharded_index_from_arrays
    from malva_tpu_torch.parallel.sharded_index import ShardedCallSession
    from malva_tpu.index.device import pack2bit_u32_np

    cfg = _cfg()
    host_idx, keys = _index(cfg)
    port_idx, _ = _index(cfg)
    contexts, counters = _contexts(keys, seed=9, n=1500)
    st = jax_shard(port_idx, cfg, 4)
    arrays = {n: np.asarray(getattr(st, n)) for n in
              ("bf_packed", "bf_counts", "ctx_words", "kmap_keys", "kmap_vals")}
    arrays.update(counts_len=st.counts_len, nbs=st.nbs, size_bits=st.size_bits, k=35, ref_k=43)
    sharded = sharded_index_from_arrays(arrays, [CPU] * 4, st.tables)
    sess = ShardedCallSession(port_idx, cfg, [CPU] * 4, sharded=sharded)
    sess.step(pack2bit_u32_np(contexts, 43), counters)
    sess.finish()
    apply_sample_counts(host_idx, contexts, counters, cfg)
    np.testing.assert_array_equal(host_idx.bf.counts, port_idx.bf.counts)
    assert host_idx.ref_bf.kmers == port_idx.ref_bf.kmers


@pytest.mark.parametrize("minifilter", [True, False])
def test_shard_update_plain_one_shard_is_callstep(minifilter):
    """At S = 1 one shard owns every word, its local rank is the global
    rank and its mini-filter is the one-device rows': K4's plain version
    equals K1's, with the mini-filter on and off."""
    from malva_tpu.index.device import pack2bit_u32_np

    from malva_tpu_torch.index.device import DeviceIndex
    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.bloom import from_u32, lanes, to_u32
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size

    cfg = _cfg()
    index, keys = _index(cfg, seed=2)
    contexts, counters = _contexts(keys, seed=5, n=1200)
    ctx = from_u32(pack2bit_u32_np(contexts, 43), CPU)
    cnt = from_u32(counters, CPU)

    dev = DeviceIndex.from_host(index, cfg, CPU)
    one = shard_index_routed(index, cfg, [CPU])
    sh = one.shards[0]
    assert dev.minifilter and one.minifilter
    assert torch.equal(sh.bf_packed, dev.bf_packed)
    if not minifilter:  # the rank without the filter
        dev.bf_packed[:, 1] &= RANK_MASK
        sh.bf_packed[:, 1] &= RANK_MASK
    st_k1 = dev.state()
    kernels.callstep_plain(dev.bf_packed, dev.ctx_words, dev.kmap_keys, st_k1, ctx, cnt, k=35,
                           ref_k=43, size_bits=cfg.bf_size, n_buckets=dev.n_buckets,
                           minifilter=minifilter)

    x_hi, x_lo = kernels.callstep_hash_plain(ctx, 35, 43, with_ctx=True)[:2]
    cw, cb = xxh3_mod_size(x_hi, x_lo, cfg.bf_size)
    known = ((lanes(sh.ctx_words[cw]) >> cb) & 1).bool()
    st_k4 = sh.state.clone()
    kernels.shard_update_plain(sh.bf_packed, sh.kmap_keys, st_k4, ctx, cnt, known, k=35,
                               ref_k=43, size_bits=cfg.bf_size, n_buckets=sh.kmap_keys.shape[0],
                               word_base=0, counts_len=st_k4.shape[0] - sh.kmap_keys.shape[0] * 4,
                               minifilter=minifilter)
    n = index.bf.counts.shape[0]
    np.testing.assert_array_equal(to_u32(st_k4[:n]), to_u32(st_k1[:n]))
    assert to_u32(st_k1[:n]).any()
    # the exact maps hold the same keys in other slots: compare per key
    one.shards[0].state = st_k4
    a, b = dict(index.ref_bf.kmers), dict(index.ref_bf.kmers)
    one.tables[0].write_back(to_u32(st_k4[one.cmax :]), a)
    dev.table.write_back(to_u32(st_k1[n:]), b)
    assert a == b and any(a.values())


def test_shard_update_ignores_lanes_of_other_shards():
    """A lane whose Bloom word another shard owns changes nothing."""
    from malva_tpu.index.device import pack2bit_u32_np

    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.bloom import from_u32

    cfg = _cfg()
    index, keys = _index(cfg, seed=2)
    contexts, counters = _contexts(keys, seed=6, n=1000)
    sharded = shard_index_routed(index, cfg, [CPU] * 4)
    sh = sharded.shards[3]
    before = sh.state.clone()
    kernels.shard_update(sh.bf_packed, sh.kmap_keys, sh.state,
                         from_u32(pack2bit_u32_np(contexts, 43), CPU), from_u32(counters, CPU),
                         torch.zeros(1000, dtype=torch.bool), k=35, ref_k=43,
                         size_bits=cfg.bf_size, n_buckets=sharded.nbs, word_base=1 << 20,
                         counts_len=sharded.cmax, minifilter=sharded.minifilter)
    assert torch.equal(before, sh.state)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_ref_scan_matches_jax_and_host(n_shards):
    """The sharded context scan (N bytes, a 37-base contig, slices smaller
    than a contig) equals JAX's build_context_sharded and the host scan."""
    import jax

    from malva_tpu.parallel.mesh import make_mesh as jax_mesh
    from malva_tpu.parallel.sharded_index import build_context_sharded as jax_scan

    cfg = _cfg()
    rng = np.random.default_rng(21)
    alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
    refs = [alpha[rng.integers(0, 5, size=n)] for n in (4000, 37, 700)]
    idx = [_index(cfg, seed=5)[0] for _ in range(3)]
    for ref in refs:
        for start in (10, 150, 800):
            if start + 39 <= len(ref):
                for ix in idx:
                    ix.bf.add_keys(ref[start + 4 : start + 39][None, :])
    host_idx, jax_idx, port_idx = idx

    off = cfg.center_off
    for ref in refs:
        if len(ref) < cfg.ref_k:
            if len(ref) > off and host_idx.bf.test_keys(ref[off : off + cfg.k][None, :])[0]:
                host_idx.context_bf.add_keys(ref[: cfg.ref_k][None, :])
            continue
        windows = np.lib.stride_tricks.sliding_window_view(ref, cfg.ref_k)
        hits = host_idx.bf.test_keys(np.ascontiguousarray(windows[:, off : off + cfg.k]))
        host_idx.context_bf.add_keys(np.ascontiguousarray(windows[hits]))

    jax_scan(jax_idx, refs, cfg, jax_mesh(min(n_shards, len(jax.devices()))), slice_chunk=256)
    build_context_sharded(port_idx, refs, cfg, [CPU] * n_shards, slice_chunk=256)
    assert host_idx.context_bf.words.any()
    np.testing.assert_array_equal(port_idx.context_bf.words, host_idx.context_bf.words)
    np.testing.assert_array_equal(port_idx.context_bf.words, jax_idx.context_bf.words)


def _diploid(**kw):
    return Config(fasta_path=os.path.join(D, "ref.fa"), vcf_path=os.path.join(D, "vars.vcf"),
                  sample_path=os.path.join(D, "reads.fa"), bf_size=1 << 20, backend="cuda", **kw)


def _golden():
    return open(os.path.join(D, "golden.vcf")).read()


@pytest.mark.parametrize("branch", ["in_ram", "spill", "kmc_dump"])
def test_pipeline_on_cpu_mesh_matches_golden(branch, tmp_path, capfd):
    """build_index + call with a 4-shard CPU mesh reproduce golden.vcf in
    each branch of call: in RAM, the spill stream and a KMC dump of the
    same reads (test_e2e_multichip.py's analogue)."""
    from malva_tpu_torch.count.counter import count_reads_kmers

    kw = {}
    if branch == "spill":
        kw["spill_dir"] = str(tmp_path / "spill")
    cfg = _diploid(**kw)
    if branch == "kmc_dump":
        keys, counts = count_reads_kmers(cfg.sample_path, 43)
        dump = tmp_path / "reads.kmc.txt"
        dump.write_text("".join(f"{k.tobytes().decode()}\t{c}\n" for k, c in zip(keys, counts)))
        cfg.sample_path, cfg.from_kmc_dump = str(dump), True
    mesh = make_mesh(devices=[CPU] * 4)
    index = tp.build_index(cfg, mesh=mesh)
    out = io.StringIO()
    stats = tp.call(cfg, index, out, mesh=mesh)
    assert out.getvalue() == _golden()
    assert stats["shards"] == 4 and stats["rows"] > 5000
    err = capfd.readouterr().err
    assert "sharded context scan" in err and "sharded call step" in err


def test_call_batch_on_cpu_mesh_matches_golden(capfd):
    """call_batch with a 4-shard CPU mesh: each sample equals golden.vcf,
    and the sharded index is placed once."""
    cfg = _diploid()
    mesh = [CPU] * 4
    index = tp.build_index(cfg, mesh=mesh)
    outs = [io.StringIO(), io.StringIO()]
    tp.call_batch(cfg, index, [cfg.sample_path] * 2, outs, mesh=mesh)
    assert [o.getvalue() for o in outs] == [_golden()] * 2
    assert capfd.readouterr().err.count("sharded index uploaded") == 1


def test_dryrun_multichip_on_cpu_mesh(capfd):
    from malva_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(4, [CPU] * 4)
    err = capfd.readouterr().err
    assert "[dryrun_multichip] ok: 4-shard mesh" in err
    routed = re.search(r"hits routed to their context-word owners \[([0-9, ]+)\]", err)
    assert sum(int(n) for n in routed.group(1).split(",")) > 0


def test_entry_matches_jax_entry():
    """entry()'s step and arguments give the state JAX's entry() gives."""
    import importlib

    from malva_tpu_torch.graft_entry import entry
    from malva_tpu_torch.ops.bloom import to_u32

    jax_step, jax_args = importlib.import_module("__graft_entry__").entry()
    want = np.asarray(jax_step(*jax_args))
    step, args = entry()
    np.testing.assert_array_equal(to_u32(args[0]), np.asarray(jax_args[1]))
    step(*args)
    np.testing.assert_array_equal(to_u32(args[0]), want)


def test_mesh_routing(monkeypatch):
    """mesh_for: all cards where cuda resolves, more than one is present
    and their count divides the Bloom words; an explicit mesh as given."""
    from malva_tpu_torch import backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = backend.mesh_for(Config(backend="cuda", bf_size=1 << 33))
    assert mesh == tuple(torch.device("cuda", i) for i in range(4))
    assert backend.mesh_for(Config(backend="auto", bf_size=1 << 33), 10, 100) is None
    assert backend.mesh_for(Config(backend="host", bf_size=1 << 33)) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert backend.mesh_for(Config(backend="cuda", bf_size=1 << 33)) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend.mesh_for(Config(backend="cuda", bf_size=1 << 33)) is None
    assert backend.mesh_for(Config(backend="host", bf_size=1 << 20),
                            mesh=["cpu"] * 4) == (CPU,) * 4
    with pytest.raises(ValueError):
        backend.mesh_for(Config(bf_size=1 << 20), mesh=[CPU] * 3)
    # an explicit device alone keeps the single-device path
    assert tp._route(Config(backend="cuda", bf_size=1 << 33), 10, 0, device="cpu") == (None, CPU)


def test_shard_update_refuses_inputs_on_two_devices():
    """A shard's kernel takes its inputs from one device of the mesh."""
    from malva_tpu_torch.ops import kernels

    cpu = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.shard_update(cpu, cpu, cpu, cpu, cpu, torch.zeros(4, dtype=torch.bool,
                                                                 device="meta"),
                             k=35, ref_k=43, size_bits=1 << 20, n_buckets=1, word_base=0,
                             counts_len=0, minifilter=False)


def test_make_mesh_and_all_gather_design():
    assert make_mesh(2, [CPU] * 4) == (CPU, CPU)
    with pytest.raises(ValueError):
        make_mesh(4, [CPU] * 2)
    with pytest.raises(ValueError):
        make_mesh(devices=[CPU, torch.device("meta")])
    cfg = _cfg()
    index, keys = _index(cfg)
    host_idx, _ = _index(cfg)
    contexts, counters = _contexts(keys)
    stats = apply_sample_counts_sharded(index, contexts, counters, cfg, [CPU] * 2, routed=False)
    apply_sample_counts(host_idx, contexts, counters, cfg)
    assert stats["design"] == "gather" and stats["gathered_rows"] == [contexts.shape[0]] * 2
    np.testing.assert_array_equal(index.bf.counts, host_idx.bf.counts)
    assert index.ref_bf.kmers == host_idx.ref_bf.kmers


@pytest.mark.parametrize("n_shards", [2, 8])
def test_gather_step_matches_jax_and_host(n_shards):
    """bf.counts and the exact map after the port's all-gather step
    (routed=False: K1 hash-only, the merged context flags, K5) equal JAX's
    all-gather step on its 8-device CPU mesh and the host apply, over three
    steps of a 1024-row batch."""
    from malva_tpu.parallel.mesh import make_mesh as jax_mesh
    from malva_tpu.parallel.sharded_index import apply_sample_counts_sharded as jax_apply

    cfg = _cfg()
    host_idx, keys = _index(cfg)
    jax_idx, _ = _index(cfg)
    port_idx, _ = _index(cfg)
    contexts, counters = _contexts(keys)

    apply_sample_counts(host_idx, contexts, counters, cfg)
    jax_apply(jax_idx, contexts, counters, cfg, jax_mesh(n_shards), batch=1024, routed=False)
    stats = apply_sample_counts_sharded(port_idx, contexts, counters, cfg, [CPU] * n_shards,
                                        batch=1024, routed=False)
    assert stats["steps"] == 3 and stats["gathered_rows"] == [contexts.shape[0]] * n_shards
    assert host_idx.bf.counts.any() and any(host_idx.ref_bf.kmers.values())
    for other in (jax_idx, host_idx):
        np.testing.assert_array_equal(port_idx.bf.counts, np.asarray(other.bf.counts))
        assert port_idx.ref_bf.kmers == other.ref_bf.kmers


def _jax_gather_arrays(st, cfg) -> dict:
    arrays = {n: np.asarray(getattr(st, n)) for n in
              ("bf_packed", "bf_counts", "ctx_words", "kmap_keys", "kmap_vals")}
    arrays.update(counts_len=st.counts_len, n_buckets=st.n_buckets, size_bits=st.size_bits,
                  k=cfg.k, ref_k=cfg.ref_k)
    return arrays


@pytest.mark.parametrize("n_shards", [2, 8])
def test_gather_arrays_match_jax(n_shards):
    """The all-gather layout the port builds on its shards equals JAX's
    shard_index array for array: [word, local rank] rows without a
    mini-filter, context words, each shard's contiguous range of the one
    global bucket table, and the counter state; the same state carried
    across through convert.py places shard s on mesh[s] likewise."""
    from malva_tpu.parallel.sharded_index import shard_index as jax_shard

    from malva_tpu_torch.convert import gather_index_from_arrays
    from malva_tpu_torch.ops.bloom import to_u32
    from malva_tpu_torch.parallel.sharded_index import shard_index

    cfg = _cfg()
    index, _ = _index(cfg, seed=3)
    index.bf.counts[:] = np.arange(1, index.bf.counts.shape[0] + 1, dtype=np.uint32)
    for i, key in enumerate(index.ref_bf.kmers):  # a value per key, to see where it lands
        index.ref_bf.kmers[key] = i + 1
    own = shard_index(index, cfg, [CPU] * n_shards)
    st = jax_shard(index, cfg, n_shards)
    arrays = _jax_gather_arrays(st, cfg)
    assert own.counts_len == st.counts_len and own.n_buckets == st.n_buckets
    assert own.n_buckets % n_shards == 0 and own.cmax == arrays["bf_counts"].shape[1]
    carried = gather_index_from_arrays(arrays, [CPU] * n_shards, st.table)
    for gathered in (own, carried):
        for s, sh in enumerate(gathered.shards):
            for name in ("bf_packed", "ctx_words", "kmap_keys"):
                np.testing.assert_array_equal(to_u32(getattr(sh, name)), arrays[name][s],
                                              err_msg=name)
            np.testing.assert_array_equal(
                to_u32(sh.state), np.concatenate([arrays["bf_counts"][s], arrays["kmap_vals"][s]]))
    assert arrays["bf_packed"][:, :, 1].any() and arrays["kmap_keys"].any()
    assert arrays["kmap_vals"].any()
    with pytest.raises(KeyError):
        gather_index_from_arrays({"bf_packed": arrays["bf_packed"]}, [CPU] * n_shards)


def test_carried_jax_gather_state_steps_like_own_index():
    """One all-gather step over an index carried from JAX's arrays leaves
    every shard's state equal to one over the port's own index, and written
    back with JAX's table gives the host apply's counters."""
    from malva_tpu.parallel.sharded_index import shard_index as jax_shard

    from malva_tpu_torch.convert import gather_index_from_arrays
    from malva_tpu_torch.parallel.sharded_index import ShardedCallSession, shard_index

    cfg = _cfg()
    host_idx, keys = _index(cfg, seed=12)
    port_idx, _ = _index(cfg, seed=12)
    contexts, counters = _contexts(keys, seed=13, n=2000)
    packed = pack2bit_u32_np(contexts, 43)
    mesh = [CPU] * 4
    st = jax_shard(port_idx, cfg, 4)
    carried = gather_index_from_arrays(_jax_gather_arrays(st, cfg), mesh, st.table)
    own = shard_index(port_idx, cfg, mesh)
    for sharded in (own, carried):
        sess = ShardedCallSession(port_idx, cfg, mesh, sharded=sharded, routed=False)
        sess.step(packed, counters)
    got, want = ([to_u32(sh.state) for sh in g.shards] for g in (carried, own))
    assert any(g[: carried.cmax].any() for g in got) and any(g[carried.cmax :].any() for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    carried.write_back(port_idx)
    apply_sample_counts(host_idx, contexts, counters, cfg)
    np.testing.assert_array_equal(port_idx.bf.counts, host_idx.bf.counts)
    assert port_idx.ref_bf.kmers == host_idx.ref_bf.kmers


def test_carried_jax_gather_state_without_table_says_so():
    """An index carried from JAX's arrays without its host BucketTable
    cannot restart (so no session takes it) or write back: both raise a
    ValueError that names the missing table, and the host index is left
    as it was."""
    from malva_tpu.parallel.sharded_index import shard_index as jax_shard

    from malva_tpu_torch.convert import gather_index_from_arrays
    from malva_tpu_torch.parallel.sharded_index import ShardedCallSession

    cfg = _cfg()
    index, _ = _index(cfg, seed=12)
    mesh = [CPU] * 4
    carried = gather_index_from_arrays(_jax_gather_arrays(jax_shard(index, cfg, 4), cfg), mesh)
    assert carried.table is None
    counts, kmers = index.bf.counts.copy(), dict(index.ref_bf.kmers)
    with pytest.raises(ValueError, match="BucketTable"):
        ShardedCallSession(index, cfg, mesh, sharded=carried, routed=False)
    with pytest.raises(ValueError, match="BucketTable"):
        carried.write_back(index)
    np.testing.assert_array_equal(index.bf.counts, counts)
    assert index.ref_bf.kmers == kmers


def test_gather_session_multistep_matches_routed():
    """A ShardedCallSession(routed=False) over several steps, the last of
    uneven size and padded with zero-counter rows (as JAX's session pads
    its last buffer), leaves the same counters and map values as the routed
    session on the same batches, and the host apply's; a session refuses an
    index of the other design."""
    from malva_tpu_torch.parallel.sharded_index import ShardedCallSession, shard_index

    cfg = _cfg()
    host_idx, keys = _index(cfg, seed=8)
    gather_idx, _ = _index(cfg, seed=8)
    routed_idx, _ = _index(cfg, seed=8)
    contexts, counters = _contexts(keys, seed=17, n=2500)
    packed = pack2bit_u32_np(contexts, 43)
    pad = pack2bit_u32_np(np.full((300, 43), ord("A"), np.uint8), 43)
    steps = [(packed[:1024], counters[:1024]), (packed[1024:2048], counters[1024:2048]),
             (np.concatenate([packed[2048:], pad]),
              np.concatenate([counters[2048:], np.zeros(300, np.uint32)]))]
    mesh = [CPU] * 4
    for index, routed in ((gather_idx, False), (routed_idx, True)):
        sess = ShardedCallSession(index, cfg, mesh, routed=routed)
        for p, c in steps:
            sess.step(p, c)
        stats = sess.finish()
        assert stats["steps"] == 3 and stats["rows"] == 2800
    assert stats["design"] == "routed"
    apply_sample_counts(host_idx, contexts, counters, cfg)
    assert host_idx.bf.counts.any() and any(host_idx.ref_bf.kmers.values())
    for other in (routed_idx, host_idx):
        np.testing.assert_array_equal(gather_idx.bf.counts, other.bf.counts)
        assert gather_idx.ref_bf.kmers == other.ref_bf.kmers
    with pytest.raises(ValueError, match="all-gather"):
        ShardedCallSession(gather_idx, cfg, mesh, sharded=shard_index_routed(gather_idx, cfg, mesh),
                           routed=False)
    with pytest.raises(ValueError, match="routed"):
        ShardedCallSession(gather_idx, cfg, mesh, sharded=shard_index(gather_idx, cfg, mesh))


def test_gather_update_plain_one_shard_is_callstep():
    """At S = 1 one shard owns every word and every bucket: K5's plain
    version equals K1's without the mini-filter, counters and map values."""
    from malva_tpu_torch.index.device import DeviceIndex
    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.bloom import from_u32, lanes
    from malva_tpu_torch.ops.xxh3 import xxh3_mod_size
    from malva_tpu_torch.parallel.sharded_index import shard_index

    cfg = _cfg()
    index, keys = _index(cfg, seed=2)
    contexts, counters = _contexts(keys, seed=5, n=1200)
    ctx = from_u32(pack2bit_u32_np(contexts, 43), CPU)
    cnt = from_u32(counters, CPU)
    dev = DeviceIndex.from_host(index, cfg, CPU)
    dev.bf_packed[:, 1] &= RANK_MASK
    one = shard_index(index, cfg, [CPU])
    sh = one.shards[0]
    assert torch.equal(sh.bf_packed, dev.bf_packed) and torch.equal(sh.kmap_keys, dev.kmap_keys)
    st_k1 = dev.state()
    kernels.callstep_plain(dev.bf_packed, dev.ctx_words, dev.kmap_keys, st_k1, ctx, cnt, k=35,
                           ref_k=43, size_bits=cfg.bf_size, n_buckets=dev.n_buckets,
                           minifilter=False)
    x_hi, x_lo = kernels.callstep_hash_plain(ctx, 35, 43, with_ctx=True)[:2]
    cw, cb = xxh3_mod_size(x_hi, x_lo, cfg.bf_size)
    known = ((lanes(sh.ctx_words[cw]) >> cb) & 1).bool()
    st_k5 = sh.state.clone()
    kernels.gather_update_plain(sh.bf_packed, sh.kmap_keys, st_k5, ctx, cnt, known, k=35,
                                ref_k=43, size_bits=cfg.bf_size, n_buckets=one.n_buckets,
                                word_base=0, bucket_base=0, counts_len=one.cmax)
    n = index.bf.counts.shape[0]
    assert one.cmax == n and to_u32(st_k1[:n]).any() and to_u32(st_k1[n:]).any()
    np.testing.assert_array_equal(to_u32(st_k5), to_u32(st_k1))


def test_gather_update_ignores_lanes_of_other_shards():
    """A lane whose Bloom word and both buckets lie on other shards changes
    nothing on this one."""
    from malva_tpu_torch.ops import kernels
    from malva_tpu_torch.ops.bloom import from_u32
    from malva_tpu_torch.parallel.sharded_index import shard_index

    cfg = _cfg()
    index, keys = _index(cfg, seed=2)
    contexts, counters = _contexts(keys, seed=6, n=1000)
    gathered = shard_index(index, cfg, [CPU] * 4)
    sh = gathered.shards[3]
    before = sh.state.clone()
    # every lane looks like another shard's: no word and no bucket of the range
    kernels.gather_update(sh.bf_packed, sh.kmap_keys, sh.state,
                          from_u32(pack2bit_u32_np(contexts, 43), CPU), from_u32(counters, CPU),
                          torch.zeros(1000, dtype=torch.bool), k=35, ref_k=43,
                          size_bits=cfg.bf_size, n_buckets=gathered.n_buckets,
                          word_base=1 << 20, bucket_base=gathered.n_buckets,
                          counts_len=gathered.cmax)
    assert torch.equal(before, sh.state)


def test_shard_minifilter_covers_every_map_key():
    """Every key of every shard's exact map has its mini-filter bit (hash
    bits 60-61) set in the row of its Bloom word on that shard."""
    from malva_tpu_torch.ops.bloom import to_u32

    cfg = _cfg()
    index, _ = _index(cfg, seed=4)
    sharded = shard_index_routed(index, cfg, [CPU] * 4)
    wps = sharded.words_per_shard
    n_keys = 0
    for s, (sh, table) in enumerate(zip(sharded.shards, sharded.tables)):
        h = table.key_hashes
        rows = to_u32(sh.bf_packed)[((h % np.uint64(cfg.bf_size)) >> np.uint64(5)).astype(np.int64)
                                    - s * wps]
        bit = ((h >> np.uint64(60)) & np.uint64(3)).astype(np.uint32)
        assert ((rows[:, 1] >> np.uint32(RANK_BITS + bit)) & 1).all()
        n_keys += h.shape[0]
    assert n_keys == len(index.ref_bf.kmers)


def _routed_states(sharded, mesh, contexts, counters):
    """Every shard's state after one routed step over the contexts."""
    from malva_tpu.index.device import pack2bit_u32_np

    from malva_tpu_torch.ops.bloom import from_u32, to_u32
    from malva_tpu_torch.parallel.sharded_index import routed_step

    S = len(mesh)
    packed = pack2bit_u32_np(contexts, 43)
    bounds = [packed.shape[0] * s // S for s in range(S + 1)]
    ctx = [from_u32(packed[a:b], d) for a, b, d in zip(bounds, bounds[1:], mesh)]
    cnt = [from_u32(counters[a:b], d) for a, b, d in zip(bounds, bounds[1:], mesh)]
    routed_step(sharded, mesh, ctx, cnt, {"hop1_rows": [0] * S, "hop2_rows": [0] * S})
    return [to_u32(sh.state) for sh in sharded.shards]


@pytest.mark.parametrize("minifilter", [True, False])
def test_sharded_call_minifilter_on_and_off_matches_host(minifilter):
    """The sharded call phase on 4 virtual CPU shards, with the shards'
    mini-filter on and with it off (rows without it, as where counters
    reach 2^28), gives the host apply's counters and map values."""
    from malva_tpu.index.device import pack2bit_u32_np

    from malva_tpu_torch.parallel.sharded_index import ShardedCallSession

    cfg = _cfg()
    host_idx, keys = _index(cfg, seed=8)
    port_idx, _ = _index(cfg, seed=8)
    contexts, counters = _contexts(keys, seed=11, n=2000)
    mesh = [CPU] * 4
    sharded = shard_index_routed(port_idx, cfg, mesh)
    assert sharded.minifilter
    if not minifilter:
        for sh in sharded.shards:
            sh.bf_packed[:, 1] &= RANK_MASK
        sharded.minifilter = False
    sess = ShardedCallSession(port_idx, cfg, mesh, sharded=sharded)
    sess.step(pack2bit_u32_np(contexts, 43), counters)
    sess.finish()
    apply_sample_counts(host_idx, contexts, counters, cfg)
    assert host_idx.bf.counts.any() and any(host_idx.ref_bf.kmers.values())
    np.testing.assert_array_equal(port_idx.bf.counts, host_idx.bf.counts)
    assert port_idx.ref_bf.kmers == host_idx.ref_bf.kmers


def test_place_from_jax_arrays_runs_without_minifilter():
    """An index placed from JAX's routed arrays alone (no tables) has no
    mini-filter, and a routed step over it leaves every shard's state equal
    to the port's own index (mini-filter on) after the same step."""
    from malva_tpu.parallel.sharded_index import shard_index_routed as jax_shard

    from malva_tpu_torch.convert import sharded_index_from_arrays

    cfg = _cfg()
    index, keys = _index(cfg, seed=12)
    contexts, counters = _contexts(keys, seed=13, n=2000)
    mesh = [CPU] * 4
    st = jax_shard(index, cfg, 4)
    arrays = {n: np.asarray(getattr(st, n)) for n in
              ("bf_packed", "bf_counts", "ctx_words", "kmap_keys", "kmap_vals")}
    arrays.update(counts_len=st.counts_len, nbs=st.nbs, size_bits=st.size_bits, k=35, ref_k=43)
    carried = sharded_index_from_arrays(arrays, mesh)
    own = shard_index_routed(index, cfg, mesh)
    assert carried.tables is None and not carried.minifilter and own.minifilter
    got = _routed_states(carried, mesh, contexts, counters)
    want = _routed_states(own, mesh, contexts, counters)
    assert any(g.any() for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("cards", ["one device", "four devices"])
def test_context_scan_uploads_alt_words_once(cards, monkeypatch):
    """The sharded context scan on a 4-shard CPU mesh reads the alt words
    from the host once (one call of the one host-upload helper on
    ``index.bf.words``), on a mesh of one device repeated and on one of
    four distinct devices (``cpu:0``..``cpu:3``, where each device needs
    the words), and still equals JAX's sharded scan and the host scan."""
    import jax

    from malva_tpu.parallel.mesh import make_mesh as jax_mesh
    from malva_tpu.parallel.sharded_index import build_context_sharded as jax_scan

    from malva_tpu_torch.parallel import sharded_index

    cfg = _cfg()
    rng = np.random.default_rng(31)
    alpha = np.frombuffer(b"ACGTN", dtype=np.uint8)
    refs = [alpha[rng.integers(0, 5, size=n)] for n in (3000, 900)]
    idx = [_index(cfg, seed=6)[0] for _ in range(3)]
    for ref in refs:
        for start in (20, 400, 850):
            for ix in idx:
                ix.bf.add_keys(ref[start + 4 : start + 39][None, :])
    host_idx, jax_idx, port_idx = idx
    for ref in refs:
        windows = np.lib.stride_tricks.sliding_window_view(ref, cfg.ref_k)
        hits = host_idx.bf.test_keys(np.ascontiguousarray(windows[:, 4:39]))
        host_idx.context_bf.add_keys(np.ascontiguousarray(windows[hits]))

    mesh = [CPU] * 4 if cards == "one device" else [torch.device("cpu", i) for i in range(4)]
    calls = _count_calls(monkeypatch, sharded_index, "upload")
    jax_scan(jax_idx, refs, cfg, jax_mesh(min(4, len(jax.devices()))), slice_chunk=256)
    build_context_sharded(port_idx, refs, cfg, mesh, slice_chunk=256)
    words = port_idx.bf.words
    assert sum(np.shares_memory(a, words) for args in calls for a in args[0]) == 1
    assert host_idx.context_bf.words.any()
    np.testing.assert_array_equal(port_idx.context_bf.words, host_idx.context_bf.words)
    np.testing.assert_array_equal(port_idx.context_bf.words, jax_idx.context_bf.words)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_routed_step_reads_split_sizes_once_per_hop(n_shards, monkeypatch):
    """The routed step no longer reads split sizes per hop: its hops are
    fixed slot blocks whose counts travel in their headers, so three
    session steps read nothing on the host, and the session reads the
    tallies once, at its end, and says so in its stats; the all-gather
    step reads none.  The counters still equal the host apply's."""
    from malva_tpu_torch.parallel import sharded_index
    from malva_tpu_torch.parallel.sharded_index import ShardedCallSession, gather_step, shard_index

    cfg = _cfg()
    host_idx, keys = _index(cfg, seed=14)
    port_idx, _ = _index(cfg, seed=14)
    contexts, counters = _contexts(keys, seed=15, n=1800)
    mesh = [CPU] * n_shards
    reads = _count_calls(monkeypatch, sharded_index, "read_host")
    sess = ShardedCallSession(port_idx, cfg, mesh, batch=600)
    placed = len(reads)
    packed = pack2bit_u32_np(contexts, 43)
    sess.step(packed[:600], counters[:600])
    assert len(reads) - placed == 0
    sess.step(packed[600:1200], counters[600:1200])
    sess.step(packed[1200:], counters[1200:])
    assert len(reads) - placed == 0
    stats = sess.finish()
    assert len(reads) - placed == 1 and stats["host_reads"] == 1
    assert sum(stats["hop1_rows"]) == sum(stats["hop2_rows"]) == 1800
    apply_sample_counts(host_idx, contexts, counters, cfg)
    np.testing.assert_array_equal(port_idx.bf.counts, host_idx.bf.counts)
    assert port_idx.ref_bf.kmers == host_idx.ref_bf.kmers

    gathered = shard_index(port_idx, cfg, mesh)
    before = len(reads)
    ctx = sharded_index.upload(sharded_index.row_slices(packed, n_shards), mesh)
    cnt = sharded_index.upload(sharded_index.row_slices(counters, n_shards), mesh)
    gather_step(gathered, mesh, ctx, cnt, {"gathered_rows": [0] * n_shards})
    assert len(reads) == before


def test_card_startup_only_for_several_cards(monkeypatch, tmp_path, capfd):
    """The cards' start-up thread is not started for ``--backend host``,
    for a CPU mesh (virtual or of distinct devices) or for an explicit
    device; on a host that reports four cards it starts for the cuda
    backend, over the four, and not for virtual shards of one card."""
    import shutil

    from malva_tpu_torch import backend, cli
    from malva_tpu_torch.parallel import mesh as mesh_mod

    started = []

    class Recorder:
        def __init__(self, cards):
            self.cards = tuple(cards)
            started.append(self.cards)

    monkeypatch.setattr(mesh_mod, "CardStartup", Recorder)
    monkeypatch.setattr(backend, "_startup", None)
    for name in ("ref.fa", "vars.vcf", "reads.fa"):
        shutil.copy(os.path.join(D, name), tmp_path / name)
    out = io.StringIO()
    assert cli.main(["run", "--backend", "host", "-b", "1",
                     *(str(tmp_path / n) for n in ("ref.fa", "vars.vcf", "reads.fa"))],
                    out=out) == 0
    assert out.getvalue() == _golden()
    cfg = _diploid()
    for mesh in ([CPU] * 4, [torch.device("cpu", i) for i in range(4)]):
        index = tp.build_index(cfg, mesh=mesh)
        out = io.StringIO()
        tp.call(cfg, index, out, mesh=mesh)
        assert out.getvalue() == _golden()
    tp.build_index(cfg, device="cpu")
    assert started == []
    assert "card start-up" not in capfd.readouterr().err

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    big = Config(backend="cuda", bf_size=1 << 33)
    first = backend.start_cards(big)
    assert isinstance(first, Recorder)
    assert started == [tuple(torch.device("cuda", i) for i in range(4))]
    assert backend.start_cards(Config(backend="host", bf_size=1 << 33)) is None
    assert backend.start_cards(big, device="cuda:1") is None
    assert backend.start_cards(big, mesh=["cuda:0"] * 4) is None
    assert backend.start_cards(Config(backend="cuda", bf_size=3 << 20)) is None
    # one start-up per process: later entry points (call after build_index,
    # auto as cuda, a mesh of some of the cards) get the same one
    assert backend.start_cards(big) is first
    assert backend.start_cards(Config(backend="auto", bf_size=1 << 33)) is first
    assert backend.start_cards(big, mesh=["cuda:2", "cuda:3"]) is first
    assert len(started) == 1


def test_card_startup_error_is_raised_at_join(monkeypatch, capfd):
    """An error in the start-up thread (here: libcuda failing to make a
    context) is raised where the route joins it, with the thread's wall and
    the wait logged, and is raised again at a later join."""
    from malva_tpu_torch.parallel import mesh as mesh_mod

    def fail(cards):
        raise RuntimeError("cuDevicePrimaryCtxRetain(cuda:1) failed with CUresult 2")

    monkeypatch.setattr(mesh_mod, "retain_primary_contexts", fail)
    cards = mesh_mod.CardStartup([torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(RuntimeError, match="CUresult 2"):
        tp._route(Config(backend="host", bf_size=1 << 20), None, 0, mesh=[CPU] * 2, cards=cards)
    assert cards.wall_s is not None and cards.waited_s >= 0
    with pytest.raises(RuntimeError, match="CUresult 2"):
        cards.join()
    assert capfd.readouterr().err.count("card start-up: 2 cards (cuda:0, cuda:1)") == 1


def test_cuda_backend_asks_cuda_only_at_the_route(monkeypatch):
    """``--backend cuda`` raises without a device, whatever NVML counts,
    and ``run``'s overlap decision for it does not ask CUDA (which would
    start every card on the main thread before the index pass)."""
    from malva_tpu_torch import backend, cli

    asked = []

    def unavailable():
        asked.append(True)
        return False

    monkeypatch.setattr(torch.cuda, "is_available", unavailable)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = Config(backend="cuda", bf_size=1 << 33, sample_path=os.path.join(D, "reads.fa"))
    assert not cli._overlaps_counting(cfg)
    assert asked == []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.resolve(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp._route(cfg, None, 0)
    assert len(asked) == 2
