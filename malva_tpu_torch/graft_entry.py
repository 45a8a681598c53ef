"""Entry points of the port: the call step, and a multi-device dry run.

Counterpart of ``__graft_entry__.py``.  :func:`entry` returns the port's
call step (K1 through ``DeviceIndex.step``) with small example arguments
on the first CUDA device, or on the CPU without one.
:func:`dryrun_multichip` runs the sharded context scan, the routed call
step and the genotype model over an n-shard mesh on tiny shapes, each
asserted bit-equal to the single-device host path.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .utils.config import Config

CFG = Config(k=35, ref_k=43, bf_size=1 << 20)


def toy_problem(cfg: Config, n_ctx: int = 256, seed: int = 0):
    """(index, canonical contexts, counters) from a seed, as
    ``__graft_entry__._toy_problem``."""
    from .index.bloom_filter import BF
    from .index.kmap import KMAP
    from .ops.seq import canonical
    from .pipeline import Index

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    bf, ref_bf, ctx = BF(cfg.bf_size), KMAP(), BF(cfg.bf_size)
    bf.add_keys(alpha[rng.integers(0, 4, size=(64, cfg.k))])
    ref_bf.add_keys(alpha[rng.integers(0, 4, size=(64, cfg.k))])
    ctx.add_keys(alpha[rng.integers(0, 4, size=(64, cfg.ref_k))])
    bf.switch_mode()
    ctx.switch_mode()
    contexts = canonical(alpha[rng.integers(0, 4, size=(n_ctx, cfg.ref_k))])
    counters = rng.integers(1, 255, size=n_ctx).astype(np.uint32)
    return Index(bf=bf, ref_bf=ref_bf, context_bf=ctx), contexts, counters


def entry():
    """(step, args): ``step(*args)`` runs one call step, updating
    ``args[0]``, the counter state ``[bf_counts | kmap_vals]``, in place."""
    from .index.device import DeviceIndex, pack2bit_u32_np
    from .ops.bloom import from_u32

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    index, contexts, counters = toy_problem(CFG)
    dev = DeviceIndex.from_host(index, CFG, device)
    args = (dev.state(), from_u32(pack2bit_u32_np(contexts, CFG.ref_k), device),
            from_u32(counters, device))
    return dev.step, args


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One sharded step of each phase over an ``n_devices``-shard mesh
    (``parallel.mesh.make_mesh(n_devices, devices)``; ``devices`` may
    repeat one device), each asserted against the single-device host
    path."""
    from .models.genotype import make_genotype_fn
    from .parallel.mesh import make_mesh
    from .parallel.sharded_index import apply_sample_counts_sharded, build_context_sharded
    from .pipeline import apply_sample_counts

    mesh = make_mesh(n_devices, devices)
    index, contexts, counters = toy_problem(CFG, n_ctx=32 * n_devices)
    host_index, _, _ = toy_problem(CFG, n_ctx=32 * n_devices)

    # index phase: the sharded context scan against the host scan, on a
    # contig with some of the toy's Bloom keys (its first draw) planted as
    # window centres, so that hits cross to their context-word owners
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    alt = alpha[np.random.default_rng(0).integers(0, 4, size=(64, CFG.k))]
    rng = np.random.default_rng(3)
    ref = alpha[rng.integers(0, 4, size=2048)]
    off = CFG.center_off
    for j, at in enumerate(range(off, ref.shape[0] - CFG.ref_k, 150)):
        ref[at : at + CFG.k] = alt[j]
    build_context_sharded(index, [ref], CFG, mesh, slice_chunk=128)
    windows = np.lib.stride_tricks.sliding_window_view(ref, CFG.ref_k)
    hits = host_index.bf.test_keys(np.ascontiguousarray(windows[:, off : off + CFG.k]))
    if not hits.any():
        raise AssertionError("the toy contig has no Bloom hit to route")
    host_index.context_bf.add_keys(np.ascontiguousarray(windows[hits]))
    if not np.array_equal(index.context_bf.words, host_index.context_bf.words):
        raise AssertionError("sharded context scan diverged from the host scan")
    index.context_bf.switch_mode()
    host_index.context_bf.switch_mode()

    # call phase: the routed step against the host apply
    apply_sample_counts_sharded(index, contexts, counters, CFG, mesh, batch=32 * n_devices)
    apply_sample_counts(host_index, contexts, counters, CFG)
    if not np.array_equal(index.bf.counts, host_index.bf.counts):
        raise AssertionError("sharded call step diverged from the host path (BF counters)")
    if dict(index.ref_bf.kmers) != dict(host_index.ref_bf.kmers):
        raise AssertionError("sharded call step diverged from the host path (exact map)")

    # the genotype model over a batch split across the mesh, against one device
    B = 16 * n_devices
    rng = np.random.default_rng(1)
    cov = torch.from_numpy(rng.integers(0, 30, size=(B, 4)).astype(np.int32))
    freqs = torch.from_numpy(rng.random((B, 4), dtype=np.float32))
    n_all = torch.from_numpy(rng.integers(2, 5, size=B).astype(np.int32))
    parts = [make_genotype_fn(4, False, 0.001, 200, d)(*(t.chunk(len(mesh))[s]
                                                          for t in (cov, freqs, n_all)))
             for s, d in enumerate(mesh)]
    sharded = [torch.cat([p[i].cpu() for p in parts]) for i in range(3)]
    whole = [t.cpu() for t in make_genotype_fn(4, False, 0.001, 200, mesh[0])(cov, freqs, n_all)]
    for name, a, b in zip(("g1", "g2", "gq"), sharded, whole):
        if not torch.equal(a, b):
            raise AssertionError(f"sharded genotype {name} diverged")
    print(f"[dryrun_multichip] ok: {len(mesh)}-shard mesh ({', '.join(map(str, mesh))}): "
          f"sharded context scan, routed call step and genotype model bit-match the "
          f"single-device host path", file=sys.stderr)
