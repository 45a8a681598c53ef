"""K2 (the reference context scan) in the port against the JAX package and
the host scan, bit for bit (tolerance zero)."""

import numpy as np
import pytest
import torch

from malva_tpu.ops.pallas_kernels import HALO, make_window_hash_fn
from malva_tpu.utils.config import Config
from malva_tpu_torch.index.device import build_context_device
from malva_tpu_torch.ops import kernels
from test_device import _tiny_index

K, REF_K = 35, 43
ALPHABETS = {
    "acgtn": b"ACGTN",
    "iupac": b"ACGTACGTNacgtnRYSWKMBDHV",
    "bytes": bytes(range(256)),
}


@pytest.mark.parametrize("alphabet", sorted(ALPHABETS))
def test_window_hash_matches_pallas(alphabet):
    """Plain K2 == make_window_hash_fn in interpret mode: strcmp/RCN
    canonical forms of the centre and the window, then XXH3 of both."""
    import jax.numpy as jnp

    rng = np.random.default_rng(len(alphabet))
    alpha = np.frombuffer(ALPHABETS[alphabet], dtype=np.uint8)
    n_pos, tile = 512, 128
    ref = alpha[rng.integers(0, alpha.shape[0], size=n_pos + HALO)]
    fn = make_window_hash_fn(K, REF_K, tile, interpret=True)
    want = [np.asarray(x)[0] for x in fn(jnp.asarray(ref.astype(np.uint32))[None, :])]
    got = kernels.window_hash(torch.from_numpy(ref[: n_pos + REF_K - 1].copy()), n_pos, K, REF_K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)


def _host_scan(index, refs, cfg):
    off = cfg.center_off
    for ref in refs:
        if len(ref) < cfg.ref_k:
            if len(ref) > off and index.bf.test_keys(ref[off : off + cfg.k][None, :])[0]:
                index.context_bf.add_keys(ref[: cfg.ref_k][None, :])
            continue
        windows = np.lib.stride_tricks.sliding_window_view(ref, cfg.ref_k)
        hits = index.bf.test_keys(np.ascontiguousarray(windows[:, off : off + cfg.k]))
        index.context_bf.add_keys(np.ascontiguousarray(windows[hits]))


@pytest.mark.parametrize("chunk", [512, 1 << 20])
def test_build_context_device_matches_host_scan(chunk):
    """context_bf.words identical to the host scan (pipeline.py:460-483),
    over contigs with IUPAC bytes, one shorter than ref_k and one whose
    length is not a multiple of the chunk."""
    cfg = Config(k=K, ref_k=REF_K, bf_size=1 << 20)
    rng = np.random.default_rng(13)
    alpha = np.frombuffer(b"ACGTACGTNRYacgt", dtype=np.uint8)
    refs = [alpha[rng.integers(0, alpha.shape[0], size=n)] for n in (3000, 1777)]
    short = np.frombuffer(b"ACGTTGCAAGGCTTACCGATTGCATGGCAATCGGTACCA", dtype=np.uint8).copy()
    refs.append(short)  # 39 bases < ref_k, > centre offset

    host_idx, _ = _tiny_index(cfg, seed=9)
    dev_idx, _ = _tiny_index(cfg, seed=9)
    for idx in (host_idx, dev_idx):
        for ref, start in ((refs[0], 150), (refs[0], 1500), (refs[1], 700)):
            idx.bf.add_keys(ref[start + 4 : start + 39][None, :])
        idx.bf.add_keys(short[4:39][None, :])

    _host_scan(host_idx, refs, cfg)
    build_context_device(dev_idx, refs, cfg, "cpu", chunk=chunk)
    np.testing.assert_array_equal(host_idx.context_bf.words, dev_idx.context_bf.words)
    assert np.bitwise_count(dev_idx.context_bf.words).sum() >= 4


def test_ref_scan_checks_its_inputs():
    bf = torch.zeros(1 << 15, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_pos"):
        kernels.ref_scan(bf, bf.clone(), torch.zeros(100, dtype=torch.uint8), 100,
                         k=K, ref_k=REF_K, size_bits=1 << 20)
