"""The port's float32 genotype model against ``genotype_jax`` and the host
model.

Tolerance: ``best_g1``/``best_g2`` identical, ``gq`` within 1, since the
float32 log and exp of XLA and of torch may differ in the last bit, which
can move ``round(100 * q)`` across a half.  Against the host float64
model the argmax agrees except on near-ties, as
tests/test_genotype_models.py:72 checks for the JAX model.
"""

import numpy as np
import pytest
import torch

from malva_tpu.models import genotype_jax
from malva_tpu.models.genotype import format_variants, genotype_block
from malva_tpu_torch.models.genotype import make_genotype_fn
from test_genotype_models import FakeVariant

ER, MAX_COV = 0.001, 200


def _inputs(seed: int, B: int, A: int):
    """Seeded variants padded to A alleles, with zero-coverage, single-
    allele, over-max_cov and zero-frequency rows."""
    rng = np.random.default_rng(seed)
    n_all = rng.integers(2, A + 1, B).astype(np.int32)
    n_all[rng.random(B) < 0.05] = 1
    cov = rng.integers(0, 60, (B, A)).astype(np.int32)
    cov[rng.random(B) < 0.05] = 0
    cov[rng.random(B) < 0.03, 0] = MAX_COV + 50
    freqs = rng.random((B, A)).astype(np.float32)
    freqs[rng.random(B) < 0.05, 0] = 0
    pad = np.arange(A)[None, :] < n_all[:, None]
    cov *= pad
    freqs = np.where(pad, freqs, 0)
    freqs = (freqs / np.maximum(freqs.sum(axis=1, keepdims=True), 1e-9)).astype(np.float32)
    return cov, freqs, n_all


@pytest.mark.parametrize("haploid", [False, True])
@pytest.mark.parametrize("A", [2, 3, 4])
def test_matches_genotype_jax(haploid, A):
    cov, freqs, n_all = _inputs(10 * A + haploid, 2048, A)
    want = [np.asarray(x) for x in
            genotype_jax.make_genotype_fn(A, haploid, ER, MAX_COV)(cov, freqs, n_all)]
    fn = make_genotype_fn(A, haploid, ER, MAX_COV, "cpu")
    got = [x.numpy() for x in fn(torch.from_numpy(cov), torch.from_numpy(freqs),
                                 torch.from_numpy(n_all))]
    assert all(g.dtype == np.int32 and g.shape == (2048,) for g in got)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert np.abs(got[2].astype(np.int64) - want[2]).max() <= 1
    # the degenerate rows are all there, and give 0/0 with GQ 0
    degenerate = (cov.sum(axis=1) == 0) | (n_all == 1) | (cov > MAX_COV).any(axis=1)
    assert degenerate.sum() > 50 and (~degenerate).sum() > 1500
    assert not got[0][degenerate].any() and not got[2][degenerate].any()
    if haploid:
        np.testing.assert_array_equal(got[0], got[1])


def test_all_priors_zero_gives_no_nan():
    """A row whose every prior is -inf stays degenerate: 0/0, GQ 0."""
    fn = make_genotype_fn(3, False, ER, MAX_COV, "cpu")
    cov = torch.tensor([[5, 6, 0]], dtype=torch.int32)
    g1, g2, gq = fn(cov, torch.zeros((1, 3), dtype=torch.float32),
                    torch.tensor([3], dtype=torch.int32))
    assert (int(g1), int(g2), int(gq)) == (0, 0, 0)


def test_agrees_with_host_argmax():
    rng = np.random.default_rng(5)
    B, A = 256, 3
    cov = rng.integers(0, 40, size=(B, A)).astype(np.int32)
    freqs = rng.random((B, A)).astype(np.float32)
    freqs /= freqs.sum(axis=1, keepdims=True)
    n_all = np.full(B, A, dtype=np.int32)
    fn = make_genotype_fn(A, False, ER, MAX_COV, "cpu")
    g1, g2, gq = (x.numpy() for x in fn(torch.from_numpy(cov), torch.from_numpy(freqs),
                                        torch.from_numpy(n_all)))
    agree = 0
    for i in range(B):
        v = FakeVariant(cov[i].tolist(), freqs[i].tolist())
        genotype_block([v], MAX_COV, False, np.float32(ER))
        gt, hq = format_variants([v], haploid=False, verbose=False)[0].split("\t")[-1].split(":")
        if tuple(int(x) for x in gt.split("/")) == (int(g1[i]), int(g2[i])):
            agree += 1
            assert abs(int(hq) - int(gq[i])) <= 2  # f32 against f64 rounding
    assert agree >= B * 0.97  # f32 and f64 may disagree only on near-ties
