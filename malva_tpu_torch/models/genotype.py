"""Batched float32 genotype-likelihood model on a torch device.

Counterpart of ``malva_tpu/models/genotype_jax.py:25 make_genotype_fn``:
the binomial likelihood with the Stirling log-binomial and allele-
frequency priors of ``malva_tpu.models.genotype`` (reference:
var_block.hpp:224-330), in float32, over variants padded to A alleles.
Nothing on the output path uses it: the host float64 model stays the
authority for emitted VCFs.

Inputs: coverages (B, A) int32 (0 padding), freqs (B, A) float32 (0
padding), n_alleles (B,) int32 (>= 1).  Returns (best_g1, best_g2, gq),
int32 tensors of shape (B,); for haploid calls best_g2 == best_g1.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def _log_binom(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stirling form with the 0-edge guard (var_block.hpp:792-797)."""
    def safe(x):
        return torch.where(x > 0, torch.log(torch.clamp(x, min=1.0)) * x, 0.0)

    out = safe(n.to(F32)) - safe(k.to(F32)) - safe((n - k).to(F32))
    return torch.where((n == 0) | (n == k) | (k == 0), 0.0, out)


def make_genotype_fn(max_alleles: int, haploid: bool, error_rate: float, max_cov: int,
                     device):
    """The model for up to ``max_alleles`` alleles on ``device``."""
    device = torch.device(device)
    A = max_alleles
    er = np.float32(error_rate)
    # constants as genotype_jax computes them: the log on the host, then f32
    log_hom = float(np.float32(np.log(1.0 - er)))
    log_het = float(np.float32(np.log((1.0 - er) / 2.0)))
    er_t = torch.tensor(er, dtype=F32, device=device)
    pairs = [(g, g) for g in range(A)] if haploid else [
        (g1, g2) for g1 in range(A) for g2 in range(g1, A)]
    g1s = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=device)
    g2s = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=device)
    neg_inf = float("-inf")

    def genotype(coverages: torch.Tensor, freqs: torch.Tensor, n_alleles: torch.Tensor):
        cov = coverages.to(device=device, dtype=torch.int32)
        freqs = freqs.to(device=device, dtype=F32)
        n_all = n_alleles.to(device=device, dtype=torch.int32)
        total = cov.sum(dim=1, dtype=torch.int32)

        logp = []
        for g1, g2 in pairs:
            c1, f1 = cov[:, g1], freqs[:, g1]
            if g1 == g2:
                prior = 2.0 * torch.log(torch.clamp(f1, min=1e-38)) + torch.where(
                    f1 > 0, 0.0, neg_inf)
                err = total - c1
                denom = torch.clamp(n_all - 1, min=1).to(F32)
                post = (_log_binom(c1 + err, c1) + c1.to(F32) * log_hom
                        + err.to(F32) * torch.log(er_t / denom))
            else:
                c2, f2 = cov[:, g2], freqs[:, g2]
                pf = 2.0 * f1 * f2
                prior = torch.log(torch.clamp(pf, min=1e-38)) + torch.where(pf > 0, 0.0, neg_inf)
                err = total - c1 - c2
                denom = torch.clamp(n_all - 2, min=1).to(F32)
                post = (_log_binom(c1 + c2 + err, c1 + c2) + _log_binom(c1 + c2, c1)
                        + (c1 + c2).to(F32) * log_het
                        + torch.where(n_all > 2, err.to(F32) * torch.log(er_t / denom), 0.0))
            valid = (g1 if haploid else g2) < n_all
            logp.append(torch.where(valid, prior + post, neg_inf))
        logp = torch.stack(logp, dim=1)  # (B, n_pairs)

        # normalize in log space; where a row is all -inf its maximum is
        # replaced by 0 before the subtraction, so exp gives 0, not NaN
        m = logp.max(dim=1, keepdim=True).values
        finite = torch.isfinite(m[:, 0])
        rel = torch.exp(logp - torch.where(torch.isfinite(m), m, 0.0))
        qual = rel / torch.clamp(rel.sum(dim=1, keepdim=True), min=1e-30)
        best = torch.argmax(logp, dim=1)  # the first maximum
        best_q = torch.gather(qual, 1, best[:, None])[:, 0]

        # degenerate cases: over-covered / no coverage / one allele
        over = (cov > max_cov).any(dim=1)
        degenerate = over | (total == 0) | (n_all == 1) | ~finite
        best = torch.where(degenerate, 0, best)
        gq = torch.where(degenerate, 0, torch.round(best_q * 100).to(torch.int32))
        return g1s[best], g2s[best], gq.to(torch.int32)

    return genotype
