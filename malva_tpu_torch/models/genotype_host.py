"""Genotype likelihood model + VCF record emission.

Scalar host mirror of the reference's genotyping math (reference:
var_block.hpp:224-330 and 337-396), replicating its numeric quirks:

* allele frequencies are float32, and — the reference being C++ —
  ``log(float_expr)`` resolves to the FLOAT overload (logf): priors and
  the per-term posterior products (``truth * log(1-err)`` etc.) are
  float32 end to end, widening to double only at the additive
  accumulation.  The mirror calls libm's logf via ctypes so the rounding
  is the oracle's own (exposed by the -v 6-decimal rendering, which the
  fuzz gate covers; GQ-only output hides sub-rounding differences);
* the log-binomial uses the Stirling form n·ln n − k·ln k − (n−k)·ln(n−k)
  with the 0/n==k/k==0 guard (var_block.hpp:792-797);
* an allele coverage above max_cov short-circuits the variant to the
  0/0 (0 haploid) genotype with quality 0, appending one such entry per
  over-covered allele (upstream's continue-not-break quirk);
* GQ = round(100·best/Σ) half-away-from-zero; Σ==0 leaves the default
  genotype with GQ 0 (nan comparisons are false).

A vmapped JAX version for bulk device genotyping lives in
:mod:`malva_tpu.models.genotype_jax`; this module is the bit-exactness
reference used for VCF output.
"""

from __future__ import annotations

import math

import numpy as np

from ..variants.variant import Variant

F32 = np.float32


def log_binomial(n: int, k: int) -> float:
    if n == 0 or n == k or k == 0:
        return 0.0
    return n * math.log(n) - k * math.log(k) - (n - k) * math.log(n - k)


_LABELS_H: dict[int, list[str]] = {}
_LABELS_D: dict[int, list[str]] = {}


def _labels(n_all: int, haploid: bool) -> list[str]:
    cache = _LABELS_H if haploid else _LABELS_D
    out = cache.get(n_all)
    if out is None:
        if haploid:
            out = [str(g) for g in range(n_all)]
        else:
            out = [f"{g1}/{g2}" for g1 in range(n_all) for g2 in range(g1, n_all)]
        cache[n_all] = out
    return out


def genotype_block(
    variants: list[Variant], max_cov: int, haploid: bool, error_rate: F32
) -> None:
    """Compute posterior weights for every variant's genotypes in place.

    Uses the native kernel (libm log/exp in double, float32 operand
    pre-rounding — the exact arithmetic of the reference, parity-gated by
    the oracle fuzz suite) when available; the Python path below is the
    scalar mirror."""
    if _genotype_block_native(variants, max_cov, haploid, error_rate):
        return
    genotype_block_py(variants, max_cov, haploid, error_rate)


def _genotype_block_native(
    variants: list[Variant], max_cov: int, haploid: bool, error_rate: F32
) -> bool:
    from ..utils.native import genotype_block_native

    return genotype_block_native(variants, max_cov, haploid, error_rate, _labels)


def genotype_block_py(
    variants: list[Variant], max_cov: int, haploid: bool, error_rate: F32
) -> None:
    best_geno = "0" if haploid else "0/0"
    er = F32(error_rate)

    for v in variants:
        over = False
        for cov in v.coverages:
            if cov > max_cov:
                v.add_genotype(best_geno, 0.0)
                over = True
        if over:
            continue

        if len(v.coverages) == 1:
            v.add_genotype(best_geno, 1.0)
            continue

        total_sum = sum(v.coverages)
        if total_sum == 0:
            v.add_genotype(best_geno, 0.0)
            continue

        n_all = len(v.coverages)
        if haploid:
            l1 = _logf(F32(1) - er)
            l2 = _logf(er / F32(n_all - 1))
            for g1 in range(n_all):
                truth = v.coverages[g1]
                error = total_sum - truth
                log_prior = float(F32(2) * _logf(v.frequencies[g1]))
                log_post = (
                    log_binomial(truth + error, truth)
                    + float(F32(truth) * l1)      # float multiplies,
                    + float(F32(error) * l2)      # double adds
                )
                _store(v, f"{g1}", log_prior + log_post)
        else:
            l1 = _logf(F32(1) - er)
            l2 = _logf(er / F32(n_all - 1))
            lh = _logf((F32(1) - er) / F32(2))
            le = _logf(er / F32(n_all - 2)) if n_all > 2 else F32(0)
            for g1 in range(n_all):
                for g2 in range(g1, n_all):
                    if g1 == g2:
                        log_prior = float(F32(2) * _logf(v.frequencies[g1]))
                        truth = v.coverages[g1]
                        error = total_sum - truth
                        log_post = (
                            log_binomial(truth + error, truth)
                            + float(F32(truth) * l1)
                            + float(F32(error) * l2)
                        )
                    else:
                        log_prior = float(
                            _logf(F32(2) * v.frequencies[g1] * v.frequencies[g2])
                        )
                        t1 = v.coverages[g1]
                        t2 = v.coverages[g2]
                        error = total_sum - t1 - t2
                        log_post = (
                            log_binomial(t1 + t2 + error, t1 + t2)
                            + log_binomial(t1 + t2, t1)
                            + float(F32(t1) * lh)
                            + float(F32(t2) * lh)
                        )
                        if n_all > 2:
                            log_post += float(F32(error) * le)
                    _store(v, f"{g1}/{g2}", log_prior + log_post)


def _load_logf():
    import ctypes

    try:
        libm = ctypes.CDLL("libm.so.6")
        fn = libm.logf
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float]
        return fn
    except OSError:  # non-glibc fallback: double log rounded to f32
        return None


_LOGF = _load_logf()


def _logf(x32) -> F32:
    """logf() of a float32 operand — the C++ float overload the reference
    hits (see module docstring)."""
    x = F32(x32)
    if x == 0.0:
        return F32(-math.inf)
    if x < 0.0:
        return F32(math.nan)
    if _LOGF is not None:
        return F32(_LOGF(float(x)))
    return F32(math.log(float(x)))


def _store(v: Variant, geno: str, log_prob: float) -> None:
    prob = 0.0
    if not math.isinf(log_prob):
        prob = math.exp(log_prob)
    v.add_genotype(geno, prob)


def _fmt_qual(q: np.float32) -> str:
    """cout << float: defaultfloat, precision 6 (== printf %.6g)."""
    if math.isnan(float(q)):
        return "."
    return "%.6g" % float(q)


def format_variants(variants: list[Variant], haploid: bool, verbose: bool) -> list[str]:
    """Render each variant as its output VCF line (var_block.hpp:337-396)."""
    lines: list[str] = []
    for v in variants:
        alts = b",".join(v.alts).decode()
        info = "."
        if verbose:
            info = "COVS=" + ",".join(str(int(c)) for c in v.coverages)
        best_geno = "0" if haploid else "0/0"
        best_qual = 0.0
        total_qual = sum(p for _, p in v.computed_gts)
        gts_parts = []
        for geno, prob in v.computed_gts:
            qual = prob / total_qual if total_qual != 0 else math.nan
            if qual > best_qual:
                best_geno = geno
                best_qual = qual
            if verbose:
                # std::to_string == %f; 0.0/0.0 on x86 SSE yields the
                # sign-bit-set QNaN, which glibc prints as "-nan"
                # (var_block.hpp:388 renders exactly that)
                txt = "-nan" if math.isnan(qual) else f"{qual:.6f}"
                gts_parts.append(f"{geno}:{txt}")
        if verbose:
            info += ";GTS=" + ",".join(gts_parts)
        gq = int(math.floor(best_qual * 100 + 0.5))
        lines.append(
            f"{v.seq_name}\t{v.ref_pos + 1}\t{v.idx}\t{v.ref_sub.decode()}\t"
            f"{alts}\t{_fmt_qual(v.quality)}\t{v.filt}\t{info}\tGT:GQ\t"
            f"{best_geno}:{gq}"
        )
    return lines
