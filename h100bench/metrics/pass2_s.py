"""Mean seconds a sample of the window spends in the PhaseTimer phase ``VCF
parsing and genotyping``: pass 2 (``pipeline._genotype_and_emit``: the VCF
read again, coverage, genotyping, the output)."""

from h100bench.record import mean_phase


def read(record: dict) -> float | None:
    return mean_phase(record, "VCF parsing and genotyping")
