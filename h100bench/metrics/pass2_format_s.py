"""Mean seconds a sample of the window spends genotyping and writing pass 2's
records: the spans ``pass2.genotype`` (``genotype_block``) and
``pass2.format`` (``format_variants`` and the writes).  From the
program's spans line (``h100bench/spans.py``)."""

from h100bench.spans import mean_total


def read(record: dict) -> float | None:
    return mean_total(record, "pass2.genotype", "pass2.format")
