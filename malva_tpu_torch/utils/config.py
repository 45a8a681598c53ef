"""Pipeline configuration (mirrors reference argument_parser.hpp:51-67).

Same flag names and defaults as `malva-geno`; no mutable globals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Config:
    fasta_path: str = ""
    vcf_path: str = ""
    sample_path: str = ""  # reads file (replaces the external KMC db prefix)
    k: int = 35
    ref_k: int = 43
    error_rate: np.float32 = np.float32(0.001)
    samples: str = "-"
    freq_key: str = "AF"
    max_coverage: int = 200
    bf_size: int = 1 << 35  # bits; -b N gives N * 2^33 (argument_parser.hpp:120-123)
    strip_chr: bool = False
    from_kmc_dump: bool = False  # sample path is a kmc_dump text file
    from_kmc_db: bool = False    # sample path is a KMC database prefix (.kmc_pre/.kmc_suf)
    backend: str = "auto"  # auto|host|device: where the hot loops run
    spill_dir: str = ""  # bounded-memory counting: disk spill directory (kmc -m4 parity)
    uniform: bool = False
    verbose: bool = False
    haploid: bool = False

    @staticmethod
    def bf_gb_to_bits(gb: int) -> int:
        return int(gb) * (1 << 33)

    @property
    def center_off(self) -> int:
        return (self.ref_k - self.k) // 2

    def index_path(self) -> str:
        return f"{self.vcf_path}.c{self.ref_k}.k{self.k}.malvax.npz"
