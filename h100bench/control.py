"""The control's readings at a cell's own size: the plain reference put in
the program's place, counting in four bits (counts capped at 15) where
the configuration's counter keeps eight (capped at 255), judged by the
same comparison as a run.  The benchmark's runs do not run it.

    python3 h100bench/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed: the ``vcf_diff`` of each checked donor.  It needs
no card: the reference is NumPy.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list | None = None) -> int:
    from h100bench import check, run
    from h100bench.reference.malva import CONTROL_CAP, Reference

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    _, workload, config = run.load_cell(args.workload)
    flags = run.genotyper_flags(config["flags"])
    for seed in map(int, args.seeds.split(",")):
        work = tempfile.mkdtemp(prefix="h100bench-control-", dir=os.environ.get("TMPDIR"))
        try:
            t = time.monotonic()
            cohort, readsets = run.make_inputs(workload, config, seed, work)
            ref = Reference.build(cohort, flags.b << 33, flags.k, flags.r, flags.haploid,
                                  flags.verbose, flags.c, flags.e)
            diffs = []
            for rs in readsets[: int(workload["checked_samples"])]:
                want = ref.vcf(ref.state(rs.reads))
                diffs.append(check.vcf_diff(ref.vcf(ref.state(rs.reads, CONTROL_CAP)), want))
            print(json.dumps({"workload": args.workload, "seed": seed, "control_vcf_diff": diffs,
                              "records": len(ref.recs), "seconds": time.monotonic() - t}),
                  flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    sys.exit(main())
