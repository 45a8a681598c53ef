"""Set-up: from the process's start to the window's, on the host's clock:
the interpreter and imports, the inputs' generation, the index built and
saved once, the warm-up sample and, in a run that builds them, the
kernels and the native library (end to end)."""


def read(record: dict) -> float | None:
    return record["setup_s"]
