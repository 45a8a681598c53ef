"""Mean over the window's samples of how many threads pass 2's block
extraction kept busy: the blocks' seconds on the threads that ran them
(counter ``pass2.extract_busy_us``, summed over the sample's native
calls) over the ``pass2.extract`` spans' seconds.  Near 1 where one
block holds the batch (its records chain), up to the native library's
thread count where many blocks share it.  From the program's spans line
(``h100bench/spans.py``); None from a program without the counter."""

from h100bench.spans import counter, mean, total_s


def parallelism(sample: dict) -> float | None:
    busy_us = counter(sample, "pass2.extract_busy_us")
    wall_s = total_s(sample, ("pass2.extract",))
    if busy_us is None or not wall_s:
        return None
    return busy_us / 1e6 / wall_s


def read(record: dict) -> float | None:
    return mean(record, parallelism)
