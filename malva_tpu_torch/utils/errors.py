"""Input-error taxonomy for the one-line `ERROR:` CLI contract.

The reference exits with a single `ERROR: ...` stderr line on bad inputs
(reference main.cpp:262-281).  Deliberate validation failures raise
:class:`InputError` so the CLI can catch exactly those; genuine internal
bugs raise builtin exceptions and traceback (ADVICE r4: a blanket
``except (ValueError, KeyError, ...)`` turned bugs into cryptic
one-liners like ``ERROR: 'chr1'``).

InputError subclasses ValueError so library callers that caught
ValueError keep working.
"""


class InputError(ValueError):
    """Invalid user input: malformed, truncated or unsupported files."""
