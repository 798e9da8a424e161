"""C-compatible numeric formatting helpers, of one value or of each element
of an array (the port's counterpart of ``hpgq/utils/cfmt.py``, which takes
one value at a time; the port imports nothing of ``hpgq``).

The reference's reports are produced with C ``printf`` on values computed with
C ``float`` arithmetic and libm ``round()``.  Byte-equivalence therefore needs:

* ``c_round`` — round-half-away-from-zero (C99 ``round()``), not Python's
  banker's rounding, from the exact fraction, so even the 1-ulp edge cases
  (e.g. ``round(0.49999999999999994) == 0``) match.
* ``f32div`` / ``f32pct`` — the reference computes percentages as
  ``100.0f * a / b`` in single precision before printing with ``%0.2f``
  (e.g. ``src/stats_report.c:118-124``); we reproduce the f32 intermediate.
* ``fmt2f`` — ``%0.2f`` on the resulting double, identical to glibc printf.

A scalar argument gives a Python ``float`` (``fmt2f``: a ``str``); an array
gives a float64 array (``fmt2f``, of a 1-D array: a list of ``str``), element
by element the same.  The per-position report files hold one line a position, 100k and
more for long reads, so their arithmetic runs over whole arrays.

Quirk note: several reference format strings contain a bare ``%`` followed by
a non-conversion character (``"%0.2f %\\n"``, ``"(%0.2f %)"`` at
``src/stats_report.c:103,118-124``).  glibc prints those verbatim (verified
empirically), so the report writers emit the literal ``%`` / ``%)`` text.
"""

import math

import numpy as np


def _out(x: np.ndarray):
    """A 0-d result as a Python float, any other as the array."""
    return float(x) if x.ndim == 0 else x


def c_round(x):
    """C99 round(): round half away from zero."""
    x = np.asarray(x, dtype=np.float64)
    whole = np.trunc(x)  # x - whole is exact: the fraction, sign of x
    with np.errstate(invalid="ignore"):  # inf - inf
        away = np.abs(x - whole) >= 0.5
    return _out(np.where(away, whole + np.copysign(1.0, x), whole))


def f32pct(count, total):
    """C ``100.0f * count / total`` — the multiply happens in float32 too
    (drops bits for counts > 2^24), then the f32 division."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _out(((np.float32(100.0) * np.asarray(count, dtype=np.float32))
                     / np.asarray(total, dtype=np.float32)).astype(np.float64))


def f32div(a, b):
    """``(float)a / b`` with float32 arithmetic, like C ``1.0f * a / b``."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _out((np.asarray(a, dtype=np.float32)
                     / np.asarray(b, dtype=np.float32)).astype(np.float64))


def _fmt2f(x: float) -> str:
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    if math.isinf(x):
        return "-inf" if x < 0 else "inf"
    return "%0.2f" % x


def fmt2f(x):
    """``%0.2f`` of a double (matches glibc printf, incl. nan/inf), or
    the list of it for each element of a 1-D array."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 0:
        return _fmt2f(float(x))
    # one format call for all; glibc signs a nan, Python does not
    out = ("%0.2f\n" * len(x) % tuple(x.tolist())).split("\n")[:-1]
    for i in np.flatnonzero(~np.isfinite(x)).tolist():
        out[i] = _fmt2f(float(x[i]))
    return out
