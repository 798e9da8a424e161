"""The port's own copy of ``hpgq/utils/cfmt.py`` (the port imports nothing of
``hpgq``); kept equal to it.

C-compatible numeric formatting helpers.

The reference's reports are produced with C ``printf`` on values computed with
C ``float`` arithmetic and libm ``round()``.  Byte-equivalence therefore needs:

* ``c_round`` — round-half-away-from-zero (C99 ``round()``), not Python's
  banker's rounding.  We bind libm's ``round`` directly when available so even
  the 1-ulp edge cases (e.g. ``round(0.49999999999999994) == 0``) match.
* ``f32div`` / ``f32mul`` — the reference computes percentages as
  ``100.0f * a / b`` in single precision before printing with ``%0.2f``
  (e.g. ``src/stats_report.c:118-124``); we reproduce the f32 intermediate.
* ``fmt2f`` — ``%0.2f`` on the resulting double, identical to glibc printf.

Quirk note: several reference format strings contain a bare ``%`` followed by
a non-conversion character (``"%0.2f %\\n"``, ``"(%0.2f %)"`` at
``src/stats_report.c:103,118-124``).  glibc prints those verbatim (verified
empirically), so the report writers emit the literal ``%`` / ``%)`` text.
"""

import ctypes
import ctypes.util
import math

_libm_round = None
try:  # bind C round() for exact semantics
    _libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    _libm.round.restype = ctypes.c_double
    _libm.round.argtypes = [ctypes.c_double]
    _libm_round = _libm.round
except OSError:  # pragma: no cover - non-glibc fallback
    _libm_round = None


def c_round(x: float) -> float:
    """C99 round(): round half away from zero."""
    x = float(x)
    if _libm_round is not None:
        return _libm_round(x)
    if math.isnan(x) or math.isinf(x):  # pragma: no cover
        return x
    return math.copysign(math.floor(abs(x) + 0.5), x)  # pragma: no cover


def f32(x) -> float:
    """Value of x as a C float (f32), returned as a Python double."""
    import numpy as np

    return float(np.float32(x))


def f32pct(count, total) -> float:
    """C ``100.0f * count / total`` — the multiply happens in float32 too
    (drops bits for counts > 2^24), then the f32 division."""
    import numpy as np

    with np.errstate(divide="ignore", invalid="ignore"):
        return float(
            np.float32(np.float32(100.0) * np.float32(count)) / np.float32(total)
        )


def f32div(a, b) -> float:
    """``(float)a / b`` with float32 arithmetic, like C ``1.0f * a / b``."""
    import numpy as np

    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float32(a) / np.float32(b))


def fmt2f(x: float) -> str:
    """``%0.2f`` of a double (matches glibc printf, incl. nan/inf)."""
    if math.isnan(x):
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    if math.isinf(x):
        return "-inf" if x < 0 else "inf"
    return "%0.2f" % x


def c_int_trunc(x: float) -> int:
    """C double->int conversion (truncation toward zero)."""
    return int(x)


def c_uchar(x: int) -> int:
    """C (unsigned char) cast of an int: mod 256."""
    return int(x) & 0xFF
