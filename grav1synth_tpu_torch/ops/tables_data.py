"""AV1 spec constant tables for film grain synthesis.

``GAUSSIAN_SEQUENCE`` is the 2048-entry pseudo-Gaussian table from AV1
spec section 7.18.3.3. The values are normative spec data (not program
code); this copy was extracted from the system libdav1d binary and
cross-verified bit-identical against the copy in libaom.
"""

from __future__ import annotations

import json
import os

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))

with open(os.path.join(_HERE, "_gaussian_raw.json")) as _f:
    GAUSSIAN_SEQUENCE = np.asarray(json.load(_f), dtype=np.int16)

assert GAUSSIAN_SEQUENCE.shape == (2048,)
