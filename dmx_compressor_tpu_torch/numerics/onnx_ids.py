"""Frozen BFP type identifiers of the Q/DQ export contract.

Port of ``dmx_compressor_tpu/numerics/onnx_ids.py`` (the port keeps its own
copy).  These integer ids are a fixed interface contract with the
downstream hardware compiler ("content of this Enum is final (June 9,
2023)"): generated here, value for value the frozen enum, 10001-10055.
"""

from __future__ import annotations

BFP_TYPE_IDS: dict[str, int] = {}


def _assign(names):
    base = 10001 + len(BFP_TYPE_IDS)
    for i, n in enumerate(names):
        BFP_TYPE_IDS[n] = base + i


_SIZES = ("32_1", "24_64", "24_32", "24_16") + tuple(
    f"{p}_{b}" for p in (16, 14, 12) for b in (128, 64, 32, 16)
)

_assign([f"DMX_BFP_{s}" for s in _SIZES])  # 10001-10016
_assign([f"DMX_BFP_{p}A_{b}" for p in (14, 12) for b in (128, 64, 32, 16)])  # 10017-24
_assign([f"DMX_UBFP_{s}" for s in _SIZES])  # 10025-10040
_assign([f"DMX_SBFP_12_16_{bias}" for bias in range(4, 19)])  # 10041-10055
