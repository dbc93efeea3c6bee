"""The benchmark's arithmetic: the card's peaks and the roofline of a
piece of work."""
from __future__ import annotations

# published peaks (NVIDIA's data sheet, H100 SXM); the studies move data
# and do next to no arithmetic, so their bound is their bytes over the
# memory rate
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks(card: str) -> dict:
    for name, p in PEAKS.items():
        if name in card or card in name:
            return p
    raise KeyError(f"no published peaks for card {card!r}")


def least_seconds(nbytes: float, card: str) -> float:
    return nbytes / peaks(card)["bytes_per_s"]


def roofline_pct(nbytes: float, seconds: float, card: str) -> float:
    """The share of the card's bound that work of ``nbytes`` reached in
    ``seconds`` of device time; None where nothing ran."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * least_seconds(nbytes, card) / seconds


def idle_pct(busy: float, window: float) -> float:
    return 100.0 * (1.0 - busy / window)
