"""FLOP accounting and the share of the card's peak, PyTorch port.

Counterpart of sdn3d_tpu/utils/flops.py, which divides XLA's
cost-analysis counts by TPU peaks.  Here the counts come from
torch.utils.flop_counter.FlopCounterMode (`count_flops`: products,
convolutions and their backward, attention; elementwise operations count
0, so a row's share of peak is a floor of the work's, not a
utilization), and the peaks are NVIDIA's published dense rates of the
card (`PEAKS`, by the name torch.cuda.get_device_name gives): float32
outside the tensor cores, bfloat16 on them, and HBM bandwidth.  Those
rates assume the card's full power limit; a card set below it runs slower
under load, so a row is read beside the card's power limit.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

# device name -> {"float32", "bfloat16": FLOP/s, "hbm": bytes/s}, NVIDIA's
# data sheets, dense (no sparsity)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                              "hbm": 3.35e12},            # SXM5, 700 W
    "NVIDIA H100 PCIe": {"float32": 51e12, "bfloat16": 756e12,
                         "hbm": 2.0e12},
    "NVIDIA H100 NVL": {"float32": 60e12, "bfloat16": 835e12,
                        "hbm": 3.9e12},
}


def peaks_for(name: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named `name`: its own entry, else the entry
    whose name is the longest prefix of it (a variant's longer name), else
    None."""
    if name in PEAKS:
        return PEAKS[name]
    prefixes = [k for k in PEAKS if name.startswith(k)]
    return PEAKS[max(prefixes, key=len)] if prefixes else None


def device_peaks(device=None) -> Optional[Dict[str, float]]:
    """The peaks of CUDA `device` (default: the current card), or None
    without a card or for a card not in PEAKS."""
    import torch

    if not torch.cuda.is_available():
        return None
    return peaks_for(torch.cuda.get_device_name(device))


def count_flops(fn: Callable[[], Any], top: int = 5
                ) -> Tuple[float, List[Tuple[str, float]]]:
    """(FLOPs of fn(), the `top` operators by FLOPs) under FlopCounterMode;
    fn runs once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    ops = sorted(((str(k), float(v)) for k, v in counter.get_flop_counts()
                  .get("Global", {}).items()), key=lambda kv: -kv[1])
    return float(counter.get_total_flops()), ops[:top]


def mfu_row(flops: float, bytes_: Optional[float], seconds: float,
            dtype: str = "float32",
            peaks: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Roofline row of work of `flops` (and `bytes_`, when counted) that
    ran in `seconds` on one card: the achieved TFLOP/s, the floor (the
    time at the card's `dtype` peak, in ms) and the share of that peak;
    of the HBM peak when bytes are given.  `peaks` defaults to the
    current card's (device_peaks); without any, the row has no shares."""
    row: Dict[str, Any] = {"flops": flops}
    if bytes_ is not None:
        row["bytes"] = bytes_
    if seconds > 0:
        row["tflops_per_s"] = flops / seconds / 1e12
    peaks = peaks or device_peaks()
    if peaks is None:
        return row
    row["floor_ms"] = flops / peaks[dtype] * 1e3
    if seconds > 0:
        row["pct_peak_flops"] = 100.0 * flops / seconds / peaks[dtype]
        if bytes_ is not None:
            row["pct_peak_hbm"] = 100.0 * bytes_ / seconds / peaks["hbm"]
            row["bound"] = ("flops" if row["pct_peak_flops"]
                            >= row["pct_peak_hbm"] else "bytes")
    return row
